"""The controls: the plain reference in the program's place, breaking one
guarantee of the configuration, must come out not correct.

The configuration states an exact inner join with its payloads carried
whole (``guarantees`` in its file). Each configuration names its
control, which its kind answers (``kinds/<kind>.py``: ``control``):
``hash32_keys`` matches rows on 32 bits of a hash of the keys,
unverified (the precision below the stated int64 keys);
``truncate_strings`` carries a string payload in a fixed 8-byte field.
``Control`` answers a join so, ``ControlServer`` serves queries so, and
``WorldControl`` answers a rank's probe rows against the whole world's
build side (the rows it gives are the rows its probe rows own).

    python3 joinbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 5]

runs the cell with the control in the program's place, once a seed,
and prints each run's result line; on the cards, at the cell's own size
and load. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

import torch

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from joinbench.system import Answer  # noqa: E402


def control_answer(kind, mode: str, left: list, right: list) -> Answer:
    """The reference's join of ``left`` and ``right`` under ``mode``, as
    the configuration's ``kind`` module answers it."""
    cols = kind.control(mode, left, right)
    n = cols[0].shape[0]
    dev = cols[0].device
    return Answer(cols, torch.tensor(n, dtype=torch.int64, device=dev),
                  torch.zeros((), dtype=torch.bool, device=dev))


class Control:
    """A system whose joins are the control's."""

    def __init__(self, kind, mode: str, device):
        self.kind = kind
        self.mode = mode
        self.device = torch.device(device)
        self.port = self

    def config(self, settings: dict) -> dict:
        return settings

    def table(self, cols: list) -> list:
        return cols

    def phases(self):
        return contextlib.nullcontext([])

    def join_cols(self, left: list, right: list, config, left_on=(0,), right_on=(0,)) -> Answer:
        return control_answer(self.kind, self.mode, left, right)

    def serve(self, build: list, config, serve_settings: dict,
              on: tuple = ((0,), (0,))) -> "ControlServer":
        return ControlServer(self, build)


class _Ticket:
    def __init__(self, left: list):
        self.left = left
        self.submit_t = time.monotonic()
        self.start_t = None
        self.done = False
        self.error = None
        self.answer = None


class ControlServer:
    """One query answered a pump, first come first served."""

    def __init__(self, control: Control, build: list):
        self.port = control
        self.build = build
        self.queue: list = []
        self.sched = self

    def submit(self, left: list) -> _Ticket:
        t = _Ticket(left)
        self.queue.append(t)
        return t

    def warm(self, left: list) -> None:
        control_answer(self.port.kind, self.port.mode, left, self.build)

    def pump(self, timeout: float) -> int:
        if not self.queue:
            time.sleep(timeout)
            return 0
        t = self.queue.pop(0)
        t.start_t = time.monotonic()
        t.answer = control_answer(self.port.kind, self.port.mode, t.left, self.build)
        t.left = None
        t.done = True
        return 1

    @staticmethod
    def answer(ticket: _Ticket):
        return ticket.answer

    @staticmethod
    def queued_s(ticket: _Ticket):
        return None if ticket.start_t is None else ticket.start_t - ticket.submit_t

    def close(self) -> None:
        self.queue.clear()


class WorldControl(Control):
    """The control on one rank of a world: this rank's probe rows joined
    against the whole world's build side, drawn again from the seed."""

    def __init__(self, kind, cfg: dict, device, seed: int, world: int):
        super().__init__(kind, cfg["control"], device)
        self.build = kind.world_build_side(cfg, seed, world, self.device)

    def join_cols(self, left: list, right: list, config, left_on=(0,), right_on=(0,)) -> Answer:
        return control_answer(self.kind, self.mode, left, self.build)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the cell with the control in the program's place")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    from joinbench import run, spec

    run.set_cache_dirs()
    cell = spec.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.traffic["ranks"] > 1:
            res = run.run_cell(cell, seed, args.seconds, False,
                               world_options={"system": "control"})
        else:
            res = run.run_cell(cell, seed, args.seconds, False,
                               system=Control(cell.kind, cell.config["control"], "cuda"))
        print(json.dumps({"seed": seed, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Faults planted under the timed path, for the test that sees
``correct`` come out false. The benchmark's own runs never use them.

Each wraps the program (``system.Port``) and breaks its answers in one
way a join can fail:

- ``unchanged``: the step hands back its input unchanged (the probe
  table as the answer);
- ``half``: half of the answer's rows left out;
- ``no_exchange``: the exchange between ranks left out (each rank of a
  process world keeps the buckets it would send, as if it had received
  them: the transport's all-to-all patched, in this process);
- ``altered``: one value of the answer altered where it is produced.
"""

from __future__ import annotations

import dataclasses

import torch

from joinbench.system import Answer, Port

FAULTS = ("unchanged", "half", "no_exchange", "altered")


def _broken(kind: str, left: list, ans: Answer) -> Answer:
    if kind == "unchanged":
        cols = [left[0], left[1]] + ([left[1]] if not isinstance(left[1], tuple) else [])
        n = left[0].shape[0]
        return Answer(cols, torch.tensor(n, dtype=torch.int64, device=left[0].device),
                      ans.flagged)
    if kind == "half":
        return dataclasses.replace(ans, count=ans.count // 2)
    if kind == "altered":
        key = ans.columns[0].clone()
        key[0] += 1
        return dataclasses.replace(ans, columns=[key] + ans.columns[1:])
    return ans


def _skip_exchange() -> None:
    """Every all-to-all of the process world's transport hands each rank
    the buckets it sent."""
    from dj_tpu_torch.parallel import communicator

    def kept(self, buckets):
        return communicator.Pending(lambda: buckets, buckets)

    communicator.DistTransport.all_to_all_start = kept


class Faulty:
    """The program with fault ``kind`` under its answers."""

    def __init__(self, kind: str, port: Port):
        if kind not in FAULTS:
            raise ValueError(f"unknown fault {kind!r}")
        self.kind = kind
        self.port = port
        if kind == "no_exchange":
            _skip_exchange()

    def config(self, settings: dict):
        return self.port.config(settings)

    def table(self, cols: list):
        return self.port.table(cols)

    def phases(self):
        return self.port.phases()

    def join_cols(self, left: list, right: list, config, left_on=(0,), right_on=(0,)) -> Answer:
        return _broken(self.kind, left,
                       self.port.join_cols(left, right, config, left_on, right_on))

    def serve(self, build: tuple, config, serve_settings: dict, on: tuple = ((0,), (0,))):
        server = self.port.serve(build, config, serve_settings, on)
        kind, answer = self.kind, server.answer

        def broken(ticket):
            ans = answer(ticket)
            if ans is None:
                return None
            left = [c.data for c in ticket.args[1].columns]
            return _broken(kind, left, ans)

        server.answer = broken
        return server


def make(name: str, port: Port) -> Faulty:
    """``fault:<kind>`` (a world's system name) or ``<kind>``."""
    return Faulty(name.split(":", 1)[-1], port)

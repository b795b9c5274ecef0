"""A cell over a world of processes, one rank per card.

``run`` (the parent, which imports neither torch nor the program) starts
one process a rank (``python -m joinbench.world <spec>``, from the
checkout's root, the card ``LOCAL_RANK``), waits for all and joins their
reports into the result line. Each rank first looks for the world's
cards (none: it exits ``NO_CARDS``, and the parent prints no result)
and checks the cell against its configuration's kind (``spec.check``:
the parent loads no kind, which imports torch); rank 0 builds the
program's kernels where the checkout lacks them before it joins the
world, so the other ranks, held at a barrier once they have joined,
find them built. Each rank joins the process world through a file
store under ``TMPDIR`` (a fresh file a run, removed after), draws its
share of the world's tables from the seed (the kind's ``world_inputs``;
int64: build keys unique over the world, probe rows matching build rows
on every rank), runs the closed loop in lockstep (rank 0's clock
decides when the window ends) and checks its answers: each row of the
sampled join goes to the rank that owns it (``world_owner``), which
compares what it received with the reference's join of its probe rows
against the whole world's build side (``world_rows_wrong``); every
join's row count, summed over the ranks, is held to the world's exact
count.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
REPORT = "JOINBENCH_RANK "
WORLD_TIMEOUT_S = 330.0
NO_CARDS = 2  # a rank's exit code when the machine lacks the world's cards


class RankFailed(RuntimeError):
    """A rank exited non-zero; ``code`` is its exit code."""

    def __init__(self, rank: int, code: int):
        super().__init__(f"rank {rank} of the world exited {code}")
        self.code = code


def _spawn(spec: dict, world: int) -> list:
    """One process a rank, its standard output to a temporary file."""
    procs = []
    for r in range(world):
        env = dict(os.environ, LOCAL_RANK=str(r))
        out = tempfile.TemporaryFile(mode="w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "joinbench.world", json.dumps(dict(spec, rank=r))],
            cwd=str(ROOT), env=env, stdout=out, text=True), out))
    return procs


def _wait(procs: list, timeout: float) -> list:
    """Each rank's report; kills every rank left when one fails or the
    world outlives ``timeout``."""
    deadline = time.monotonic() + timeout
    outs: list = [None] * len(procs)
    try:
        pending = set(range(len(procs)))
        while pending:
            for r in sorted(pending):
                p, out = procs[r]
                if p.poll() is not None:
                    pending.discard(r)
                    out.seek(0)
                    outs[r] = out.read()
                    if p.returncode != 0:
                        raise RankFailed(r, p.returncode)
            if time.monotonic() > deadline:
                raise TimeoutError(f"the world did not end within {timeout} s")
            time.sleep(0.05)
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            out.close()
    reports = []
    for r, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(REPORT)]
        if not lines:
            raise RuntimeError(f"rank {r} printed no report")
        reports.append(json.loads(lines[-1][len(REPORT):]))
    return reports


def run(cell, seed: int, seconds: float, trace: bool, wall_start: float, *,
        device: str = "cuda", backend: str = "nccl", system: str = "port",
        timeout: float = WORLD_TIMEOUT_S) -> dict:
    """The cell's result line from a world of ``cell.traffic["ranks"]``
    processes."""
    from joinbench import profiling
    from joinbench.run import result_line

    world = cell.traffic["ranks"]
    fd, store = tempfile.mkstemp(prefix="joinbench-store-")
    os.close(fd)
    os.unlink(store)
    spec = {"workload": cell.name, "here": str(cell.here), "config": cell.config,
            "traffic": cell.traffic, "seed": seed, "seconds": seconds, "trace": trace,
            "world": world, "address": "file://" + store, "device": device, "backend": backend,
            "system": system, "wall_start": wall_start}
    try:
        reports = _wait(_spawn(spec, world), timeout)
    finally:
        if os.path.exists(store):
            os.unlink(store)
    r0 = reports[0]
    forbidden = sorted({m for rep in reports for m in rep["forbidden"]})
    if forbidden:
        raise RuntimeError(f"a rank loaded {forbidden}")
    checks = {k: tuple(v) for k, v in r0["checks"].items()}
    correct = all(v <= lim for v, lim in checks.values())
    window = max(rep["window_s"] for rep in reports)
    peak = max(rep["peak"] for rep in reports)
    per_join = sum(rep["input_bytes"] for rep in reports)
    e2e = {"input_gb_per_s.world": r0["joins"] * per_join / window / 1e9,
           "peak_device_gb": peak / 1e9,
           "setup_s": max(rep["wall0"] for rep in reports) - wall_start}
    dev = dict(r0["device"], count=world, memory_peak_bytes=peak)
    layer, bd = {}, None
    if trace:
        from joinbench.run import read_layers

        profs = [rep["profile"] for rep in reports if rep["profile"]]
        ctx = {"loop": "closed", "device_kind": dev["kind"], "profiles": profs,
               "stretch_calls": r0["stretch_calls"] if len(profs) == world else 0,
               "phases": [[r[0] for r in calls]
                          for calls in zip(*(rep["phases"] for rep in reports))],
               "work": {"positions": sum(rep["positions"] for rep in reports),
                        "matches": r0["world_matches"]}}
        layer = read_layers(cell, ctx)
        if len(profs) == world:
            dev.update(busy_s=sum(p["busy_s"] for p in profs) / world,
                       window_s=sum(p["window_s"] for p in profs) / world)
            bd = profiling.breakdown(profs)
    return result_line(cell, correct, r0["joins"], r0["failed"], e2e, layer, dev, checks, trace,
                       bd)


def _system(name: str, kind, cfg: dict, device, seed: int, world: int):
    from joinbench.system import Port

    if name == "port":
        return Port(device)
    if name == "control":
        from joinbench.control import WorldControl

        return WorldControl(kind, cfg, device, seed, world)
    from joinbench.faults import make as make_fault

    return make_fault(name, Port(device))


def _route_to_owners(cols: list, owner, world: int, device) -> list:
    """The rows of ``cols`` sent to rank ``owner[i]``, all-to-all; the
    rows this rank received."""
    import torch
    import torch.distributed as dist

    order = torch.argsort(owner, stable=True)
    send = torch.stack([c[order] for c in cols], dim=1).contiguous()
    sizes = torch.bincount(owner, minlength=world)
    got_sizes = torch.empty_like(sizes)
    dist.all_to_all_single(got_sizes, sizes)
    split_in, split_out = sizes.tolist(), got_sizes.tolist()
    recv = torch.empty((sum(split_out), len(cols)), dtype=send.dtype, device=device)
    dist.all_to_all_single(recv, send, split_out, split_in)
    return [recv[:, j] for j in range(len(cols))]


def _stage(rank: int, name: str, wall_start: float) -> None:
    """One line of a rank's set-up timeline on standard error, in seconds
    from the parent's start."""
    print(f"joinbench: rank {rank}: {name} at {time.time() - wall_start:.3f} s",
          file=sys.stderr, flush=True)


def rank_main(spec: dict) -> dict:
    """One rank: the data, the loop, the check; returns its report."""
    rank, world, wall_start = spec["rank"], spec["world"], spec["wall_start"]
    from joinbench.run import forbidden_modules, set_cache_dirs

    set_cache_dirs()
    import torch
    import torch.distributed as dist

    if spec["device"] == "cuda":
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < world:
            print(f"joinbench: rank {rank}: the world needs {world} CUDA cards; found {found}",
                  file=sys.stderr, flush=True)
            sys.exit(NO_CARDS)
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    from joinbench import datagen, harness
    from joinbench.spec import check, find
    from joinbench.system import build_kernels, close_world, init_world

    here = pathlib.Path(spec["here"])
    cell = find(spec["workload"], here=here)
    kind = check(cell.config, cell.traffic, here)
    _stage(rank, "program imported", wall_start)
    if spec["device"] == "cuda" and rank == 0:
        build_kernels()
        _stage(rank, "kernels built", wall_start)
    init_world(spec["address"], world, rank, spec["backend"], spec["device"])
    dist.barrier()  # no rank loads a kernel before rank 0 has built them
    _stage(rank, "world joined", wall_start)
    try:
        cfg, traffic, seed = spec["config"], spec["traffic"], spec["seed"]
        inputs = kind.world_inputs(cfg, seed, rank, world, device)
        harness.free_memory(device)
        _stage(rank, "tables drawn", wall_start)
        system = _system(spec["system"], kind, cfg, device, seed, world)
        left, right = kind.sides(inputs)
        join_config = system.config({**cfg["join_config"], **traffic.get("join_config", {})})

        def keep_going(want: bool) -> bool:
            flag = torch.tensor([int(want)], dtype=torch.int64, device=device)
            dist.broadcast(flag, 0)
            return bool(flag.item())

        loop = harness.closed_loop(system, left, right, join_config, device, spec["seconds"],
                                   spec["trace"], datagen.sub_seed(seed, 5), keep_going,
                                   stretch_calls=traffic["trace_calls"], on=kind.on(cfg))
        counts = torch.stack(loop["counts"])
        dist.all_reduce(counts)
        flags = torch.stack(loop["flags"]).to(torch.int64)
        dist.all_reduce(flags)
        matches = torch.as_tensor(kind.expected_count(inputs), dtype=torch.int64,
                                  device=device).reshape(1).clone()
        dist.all_reduce(matches)
        want = int(matches)
        counts, flags = counts.cpu().tolist(), flags.cpu().tolist()
        del loop["counts"], loop["flags"]
        harness.free_memory(device)
        got = _route_to_owners(loop["sample"], kind.world_owner(cfg, loop["sample"]), world,
                               device)
        del loop["sample"]
        build = kind.world_build_side(cfg, seed, world, device)
        wrong = torch.tensor([kind.world_rows_wrong(inputs, build, got)], dtype=torch.int64,
                             device=device)
        dist.all_reduce(wrong)
        checks = {"count_off": (sum(c != want for c in counts), 0),
                  "flagged": (sum(f > 0 for f in flags), 0), "rows_wrong": (int(wrong), 0)}
        prof = loop["profile"]
        if prof:
            prof = {k: v for k, v in prof.items() if k != "busy_us"}
        return {
            "rank": rank, "joins": loop["joins"], "window_s": loop["window_s"],
            "wall0": loop["wall0"], "peak": loop["peak"],
            "input_bytes": harness.nbytes(left) + harness.nbytes(right),
            "positions": left[0].shape[0] + right[0].shape[0], "world_matches": want,
            "checks": checks,
            "failed": sum(c != want or f > 0 for c, f in zip(counts, flags)),
            "device": harness.device_info(device, world), "phases": loop["phases"],
            "profile": prof, "stretch_calls": loop["stretch_calls"],
            "forbidden": forbidden_modules(),
        }
    finally:
        close_world()


if __name__ == "__main__":
    report = rank_main(json.loads(sys.argv[1]))
    print(REPORT + json.dumps(report), flush=True)

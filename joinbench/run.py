"""Run one cell of BENCHMARK.json once and print its result line.

    python3 joinbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It makes the cell's tables from the seed on the device, builds the
program's kernels where the checkout lacks them, warms up, measures for
``--seconds`` and checks the answers against the plain reference. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its
limit); the last lines of standard error repeat the checks. With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a traced run. It exits
non-zero and prints no result without the cards (a world's ranks look
for them), or if ``jax``, ``jaxlib``, ``flax`` or ``dj_tpu`` was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()
WALL_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "dj_tpu")
CACHE = ROOT / ".joinbench_cache"  # fixed: a later run of the checkout finds what it built


def set_cache_dirs() -> None:
    """Every kernel cache inside the checkout, at a fixed path."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or dj_tpu."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def stage(name: str, t_start: float = T_START) -> None:
    """One line of the set-up's timeline on standard error."""
    print(f"joinbench: {name} at {time.perf_counter() - t_start:.3f} s", file=sys.stderr,
          flush=True)


def _metric(entry: dict, value: float) -> dict:
    return {"value": value, "unit": entry["unit"]}


def result_line(cell, correct: bool, attempted: int, failed: int, e2e: dict, layer: dict,
                device: dict, checks: dict, trace: bool, breakdown=None) -> dict:
    """The contract's result object; ``checks`` comes last."""
    if trace:
        metrics = {m["name"]: _metric(m, layer[m["name"]]) for m in cell.per_layer
                   if layer.get(m["name"]) is not None}
    else:
        metrics = {m["name"]: _metric(m, e2e[m["name"]]) for m in cell.end_to_end}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if trace and breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def read_layers(cell, ctx: dict) -> dict:
    from joinbench import spec

    return {m["name"]: spec.load_reader(m["name"])(ctx) for m in cell.per_layer}


def run_closed(cell, seed: int, seconds: float, trace: bool, device, system=None,
               t_start: float = T_START) -> dict:
    """A closed-loop cell on one rank of this process."""
    import torch

    from joinbench import harness, profiling
    from joinbench.datagen import sub_seed

    if system is None:
        from joinbench.system import Port

        system = Port(device)
    cfg, kind = cell.config, cell.kind
    stage("program imported")
    inputs = kind.inputs(cfg, seed, device)
    expected = int(kind.expected_count(inputs))
    left, right = kind.sides(inputs)
    join_config = system.config({**cfg["join_config"], **cell.traffic.get("join_config", {})})
    stage("tables drawn")
    if device.type == "cuda":
        from joinbench.system import build_kernels

        build_kernels()
        stage("kernels built")
    loop = harness.closed_loop(system, left, right, join_config, device, seconds, trace,
                               sub_seed(seed, 5), stretch_calls=cell.traffic["trace_calls"],
                               on=kind.on(cfg))
    setup_s = loop["t_window"] - t_start
    counts = torch.stack(loop["counts"]).cpu().tolist()
    flags = torch.stack(loop["flags"]).cpu().tolist()
    del loop["counts"], loop["flags"]
    harness.free_memory(device)
    rows = kind.rows_wrong(inputs, loop["sample"])
    bad = [c != expected or f for c, f in zip(counts, flags)]
    checks = {"count_off": (sum(c != expected for c in counts), 0),
              "flagged": (sum(flags), 0), "rows_wrong": (rows, 0)}
    correct = all(v <= lim for v, lim in checks.values())
    per_join = harness.nbytes(left) + harness.nbytes(right)
    e2e = {"input_gb_per_s": loop["joins"] * per_join / loop["window_s"] / 1e9,
           "peak_device_gb": loop["peak"] / 1e9, "setup_s": setup_s}
    dev = dict(harness.device_info(device, 1), memory_peak_bytes=loop["peak"])
    layer, bd = {}, None
    if trace:
        prof = loop["profile"]
        ctx = {"loop": "closed", "phases": loop["phases"], "profiles": [prof] if prof else [],
               "stretch_calls": loop["stretch_calls"], "device_kind": dev["kind"],
               "work": {"positions": left[0].shape[0] + right[0].shape[0],
                        "matches": expected}}
        layer = read_layers(cell, ctx)
        if prof:
            dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            bd = profiling.breakdown([prof])
    return result_line(cell, correct, loop["joins"], sum(bad), e2e, layer, dev, checks, trace,
                       bd)


def run_open(cell, seed: int, seconds: float, trace: bool, device, system=None,
             t_start: float = T_START) -> dict:
    """An open-loop (served) cell on one rank of this process."""
    import torch

    from joinbench import harness, profiling

    if system is None:
        from joinbench.system import Port

        system = Port(device)
    cfg, traffic, kind = cell.config, cell.traffic, cell.kind
    stage("program imported")
    inputs = kind.inputs(cfg, seed, device, probe=False)
    build = kind.sides(inputs)[1]
    join_config = system.config({**cfg["join_config"], **traffic.get("join_config", {}),
                                 "key_range": kind.key_range(cfg)})
    stage("tables drawn")
    if device.type == "cuda":
        from joinbench.system import build_kernels

        build_kernels()
        stage("kernels built")
    server = system.serve(system.table(build), join_config, traffic["serve"], kind.on(cfg))
    sizes = [traffic["probe_rows_max"], traffic["probe_rows_min"],
             (traffic["probe_rows_min"] + traffic["probe_rows_max"]) // 2]
    for i, rows in enumerate(sizes):
        query = harness.probe_query(kind, inputs, device, seed, (6, i), rows,
                                    traffic["selectivity"])
        server.warm(system.table(kind.sides(query)[0]))
        stage(f"warm query {i} of {rows} rows answered")
    harness.free_memory(device)
    loop = harness.open_loop(server, kind, inputs, traffic, device, seed, seconds, trace,
                             system.phases)
    setup_s = loop["t_window"] - t_start
    server.close()
    del server
    recs = loop["records"]
    answered = {i: r for i, r in recs.items() if r["error"] is None}
    lat = harness.latency_stats(loop, loop["window_s"])
    idx = sorted(answered)
    counts = torch.stack([answered[i]["count"] for i in idx]).cpu().tolist() if idx else []
    flags = torch.stack([answered[i]["flagged"] for i in idx]).cpu().tolist() if idx else []
    want = torch.stack([loop["matches"][i] for i in idx]).cpu().tolist() if idx else []
    harness.free_memory(device)
    rows = 0
    for i, got in sorted(loop["samples"].items()):
        query = harness.probe_query(kind, inputs, device, seed, (2, i), int(loop["sizes"][i]),
                                    traffic["selectivity"])
        rows += kind.rows_wrong(query, got)
    unanswered = loop["n"] - len(answered)
    count_off = sum(c != w for c, w in zip(counts, want))
    checks = {"unanswered": (unanswered, 0), "count_off": (count_off, 0),
              "flagged": (sum(flags), 0), "rows_wrong": (rows, 0)}
    correct = all(v <= lim for v, lim in checks.values())
    failed = unanswered + sum(c != w or f for c, w, f in zip(counts, want, flags))
    e2e = dict(lat, peak_device_gb=loop["peak"] / 1e9, setup_s=setup_s)
    dev = dict(harness.device_info(device, 1), memory_peak_bytes=loop["peak"])
    layer, bd = {}, None
    if trace:
        prof = loop["profile"]
        ctx = {"loop": "open", "phases": loop["phases"], "profiles": [prof] if prof else [],
               "device_kind": dev["kind"], "query_cover": harness.query_cover(loop),
               "queued_s": [r["queued_s"] for i, r in answered.items()
                            if r["queued_s"] is not None
                            and loop["due"][i] < loop["trace_from"]]}
        layer = read_layers(cell, ctx)
        if prof:
            dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            bd = profiling.breakdown([prof])
    return result_line(cell, correct, loop["n"], failed, e2e, layer, dev, checks, trace, bd)


def run_cell(cell, seed: int, seconds: float, trace: bool, device=None, system=None,
             world_options=None) -> dict:
    """The cell's result line, run in this process (one rank) or in a
    world of processes (``world.run``, whose parent never imports torch)."""
    if cell.traffic["ranks"] > 1:
        from joinbench import world

        return world.run(cell, seed, seconds, trace, WALL_START, **(world_options or {}))
    import torch

    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if cell.traffic["loop"] == "open":
        return run_open(cell, seed, seconds, trace, device, system)
    return run_closed(cell, seed, seconds, trace, device, system)


def report(result: dict) -> None:
    """The checks on standard error (last lines), then the result line."""
    for k, c in result["checks"].items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    from joinbench import spec

    cell = spec.find(args.workload)
    if cell.traffic["ranks"] > 1:
        from joinbench import world

        # Each rank checks the cell against its kind: this parent never imports torch.
        try:
            result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
        except world.RankFailed as e:
            print(f"joinbench: {args.workload}: {e}; no result", file=sys.stderr)
            return e.code
    else:
        spec.check(cell.config, cell.traffic, cell.here)
        import torch

        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell.chips:
            print(f"joinbench: {args.workload} needs {cell.chips} CUDA card(s); found {found}",
                  file=sys.stderr)
            return 2
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"joinbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The served cell's rate sweep: the highest rate the scheduler sustains.

    python3 joinbench/sweep.py --workload int64-100m.serve --rates 10,14,18 --seconds 15

sets the cell up once, then offers the cell's traffic at each rate in
turn (open loop, the cell's own sizes and schedule at that rate) and
prints, a line per rate, the queries, p50 and p95 from due to answer,
the mean queue wait in the first and last quarters of the window, and
the queries still unanswered when the window closed. A rate whose last
quarter waits far longer than its first, or that leaves a backlog at
the close, is past the knee. Run once on the cards to fix the cell's
``rate_per_s``; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def sweep_rate(server, kind, inputs, traffic: dict, device, seed: int, seconds: float,
               dump: list = None) -> dict:
    from joinbench import harness

    loop = harness.open_loop(server, kind, inputs, traffic, device, seed, seconds, False)
    if dump is not None:
        dump.append([[i, float(loop["due"][i]), int(loop["sizes"][i]), r["start"] - loop["t0"],
                      r["end"] - loop["t0"], r["queued_s"]]
                     for i, r in sorted(loop["records"].items())])
    lat = harness.latency_stats(loop, loop["window_s"])
    recs = [loop["records"][i] for i in sorted(loop["records"])]
    waits = [r["queued_s"] for r in recs if r["queued_s"] is not None]
    q = max(1, len(waits) // 4)
    t_close = loop["t0"] + seconds
    return {"rate_per_s": traffic["rate_per_s"], "queries": loop["n"],
            "answered": len(recs), **lat,
            "wait_first_quarter_ms": 1e3 * statistics.mean(waits[:q]) if waits else None,
            "wait_last_quarter_ms": 1e3 * statistics.mean(waits[-q:]) if waits else None,
            "unanswered_at_close": sum(1 for r in recs if r["end"] > t_close)
            + loop["n"] - len(recs),
            "peak_device_gb": loop["peak"] / 1e9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the served cell's rate sweep")
    ap.add_argument("--workload", default="int64-100m.serve")
    ap.add_argument("--rates", required=True, help="comma-separated queries/s")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--dump", default="", help="write every query's times to this file")
    args = ap.parse_args(argv)
    import torch

    from joinbench import harness, run, spec
    from joinbench.system import Port, build_kernels

    run.set_cache_dirs()
    cell = spec.resolve(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    port = Port(device)
    cfg, traffic, kind = cell.config, cell.traffic, cell.kind
    inputs = kind.inputs(cfg, args.seed, device, probe=False)
    build_kernels()
    join_config = port.config({**cfg["join_config"], "key_range": kind.key_range(cfg)})
    server = port.serve(port.table(kind.sides(inputs)[1]), join_config, traffic["serve"],
                        kind.on(cfg))
    query = harness.probe_query(kind, inputs, device, args.seed, (6, 0),
                                traffic["probe_rows_max"], traffic["selectivity"])
    server.warm(port.table(kind.sides(query)[0]))
    dump = [] if args.dump else None
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        tr = dict(traffic, rate_per_s=rate)
        row = sweep_rate(server, kind, inputs, tr, device, args.seed + k, args.seconds, dump)
        print("SWEEP " + json.dumps(row), flush=True)
        server.sched.reset_pressure()
    server.close()
    if dump is not None:
        pathlib.Path(args.dump).write_text(json.dumps(dump))
    return 0


if __name__ == "__main__":
    sys.exit(main())

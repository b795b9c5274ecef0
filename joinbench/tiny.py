"""The cells at sizes a CPU test run holds, for the benchmark's tests."""

from __future__ import annotations

import dataclasses

from joinbench import spec

TINY_ROWS = 20_000


def tiny(name: str, rows: int = TINY_ROWS, **traffic):
    """Cell ``name`` with its tables cut to ``rows`` a side (TPC-H: a
    quarter as many orders), a served cell's probes to 1/20 .. 2/5 of
    the build side at 20 queries/s; ``traffic`` overrides the mix."""
    c = spec.resolve(name)
    cfg = dict(c.config)
    if cfg["kind"] == "int64":
        cfg.update(build_rows=rows, probe_rows=rows, rand_max=2 * rows)
    else:
        cfg.update(orders_rows=rows // 4)
    tr = dict(c.traffic)
    if tr["loop"] == "open":
        tr.update(rate_per_s=20.0, probe_rows_min=rows // 20, probe_rows_max=2 * rows // 5,
                  wait_after_close_s=30)
    tr.update(traffic)
    return dataclasses.replace(c, config=cfg, traffic=tr)

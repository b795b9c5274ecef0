"""The cells at sizes a CPU test run holds, for the benchmark's tests."""

from __future__ import annotations

import dataclasses

from joinbench import spec

TINY_ROWS = 20_000


def tiny(name: str, rows: int = TINY_ROWS, **traffic):
    """Cell ``name`` cut to ``rows`` (``cut``)."""
    return cut(spec.resolve(name), rows, **traffic)


def cut(cell: spec.Cell, rows: int = TINY_ROWS, **traffic) -> spec.Cell:
    """``cell`` with its tables cut to ``rows`` as its kind cuts them
    (``tiny``: int64 ``rows`` a side, TPC-H a quarter as many orders), a
    served cell's probes to 1/20 .. 2/5 of the build side at 20
    queries/s; ``traffic`` overrides the mix."""
    cfg = cell.kind.tiny(dict(cell.config), rows)
    tr = dict(cell.traffic)
    if tr["loop"] == "open":
        tr.update(rate_per_s=20.0, probe_rows_min=rows // 20, probe_rows_max=2 * rows // 5,
                  wait_after_close_s=30)
    tr.update(traffic)
    return dataclasses.replace(cell, config=cfg, traffic=tr)

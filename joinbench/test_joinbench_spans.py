"""The per-layer metrics that read the program's span tree: a tiny
traced run of each cell on the CPU reports each of them where its cell
lists it, and none where it does not; on a record without the spans (a
program that lacks them) each reader returns None."""

from __future__ import annotations

import pytest
import torch

from joinbench import run, spec
from joinbench.tiny import tiny

SPAN_METRICS = (
    "phase_ms.dj_join_sort", "phase_ms.dj_join_expand", "phase_ms.dj_join_take",
    "phase_ms.dj_join_strings", "phase_ms.dj_range_probe", "phase_ms.untraced",
    "phase_ms.dj_range_probe.world", "phase_ms.untraced.world", "phase_ms.serve_run",
    "phase_ms.dj_join_sort.serve",
)
CELLS = ["int64-100m.join", "tpch-sf100-split8.join", "int64-100m.serve", "int64-100m.join.w4"]
WORLD = {"device": "cpu", "backend": "gloo", "timeout": 240}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_every_span_metric_is_listed_somewhere():
    listed = {m["name"] for m in spec.load_benchmark()["per_layer"] if "workloads" in m}
    assert set(SPAN_METRICS) <= listed


@pytest.mark.parametrize("name", CELLS)
def test_span_metrics_read_a_number_where_listed(name):
    cell = tiny(name)
    if cell.traffic["ranks"] > 1:
        res = run.run_cell(cell, 4000000017, 0.5, True, world_options=dict(WORLD, system="port"))
    elif cell.traffic["loop"] == "open":
        # A window long enough for both traced stretches to hold queries.
        cell = tiny(name, trace_stretch_s=0.5)
        res = run.run_cell(cell, 4000000017, 2.0, True, device="cpu")
    else:
        res = run.run_cell(cell, 4000000017, 0.5, True, device="cpu")
    assert res["correct"] is True
    listed = {m["name"] for m in cell.per_layer}
    for metric in SPAN_METRICS:
        if metric in listed:
            assert metric in res["metrics"], metric
            assert res["metrics"][metric]["value"] >= 0.0
            assert res["metrics"][metric]["unit"] == "ms"
        else:
            assert metric not in res["metrics"], metric
    if "phase_ms.serve_run" in listed:
        assert res["metrics"]["phase_ms.serve_run"]["value"] >= res["metrics"][
            "phase_ms.dj_join.serve"]["value"]
    if "phase_ms.dj_join_sort" in listed:
        assert res["metrics"]["phase_ms.dj_join_sort"]["value"] <= res["metrics"][
            "phase_ms.dj_join"]["value"]


@pytest.mark.parametrize("loop", ["closed", "open"])
@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_record_without_the_spans_reads_none(metric, loop):
    """The phases a program without spans records: every reader finds
    nothing and returns None, without raising."""
    ctx = {"loop": loop, "phases": [[{"dj_partition": 3.0, "dj_join": 40.0, "dj_concat": 0.5}]
                                    for _ in range(3)]}
    assert spec.load_reader(metric)(ctx) is None

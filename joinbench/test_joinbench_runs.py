"""Whole runs of each cell at a tiny size on the CPU (the look for a card
skipped): the result line keeps the contract, sound runs are correct,
and the controls and the faults planted under the timed path come out
not correct."""

from __future__ import annotations

import json

import pytest
import torch

from joinbench import run
from joinbench.control import Control
from joinbench.faults import Faulty
from joinbench.system import Port
from joinbench.tiny import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}
WORLD = {"device": "cpu", "backend": "gloo", "timeout": 240}
SINGLE = ["int64-100m.join", "tpch-sf100-split8.join", "int64-100m.serve"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, trace=False, system=None, seconds=0.5):
    """A tiny run of ``name``; ``system``: the program's stand-in (a
    world's by name: "control" or "fault:<kind>")."""
    cell = tiny(name)
    if cell.traffic["ranks"] > 1:
        return run.run_cell(cell, 4000000007, seconds, trace,
                            world_options=dict(WORLD, system=system or "port"))
    return run.run_cell(cell, 4000000007, seconds, trace, device="cpu", system=system)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", SINGLE)
def test_result_line_keeps_the_contract(name, trace):
    res = _run(name, trace)
    assert list(res) == RESULT_KEYS[:5] + (["breakdown"] if "breakdown" in res else []) + [
        "checks"]
    assert json.loads(json.dumps(res)) == res
    assert DEVICE_KEYS <= set(res["device"])
    cell = tiny(name)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0


def test_report_puts_the_checks_last(capsys):
    res = _run("int64-100m.join")
    run.report(res)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == res
    lines = err.strip().splitlines()
    assert lines[-len(res["checks"]):] == [f"{k} {c['value']} limit {c['limit']}"
                                           for k, c in res["checks"].items()]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", SINGLE)
def test_a_planted_fault_is_not_correct(name, fault):
    res = _run(name, system=Faulty(fault, Port(torch.device("cpu"))))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_tpch_control_is_not_correct():
    cell = tiny("tpch-sf100-split8.join")
    res = run.run_cell(cell, 4000000009, 0.2, False, device="cpu",
                       system=Control(cell.kind, cell.config["control"], "cpu"))
    assert res["correct"] is False


@pytest.mark.parametrize("name", ["int64-100m.join", "int64-100m.serve"])
def test_int64_control_is_not_correct_at_a_million_rows(name):
    cell = tiny(name, rows=1_000_000, rate_per_s=4.0)
    res = run.run_cell(cell, 4000000011, 0.5, False, device="cpu",
                       system=Control(cell.kind, cell.config["control"], "cpu"))
    assert res["correct"] is False
    assert res["checks"]["rows_wrong"]["value"] > 0


def test_world_cell_runs_correct_over_gloo():
    res = _run("int64-100m.join.w4", trace=True)
    assert res["correct"] is True
    assert res["device"]["count"] == 4
    assert {"phase_ms.dj_join.world", "phase_ms.dj_partition", "phase_ms.a2a_exchange"} <= set(
        res["metrics"])


@pytest.mark.parametrize("fault", ["no_exchange", "half"])
def test_world_fault_is_not_correct(fault):
    res = _run("int64-100m.join.w4", system=f"fault:{fault}")
    assert res["correct"] is False


def test_world_control_is_not_correct():
    cell = tiny("int64-100m.join.w4", rows=1_000_000)
    res = run.run_cell(cell, 4000000013, 0.2, False, world_options=dict(WORLD, system="control"))
    assert res["correct"] is False

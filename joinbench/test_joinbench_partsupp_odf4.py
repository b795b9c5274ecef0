"""The TPC-H lineitem JOIN partsupp deployment (a two-column key) and the
one-card over-decomposed int64 cell: their tiny tables and answers keep
pinned digests, their runs keep the result line's contract and read
correct, the faults and the partkey-only control do not, the partsupp
share keeps the scale's key domains and refuses other sizes, and the
unpacked sort's span metrics read where listed and nowhere else."""

from __future__ import annotations

import pytest
import torch

from joinbench import run, spec
from joinbench import test_joinbench_kinds as kinds_tests
from joinbench import test_joinbench_runs as runs_tests
from joinbench import test_joinbench_spans as spans_tests
from joinbench.control import Control
from joinbench.faults import Faulty
from joinbench.system import Port
from joinbench.tiny import tiny

CPU = torch.device("cpu")
PARTSUPP = "tpch-sf100-partsupp-split8.join"
ODF4 = "int64-100m.join.odf4"
CELLS = [PARTSUPP, ODF4]
# sha256 of the tiny tables, the reference's answer and the control's, as
# ``test_joinbench_kinds`` takes them; odf4 draws int64-100m.join's tables.
PINNED = {
    "tpch-sf100-partsupp-split8.join/4000000007/inputs": "d277d380d1d8b00802a5f76411170abebda88ff3c3470ffa6b335e22406e2c12",
    "tpch-sf100-partsupp-split8.join/4000000007/answer": "5d860c84a70abdc9367cb0cf7c6f5a1e234e0f494ee25e70b77fcf107023214b",
    "tpch-sf100-partsupp-split8.join/4000000007/control": "dd8209c7bb8789a532b8128741c367feb4903f2da815b109e991740d47c8f32c",
    "tpch-sf100-partsupp-split8.join/3/inputs": "cbf3513b91579337b94d0b9ae9f9fb05af498ace449c274e47649045ecde4a34",
    "tpch-sf100-partsupp-split8.join/3/answer": "b60b77aba8626ecbbfa8da422f197ea9b6a8250a8d43d5a259610bdffaf051be",
    "tpch-sf100-partsupp-split8.join/3/control": "fa52f60124c7a14dd282c5f3c191a3945ae10833dcd6d33a3b33cb082ac70810",
    "int64-100m.join.odf4/4000000007/inputs": "ac73dbb4fd8d9e75cdac69b82fe7410805f1768c6373275576b9c922c5d31adc",
    "int64-100m.join.odf4/4000000007/answer": "bb008dd540dfd8f17d5ae8eaa8a68b1ec46fb6762d11c51d9debd3ceee79b09c",
    "int64-100m.join.odf4/4000000007/control": "bb008dd540dfd8f17d5ae8eaa8a68b1ec46fb6762d11c51d9debd3ceee79b09c",
    "int64-100m.join.odf4/3/inputs": "5dea23e9473bc80b3ffe44c039d53a6447d89e988245355391283d9ba96587ee",
    "int64-100m.join.odf4/3/answer": "3c6962d9ebcb0c06aca30009f2e406fdc8039500314702f830052ae8b45535a1",
    "int64-100m.join.odf4/3/control": "3c6962d9ebcb0c06aca30009f2e406fdc8039500314702f830052ae8b45535a1",
}
# The unpacked sort's spans; the partsupp cell's key packs into one word at
# the tiny size only, so its span test takes the full-size form under
# ``DJT_JOIN_PACK=0``.
LEX_METRICS = ("phase_ms.dj_join_lex_sort", "phase_ms.dj_join_run_ids")
UNPACKED = {PARTSUPP}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", kinds_tests.SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_tiny_inputs_and_answers_keep_their_digests(name, seed):
    got = kinds_tests._digests(name, seed)
    assert got == {k: PINNED[k] for k in got}
    assert len(got) == sum(k.startswith(f"{name}/{seed}/") for k in PINNED)


@pytest.mark.parametrize("pack", ["1", "0"])
def test_partsupp_keeps_the_scales_key_domains_and_reads_correct(pack, monkeypatch):
    """The tiny partsupp share keeps SF 100's partkey and suppkey
    domains, and reads correct through the program both as drawn (its
    spans pack into one word) and under ``DJT_JOIN_PACK=0``, which takes
    the unpacked lexicographic sort."""
    monkeypatch.setenv("DJT_JOIN_PACK", pack)
    cell = tiny(PARTSUPP)
    inputs = cell.kind.inputs(cell.config, 4000000021, CPU)
    assert int(inputs["ps_partkey"].max()).bit_length() == 25
    assert int(inputs["ps_suppkey"].max()).bit_length() == 20
    res = run.run_cell(cell, 4000000021, 0.3, False, device="cpu")
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("key, value", [("parts", 19_999_999), ("suppliers", 999_999),
                                        ("lineitems", 600_000_000), ("split", 8)])
def test_partsupp_refuses_sizes_that_are_not_the_scales(key, value):
    cfg = spec.load_config("tpch-sf100-partsupp-split8")
    assert spec.check(cfg, spec.load_traffic("join"))
    with pytest.raises(ValueError, match=key):
        spec.check(dict(cfg, **{key: value}), spec.load_traffic("join"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_keeps_the_contract(name, trace):
    runs_tests.test_result_line_keeps_the_contract(name, trace)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    res = runs_tests._run(name, system=Faulty(fault, Port(CPU)))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_partsupp_control_is_not_correct():
    """Joined on the partkey alone, a lineitem also meets the share's
    other suppliers of its part: extra rows, wrong supplycosts."""
    cell = tiny(PARTSUPP)
    res = run.run_cell(cell, 4000000009, 0.2, False, device="cpu",
                       system=Control(cell.kind, cell.config["control"], "cpu"))
    assert res["correct"] is False
    assert res["checks"]["count_off"]["value"] > 0 and res["checks"]["rows_wrong"]["value"] > 0


def test_every_lex_sort_metric_is_listed_somewhere():
    listed = {m["name"] for m in spec.load_benchmark()["per_layer"] if "workloads" in m}
    assert set(LEX_METRICS) <= listed


@pytest.mark.parametrize("name", CELLS)
def test_span_metrics_read_a_number_where_listed(name, monkeypatch):
    if name in UNPACKED:
        monkeypatch.setenv("DJT_JOIN_PACK", "0")
    cell = tiny(name)
    res = run.run_cell(cell, 4000000017, 0.5, True, device="cpu")
    assert res["correct"] is True
    listed = {m["name"] for m in cell.per_layer}
    for metric in spans_tests.SPAN_METRICS + LEX_METRICS:
        if metric in listed:
            assert metric in res["metrics"], metric
            assert res["metrics"][metric]["value"] >= 0.0
            assert res["metrics"][metric]["unit"] == "ms"
        else:
            assert metric not in res["metrics"], metric
    assert res["metrics"]["phase_ms.dj_join_sort"]["value"] <= res["metrics"][
        "phase_ms.dj_join"]["value"]
    for inner in LEX_METRICS:
        if inner in listed:
            assert res["metrics"][inner]["value"] <= res["metrics"]["phase_ms.dj_join_sort"][
                "value"]


@pytest.mark.parametrize("loop", ["closed", "open"])
@pytest.mark.parametrize("metric", LEX_METRICS)
def test_a_record_without_the_spans_reads_none(metric, loop):
    """A program without the unpacked sort's spans: the readers find
    nothing and return None, without raising."""
    ctx = {"loop": loop, "phases": [[{"dj_partition": 3.0, "dj_join": 40.0, "dj_concat": 0.5}]
                                    for _ in range(3)]}
    assert spec.load_reader(metric)(ctx) is None

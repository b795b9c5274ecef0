"""A CPU rehearsal of chip_smoke's phases 4h, 5c, 5d and 8e.

The phases run at a tiny size on CPU tables, every check as on the card:
the card's calls stubbed (synchronize, events, memory stats), and the
kernels' wrappers, as ``ops.join`` calls them, made to count their plain
calls, so that each phase's launch checks hold.
"""

import importlib.util
import pathlib
import time
import types

import pytest
import torch

import dj_tpu_torch as tj
from dj_tpu_torch.ops import expand, merge, scan
from dj_tpu_torch.ops import join as tjoin

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cs(monkeypatch):
    """chip_smoke, with the card stubbed and the kernels counted."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Event:
        def __init__(self, **kw):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    for name, fn in (("synchronize", lambda *a, **k: None), ("Event", Event),
                     ("reset_peak_memory_stats", lambda *a, **k: None),
                     ("max_memory_allocated", lambda *a, **k: 0),
                     ("memory_allocated", lambda *a, **k: 0),
                     ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    for name, module, counter in (("join_scans", scan, "launches"),
                                  ("expand_values", expand, "launches"),
                                  ("expand_ranks", expand, "ranks_launches"),
                                  ("merge_sorted_u64", merge, "launches")):
        real = getattr(tjoin, name)

        def counted(*a, _real=real, _m=module, _c=counter, **k):
            setattr(_m, _c, getattr(_m, _c) + 1)
            return _real(*a, **k)

        monkeypatch.setattr(tjoin, name, counted)
    # One thread: the rehearsals run many small ops, whose thread pools
    # stall when other test processes share the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tj.resilience.ledger.reset()
    yield mod
    tj.resilience.ledger.reset()
    torch.set_num_threads(threads)


def _dj():
    dj = types.SimpleNamespace(**{k: getattr(tj, k) for k in tj.__all__})
    dj.make_topology = lambda devs=None, intra_size=None: tj.make_topology(
        ["cpu"] * (1 if devs is None else len(devs)), intra_size=intra_size)
    return dj


def _main_path(cs, dj, rows):
    gen = torch.Generator().manual_seed(0)
    build, probe, expected = dj.generate_build_probe_tables(
        gen, rows, rows, 0.3, 2 * rows, True, return_expected_matches=True)
    topo = dj.make_topology()
    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    out, counts, _ = dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0])
    return gen, build, probe, int(expected), topo, left, lcnt, right, rcnt, cs.sorted_rows(out,
                                                                                         counts)


def test_chip_smoke_knob_and_probe_phases_rehearse_on_cpu(cs, capsys):
    dj = _dj()
    rows = 20_000
    gen, build, probe, expected, topo, left, lcnt, right, rcnt, ref = _main_path(cs, dj, rows)
    knobs = cs.run_knobs(dj, topo, left, lcnt, right, rcnt, build, probe, expected, ref,
                         {1: 1.0, 4: 1.0}, "cpu")
    assert knobs["knob_range_probe_0"][1]["join_scans"] == 1
    for odf in (1, 4):
        cfg = dj.JoinConfig(over_decom_factor=odf, key_range=(0, 2 * rows))
        prep = dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=rows)
        got = cs.run_probe_expand(dj, topo, left, lcnt, prep, cfg, odf, build, probe, expected,
                                  ref, "cpu")
        assert got["prepared_probe_pallas"][odf]["expand_values"] == odf
        assert got["prepared_probe_hist"][odf]["expand_ranks"] == odf
    _, _, csum = cs.probe_tier_inputs(prep, left, lcnt)
    cnt = torch.diff(csum, prepend=torch.zeros(1, dtype=csum.dtype))
    assert cs.compare_probe_values("main", cnt, 2 * rows) == 0
    assert cs.probe_values_edge_cases(gen, "cpu", 20_000) == [0, 0, 0]
    out = capsys.readouterr().out
    for line in ("[knob]", "[probe_expand]", "[kernels_vs_plain]"):
        assert line in out
    assert "csum wrapped past 2^31" in out


def test_chip_smoke_append_phase_rehearses_on_cpu(cs, capsys):
    dj = _dj()
    rows = 20_000
    gen, build, probe, expected, topo, left, lcnt, right, rcnt, _ = _main_path(cs, dj, rows)
    one, world = cs.run_appends(dj, "cpu", gen, topo, left, lcnt, right, rcnt, build, probe,
                                expected, rows, "cpu")
    assert one["append_merge"][4]["merge_sorted_u64"] == 4
    assert world["append_probe"][4]["expand_ranks"] == 4 * cs.WORLD
    out = capsys.readouterr().out
    for case in ("(i)", "(ii)", "(iii)", "(iv)", "(v)"):
        assert f'"case": "{case}"' in out


def test_chip_smoke_prepared_string_phase_rehearses_on_cpu(cs, capsys):
    dj = _dj()
    orders, lineitem, _, _ = cs.tpch_tables(dj, "cpu", 0, 20_000)
    li_sorted = torch.sort(cs.lineitem_words(*(c.data for c in lineitem.columns))).values
    one, world = cs.run_prepared_strings(dj, "cpu", orders, lineitem, li_sorted, "cpu")
    assert one["tpch_prepared_probe"][4]["expand_ranks"] == 4
    assert world["tpch_prepared_merge"][1]["merge_sorted_u64"] == cs.WORLD
    assert one["tpch_prepared_append_sort"][4]["join_scans"] == 4
    out = capsys.readouterr().out
    for line in ("[tpch_prepared]", "[tpch_prepared_auto]", "[tpch_prepared_append]",
                 "[tpch_prepared_string_key]"):
        assert line in out


def test_chip_smoke_plan_tier_phases_rehearse_on_cpu(cs, capsys):
    """Phases 4i and 5e at 20,000 rows: the broadcast and salted plans,
    the replay and the two-level world, then the prepared tiers, the
    append to a broadcast side and the salted side on a skewed build
    table, every check as on the card."""
    dj = _dj()
    rows = 20_000
    gen, build, probe, expected, topo, left, lcnt, right, rcnt, ref = _main_path(cs, dj, rows)
    two = dj.make_topology(["cpu"] * cs.WORLD, intra_size=cs.INTRA)
    two_digests = cs.shard_digests(*dj.distributed_inner_join(
        two, *dj.shard_table(two, probe), *dj.shard_table(two, build), [0], [0])[:2])
    plans, digests = cs.run_plan_tiers(dj, "cpu", build, probe, expected, ref, rows, "cpu",
                                       two_digests)
    assert plans["plan_broadcast"][4]["join_scans"] == cs.WORLD
    assert plans["plan_salted"][4]["expand_values"] >= 4 * cs.WORLD
    assert sum(n for n, _ in digests) == expected
    tiers = cs.run_prepared_tiers(dj, "cpu", gen, topo, left, lcnt, build, probe, expected, ref,
                                  rows, "cpu")
    assert tiers["prepared_broadcast_probe"][1]["expand_ranks"] == cs.WORLD
    assert tiers["prepared_broadcast_merge"][1]["merge_sorted_u64"] == cs.WORLD
    assert tiers["prepared_salted_skewed_merge"][1]["merge_sorted_u64"] >= cs.WORLD
    assert tiers["prepared_shuffle_skewed_sort"][1]["join_scans"] >= cs.WORLD
    out = capsys.readouterr().out
    for case in ("(i)", "(ii)", "(iii)"):
        assert f'"smoke_phase": "4i", "case": "{case}"' in out
        assert f'"smoke_phase": "5e", "case": "{case}"' in out
    assert '"tier": "salted"' in out

"""The degradation ladder and the fault sites on dj_tpu_torch's real paths.

Each tier's fault site fires once on the path that runs it, on small CPU
tables at worlds of 1 and 4: ``pallas_merge`` and ``probe_merge`` (the
prepared query's merge tiers), ``probe_expand``, ``broadcast`` and
``salted`` (the adaptive plans), ``prepare_broadcast`` /
``prepare_salted``, ``bc_prepared_query`` / ``salted_prepared_query``
(the prepared build tiers), ``codec`` (a compressed shuffle) and the
pipeline's broadcast stage. Each pins its tier's baseline with one
``degrade`` event and ``dj_degrade_total{tier}`` = 1, as dj_tpu's slow
ladder tests assert (``tests/test_faults.py``, ``test_probe_join.py``,
``test_prepared_tier.py``, ``test_plan_adapt.py``), writes the baseline
into the tier's knob, and the retry serves a numpy oracle's rows without
the tier's kernel; ``reset_pins`` restores the knob. ``module_build``
with no active tier propagates FaultInjected; a fault-forced overflow
that exhausts the heal raises CapacityExhausted and pins nothing; the
flag sites heal exactly their factor; the ``communicator`` site counts
one consultation a dispatch, not one a rank thread.

Two cases also run dj_tpu end to end at a world of 4 on the CPU mesh
(``join.join_overflow@call=1`` through the auto wrapper, and
``broadcast@call=1`` under the adaptive planner, dj_tpu's
``tests/test_plan_adapt.py:436``): the same fault, degrade and heal
events, pins and row multisets. One gloo process world of 2 arms
``DJT_FAULT=join.join_overflow@call=1`` in every process: each heals
once and serves the unfaulted run's rows; in another, a failure on one
process under an active tier is not retried there, and its peer fails
in the collective. A merge kernel that does not launch (``KernelError``)
fails the prepared query and its warmup and pins nothing.
"""

import collections
import importlib.util
import json
import os
import pathlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from test_torch_smoke_prepared import _dj, _main_path, cs  # noqa: F401 - cs is a fixture
from dj_tpu.obs import recorder as jrecorder
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.resilience import errors as jerrors
from dj_tpu.resilience import faults as jfaults
import dj_tpu_torch as tj
from dj_tpu_torch import convert, knobs
from dj_tpu_torch import obs as tobs
from dj_tpu_torch.compress import cascaded as cz
from dj_tpu_torch.ops import cuda_build
from dj_tpu_torch.ops import expand as texpand
from dj_tpu_torch.ops import join as tjoin
from dj_tpu_torch.parallel import pipeline as tpipe
from dj_tpu_torch.resilience import errors as terrors
from dj_tpu_torch.resilience import faults as tfaults
from dj_tpu_torch.resilience import ledger as tledger

ROOT = pathlib.Path(__file__).resolve().parents[1]
LADDER_EVENTS = ("fault", "degrade", "heal", "reprepare")
FAULT_SUFFIX = " (DJT_FAULT / faults.arm)"


@pytest.fixture(autouse=True)
def clean_slate(monkeypatch):
    """No spec, counts, pins, ledger entries or reset-class knobs in
    either package; the port's obs on and empty; one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    was = tobs.enabled()
    for f, e in ((tfaults, terrors), (jfaults, jerrors)):
        f.reset()
        e.reset_pins()
    tledger.reset()
    tobs.reset(reenable=True)
    tobs.drain()
    yield
    for f, e in ((tfaults, terrors), (jfaults, jerrors)):
        f.reset()
        e.reset_pins()
    tledger.reset()
    tobs.reset(reenable=was)
    tobs.drain()
    torch.set_num_threads(threads)


def _events(o, types=LADDER_EVENTS) -> list:
    """The ladder's and the heal's events so far, without times."""
    return [{k: v for k, v in e.items() if k not in ("seq", "ts")}
            for e in o.drain() if e["type"] in types]


def _keys(seed, n, hi, hot=0.0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, hi, n)
    if hot:
        k[rng.random(n) < hot] = 7
    return k.astype(np.int64)


def _oracle(lkeys, rkeys) -> list:
    """(key, left row, right row) of every matching pair, sorted."""
    by = collections.defaultdict(list)
    for j, k in enumerate(rkeys.tolist()):
        by[k].append(j)
    return sorted((k, i, j) for i, k in enumerate(lkeys.tolist()) for j in by[k])


def _rows(out, counts) -> list:
    """The valid rows of a sharded result as sorted tuples (either
    package)."""
    counts = np.asarray(counts).tolist()
    cols = [np.asarray(c.data) for c in out.columns]
    cap = cols[0].shape[0] // len(counts)
    return sorted(row for r, n in enumerate(counts)
                  for row in zip(*[c[r * cap: r * cap + n].tolist() for c in cols]))


def _tside(topo, keys):
    t = convert.table_from_numpy([keys, np.arange(len(keys), dtype=np.int64)],
                                 ["int64", "int64"], device="cpu")
    return tj.shard_table(topo, t)


def _degraded(tier):
    """dj_degrade_total by tier after one pin of ``tier``."""
    return {t: tobs.counter_value("dj_degrade_total", tier=t)
            for t in terrors.TIER_BASELINE} == {t: int(t == tier) for t in terrors.TIER_BASELINE}


class Counted:
    """Calls of the named functions of a module (the kernel wrappers on
    the CPU take their plain versions; this counts the calls)."""

    def __init__(self, monkeypatch, mod, *names):
        self.n = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(mod, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.n[_name] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(mod, name, wrapped)

    def take(self) -> dict:
        out, self.n = dict(self.n), dict.fromkeys(self.n, 0)
        return out


CFG = dict(over_decom_factor=2, bucket_factor=4.0, join_out_factor=4.0)


def _prepared_world(w, seed, monkeypatch, hot=0.0, **cfg):
    topo = tj.make_topology(["cpu"] * w)
    lk, rk = _keys(seed, 400, 150), _keys(seed + 1, 300, 150, hot)
    (l, lc), (r, rc) = _tside(topo, lk), _tside(topo, rk)
    config = tj.JoinConfig(**{**CFG, "key_range": (0, 149), **cfg})
    return topo, l, lc, r, rc, config, _oracle(lk, rk)


# --- the merge tiers and the probe tier's expansion ----------------------


@pytest.mark.parametrize("site,merge,kernel", [("pallas_merge", "merge", "merge_sorted_u64"),
                                               ("probe_merge", "probe", "expand_ranks")])
def test_merge_tier_site_pins_the_sort_tier(site, merge, kernel, monkeypatch):
    """dj_tpu's test_pallas_merge_fault_pins_merge_tier and
    test_probe_merge...: DJT_JOIN_MERGE=sort after the pin, one degrade
    event, the rows exact, and the tier's kernel not run by the retry."""
    monkeypatch.setenv("DJT_JOIN_MERGE", merge)
    topo, l, lc, r, rc, cfg, want = _prepared_world(1, 3, monkeypatch)
    prep = tj.prepare_join_side(topo, r, rc, [0], cfg, left_capacity=l.capacity)
    calls = Counted(monkeypatch, tjoin, "merge_sorted_u64", "expand_ranks", "join_scans")
    assert _rows(*tj.distributed_inner_join(topo, l, lc, prep, None, [0], None, cfg)[:2]) == want
    assert calls.take()[kernel] == 2  # one a batch
    tobs.drain()
    tfaults.configure(f"{site}@call=1")
    out, counts, info, used, _ = tj.distributed_inner_join_auto(topo, l, lc, prep, None, [0],
                                                                None, cfg)
    assert _rows(out, counts) == want and not any(bool(v.any()) for v in info.values())
    ran = calls.take()
    assert ran[kernel] == 0 and ran["join_scans"] == 2  # the sort tier's scans
    assert terrors.pinned_tiers() == {
        "merge": f"distributed_inner_join(prepared): FaultInjected: fault injected: "
                 f"{site}@call=1{FAULT_SUFFIX}"}
    assert os.environ["DJT_JOIN_MERGE"] == "sort" and _degraded("merge")
    assert _events(tobs) == [
        {"type": "fault", "site": site, "call": 1},
        {"type": "degrade", "tier": "merge", "baseline": "sort",
         "reason": terrors.pinned_tiers()["merge"]}]
    tfaults.reset()
    terrors.reset_pins()
    assert os.environ["DJT_JOIN_MERGE"] == merge
    tj.distributed_inner_join(topo, l, lc, prep, None, [0], None, cfg)
    assert calls.take()[kernel] == 2


@pytest.mark.parametrize("world", [1, 4])
def test_a_failing_merge_kernel_fails_the_query_and_pins_nothing(world, monkeypatch):
    """A merge kernel that does not launch (KernelError) under
    DJT_JOIN_MERGE=merge: the prepared query raises it through the auto
    wrapper and the warmup, nothing is pinned, no degrade event, and the
    merge tier stays the resolved one; the query is never served by the
    sort tier."""
    monkeypatch.setenv("DJT_JOIN_MERGE", "merge")
    topo, l, lc, r, rc, cfg, want = _prepared_world(world, 3, monkeypatch)
    prep = tj.prepare_join_side(topo, r, rc, [0], cfg, left_capacity=l.capacity)

    def broken(a, b):
        raise cuda_build.KernelError("merge_sorted_u64: CUDA launch failed with error 700")

    monkeypatch.setattr(tjoin, "merge_sorted_u64", broken)
    calls = Counted(monkeypatch, tjoin, "sort_u64")
    for run in (lambda: tj.distributed_inner_join_auto(topo, l, lc, prep, None, [0], None, cfg),
                lambda: tj.warmup_prepared_join(topo, prep, l, lc, [0], cfg)):
        with pytest.raises(cuda_build.KernelError, match="launch failed"):
            run()
    assert terrors.pinned_tiers() == {} and os.environ["DJT_JOIN_MERGE"] == "merge"
    assert tjoin.resolve_merge_impl() == "merge" and _events(tobs) == []
    assert tobs.counter_value("dj_degrade_total", tier="merge") == 0
    assert calls.take()["sort_u64"] <= 2 * world  # one probe-side sort a rank and call, no retry


def test_probe_expand_site_pins_hist(monkeypatch):
    """dj_tpu's test_probe_expand_fault_pins_hist (test_prepared_tier.py):
    at a world of 4, odf 2, DJT_PROBE_EXPAND=hist after the pin and
    expand_values (the pallas expansion) not run by the retry."""
    monkeypatch.setenv("DJT_JOIN_MERGE", "probe")
    monkeypatch.setenv("DJT_PROBE_EXPAND", "pallas")
    topo, l, lc, r, rc, cfg, want = _prepared_world(4, 5, monkeypatch)
    prep = tj.prepare_join_side(topo, r, rc, [0], cfg, left_capacity=l.capacity)
    calls = Counted(monkeypatch, tjoin, "expand_values", "expand_ranks")
    tfaults.configure("probe_expand@call=1")
    res = tj.distributed_inner_join_auto(topo, l, lc, prep, None, [0], None, cfg)
    assert _rows(res[0], res[1]) == want
    assert calls.take() == {"expand_values": 0, "expand_ranks": 8}
    assert os.environ["DJT_PROBE_EXPAND"] == "hist" and terrors.tier_pinned("expand")
    assert _degraded("expand")
    assert [e["type"] for e in _events(tobs)] == ["fault", "degrade"]
    tfaults.reset()
    terrors.reset_pins()
    assert os.environ["DJT_PROBE_EXPAND"] == "pallas"
    tj.distributed_inner_join(topo, l, lc, prep, None, [0], None, cfg)
    assert calls.take()["expand_values"] == 8


# --- the adaptive plans ---------------------------------------------------


def test_salted_site_pins_adapt_and_serves_on_shuffle(monkeypatch):
    """dj_tpu's test_fault_site_pins_adapt_and_retries_on_shuffle[salted]:
    a salted decision's fault pins DJT_PLAN_ADAPT=0, and the retry (the
    same call, the decision replayed) runs the shuffle plan."""
    monkeypatch.setenv("DJT_PLAN_ADAPT", "1")
    monkeypatch.setenv("DJT_BROADCAST_BYTES", "0")
    topo = tj.make_topology(["cpu"] * 4)
    lk, rk = _keys(9, 600, 150, hot=0.5), _keys(10, 300, 150)
    (l, lc), (r, rc) = _tside(topo, lk), _tside(topo, rk)
    cfg = tj.JoinConfig(over_decom_factor=1, bucket_factor=8.0, join_out_factor=16.0)
    from dj_tpu_torch.parallel import dist_join as tdist

    assert tdist._resolve_plan_decision(topo, l, lc, r, rc, (0,), (0,), cfg).tier == "salted"
    tfaults.configure("salted@call=1")
    out, counts, info, _ = tj.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], cfg)
    assert _rows(out, counts) == _oracle(lk, rk)
    assert os.environ["DJT_PLAN_ADAPT"] == "0" and _degraded("adapt")
    assert tobs.counter_value("dj_plan_dispatch_total", tier="salted") == 0
    assert tobs.counter_value("dj_plan_dispatch_total") == 0  # the planner is off after the pin
    terrors.reset_pins()
    assert os.environ["DJT_PLAN_ADAPT"] == "1"


def test_pipeline_broadcast_stage_pins_adapt(monkeypatch):
    """A pipeline's broadcast stage under the planner: its fault pins
    "adapt" and the stage runs again on the shuffle plan (one pipeline
    event, mode shuffle), with the rows of the unfaulted chain."""
    monkeypatch.setenv("DJT_PLAN_ADAPT", "1")
    topo = tj.make_topology(["cpu"] * 4)
    lk, rk = _keys(11, 300, 100), _keys(12, 200, 100)
    (l, lc), (r, rc) = _tside(topo, lk), _tside(topo, rk)
    stages = [tj.JoinStage(r, rc, left_on=(0,), right_on=(0,))]
    cfg = tj.JoinConfig(**CFG)
    plan = tj.plan_pipeline(topo, l, lc, stages, cfg)
    assert [sp.mode for sp in plan.stage_plans] == ["broadcast"]
    tfaults.configure("broadcast@call=1")
    out, counts, infos = tj.distributed_join_pipeline(topo, l, lc, stages, cfg, plan=plan)
    assert _rows(out, counts) == _oracle(lk, rk)
    assert terrors.pinned_tiers() == {
        "adapt": f"distributed_join_pipeline: FaultInjected: fault injected: "
                 f"broadcast@call=1{FAULT_SUFFIX}"}
    pipe = [e for e in tobs.drain() if e["type"] == "pipeline"]
    assert [e["mode"] for e in pipe] == ["shuffle"]
    assert tpipe._broadcast_enabled()  # the stage's own knob is untouched


# --- the prepared build tiers ----------------------------------------------


@pytest.mark.parametrize("tier,site", [("broadcast", "prepare_broadcast"),
                                       ("salted", "prepare_salted")])
def test_prepare_tier_site_demotes_inside_prepare(tier, site, monkeypatch):
    """dj_tpu's test_prepare_broadcast_fault_demotes_inside_prepare: the
    prepare's own guard pins "prepared_tier" and hands back a working
    shuffle-prepared side; the caller never sees the fault."""
    monkeypatch.setenv("DJT_PREPARED_TIER", tier)
    topo, l, lc, r, rc, cfg, want = _prepared_world(4, 13, monkeypatch, hot=0.4,
                                                    over_decom_factor=1)
    tfaults.configure(f"{site}@call=1")
    prep = tj.prepare_join_side(topo, r, rc, [0], cfg, left_capacity=l.capacity)
    assert prep.tier == "shuffle" and terrors.tier_pinned("prepared_tier")
    assert os.environ["DJT_PREPARED_TIER"] == "shuffle" and _degraded("prepared_tier")
    assert _rows(*tj.distributed_inner_join(topo, l, lc, prep, None, [0], None, cfg)[:2]) == want
    terrors.reset_pins()
    assert os.environ["DJT_PREPARED_TIER"] == tier


@pytest.mark.parametrize("tier,site", [("broadcast", "bc_prepared_query"),
                                       ("salted", "salted_prepared_query")])
def test_prepared_query_site_pins_and_reprepares_on_shuffle(tier, site, monkeypatch):
    """dj_tpu's test_bc_prepared_query_fault_pins_shuffle: a query's
    fault against a broadcast or salted side pins "prepared_tier"; the
    retry refuses the side (PreparedPlanMismatch), the auto wrapper
    re-prepares it on shuffle and serves the exact rows."""
    monkeypatch.setenv("DJT_PREPARED_TIER", tier)
    topo, l, lc, r, rc, cfg, want = _prepared_world(4, 17, monkeypatch, hot=0.4,
                                                    over_decom_factor=1)
    prep = tj.prepare_join_side(topo, r, rc, [0], cfg, left_capacity=l.capacity)
    assert prep.tier == tier
    tobs.drain()
    tfaults.configure(f"{site}@call=1")
    res = tj.distributed_inner_join_auto(topo, l, lc, prep, None, [0], None, cfg)
    assert _rows(res[0], res[1]) == want and res[4].tier == "shuffle"
    assert terrors.tier_pinned("prepared_tier") and _degraded("prepared_tier")
    events = _events(tobs)
    assert [e["type"] for e in events] == ["fault", "degrade", "reprepare"]
    assert events[2]["reason"] == "structural" and "pinned to the shuffle-prepared" in \
        events[2]["detail"]


# --- the wire tier, and the sites no tier names -----------------------------


def test_codec_site_pins_the_wire_and_shuffles_raw(monkeypatch):
    """dj_tpu's test_codec_fault_pins_wire_tier: shuffle_on_auto with
    compression at a world of 4 degrades to the raw wire; the rows are
    conserved, and the RLE decode's expand_ranks does not run."""
    topo = tj.make_topology(["cpu"] * 4)
    n = 1024
    keys = np.arange(n, dtype=np.int64)
    t, c = _tside(topo, keys)
    opt = cz.ColumnCompressionOptions("cascaded", cz.CascadedOptions(1, 0, True), 1.5)
    calls = Counted(monkeypatch, cz, "expand_ranks")
    out, counts, overflow, *_ = tj.shuffle_on_auto(topo, t, c, [0], compression=(opt, opt))
    assert calls.take()["expand_ranks"] > 0
    tfaults.configure("codec@call=1")
    out, counts, overflow, *_ = tj.shuffle_on_auto(topo, t, c, [0], compression=(opt, opt))
    assert _rows(out, counts) == [(k, k) for k in range(n)] and not bool(overflow.any())
    assert calls.take()["expand_ranks"] == 0
    assert terrors.pinned_tiers() == {
        "wire": f"shuffle_on: FaultInjected: fault injected: codec@call=1{FAULT_SUFFIX}"}
    deg = _events(tobs, ("degrade",))
    assert deg[0]["baseline"] == "uncompressed" and _degraded("wire")
    # The pin holds for the process: the next compressed call runs raw.
    tj.shuffle_on(topo, t, c, [0], compression=(opt, opt))
    assert calls.take()["expand_ranks"] == 0
    terrors.reset_pins()
    tj.shuffle_on(topo, t, c, [0], compression=(opt, opt))
    assert calls.take()["expand_ranks"] > 0


def test_module_build_without_an_active_tier_propagates(monkeypatch):
    topo = tj.make_topology(["cpu"])
    (l, lc), (r, rc) = _tside(topo, _keys(1, 100, 50)), _tside(topo, _keys(2, 100, 50))
    tfaults.configure("module_build@call=1")
    with pytest.raises(terrors.FaultInjected) as e:
        tj.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], tj.JoinConfig(**CFG))
    assert e.value.site == "module_build" and terrors.pinned_tiers() == {}
    assert _events(tobs) == [{"type": "fault", "site": "module_build", "call": 1}]


def test_exhaustion_never_pins_an_active_tier(monkeypatch):
    """A forced join_overflow on every attempt exhausts the heal: the
    CapacityExhausted passes the ladder, though "adapt" is active."""
    monkeypatch.setenv("DJT_PLAN_ADAPT", "1")
    topo = tj.make_topology(["cpu"] * 4)
    (l, lc), (r, rc) = _tside(topo, _keys(1, 200, 50)), _tside(topo, _keys(2, 200, 50))
    tfaults.configure(",".join(f"join.join_overflow@call={i}" for i in range(1, 4)))
    with pytest.raises(terrors.CapacityExhausted) as e:
        tj.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], tj.JoinConfig(**CFG),
                                       max_attempts=2)
    assert e.value.attempts == 2 and terrors.pinned_tiers() == {}
    assert tobs.counter_value("dj_degrade_total") == 0
    assert tobs.counter_value("dj_fault_injected_total", site="join.join_overflow") == 2


def test_shuffle_split_bits_heal_only_their_factor():
    """dj_tpu's test_forced_shuffle_split_bits_heal_only_their_factor: a
    forced bucket bit grows bucket_factor alone, a forced out bit
    out_factor alone; every shard's bit is set while forced."""
    topo = tj.make_topology(["cpu"] * 2)
    n = 512
    t, c = _tside(topo, np.arange(n, dtype=np.int64))
    tfaults.configure("shuffle.bucket_overflow@call=1,shuffle.out_overflow@call=2")
    out, counts, overflow, bf, of = tj.shuffle_on_auto(topo, t, c, [0], bucket_factor=2.0,
                                                       out_factor=2.0)
    assert int(counts.sum()) == n and (bf, of) == (4.0, 4.0) and not bool(overflow.any())
    heals = _events(tobs, ("heal",))
    assert [e["flags"] for e in heals] == [["shuffle_bucket_overflow"], ["shuffle_out_overflow"]]
    assert [set(e["grew"]) for e in heals] == [{"bucket_factor"}, {"out_factor"}]
    tfaults.configure("shuffle.out_overflow@call=1")
    res = tj.shuffle_on(topo, t, c, [0], with_split_overflow=True)
    assert res[2].tolist() == [True, True] and res[3]["out"].tolist() == [True, True]
    assert res[3]["bucket"].tolist() == [False, False]


def test_flag_sites_of_the_prepared_side(monkeypatch):
    """prepared.<flag> is consulted once a member of a coalesced run (the
    second member alone is forced); append.<flag> forces the append's
    info; prepare.<flag> the prepare's, which its heal grows."""
    topo, l, lc, r, rc, cfg, want = _prepared_world(1, 21, monkeypatch)
    tfaults.configure("prepare.shuffle_overflow@call=1")
    prep = tj.prepare_join_side(topo, r, rc, [0], cfg, left_capacity=l.capacity)
    assert prep.config.bucket_factor == 2 * cfg.bucket_factor
    tfaults.configure("prepared.join_overflow@call=2")
    per_query, _ = tj.distributed_inner_join_coalesced(topo, [l, l], [lc, lc], prep, [0],
                                                       prep.config)
    assert [m[2]["join_overflow"] is True for m in per_query] == [False, True]
    assert all(_rows(m[0], m[1]) == want for m in per_query)
    tfaults.configure("append.append_overflow@call=1")
    _, info = tj.append_to_prepared(topo, prep, *_tside(topo, _keys(22, 10, 150)))
    assert info["append_overflow"] is True and not bool(info["prepared_plan_mismatch"].any())


def test_the_communicator_site_counts_one_call_a_dispatch(monkeypatch):
    """In a thread world of 4 the site is consulted once a run_spmd, on
    the calling thread: call 2 fires on the second shuffle (never on a
    second rank of the first), and fires with no tier to pin."""
    topo = tj.make_topology(["cpu"] * 4)
    t, c = _tside(topo, np.arange(64, dtype=np.int64))
    tfaults.configure("communicator@call=2")
    tj.shuffle_on(topo, t, c, [0])
    assert tfaults.call_count("communicator") == 1
    with pytest.raises(terrors.FaultInjected):
        tj.shuffle_on(topo, t, c, [0])
    assert tfaults.call_count("communicator") == 2


def test_warmup_pins_a_failing_tier(monkeypatch):
    monkeypatch.setenv("DJT_JOIN_MERGE", "merge")
    topo, l, lc, r, rc, cfg, _ = _prepared_world(1, 23, monkeypatch)
    prep = tj.prepare_join_side(topo, r, rc, [0], cfg, left_capacity=l.capacity)
    tfaults.configure("pallas_merge@call=1")
    tj.warmup_prepared_join(topo, prep, l, lc, [0], cfg)
    assert os.environ["DJT_JOIN_MERGE"] == "sort" and terrors.tier_pinned("merge")


def test_an_armed_site_that_never_fires_changes_nothing(monkeypatch):
    topo = tj.make_topology(["cpu"] * 4)
    lk, rk = _keys(25, 300, 100), _keys(26, 200, 100)
    (l, lc), (r, rc) = _tside(topo, lk), _tside(topo, rk)
    monkeypatch.setenv("DJT_FAULT", "module_build@call=1000000")
    out, counts, info = tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0],
                                                  tj.JoinConfig(**CFG))
    assert _rows(out, counts) == _oracle(lk, rk) and tfaults.call_count("module_build") == 1
    assert _events(tobs) == [] and terrors.pinned_tiers() == {}


# --- two cases end to end in both packages -----------------------------------


class _Both:
    """The same tables at a world of 4 in both packages."""

    def __init__(self, lk, rk):
        self.jtopo = jmake_topology(jax_devices()[:4])
        self.ttopo = tj.make_topology(["cpu"] * 4)
        self.j, self.t = [], []
        for keys in (lk, rk):
            arrays = [keys, np.arange(len(keys), dtype=np.int64)]
            self.j.append(jshard(self.jtopo, dj_tpu.from_arrays(*map(jnp.asarray, arrays))))
            self.t.append(_tside(self.ttopo, keys))

    def auto(self, cfg):
        """Both packages' auto join: (rows, pins, ladder events) each."""
        out = []
        for pkg, topo, ((l, lc), (r, rc)), c, errs in (
                (dj_tpu, self.jtopo, self.j, cfg, jerrors),
                (tj, self.ttopo, self.t, convert.join_config_from(cfg), terrors)):
            res = pkg.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], c)
            out.append((_rows(res[0], res[1]), errs.pinned_tiers()))
        return out


def jax_devices():
    import jax

    return jax.devices()


def _jevents() -> list:
    evs = [{k: v for k, v in e.items() if k not in ("seq", "ts")}
           for e in jrecorder.drain() if e["type"] in LADDER_EVENTS]
    for e in evs:
        if "reason" in e:
            e["reason"] = e["reason"].replace("(DJ_FAULT ", "(DJT_FAULT ")
    return evs


@pytest.mark.parametrize("case", ["join_overflow", "broadcast"])
def test_end_to_end_matches_dj_tpu(case, monkeypatch, obs_capture):
    lk, rk = _keys(31, 600, 200), _keys(32, 400, 200)
    both = _Both(lk, rk)
    if case == "broadcast":
        monkeypatch.setenv("DJ_PLAN_ADAPT", "1")
        monkeypatch.setenv("DJT_PLAN_ADAPT", "1")
        spec = "broadcast@call=1"
    else:
        spec = "join.join_overflow@call=1"
    jfaults.configure(spec)
    tfaults.configure(spec)
    cfg = dj_tpu.JoinConfig(over_decom_factor=1, bucket_factor=4.0, join_out_factor=2.0)
    (jrows, jpins), (trows, tpins) = both.auto(cfg)
    assert trows == jrows == _oracle(lk, rk)
    assert {t: r.replace("(DJ_FAULT ", "(DJT_FAULT ") for t, r in jpins.items()} == tpins
    jev, tev = _jevents(), _events(tobs)
    assert tev == jev
    types = [e["type"] for e in tev]
    assert types == (["fault", "heal"] if case == "join_overflow" else ["fault", "degrade"])
    assert list(tpins) == ([] if case == "join_overflow" else ["adapt"])


# --- a gloo process world ----------------------------------------------------


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_process_world_heals_a_fault_armed_in_every_process(tmp_path):
    """DJT_FAULT=join.join_overflow@call=1 in each process of a gloo world
    of 2: every process consults the site once a call, so both force the
    flag on their first call and heal once, and serve the rows of the
    unfaulted call."""
    chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    worker = ROOT / "tests" / "torch_world_worker.py"
    outs = chip_smoke.spawn_world(
        2, [str(worker), json.dumps({"cases": ["fault"]}), str(tmp_path)], timeout=120,
        env={"OMP_NUM_THREADS": "1", "DJT_FAULT": "join.join_overflow@call=1"}, cwd=ROOT)
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r}: {out[-2000:]}\n{err[-4000:]}"
    results = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())["fault"] for r in range(2)]
    for res in results:
        assert res["attempts"] == 2 and res["clean_attempts"] == 1
        assert res["rows"] == res["clean_rows"] and res["pinned"] == {}
        assert [e["type"] for e in res["events"]] == ["fault", "heal"]
        assert res["events"][1]["flags"] == ["join_overflow"]
    assert results[0]["flags"] == results[1]["flags"]


def test_process_world_does_not_retry_a_failure_on_one_process(tmp_path):
    """A failure that is not an injected fault, on rank 1 only, under an
    active tier (DJT_PLAN_ADAPT=1): rank 1 does not pin or retry, so its
    first attempt's error reaches the caller, and rank 0, left in the
    join's collectives, fails instead of pairing them with a retry."""
    chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    worker = ROOT / "tests" / "torch_world_worker.py"
    (rc0, _, err0), (rc1, out1, err1) = chip_smoke.spawn_world(
        2, [str(worker), json.dumps({"cases": ["peer_fails"]}), str(tmp_path)], timeout=120,
        env={"OMP_NUM_THREADS": "1", "DJT_PLAN_ADAPT": "1", "DJT_COLLECTIVE_TIMEOUT_S": "30"},
        cwd=ROOT)
    assert rc1 == 0, f"rank 1: {out1[-2000:]}\n{err1[-4000:]}"
    res = pickle.loads((tmp_path / "rank1.pkl").read_bytes())["peer_fails"]
    assert res == {"raised": "rank 1 fails on purpose", "calls": 1, "pinned": {},
                   "degrades": []}
    assert rc0 != 0 and "Traceback" in err0


# --- chip_smoke's phase 12, rehearsed on the CPU --------------------------------


def test_chip_smoke_ladder_phase_rehearses_on_cpu(cs, capsys, monkeypatch):  # noqa: F811
    """Phase 12 at 20,000 rows with the card stubbed and the kernel
    wrappers counting their plain calls (the codec's decode too), every
    check as on the card; then check_no_pins fails on a pin."""
    real = cz.expand_ranks

    def counted(*a, **k):
        texpand.ranks_launches += 1
        return real(*a, **k)

    monkeypatch.setattr(cz, "expand_ranks", counted)
    dj = _dj()
    rows = 20_000
    *_, topo, left, lcnt, right, rcnt, ref = _main_path(cs, dj, rows)
    cases = cs.run_ladder(dj, "cpu", topo, left, lcnt, right, rcnt, ref, rows, 0, "cpu")
    assert sorted(cases) == ["a_armed_never_fires", "b_join_overflow_auto", "c_pallas_merge",
                             "d_probe_expand", "e_broadcast", "f_bc_prepared_query", "g_codec"]
    assert {k: list(c["pins"]) for k, c in cases.items()} == {
        "a_armed_never_fires": [], "b_join_overflow_auto": [], "c_pallas_merge": ["merge"],
        "d_probe_expand": ["expand"], "e_broadcast": ["adapt"],
        "f_bc_prepared_query": ["prepared_tier"], "g_codec": ["wire"]}
    assert cases["c_pallas_merge"]["faulted"]["launches"]["join_scans"] == 1
    assert capsys.readouterr().out.count("[ladder]") == 7
    cs.check_no_pins("rehearsal")
    assert terrors.pinned_tiers() == {} and os.environ.get("DJT_JOIN_MERGE") is None
    terrors.pin_baseline("merge", "a kernel failed")
    with pytest.raises(AssertionError, match="pinned"):
        cs.check_no_pins("rehearsal")
    assert "tier merge pinned: a kernel failed" in capsys.readouterr().out

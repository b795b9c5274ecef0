"""dj_tpu_torch.parallel.autotune against dj_tpu.parallel.autotune.

dj_tpu's ``tests/test_autotune.py`` host cases, each run through both
packages' ``resolve`` with the same stub tuner, giving the same
decisions, ``tune`` events and ``dj_autotune_*`` counters: tune once,
the ledger replay past a torn tail, drift then demote, a latency
regression, no second tune of a signature under concurrency,
``apply_config`` and its fault site, ``dispatch_scope``'s pin priority
and the candidate axes (the merge tiers under the port's names). Then
one real tuned pipeline at a world of 2: its rows are the untuned
chain's, every candidate is priced by the byte model and two probed,
its counters after the call equal dj_tpu's (the probes count nothing),
a second call replays, and a faulted probe inside
``degrade_guard(..., tiers=("autotune",))`` pins the tier once. A pin
taken inside a tuned dispatch's env outlives it, and a prepared stage's
tune under a merge fault leaves the env and the pins agreed. Last, a
CPU rehearsal of chip_smoke's phase 13 (the byte model, truth, the skew
probe and the autotuner) at 20,000 rows.
"""

import dataclasses
import os
import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dj_tpu
from dj_tpu.parallel import autotune as jtune
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.resilience import errors as jerrors
from dj_tpu.resilience import faults as jfaults
from dj_tpu.resilience import ledger as jledger
from test_torch_smoke_prepared import _dj, _main_path, cs  # noqa: F401 - cs is a fixture
import dj_tpu_torch as tj
from dj_tpu_torch import obs as tobs
from dj_tpu_torch.parallel import autotune as ttune
from dj_tpu_torch.parallel import dist_join as tdist
from dj_tpu_torch.resilience import errors as terrors
from dj_tpu_torch.resilience import faults as tfaults
from dj_tpu_torch.resilience import ledger as tledger

DROP = ("seq", "ts")


def _pkg(jax_side: bool, obs):
    if jax_side:
        return types.SimpleNamespace(tune=jtune, ledger=jledger, obs=obs, errors=jerrors,
                                     faults=jfaults, cfg=dj_tpu.JoinConfig, p="DJ_",
                                     merge={"sort": "xla", "merge": "pallas", "probe": "probe"})
    return types.SimpleNamespace(tune=ttune, ledger=tledger, obs=tobs, errors=terrors,
                                 faults=tfaults, cfg=tj.JoinConfig, p="DJT_",
                                 merge={"sort": "sort", "merge": "merge", "probe": "probe"})


@pytest.fixture
def pkgs(obs_capture, monkeypatch):
    """(dj_tpu, port) namespaces, both obs on and clean, tuner state,
    ledgers, faults and pins cleared, reset-class knobs unset."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in tj.knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    was = tobs.enabled()
    tobs.reset(reenable=True)
    tobs.drain()
    both = (_pkg(True, obs_capture), _pkg(False, tobs))
    for p in both:
        p.tune._clear()
        p.ledger.reset()
        p.faults.reset()
        p.errors.reset_pins()
    yield both
    for p in both:
        p.tune._clear()
        p.ledger.reset()
        p.faults.reset()
        p.errors.reset_pins()
    tobs.reset(reenable=was)
    tobs.drain()
    torch.set_num_threads(threads)


def _stub(winner, probe_s=0.01, evidence=None):
    calls = []

    def tune(sig):
        calls.append(sig)
        return dict(winner), probe_s, list(evidence if evidence is not None else [dict(winner)])

    tune.calls = calls
    return tune


def _d(decision):
    return None if decision is None else dataclasses.asdict(decision)


def case_tune_once(p, mp, tmp):
    mp.setenv(p.p + "AUTOTUNE", "1")
    stub = _stub({"odf": 4})
    d1 = p.tune.resolve("sig-once", stub)
    d2 = p.tune.resolve("sig-once", stub)
    assert d2 is d1 and len(stub.calls) == 1
    return [_d(d1), p.ledger.lookup("sig-once")["autotune"]]


def case_ledger_replay_torn_tail(p, mp, tmp):
    path = tmp / f"{p.p}ledger.jsonl"
    mp.setenv(p.p + "LEDGER", str(path))
    mp.setenv(p.p + "AUTOTUNE", "1")
    first = p.tune.resolve("sig-replay", _stub({"merge": "probe"}))

    def boom(sig):
        raise AssertionError("a replay must never tune")

    p.tune._clear()
    p.ledger.reset()
    with open(path, "a") as f:
        f.write('{"sig": "half-written')
    d = p.tune.resolve("sig-replay", boom)
    assert d.source == "ledger" and p.tune.resolve("sig-replay", boom) is d
    return [_d(first), _d(d)]


def case_drift_then_demote(p, mp, tmp):
    mp.setenv(p.p + "AUTOTUNE", "1")
    mp.setenv(p.p + "AUTOTUNE_RETUNE_MAX", "1")
    stub = _stub({"odf": 2})
    out = [_d(p.tune.resolve("sig-drift", stub))]
    p.tune.note_drift(9.9, sig="sig-other")  # untuned: a no-op
    p.tune.note_drift(9.9, sig="sig-drift")
    p.tune.note_drift(12.0, sig="sig-drift")  # flagged once until consumed
    out += [p.tune.flagged("sig-other"), p.tune.flagged("sig-drift")]
    out.append(_d(p.tune.resolve("sig-drift", stub)))
    p.tune.note_drift(9.9, sig="sig-drift")
    out.append(_d(p.tune.resolve("sig-drift", stub)))  # the budget is spent: demote
    out.append(_d(p.tune.resolve("sig-drift", stub)))
    assert len(stub.calls) == 2 and out[-1]["source"] == "demote"
    return out + [p.ledger.lookup("sig-drift")["autotune"]]


def case_latency_regression(p, mp, tmp):
    mp.setenv(p.p + "AUTOTUNE", "1")
    mp.setenv(p.p + "AUTOTUNE_WINDOW", "4")
    mp.setenv(p.p + "AUTOTUNE_REGRESS", "1.5")
    p.tune.resolve("sig-lat", _stub({"odf": 2}))
    p.tune.note_latency("sig-untuned", 0.5)
    out = []
    for s in (0.01, 0.01, 0.01, 0.10):
        p.tune.note_latency("sig-lat", s)
        out.append(p.tune.flagged("sig-lat"))
    assert out[2] is None and "latency regression" in out[3]
    return out


def case_concurrency(p, mp, tmp):
    mp.setenv(p.p + "AUTOTUNE", "1")
    started, release = threading.Event(), threading.Event()
    calls, results = [], {}

    def slow(sig):
        calls.append(sig)
        started.set()
        assert release.wait(timeout=30)
        return {"odf": 4}, 0.01, [{}]

    th = threading.Thread(target=lambda: results.setdefault(
        "owner", p.tune.resolve("sig-race", slow)), daemon=True)
    th.start()
    assert started.wait(timeout=30)
    during = p.tune.resolve("sig-race", slow)  # serves the defaults, no wait
    release.set()
    th.join(timeout=30)
    assert during is None and len(calls) == 1
    return [_d(results["owner"])]


def case_apply_config_and_fault(p, mp, tmp):
    mp.setenv(p.p + "AUTOTUNE", "1")
    cfg = p.cfg(over_decom_factor=2)
    tuned = p.tune.TunedDecision(odf=4)
    out = [p.tune.apply_config(None, cfg) is cfg,
           p.tune.apply_config(tuned, cfg).over_decom_factor]
    p.faults.configure("autotune_apply@call=1")
    with pytest.raises(RuntimeError, match="fault injected: autotune_apply@call=1"):
        p.tune.apply_config(tuned, cfg)
    # The ladder routes both sites to the one tier.
    for site in ("autotune_probe", "autotune_apply"):
        p.faults.reset()
        p.faults.configure(f"{site}@call=1")
        attempts = []

        def attempt():
            attempts.append(p.tune.enabled())
            p.faults.check(site)
            return "served"

        out.append(p.errors.degrade_guard("chain", attempt, tiers=("autotune",)))
        out += [attempts, p.errors.pinned_tiers() and list(p.errors.pinned_tiers()),
                os.environ[p.p + "AUTOTUNE"]]
        p.errors.reset_pins()
    return out


def case_dispatch_scope_pins(p, mp, tmp):
    mp.setenv(p.p + "AUTOTUNE", "1")
    d = p.tune.TunedDecision(merge=p.merge["probe"], bucket_ratio=1.5, expand="hist")
    out = []
    with p.tune.dispatch_scope(d, "sig-env"):
        out.append([os.environ.get(p.p + k) for k in ("JOIN_MERGE", "SHAPE_BUCKET_RATIO",
                                                      "PROBE_EXPAND")])
    out.append([os.environ.get(p.p + k) for k in ("JOIN_MERGE", "SHAPE_BUCKET_RATIO")])
    p.errors.pin_baseline("merge", "test pin")
    with p.tune.dispatch_scope(d, "sig-env"):
        out.append(os.environ.get(p.p + "JOIN_MERGE") == p.merge["sort"])
    p.errors.reset_pins()
    return out


def case_candidate_axes(p, mp, tmp):
    cfg = p.cfg(over_decom_factor=2)
    mp.setenv(p.p + "AUTOTUNE_ODF", "1,2,4")
    mp.setenv(p.p + "AUTOTUNE_MERGE", f"{p.merge['sort']},{p.merge['probe']}")
    out = [p.tune._candidate_space(cfg, prepared=False, sig="s-a"),
           p.tune._candidate_space(cfg, prepared=True, sig="s-b")]
    p.ledger.update("s-salt", plan_adapt={"tier": "salted", "replicas": 2})
    out.append(p.tune._candidate_space(cfg, prepared=False, sig="s-salt"))
    mp.setenv(p.p + "JOIN_MERGE", "probe")
    out.append(p.tune._candidate_space(cfg, prepared=True, sig="s-c"))
    mp.setenv(p.p + "SHAPE_BUCKET", "1")
    out.append(p.tune._candidate_space(cfg, prepared=False, sig="s-d"))
    return out


CASES = {n[5:]: f for n, f in globals().items() if n.startswith("case_")}


# The port's own counter of its merged sort's form, which dj_tpu does not keep.
PORT_ONLY_COUNTERS = ("dj_join_sort_total",)


def _counters(obs) -> dict:
    return {k: v for k, v in obs.metrics_summary()["counters"].items()
            if not k.startswith(PORT_ONLY_COUNTERS)}


def _recorded(obs) -> tuple:
    events = [{k: v for k, v in e.items() if k not in DROP} for e in obs.drain()]
    return events, _counters(obs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_resolve_matches_dj_tpu(case, pkgs, monkeypatch, tmp_path):
    got = []
    for p in pkgs:
        trace = CASES[case](p, monkeypatch, tmp_path)
        got.append((trace, *_recorded(p.obs)))
    (jtrace, jevents, jcounters), (ttrace, tevents, tcounters) = got
    if case == "candidate_axes":  # the merge tiers under each package's names
        names = {"xla": "sort", "pallas": "merge"}
        jtrace = [[{k: names.get(v, v) if k == "merge" else v for k, v in c.items()}
                   for c in cands] for cands in jtrace]
    if case == "dispatch_scope_pins":
        jtrace[0][2], ttrace[0][2] = ttrace[0][2], jtrace[0][2]  # DJ_/DJT_ expansion knob
    assert ttrace == jtrace
    if case in ("apply_config_and_fault", "dispatch_scope_pins"):
        for evs in (jevents, tevents):  # the reasons and the merge baseline name
            for e in evs:               # each package's knob and tier
                e.pop("reason", None)
                if e.get("tier") == "merge":
                    e.pop("baseline")
    assert tevents == jevents
    assert tcounters == jcounters


# --- one real tuned pipeline ----------------------------------------------


def _chain_arrays():
    rng = np.random.default_rng(21)
    probe = [rng.integers(0, 800, 600).astype(np.int64), np.arange(600, dtype=np.int64)]
    build = [np.arange(0, 800, 2, dtype=np.int64), np.arange(400, dtype=np.int64)]
    return probe, build


def _port_chain(w):
    probe, build = _chain_arrays()
    topo = tj.make_topology(["cpu"] * w)
    (l, lc), (r, rc) = (tj.shard_table(topo, tj.from_arrays(*a, device="cpu"))
                        for a in (probe, build))
    b2, b2c, _ = tj.shuffle_on(topo, r, rc, [0], seed=tdist.MAIN_JOIN_SEED, out_factor=2.5)
    stages = [tj.JoinStage(right=r, right_counts=rc, left_on=(0,), right_on=(0,), mode="shuffle"),
              tj.JoinStage(right=b2, right_counts=b2c, left_on=(0,), right_on=(0,),
                           right_partitioned=True)]
    return topo, l, lc, stages


def _jax_chain(w):
    probe, build = _chain_arrays()
    topo = jmake_topology(jax.devices()[:w])
    (l, lc), (r, rc) = (jshard(topo, dj_tpu.from_arrays(*[jnp.asarray(c) for c in a]))
                        for a in (probe, build))
    b2, b2c, _ = dj_tpu.shuffle_on(topo, r, rc, [0], seed=12345678, out_factor=2.5)
    stages = [dj_tpu.JoinStage(right=r, right_counts=rc, left_on=(0,), right_on=(0,),
                               mode="shuffle"),
              dj_tpu.JoinStage(right=b2, right_counts=b2c, left_on=(0,), right_on=(0,),
                               right_partitioned=True)]
    return topo, l, lc, stages


def _rows(out, counts):
    counts = np.asarray(counts).tolist()
    cols = [np.asarray(c.data) for c in out.columns]
    cap = cols[0].shape[0] // len(counts)
    return sorted(row for r, n in enumerate(counts)
                  for row in zip(*[c[r * cap: r * cap + n].tolist() for c in cols]))


def test_a_tuned_pipeline_at_world_2(pkgs, monkeypatch):
    """Both packages run the chain untuned at odf 1 and 2 first (dj_tpu
    counts a module's collectives from the trace a dispatch captures; a
    module first traced by its pricing's lower() is never traced again,
    so its dispatches count none: ROADMAP's reference differences), then
    once tuned: the counters are equal, so the probes counted nothing."""
    topo, l, lc, stages = _port_chain(2)
    jtopo, jl, jlc, jstages = _jax_chain(2)
    rows = {}
    for odf in (2, 1):
        out, counts, _, _ = tj.distributed_join_pipeline_auto(
            topo, l, lc, stages, tj.JoinConfig(over_decom_factor=odf, join_out_factor=2.0))
        rows[odf] = _rows(out, counts)
        dj_tpu.distributed_join_pipeline_auto(
            jtopo, jl, jlc, jstages,
            dj_tpu.JoinConfig(over_decom_factor=odf, join_out_factor=2.0))
    want = rows[1]
    assert rows[2] == want
    for p in pkgs:
        p.obs.reset(reenable=True)
        p.obs.drain()
        monkeypatch.setenv(p.p + "AUTOTUNE", "1")
        monkeypatch.setenv(p.p + "AUTOTUNE_ODF", "1,2")
    # Each probe runs, and reports a set time (odf 2 the faster) so both
    # packages pick one winner.
    probes = []
    for mod in (jdist, tdist):
        def timed(*a, _real=mod.price_plan_candidate, **k):
            price, probe = _real(*a, **k)
            odf = a[7].over_decom_factor
            return price, lambda: (probes.append(odf), probe(), {1: 0.02, 2: 0.01}[odf])[2]

        monkeypatch.setattr(mod, "price_plan_candidate", timed)
    cfg = tj.JoinConfig(join_out_factor=2.0)
    out, counts, _, cfgs = tj.distributed_join_pipeline_auto(topo, l, lc, stages, cfg)
    assert _rows(out, counts) == want
    (tune,) = tobs.events("tune")
    assert tune["action"] == "tune" and tune["candidates"] == 2 and probes == [1, 2]
    assert tune["odf"] == 2 and {c.over_decom_factor for c in cfgs} == {2}
    ((sig, tuned),) = ttune.tunez_summary()["signatures"].items()
    evidence = tuned["candidates"]
    assert tledger.lookup(sig)["autotune"]["candidates"] == evidence
    assert [c.get("odf") for c in evidence] == [None, 2]
    assert all(c["bytes_accessed"] > 0 and c["probe_s"] > 0 and c["flops"] is None
               for c in evidence)
    dj_tpu.distributed_join_pipeline_auto(jtopo, jl, jlc, jstages,
                                          dj_tpu.JoinConfig(join_out_factor=2.0))
    jcounters, tcounters = (_counters(p.obs) for p in pkgs)
    jcounters = {k: v for k, v in jcounters.items()
                 if not k.startswith(("dj_build_cache_total", "dj_compile_seconds_total",
                                      "dj_collective_epochs_traced_total"))}
    assert tcounters["dj_collective_launches_total"] > 0 and len(probes) == 4
    assert tcounters == jcounters
    # The second call replays: no tune, no probe.
    tj.distributed_join_pipeline_auto(topo, l, lc, stages, cfg)
    assert len(probes) == 4 and len(tobs.events("tune")) == 1
    # A faulted probe under the caller's guard pins the tier once; the
    # retry serves the defaults with the same rows.
    ttune._clear()
    tledger.reset()
    tobs.drain()
    tfaults.configure("autotune_probe@call=1")
    out, counts, _, _ = terrors.degrade_guard(
        "chain", lambda: tj.distributed_join_pipeline_auto(topo, l, lc, stages, cfg),
        tiers=("autotune",))
    assert _rows(out, counts) == want
    assert [e["tier"] for e in tobs.events("degrade")] == ["autotune"]
    assert terrors.pinned_tiers().keys() == {"autotune"} and not ttune.enabled()
    assert tobs.counter_value("dj_degrade_total", tier="autotune") == 1


def test_a_pin_taken_inside_a_tuned_scope_outlives_it(pkgs, monkeypatch):
    """A ladder pin of the merge tier taken while a tuned dispatch's
    scope overrides DJT_JOIN_MERGE keeps the baseline after the scope,
    a later scope leaves the pinned knob alone, and reset_pins restores
    the operator's value, not the tuned one."""
    monkeypatch.setenv("DJT_JOIN_MERGE", "probe")
    decision = ttune.TunedDecision(merge="merge")
    with ttune.dispatch_scope(decision):
        assert os.environ["DJT_JOIN_MERGE"] == "merge"
        terrors.pin_baseline("merge", "a fault in the tuned dispatch")
    assert os.environ["DJT_JOIN_MERGE"] == "sort" and terrors.pinned_tiers().keys() == {"merge"}
    with ttune.dispatch_scope(decision):
        assert os.environ["DJT_JOIN_MERGE"] == "sort"
    terrors.reset_pins()
    assert os.environ["DJT_JOIN_MERGE"] == "probe" and terrors.pinned_tiers() == {}


def test_a_prepared_stage_tune_under_a_merge_fault(pkgs, monkeypatch):
    """A chain whose stage 0 is prepared tunes the merge tier (sort, and
    merge reported the faster) under DJT_FAULT=pallas_merge@call=1. The
    probes consult no site of the ladder, so the fault fires in the
    chain's own query, which pins merge and serves the rows on sort;
    afterwards the env and pinned_tiers() agree, and reset_pins() leaves
    both clean."""
    probe, build = _chain_arrays()
    topo = tj.make_topology(["cpu"] * 2)
    (l, lc), (r, rc) = (tj.shard_table(topo, tj.from_arrays(*a, device="cpu"))
                        for a in (probe, build))
    cfg = tj.JoinConfig(join_out_factor=2.0, key_range=(0, 799))
    prep = tj.prepare_join_side(topo, r, rc, [0], cfg, left_capacity=l.capacity)
    stages = [tj.JoinStage(right=prep, left_on=(0,))]
    out, counts, _, _ = tj.distributed_join_pipeline_auto(topo, l, lc, stages, cfg)
    want = _rows(out, counts)
    monkeypatch.setenv("DJT_AUTOTUNE", "1")
    monkeypatch.setenv("DJT_AUTOTUNE_MERGE", "sort,merge")
    real = tdist.price_plan_candidate

    def timed(*a, **k):
        price, run = real(*a, **k)
        merge = os.environ.get("DJT_JOIN_MERGE", "sort")
        return price, lambda: (run(), {"sort": 0.02, "merge": 0.01}[merge])[1]

    monkeypatch.setattr(tdist, "price_plan_candidate", timed)
    tfaults.configure("pallas_merge@call=1")
    out, counts, _, _ = terrors.degrade_guard(
        "chain", lambda: tj.distributed_join_pipeline_auto(topo, l, lc, stages, cfg),
        tiers=("autotune",))
    assert _rows(out, counts) == want
    (tune,) = tobs.events("tune")
    assert tune["merge"] == "merge" and tune["candidates"] == 2
    assert tfaults.call_count("pallas_merge") == 1
    assert [e["tier"] for e in tobs.events("degrade")] == ["merge"]
    assert terrors.pinned_tiers().keys() == {"merge"} and os.environ["DJT_JOIN_MERGE"] == "sort"
    terrors.reset_pins()
    assert terrors.pinned_tiers() == {} and "DJT_JOIN_MERGE" not in os.environ


# --- chip_smoke's phase 13, rehearsed on the CPU ----------------------------


class _AllocatorDevice:
    """A CUDA device's stand-in for obs.truth on the CPU, reading the
    (stubbed) allocator as the real one does."""

    id = 0

    def memory_stats(self):
        used = torch.cuda.memory_allocated(0)
        return {"bytes_in_use": used, "peak_bytes_in_use": used, "bytes_limit": 80 * 2**30}


def test_chip_smoke_measurement_phase_rehearses_on_cpu(cs, capsys, monkeypatch):  # noqa: F811
    """Phase 13 (a)-(d) at 20,000 rows with the card stubbed: every check
    of the phase holds and each sub-phase logs its line."""
    from dj_tpu_torch.obs import truth

    monkeypatch.setattr(truth, "_device_list", lambda: [_AllocatorDevice()])
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (0, 80 * 2**30))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=80 * 2**30))
    dj = _dj()
    rows = 20_000
    _, build, probe, expected, topo, left, lcnt, right, rcnt, ref = _main_path(cs, dj, rows)
    dev = torch.device("cpu")
    cs.run_byte_model(dj, dev, topo, left, lcnt, right, rcnt, rows, expected, "cpu")
    cs.run_truth(dev, "cpu")
    skew = cs.run_skew(dj, dev, build, probe, rows, "cpu")
    table = cs.run_autotune(dj, dev, build, probe, expected, ref, rows, "cpu")
    assert skew["skewed_odf1"]["passes"] == skew["skewed_odf1"]["queries"]
    assert set(table) == {"autotune_chain_tuning", "autotune_probes", "autotune_chain_replay"}
    assert all(c["join_scans"] >= 1 for c in table["autotune_probes"].values())
    logged = capsys.readouterr().out
    for tag in ('"smoke_phase": "13a"', '"smoke_phase": "13b"', '"smoke_phase": "13c"',
                '"smoke_phase": "13d"'):
        assert tag in logged
    assert not terrors.pinned_tiers()

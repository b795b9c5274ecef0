"""dj_tpu_torch.obs (metrics, flight recorder, roofline phases) and
utils.timing, against dj_tpu's.

Registry and ring semantics mirror dj_tpu's ``tests/test_obs.py``:
counters, gauges and histograms with their Prometheus text and JSON
summary; a strict no-op while disabled; the bounded ring and ``drain``;
the JSONL sink; ``PhaseTimer``'s counts and means; ``profile()`` writing
a trace directory with the join's phase ranges on the CPU.

Parity: the same small calls through both packages, dj_tpu's under the
``obs_capture`` fixture of ``tests/conftest.py`` and the port's under
``port_obs``, give the same event types, non-timing fields and counter
values, apart from what only exists in JAX (``JAX_ONLY``, pinned by its
own test): a one-doubling ``_auto`` heal, a ledger hit, a compression
select, a ``plan_adapt`` decision, a prepared tier with a re-prepare, a
two-stage pipeline, a shape-bucket pad, each warmup and ``shuffle_on``,
at worlds of 1 and 4 (dj_tpu on as many devices of the CPU mesh).
"""

import json
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.parallel import pipeline as jpipe
from dj_tpu.parallel import shape_bucket as jsb
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.resilience import ledger as jledger
import dj_tpu_torch as tj
from dj_tpu_torch import obs as tobs
from dj_tpu_torch.parallel import pipeline as tpipe
from dj_tpu_torch.parallel import shape_bucket as tsb
from dj_tpu_torch.resilience import ledger as tledger

# What dj_tpu records and the port cannot: the trace-time accounting of a
# compiled module (its build-cache counters and gauge, the compile
# seconds, the retrace and collective_epoch events, the traced-epoch
# counter) and the roofline's build phase. The parity skips exactly these.
JAX_ONLY = frozenset({
    "event:retrace",
    "event:collective_epoch",
    "phase:build",
    "counter:dj_build_cache_total",
    "counter:dj_compile_seconds_total",
    "counter:dj_collective_epochs_traced_total",
    "gauge:dj_build_cache_entries",
})
# What dj_tpu records that a later slice of the port brings: nothing now
# (the per-link wire matrix came with ROADMAP item 10c).
LATER = frozenset()
# What the port records and dj_tpu does not: the merged sort's form, counted
# once a local join (dj_tpu picks its sort inside a traced module).
PORT_ONLY = frozenset({"counter:dj_join_sort_total"})
# Fields that hold a time, or a fraction of one.
TIMING_FIELDS = frozenset({"seq", "ts", "seconds", "roofline_frac"})


@pytest.fixture
def port_obs(monkeypatch):
    """The port's obs enabled with a clean registry, ring, timelines and
    ledger, on one torch thread; restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in tj.knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    was = tobs.enabled()
    tobs.reset(reenable=True)
    tobs.drain()
    tledger.reset()
    yield tobs
    tledger.reset()
    tobs.reset(reenable=was)
    tobs.drain()
    torch.set_num_threads(threads)


# --- registry and ring -----------------------------------------------------


def test_registry_counters_gauges_histograms(port_obs):
    obs = port_obs
    obs.inc("t_heal_total", flag="join_overflow")
    obs.inc("t_heal_total", 2, flag="join_overflow")
    obs.inc("t_heal_total", flag="char_overflow")
    obs.set_gauge("t_ring_size", 7)
    obs.observe("t_seconds", 0.02)
    obs.observe("t_seconds", 999.0)  # past the last bound: +Inf
    assert obs.counter_value("t_heal_total", flag="join_overflow") == 3
    assert obs.counter_value("t_heal_total") == 4
    assert obs.gauge_value("t_ring_size") == 7
    text = obs.metrics_text()
    for line in ("# TYPE t_heal_total counter", 't_heal_total{flag="join_overflow"} 3',
                 "# TYPE t_ring_size gauge", "# TYPE t_seconds histogram",
                 't_seconds_bucket{le="+Inf"} 2', "t_seconds_count 2"):
        assert line in text
    summ = obs.metrics_summary()
    json.dumps(summ)
    assert summ["counters"]['t_heal_total{flag="join_overflow"}'] == 3
    assert summ["histograms"]["t_seconds"]["count"] == 2
    assert obs.histogram_quantile("t_seconds", 0.5) == pytest.approx(0.025)
    obs.clear_prefix("t_heal")
    assert obs.counter_value("t_heal_total") == 0 and obs.gauge_value("t_ring_size") == 7


def test_disabled_is_strict_noop(port_obs):
    obs = port_obs
    obs.reset(reenable=False)
    obs.inc("t_never")
    obs.set_gauge("t_never_g", 1)
    obs.observe("t_never_h", 1.0)
    assert obs.record("t_event") is None
    with obs.roofline.phase("dispatch", model_bytes=1e6):
        pass
    assert obs.roofline.observe_phase("sync", 0.5) is None
    assert obs.counter_value("t_never") == 0
    assert obs.metrics_summary() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert obs.drain() == [] and obs.roofline.phase_totals() == {}


def test_ring_bounded_and_drain_clears(port_obs):
    obs = port_obs
    cap = obs.ring_capacity()
    assert cap == 1024
    for i in range(cap + 50):
        obs.record("t_spam", i=i)
    evs = obs.events("t_spam")
    assert len(evs) == cap and evs[-1]["i"] == cap + 49 and evs[0]["i"] == 50
    seqs = [e["seq"] for e in evs]
    assert seqs == sorted(seqs)
    assert len(obs.drain()) == cap and obs.drain() == []


def test_jsonl_sink(tmp_path, port_obs):
    obs = port_obs
    path = tmp_path / "events.jsonl"
    obs.set_log_path(str(path))
    try:
        obs.record("t_sink", a=1, rng=((0, 5),), t=torch.tensor(3))
        obs.record("t_sink", a=2)
    finally:
        obs.set_log_path(None)
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 2
    first = json.loads(lines[0])
    assert first["type"] == "t_sink" and first["a"] == 1 and first["t"] == 3
    assert first["rng"] == [[0, 5]]
    assert {"seq", "ts", "type"} <= set(first)
    snap = obs.write_snapshot(str(tmp_path / "snap.json"))
    assert [e["a"] for e in snap["events"]] == [1, 2] and obs.drain() == []


def test_phase_timer_counts_and_means():
    timer = tj.PhaseTimer()
    for _ in range(4):
        with timer.phase("join", block=lambda: torch.zeros(3)):
            pass
    with timer.phase("concat"):
        pass
    assert timer.elapsed_ms("join") >= 0.0 and timer.call_count("join") == 4
    s = timer.summary()
    assert s["join"]["count"] == 4 and s["concat"]["count"] == 1
    assert s["join"]["mean_ms"] == pytest.approx(s["join"]["total_ms"] / 4)


def test_phase_timer_prints_the_reference_format(capsys):
    timer = tj.PhaseTimer(report=True, rank=3)
    with timer.phase("Hash partition"):
        pass
    assert capsys.readouterr().out.startswith("Rank 3: Hash partition takes ")


def test_query_timer_and_roofline_summary(port_obs):
    obs = port_obs
    timer = obs.roofline.query_timer()
    with timer.phase("run"):
        pass
    frac = obs.roofline.observe_phase("dispatch", 0.002, model_bytes=0.9e9, kind="wire")
    assert frac == pytest.approx(0.9e9 / (0.002 * 450e9))
    assert obs.roofline.hbm_peak_gbps() == 3350.0
    s = obs.roofline.summary()
    assert s["run"]["count"] == 1 and s["dispatch"]["frac_p50"] is not None
    assert [e["phase"] for e in obs.events("phase")] == ["run", "dispatch"]
    obs.reset()
    assert obs.roofline.phase_totals() == {}


def test_profile_writes_a_trace_with_the_join_phases(tmp_path, port_obs):
    """profile() writes a chrome trace on the CPU, and the ranks of a
    4-rank world show their phases (Communicator.phase) as ranges."""
    w, (left, lc), (right, rc) = _port_tables(4, *_join_arrays(0))
    with tj.profile(str(tmp_path / "trace")) as prof:
        tj.distributed_inner_join(w, left, lc, right, rc, [0], [0])
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"dj_partition", "dj_exchange", "dj_join", "dj_concat", "a2a_exchange"} <= names
    assert sum(e.name == "dj_join" for e in prof.events()) == 4
    with tj.profile(None) as nothing:
        assert nothing is None


def test_annotate_is_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tj.annotate("t_range"):
            torch.ones(4).sum()
    assert any(e.name == "t_range" for e in prof.events())


def test_annotate_opens_no_profiler_op_without_a_profiler(monkeypatch):
    """With no profiler running, a range opens no record_function op;
    under one it does, on every thread of the process."""
    import threading

    opened = []
    orig = torch.profiler.record_function

    def counted(name, *a, **k):
        opened.append(name)
        return orig(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with tj.annotate("t_off"):
        pass
    assert opened == []
    def on_a_thread():
        with tj.annotate("t_thread"):
            pass

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t = threading.Thread(target=on_a_thread)
        t.start()
        t.join()
        with tj.annotate("t_on"):
            pass
    assert opened == ["t_thread", "t_on"]


class _FakeEvent:
    """A CUDA event's stand-in on the CPU: it has completed while
    ``done`` is set, and times by the host clock."""

    done = True

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return _FakeEvent.done

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_device_phases_stay_bounded_and_reach_the_registry(port_obs, monkeypatch):
    """A process that keeps obs on, with device phases (CUDA events): the
    next phase's start resolves the completed ones without waiting, each
    stamped with the query it ran in; the registry's readers resolve the
    rest; past PENDING_MAX the oldest is dropped and counted."""
    obs, rf = port_obs, port_obs.roofline
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    for i in range(50):
        with obs.query_ctx(f"q{i}"):
            with rf.phase("dispatch", device="cuda:0", model_bytes=1e3, kind="wire"):
                pass
        assert rf.pending_count() == 1
    assert 'dj_phase_seconds_count{phase="dispatch"} 50' in obs.metrics_text()
    assert rf.pending_count() == 0
    hists = obs.metrics_summary()["histograms"]
    assert hists['dj_phase_seconds{phase="dispatch"}']["count"] == 50
    assert hists['dj_roofline_frac{kind="wire",phase="dispatch"}']["count"] == 50
    assert [e["query_id"] for e in obs.events("phase")] == [f"q{i}" for i in range(50)]

    monkeypatch.setattr(_FakeEvent, "done", False)
    monkeypatch.setattr(rf, "PENDING_MAX", 8)
    for _ in range(20):
        with rf.phase("prep", device="cuda:0"):
            pass
    assert rf.pending_count() == 8
    assert obs.counter_value("dj_phase_dropped_total", phase="prep") == 12
    assert obs.histogram_raw("dj_phase_seconds", phase="prep")[3] == 8
    assert rf.pending_count() == 0


# --- parity with dj_tpu -----------------------------------------------------


def _join_arrays(seed, n=400, m=300, lo=0):
    rng = np.random.default_rng(seed)
    left = [rng.integers(0, m, n).astype(np.int64), np.arange(n, dtype=np.int64)]
    right = [np.arange(lo, m, dtype=np.int64), np.arange(m - lo, dtype=np.int64) * 7]
    return left, right


def _jax_tables(w, *arrays):
    topo = jmake_topology(jax.devices()[:w])
    return topo, *(jshard(topo, dj_tpu.from_arrays(*[jnp.asarray(a) for a in cols]))
                   for cols in arrays)


def _port_tables(w, *arrays):
    topo = tj.make_topology(["cpu"] * w)
    return topo, *(tj.shard_table(topo, tj.from_arrays(*cols, device="cpu")) for cols in arrays)


class Side:
    """One package's calls: ``dj`` its namespace, ``tables`` its sharded
    tables, ``cfg`` its JoinConfig."""

    def __init__(self, jax_side: bool, monkeypatch):
        self.jax = jax_side
        self.dj = dj_tpu if jax_side else tj
        self.tables = _jax_tables if jax_side else _port_tables
        self.mp = monkeypatch
        self.prefix = "DJ_" if jax_side else "DJT_"

    def cfg(self, **kw):
        return self.dj.JoinConfig(**kw)

    def knob(self, name, value):
        self.mp.setenv(self.prefix + name, str(value))

    def stage(self, right, rc, left_on, right_on):
        mod = jpipe if self.jax else tpipe
        return mod.JoinStage(right=right, right_counts=rc, left_on=left_on, right_on=right_on)


def case_auto_heal(s, w):
    topo, (l, lc), (r, rc) = s.tables(w, *_join_arrays(1))
    s.dj.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], s.cfg(join_out_factor=0.4))


def case_ledger_hit(s, w):
    topo, (l, lc), (r, rc) = s.tables(w, *_join_arrays(1))
    for _ in range(2):
        s.dj.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], s.cfg(join_out_factor=0.4))


def case_compress_select(s, w):
    rng = np.random.default_rng(3)
    n = 4096
    table = s.dj.from_arrays(
        *[np.sort(rng.integers(0, 1000, n)).astype(np.int64),  # compressible
          rng.integers(-(2**62), 2**62, n).astype(np.int64),  # incompressible
          rng.random(n)],  # float: rides raw
        **({} if s.jax else {"device": "cpu"}))
    s.dj.generate_auto_select_compression_options(table)


def case_plan_adapt(s, w):
    s.knob("PLAN_ADAPT", 1)
    topo, (l, lc), (r, rc) = s.tables(w, *_join_arrays(5))
    s.dj.distributed_inner_join(topo, l, lc, r, rc, [0], [0], s.cfg())  # broadcast by fit
    s.dj.distributed_inner_join(topo, l, lc, r, rc, [0], [0], s.cfg())  # replayed
    s.knob("BROADCAST_BYTES", 0)
    topo, (l, lc), (r, rc) = s.tables(w, *_join_arrays(6))
    s.dj.distributed_inner_join(topo, l, lc, r, rc, [0], [0], s.cfg())  # decided by the probe


def case_prepared_reprepare(s, w):
    s.knob("PREPARED_TIER", "auto")
    topo, (l, lc), (r, rc) = s.tables(w, *_join_arrays(7, lo=100))
    prep = s.dj.prepare_join_side(topo, r, rc, [0], s.cfg())
    # Probe keys below the build side's probed minimum: the query's
    # prepared_plan_mismatch flag re-prepares on the side's tier.
    s.dj.distributed_inner_join_auto(topo, l, lc, prep, None, [0], None, s.cfg())


def case_pipeline(s, w):
    left, right = _join_arrays(8)
    dim = [np.arange(0, 400, dtype=np.int64), np.arange(400, dtype=np.int64) * 3]
    topo, (l, lc), (r, rc), (d, dc) = s.tables(w, left, right, dim)
    stages = [s.stage(r, rc, [0], [0]), s.stage(d, dc, [1], [0])]
    s.dj.distributed_join_pipeline(topo, l, lc, stages, s.cfg(join_out_factor=2.0))


def case_shape_bucket(s, w):
    s.knob("SHAPE_BUCKET", 1)
    s.knob("SHAPE_BUCKET_MIN", 64)
    topo, (t, tc) = s.tables(w, [np.arange(300, dtype=np.int64)])
    sb = jsb if s.jax else tsb
    sb.bucket_table(topo, t)
    sb.bucket_table(topo, t)  # the memo
    topo, (t, tc) = s.tables(w, [np.arange(64 * w, dtype=np.int64)])
    sb.bucket_table(topo, t)  # on the grid


def case_warmups(s, w):
    topo, (l, lc), (r, rc) = s.tables(w, *_join_arrays(9))
    s.dj.warmup_all_to_all(topo, nbytes=4096)
    s.dj.warmup_compression(8, 256, **({} if s.jax else {"device": "cpu"}))
    prep = s.dj.prepare_join_side(topo, r, rc, [0], s.cfg())
    s.dj.warmup_prepared_join(topo, prep, l, lc, [0])


def case_shuffle_on(s, w):
    topo, (t, tc) = s.tables(w, _join_arrays(10)[0])
    s.dj.shuffle_on(topo, t, tc, [0])


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}
# One world where the world does not change what is recorded.
ONE_WORLD = {"compress_select"}


def _recorded(obs) -> dict:
    """The events, counters, gauges and histogram counts recorded so far,
    without what only JAX has and without times."""
    events = []
    for e in obs.drain():
        if f"event:{e['type']}" in JAX_ONLY:
            continue
        if e["type"] == "phase" and f"phase:{e['phase']}" in JAX_ONLY:
            continue
        e = {k: v for k, v in e.items() if k not in TIMING_FIELDS}
        if "detail" in e:
            # The port's PreparedPlanMismatch messages write "; " where
            # dj_tpu's write an em dash (ROADMAP 3, reference differences).
            e["detail"] = e["detail"].replace(" \u2014 ", "; ")
        events.append(e)
    summ = obs.metrics_summary()

    def keep(kind, series):
        if 'phase="build"' in series:
            return False  # the histograms of the build phase
        return f"{kind}:{series.split('{')[0]}" not in JAX_ONLY | LATER | PORT_ONLY

    return {
        "events": events,
        "counters": {k: v for k, v in summ["counters"].items() if keep("counter", k)},
        "gauges": {k: v for k, v in summ["gauges"].items() if keep("gauge", k)},
        "histogram_counts": {k: v["count"] for k, v in summ["histograms"].items()
                             if keep("histogram", k)},
    }


def _run_jax(case, w, monkeypatch, obs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with obs.query_ctx(f"q-{case}", "parity"):
            CASES[case](Side(True, monkeypatch), w)
    return _recorded(obs)


def _run_port(case, w, monkeypatch, obs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with obs.query_ctx(f"q-{case}", "parity"):
            CASES[case](Side(False, monkeypatch), w)
    return _recorded(obs)


@pytest.mark.parametrize("case, w", [(c, w) for c in sorted(CASES) for w in (1, 4)
                                     if w == 1 or c not in ONE_WORLD])
def test_events_and_counters_match_dj_tpu(case, w, obs_capture, port_obs, monkeypatch):
    jwant = _run_jax(case, w, monkeypatch, obs_capture)
    jledger.reset()
    got = _run_port(case, w, monkeypatch, port_obs)
    assert got["events"] or got["counters"], case
    assert [e["type"] for e in got["events"]] == [e["type"] for e in jwant["events"]]
    assert got["events"] == jwant["events"]
    assert got["counters"] == jwant["counters"]
    assert got["gauges"] == jwant["gauges"]
    assert got["histogram_counts"] == jwant["histogram_counts"]


def test_the_jax_only_set_is_pinned():
    """What the parity skips: dj_tpu's trace-time compile accounting and
    its build phase, nothing else."""
    assert JAX_ONLY == {
        "event:retrace", "event:collective_epoch", "phase:build",
        "counter:dj_build_cache_total", "counter:dj_compile_seconds_total",
        "counter:dj_collective_epochs_traced_total", "gauge:dj_build_cache_entries",
    }
    assert LATER == frozenset()
    assert PORT_ONLY == {"counter:dj_join_sort_total"}
    assert TIMING_FIELDS == {"seq", "ts", "seconds", "roofline_frac"}
    # The port records none of them.
    assert not hasattr(tobs, "cached_build") and not hasattr(tobs, "record_epoch")


def test_query_counters_count_once_per_query_in_a_thread_world(port_obs):
    """A 4-rank world of threads counts each exchange epoch once (on
    rank 0) and each query once, and the ranks' events carry the
    caller's query."""
    obs = port_obs
    topo, (l, lc), (r, rc) = _port_tables(4, *_join_arrays(11))
    calls = []
    orig = tj.Communicator.exchange_start

    def counted(self, buffers):
        calls.append(self.world_rank())
        return orig(self, buffers)

    tj.Communicator.exchange_start = counted
    try:
        with obs.query_ctx("q-world", "t"):
            tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0], tj.JoinConfig(over_decom_factor=2))
    finally:
        tj.Communicator.exchange_start = orig
    assert sorted(calls) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert obs.counter_value("dj_join_queries_total", path="unprepared") == 1
    assert obs.counter_value("dj_collective_launches_total") == 2 * 2  # two epochs, two dtypes
    (coll,) = obs.events("collectives")
    assert coll["epochs"] == 2 and coll["query_id"] == "q-world"
    assert obs.counter_value("dj_tenant_wire_bytes_total", tenant="t") == coll["total_bytes"]


def test_obs_off_adds_no_call_to_the_join(port_obs, monkeypatch):
    """With obs disabled the join path touches neither the registry nor
    the ring, and reads no clock of the roofline."""
    obs = port_obs
    obs.reset(reenable=False)
    from dj_tpu_torch.obs import metrics, recorder, roofline

    touched = []
    for mod, name in ((metrics, "_key"), (recorder, "_jsonable"), (roofline, "observe_phase")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: (touched.append(_n),
                                                                            _o(*a, **k))[1])
    topo, (l, lc), (r, rc) = _port_tables(4, *_join_arrays(12))
    tj.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], tj.JoinConfig(join_out_factor=0.4))
    assert touched == [] and obs.drain() == [] and obs.roofline.pending_count() == 0


def test_bootstrap_retries_match_dj_tpu(obs_capture, port_obs):
    """retry_backoff's backoff events and dj_init_retry_total, two
    failures then a success, in both packages."""
    from dj_tpu.parallel import bootstrap as jboot
    from dj_tpu_torch.parallel import bootstrap as tboot

    got = []
    for boot, obs in ((jboot, obs_capture), (tboot, port_obs)):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("not listening yet")
            return "up"

        assert boot.retry_backoff(flaky, "init", attempts=4, base_delay_s=0.5,
                                  sleep=lambda s: None) == "up"
        got.append(_recorded(obs))
    assert [e["delay_s"] for e in got[1]["events"]] == [0.5, 1.0]
    assert got[1] == got[0]


def test_obs_exports_what_dj_tpu_exports():
    """The port's obs exports dj_tpu's names, but those left out (no
    jit to hook); no later slice owes one."""
    import dj_tpu.obs as jobs

    left_out = {"cached_build", "capture_epochs", "record_epoch", "epoch_total_bytes"}
    later = set()
    assert set(jobs.__all__) - set(tobs.__all__) == left_out | later
    assert all(hasattr(tobs, n) for n in tobs.__all__)
    for name in ("hbm_model_bytes", "prepared_side_bytes", "fleet_snapshot", "truth"):
        assert name in tobs.__all__, name


@pytest.mark.parametrize("w", [1, 4])
def test_obs_on_adds_no_host_read_to_the_join(w, port_obs, monkeypatch):
    """The CPU's stand-in for the card's sync count (chip_smoke 11a):
    the host reads of tensors (item, tolist, bool, int, float, cpu,
    numpy) a join makes are the same with obs off and on."""
    counts = {}
    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _o=orig, _n=name, **k):
            counts[_n] = counts.get(_n, 0) + 1
            return _o(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)

    def reads(enabled):
        # Fresh tables each time: the range probe's reads count too.
        topo, (l, lc), (r, rc) = _port_tables(w, *_join_arrays(13))
        port_obs.reset(reenable=enabled)
        counts.clear()
        with port_obs.query_ctx("q-reads"):
            tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0])
        return dict(counts)

    off, on = reads(False), reads(True)
    assert on == off and sum(off.values()) > 0

"""The soak's main walk against dj_tpu's, and what the walk holds.

- A slice of the walk with four specs (a flag site, a prepared-tier
  site, an autotune site and a fleet site) through the port's
  ``main_walk`` at dj_tpu's 2048 rows on 8 CPU ranks, and through
  dj_tpu's ``scripts/chaos_soak.py`` ``main`` on its 8-device CPU mesh
  (once a module): per spec, equal terminal labels, pinned tiers, heal
  and re-prepare counts. dj_tpu's side runs with its HLO audit muted:
  its strict audit reads jax 0.9's HLO text wrongly, as the four HLO
  guards that fail on this image do.
- The collective and launch bounds that replace dj_tpu's HLO audit
  (``_collective_audits``), and that they catch a query breaking one.
- The full observatory armed against off (dj_tpu's
  ``tests/test_fleet_obs.py:645``): the black box armed, the anomaly
  window fed, the endpoint up and a query context open, one join's
  kernel calls and collectives equal.
- A SIGTERM while the main thread holds each of the obs locks the
  black box's dump reads: the process dies by the signal with its
  bundle, the section behind the held lock marked incomplete.
"""

import contextlib
import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import dj_tpu_torch as tj
from dj_tpu_torch import obs
from dj_tpu_torch.scripts import blackbox_read, chaos_soak

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLICE = ("join.join_overflow@call=1", "bc_prepared_query@call=1", "autotune_apply@call=1",
         "fleet.publish@call=1")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean():
    from dj_tpu_torch import cache, fleet, serve
    from dj_tpu_torch.parallel import autotune
    from dj_tpu_torch.resilience import errors, faults, ledger

    def reset():
        faults.reset()
        errors.reset_pins()
        ledger.reset()
        serve.reset()
        cache.reset()
        fleet.reset()
        autotune._clear()
        obs.reset(reenable=False)
        obs.drain()

    reset()
    yield
    reset()


def _jax_slice(specs) -> tuple:
    """dj_tpu's walk over ``specs``: its summary line, and per spec its
    terminal labels, the tiers it pinned, its heals and re-prepares."""
    import contextlib
    import io

    import dj_tpu.obs as jobs
    import dj_tpu.serve as jserve
    from dj_tpu.analysis import contracts
    from dj_tpu.resilience import faults as jfaults

    spec = importlib.util.spec_from_file_location("jax_chaos_soak",
                                                  ROOT / "scripts" / "chaos_soak.py")
    walk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(walk)
    walk.FAULT_WALK = tuple(specs)
    iters: list = []

    def snap():
        return ({dict(k).get("tier"): v
                 for k, v in jobs.counter_series("dj_degrade_total").items()},
                jobs.counter_value("dj_heal_total"), jobs.counter_value("dj_reprepare_total"))

    configure, audit, sched_cls = jfaults.configure, contracts.runtime_audit, jserve.QueryScheduler

    def configured(s):
        # The walk configures each spec once, at the top of its iteration.
        iters.append({"spec": s, "snap": snap(), "tickets": []})
        return configure(s)

    class Recorded(sched_cls):
        def submit(self, *a, **k):
            try:
                t = super().submit(*a, **k)
            except Exception as e:
                iters[-1]["tickets"].append(type(e).__name__)
                raise
            iters[-1]["tickets"].append(t)
            return t

        def submit_pipeline(self, *a, **k):
            t = super().submit_pipeline(*a, **k)
            iters[-1]["tickets"].append(t)
            return t

    env = {k: os.environ.get(k) for k in ("DJ_OBS_SKEW", "DJ_PLAN_ADAPT", "DJ_BROADCAST_BYTES",
                                          "DJ_SALT_RATIO", "DJ_HLO_AUDIT", "DJ_JOIN_MERGE",
                                          "DJ_OBS_TRUTH", "DJ_SERVE_MEASURED_HBM",
                                          "DJ_PREPARED_TIER", "DJ_AUTOTUNE", "DJ_FLEET_DIR")}
    jfaults.configure, contracts.runtime_audit = configured, lambda *a, **k: None
    jserve.QueryScheduler = Recorded
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            walk.main()
        end = snap()
    finally:
        jfaults.configure, contracts.runtime_audit = configure, audit
        jserve.QueryScheduler = sched_cls
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = []
    for i, it in enumerate(iters):
        (d0, h0, r0), (d1, h1, r1) = it["snap"], (iters[i + 1]["snap"] if i + 1 < len(iters)
                                                   else end)
        labels: dict = {}
        for t in it["tickets"]:
            lab = t if isinstance(t, str) else ("result" if t.error is None
                                                else type(t.error).__name__)
            labels[lab] = labels.get(lab, 0) + 1
        out.append({"spec": it["spec"], "outcomes": dict(sorted(labels.items())),
                    "pins": {k: int(v - d0.get(k, 0)) for k, v in d1.items()
                             if v - d0.get(k, 0)},
                    "heals": int(h1 - h0), "reprepares": int(r1 - r0)})
    return json.loads(printed.getvalue().splitlines()[-1]), out


@contextlib.contextmanager
def steady_tuner():
    """The tuner's choices independent of the machine's load: every probe
    dispatch times 0 s (``dist_join``'s clock, in both packages: the
    tuner keeps the cheaper-priced of its two probed candidates), and no
    result's latency calls for a retune. Each signature's candidates are
    its default and one alternative, the same in both packages: over
    decomposition 2 for an unprepared join, the sort merge for a
    prepared one (dj_tpu prices every candidate by compiling it)."""
    from dj_tpu.parallel import dist_join as jdj
    from dj_tpu_torch.parallel import dist_join as tdj

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jdj, tdj):
            mp.setattr(mod, "time", types.SimpleNamespace(perf_counter=lambda: 0.0))
        for prefix, sort in (("DJ", "xla"), ("DJT", "sort")):
            mp.setenv(f"{prefix}_AUTOTUNE_REGRESS", "1e9")
            mp.setenv(f"{prefix}_AUTOTUNE_ODF", "2")
            mp.setenv(f"{prefix}_AUTOTUNE_MERGE", sort)
            mp.setenv(f"{prefix}_AUTOTUNE_EXPAND", "segment")
        yield


@pytest.fixture(scope="module")
def jax_slice():
    from dj_tpu import cache, fleet, serve
    from dj_tpu.parallel import autotune
    from dj_tpu.resilience import errors, faults, ledger

    was = __import__("dj_tpu").obs.enabled()
    try:
        with steady_tuner():
            result = _jax_slice(SLICE)
        yield result
    finally:
        faults.reset()
        errors.reset_pins()
        ledger.reset()
        serve.reset()
        cache.reset()
        fleet.reset()
        autotune._clear()
        __import__("dj_tpu").obs.reset(reenable=was)


def test_walk_slice_matches_dj_tpu(jax_slice):
    jax_summary, jax_iterations = jax_slice
    with steady_tuner():
        summary = chaos_soak.main_walk("cpu", 2048, 8, specs=SLICE)
    assert summary["ok"], summary["violations"]
    assert summary["traces_complete"] == f"{summary['queries']}/{summary['queries']}"
    assert [it["spec"] for it in jax_iterations] == list(SLICE)
    assert summary["iterations"] == jax_iterations
    for key in ("sites", "queries", "traces_complete", "outcomes", "plan_tiers_engaged",
                "prepared_tiers_engaged"):
        assert summary[key] == jax_summary[key], key
    # The slice's own pins: none for the flag site, one of its tier else.
    assert [it["pins"] for it in summary["iterations"]] == [
        {}, {"prepared_tier": 1}, {"autotune": 1}, {"fleet": 1}]
    assert all(v == "pass" for v in summary["collective_audits"]["verdicts"].values())
    assert summary["truth"]["measured_rejects"] == 0 and summary["truth"]["device_hbm"] is None
    assert summary["skew"]["batches"] > 0 and summary["skew"]["max_ratio"] > 1.2
    assert os.environ.get("DJT_PLAN_ADAPT") is None  # the walk restored its knobs


def _walk_tables(world=4, rows=2048):
    """The walk's tables and sides, as ``_walk`` makes them."""
    topo = tj.make_topology(["cpu"] * world)
    rng = np.random.default_rng(7)
    ids = np.arange(rows, dtype=np.int64)

    def table(*cols):
        return tj.shard_table(topo, tj.from_arrays(*cols, device="cpu"))

    lk, rk = rng.integers(0, 500, rows), rng.integers(0, 500, rows)
    hot = rng.integers(0, 500, rows)
    hot[rng.random(rows) < 0.5] = 7
    small = rng.integers(0, 500, chaos_soak.SMALL_ROWS)
    tiny = rng.integers(0, 500, chaos_soak.TINY_ROWS)
    left, lc = table(lk, ids)
    right, rc = table(rk, ids)
    right_small, rsc = table(small, np.arange(small.size, dtype=np.int32))
    right_tiny, rtc = table(tiny, np.arange(tiny.size, dtype=np.int64))
    right_hot, rhc = table(hot, ids, ids)
    cfg = tj.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    with chaos_soak._env(**chaos_soak.WALK_KNOBS):
        sides = [tj.prepare_join_side(topo, r, c, [0], cfg, left_capacity=left.capacity)
                 for r, c in ((right, rc), (right_tiny, rtc), (right_hot, rhc))]
    return topo, left, lc, right, rc, right_small, rsc, sides, cfg


def test_broadcast_candidates_price_alike_at_every_odf():
    """The broadcast plan runs one join of the shard against the gathered
    build side, at an output capacity no over-decomposition splits, so
    the tuner prices its candidates alike at every odf and keeps the
    default, as dj_tpu's compiled module (the same at every odf) prices
    them. Priced at the shuffle's per-batch output, odf 2 looked cheaper
    on the walk's 128-row side; the retry after ``broadcast@call=1``
    pinned the planner then ran the shuffle plan at that odf, in twice
    the partitions, and healed a shuffle overflow dj_tpu never meets."""
    from dj_tpu_torch.parallel import dist_join

    topo = tj.make_topology(["cpu"] * 8)
    rng = np.random.default_rng(7)
    left, lc = tj.shard_table(topo, tj.from_arrays(rng.integers(0, 500, 2048),
                                                    np.arange(2048), device="cpu"))
    small = rng.integers(0, 500, chaos_soak.SMALL_ROWS)
    right, rc = tj.shard_table(topo, tj.from_arrays(small, np.arange(small.size, dtype=np.int32),
                                                     device="cpu"))
    cfg = tj.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    with chaos_soak._env(**{**chaos_soak.WALK_KNOBS, "DJT_AUTOTUNE": "0"}):
        tj.distributed_inner_join(topo, left, lc, right, rc, [0], [0], cfg)
        prices = [dist_join.price_plan_candidate(
            topo, left, lc, right, rc, [0], [0],
            tj.JoinConfig(bucket_factor=4.0, join_out_factor=4.0, over_decom_factor=odf))[0]
            for odf in (1, 2, 4)]
    assert {p["tier"] for p in prices} == {"broadcast"}
    assert len({p["bytes_accessed"] for p in prices}) == 1, prices


def test_collective_bounds_hold_and_bite():
    """Each bound of ``_collective_audits`` holds on the walk's queries,
    and breaks when its query breaks it: a shuffle-prepared side audited
    as the broadcast-prepared one issues all-to-alls, and a salted
    audit handed the broadcast side issues none."""
    topo, left, lc, right, rc, right_small, rsc, (prep, prep_bc, prep_salt), cfg = \
        _walk_tables()
    assert (prep.tier, prep_bc.tier, prep_salt.tier) == ("shuffle", "broadcast", "salted")
    obs.enable()
    violations: list = []
    with chaos_soak._env(**chaos_soak.WALK_KNOBS):
        out = chaos_soak._collective_audits(tj, obs, topo, 4, left, lc, right, rc, right_small,
                                            rsc, prep, prep_bc, prep_salt, cfg, False,
                                            violations)
    assert violations == [] and set(out["verdicts"].values()) == {"pass"}
    assert out["L"] == left.capacity // 4
    assert out["bc_prepared_query"]["collectives"] == dict.fromkeys(
        chaos_soak._Collectives.KINDS, 0)
    assert out["bc_prepared_query"]["launches_rank0"] == 0
    assert out["broadcast_query"]["collectives"]["all_to_all_start"] == 0
    assert out["broadcast_query"]["collectives"]["all_gather"] >= 4
    a2a = {k: out[k]["collectives"]["all_to_all_start"] for k in
           ("unprepared_unfused", "prepared_unfused", "salted_prepared_query")}
    assert a2a["salted_prepared_query"] >= 4
    assert 0 < 2 * a2a["prepared_unfused"] <= a2a["unprepared_unfused"]
    assert out["probe_query"]["sorts_of_L"] == 0 and out["merge_tier_query"]["sorts_of_L"] >= 4
    # The transport's methods and sort_u64 are given back.
    from dj_tpu_torch.ops import join, merge
    from dj_tpu_torch.parallel import communicator

    assert join.sort_u64 is merge.sort_u64 and merge.sort_u64.__module__.endswith("ops.merge")
    assert communicator.InProcessTransport.all_gather.__qualname__.startswith(
        "InProcessTransport")
    broken: list = []
    with chaos_soak._env(**chaos_soak.WALK_KNOBS):
        out = chaos_soak._collective_audits(tj, obs, topo, 4, left, lc, right, rc, right_small,
                                            rsc, prep, prep, prep_bc, cfg, False, broken)
    assert out["verdicts"]["bc_prepared_query"] == "violated"
    assert out["verdicts"]["salted_prepared_query"] == "violated"
    assert len(broken) == 2


class _Calls:
    """Counts the kernel wrappers' calls through ``ops.join`` (on CPU
    tensors they run their plain versions) and the transport's
    collectives, while entered."""

    NAMES = ("join_scans", "expand_values", "expand_ranks", "merge_sorted_u64")

    def __enter__(self):
        from dj_tpu_torch.ops import join

        self.counts = dict.fromkeys(self.NAMES, 0)
        self.saved = {n: getattr(join, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(join, n, self._counted(n, fn))
        self.coll = chaos_soak._Collectives().__enter__()
        return self

    def _counted(self, name, fn):
        def counted(*a, **k):
            self.counts[name] += 1
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        from dj_tpu_torch.ops import join

        self.coll.__exit__(*exc)
        for n, fn in self.saved.items():
            setattr(join, n, fn)


def _snap(phase_vals):
    return {"ranks": [{"rank": r, "phase_seconds": {"join": float(v)}, "wire_total_bytes": 0.0}
                      for r, v in enumerate(phase_vals)]}


@pytest.mark.parametrize("merge", ["sort", "merge", "probe"])
def test_observatory_armed_launches_and_collectives_equal(tmp_path, merge):
    """dj_tpu's test_fleet_obs.py:645 on the port, which compiles no
    module: one join's kernel calls and collectives (by kind, and the
    sorts of sort_u64) are equal with obs off and with the whole
    observatory armed: the black box, the anomaly window fed, the
    endpoint up, a query context and span open."""
    from dj_tpu_torch.obs import fleet, forensics
    from dj_tpu_torch.obs import http as obs_http

    n = 256
    rng = np.random.default_rng(5)
    topo = tj.make_topology(["cpu"] * 4)
    keys = rng.integers(0, 999, n).astype(np.int64)
    host = tj.from_arrays(keys, np.arange(n, dtype=np.int64), device="cpu")
    left, lc = tj.shard_table(topo, host)
    right, rc = tj.shard_table(topo, host)
    cfg = tj.JoinConfig(over_decom_factor=2, bucket_factor=4.0, join_out_factor=4.0,
                        key_range=(0, 999))
    prep = tj.prepare_join_side(topo, right, rc, [0], cfg, left_capacity=left.capacity)

    def joins():
        with _Calls() as calls, chaos_soak._env(DJT_JOIN_MERGE=merge):
            tj.distributed_inner_join(topo, left, lc, right, rc, [0], [0], cfg)
            tj.distributed_inner_join(topo, left, lc, prep, None, [0], None, cfg)
            return calls.counts, calls.coll.take()

    obs.disable()
    off = joins()
    try:
        obs.enable()
        forensics.arm(str(tmp_path))
        obs_http.stop()
        obs_http.start(0)
        fleet.note_snapshot(_snap([0.0, 0.0]))
        fleet.note_snapshot(_snap([1.0, 10.0]))
        with obs.query_ctx("0:q-guard-1"):
            with obs.span("run"):
                on = joins()
    finally:
        obs_http.stop()
        forensics.disarm()
    assert on == off
    assert sum(off[0].values()) >= 4 and off[1][0]["all_to_all_start"] >= 4
    assert obs.counter_value("dj_collective_launches_total") > 0  # obs saw the armed joins


_CHILD = """
import os, signal, sys, time
sys.path.insert(0, {root!r})
from dj_tpu_torch.obs import forensics, metrics, recorder, roofline, trace
from dj_tpu_torch.resilience import ledger
import dj_tpu_torch.obs as obs
forensics.arm({bb!r})
with obs.query_ctx("q-held"):
    obs.span_begin("query")
obs.inc("dj_soak_probe_total")


class _Done:  # a finished device phase's events: resolving it records it
    def query(self):
        return True

    def elapsed_time(self, end):
        return 2.0


roofline._pending.append((_Done(), _Done(), time.time(), ("q-held", "default"),
                          ("soak_pending", {{}})))
lock = {{"metrics": metrics._lock, "recorder": recorder._rlock, "trace": trace._traces_lock,
        "roofline": roofline._lock, "ledger": ledger._lock, "none": None}}[{which!r}]
with obs.query_ctx("q-held"):
    if lock is not None:
        lock.acquire()
    print("held", flush=True)
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(30)
print("survived", flush=True)
"""


@pytest.mark.parametrize("which", ["metrics", "recorder", "trace", "roofline", "ledger", "none"])
def test_sigterm_while_the_main_thread_holds_an_obs_lock(tmp_path, capsys, which):
    """The SIGTERM handler runs on the main thread, which the signal may
    catch inside a query context and inside one of the plain locks that
    the dump's sections or the resolve of a finished device phase take.
    The dump must not wait for it: the child dies by the signal, within
    its timeout, with its bundle, each section behind the held lock
    written incomplete and every other one whole. The finished device
    phase is resolved into the bundle only when no lock that resolving
    takes is held."""
    bb = tmp_path / "bb"
    code = _CHILD.format(root=str(ROOT), bb=str(bb), which=which)
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == -signal.SIGTERM, (proc.returncode, proc.stdout, proc.stderr)
    assert proc.stdout.strip() == "held" and "Traceback" not in proc.stderr
    (bundle,) = bb.glob("blackbox-*.jsonl")
    sections = {}
    for line in bundle.read_text().splitlines():
        obj = json.loads(line)
        sections[obj.pop("section")] = obj
    assert list(sections) == ["meta", "traces", "ring", "metrics", "knobs", "serve", "ledger",
                              "fleet", "coordination"]
    assert sections["meta"]["reason"] == "sigterm"
    held = {"metrics": {"metrics"}, "recorder": {"ring"}, "trace": {"traces"},
            "roofline": {"serve"}, "ledger": {"ledger"}, "none": set()}[which]
    for name, body in sections.items():
        if name in held:
            assert body == {"incomplete": "lock held"}, (name, body)
        else:
            assert "incomplete" not in body and "error" not in body, (name, body)
    if "traces" not in held:
        assert [t["query_id"] for t in sections["traces"]["open"]] == ["q-held"]
    if "ring" not in held:
        ring = sections["ring"]["events"]
        assert ring[-1]["type"] == "blackbox" and "query_id" not in ring[-1]
        resolved = [e for e in ring if e["type"] == "phase" and e["phase"] == "soak_pending"]
        assert len(resolved) == (1 if which in ("none", "ledger") else 0), resolved
    capsys.readouterr()
    assert blackbox_read.main([str(bb)]) == 0
    out = capsys.readouterr().out
    for name in held:
        assert f"section {name}: INCOMPLETE at dump time (lock held)" in out

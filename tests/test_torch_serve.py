"""dj_tpu_torch's query scheduler against dj_tpu's, case for case.

Each case is one scenario run through both packages (``SPkg``, the
``Pkg`` of ``test_torch_index_cache.py`` with the scheduler's names):
dj_tpu's once for every case in a module fixture, the port's in the test,
on CPU ranks of one torch thread. Compared are the events (``admission``,
``shed``, ``pressure``, ``coalesce``, ``drift``, ``serve``, ``drain``,
``index``, ``fleet``, ``tune`` and the lifecycle spans; times dropped,
query ids read as their order of appearance), the counters and gauges,
the decisions, the typed errors and their fields, and rows where the
scheduler changes what runs.

The cases follow dj_tpu's ``tests/test_serve.py:75-290`` (``from_env``,
queue full, the queued deadline, the over-budget and zero budget, the
forecast against dj_tpu's integer and the ledger-warmed factors, each
pressure level, the deadline between heal attempts, ``degrade_guard``
passing the deadline on, terminal exactly once, ``reset``), its dispatch
cases (the served result, coalescing, the overflow member's demotion,
the deadline mid-heal), the scheduler cases of ``test_index_cache.py``
(``:205``, ``:499``, ``:547``), ``test_fleet.py`` (``:536``, ``:575``,
``:616``, ``:644``, ``:681``), ``test_autotune.py:405``,
``test_truth.py`` (``:356``, ``:389``, ``:603``), ``test_skew.py:531``
and ``test_trace.py:253`` (the metrics text, not the HTTP scrape).

Recorded differences (ROADMAP §3): pressure level 2 pins ``merge``
alone, dj_tpu ``merge`` and its bucketed ``sort``; the forecast is
compared under dj_tpu's plan knobs set to the port's plan
(``DJ_JOIN_SCANS=pallas``, ``DJ_JOIN_EXPAND=pallas-vmeta``), because
dj_tpu's CPU default plan is another one, so a case that dispatches
compares its other fields; dj_tpu's compiled-module fields (retraces,
``dj_xla_*``) have no counterpart. The port's own cases: the worker
thread, the query id's rank, typed kernel and device failures pinning no
tier, a coalesced group that a kernel failure ends without demotion, the
heal that publishes its re-prepared side with ``JoinIndexCache.replace``,
and a served query's kernel calls and collectives equal to the direct
call's (dj_tpu holds its compiled module equal instead,
``test_serve.py:575``).
"""

import contextlib
import dataclasses
import gc
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_index_cache import Pkg, norm, rows
import dj_tpu_torch as tj
from dj_tpu_torch import knobs

N = 512
KEY_HI = 500
HOST = socket.gethostname()
# Fields that carry times, or the recorder's own bookkeeping.
TIMES = {"seq", "ts", "t", "queued_s", "run_s", "total_s", "elapsed_s", "seconds", "age_s",
         "waited_s", "probe_s"}
SERVE_EVENTS = ("admission", "shed", "pressure", "coalesce", "drift", "serve", "drain", "span")
SERVE_COUNTERS = ("dj_serve_admitted_total", "dj_serve_rejected_total", "dj_serve_shed_total",
                  "dj_serve_coalesced_total", "dj_forecast_drift_total",
                  "dj_fleet_tenant_shed_total")
# dj_tpu's merge tier names of the port's.
MERGE_NAMES = {"sort": "xla", "merge": "pallas", "probe": "probe"}


class SPkg(Pkg):
    """Pkg with the scheduler's modules and names."""

    def __init__(self, name: str):
        super().__init__(name)
        if name == "jax":
            from dj_tpu import serve
            from dj_tpu.obs import metrics, trace, truth
            from dj_tpu.parallel import autotune, pipeline
            from dj_tpu.resilience import heal
            from dj_tpu.serve import admission, scheduler
        else:
            from dj_tpu_torch import serve
            from dj_tpu_torch.obs import metrics, trace, truth
            from dj_tpu_torch.parallel import autotune, pipeline
            from dj_tpu_torch.resilience import heal
            from dj_tpu_torch.serve import admission, scheduler
        for k, v in dict(serve=serve, metrics=metrics, trace=trace, truth=truth,
                         autotune=autotune, pipeline=pipeline, heal=heal, admission=admission,
                         scheduler=scheduler).items():
            setattr(self, k, v)
        self.QS = serve.QueryScheduler
        self.SC = serve.ServeConfig

    def reset(self):
        super().reset()
        self.serve.reset()
        self.autotune._clear()


@contextlib.contextmanager
def envs(P, **kv):
    """Set ``P``'s prefix + each name for the body; restore after."""
    names = {P.env(k): v for k, v in kv.items()}
    prev = {n: os.environ.get(n) for n in names}
    try:
        for n, v in names.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
        yield
    finally:
        for n, v in prev.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def aligned(P):
    """dj_tpu's plan knobs set to the port's default plan, so the byte
    model prices one plan in both (for cases that dispatch nothing)."""
    if P.name == "jax":
        return envs(P, JOIN_SCANS="pallas", JOIN_EXPAND="pallas-vmeta")
    return contextlib.nullcontext()


def tables(P, n=N, seed=0, w=1, nr=None, key_hi=KEY_HI):
    topo = P.make_topology(w)
    rng = np.random.default_rng(seed)
    nr = n if nr is None else nr
    lk = rng.integers(0, key_hi, n).astype(np.int64)
    rk = rng.integers(0, key_hi, nr).astype(np.int64)
    left, lc = P.shard(topo, [lk, np.arange(n, dtype=np.int64)])
    right, rc = P.shard(topo, [rk, np.arange(nr, dtype=np.int64)])
    return topo, left, lc, right, rc, lk, rk


def oracle(lk, rk) -> int:
    return int(sum((lk == k).sum() * (rk == k).sum() for k in np.unique(rk)))


def cfg_of(P, **kw):
    base = dict(bucket_factor=4.0, join_out_factor=4.0, key_range=(0, KEY_HI - 1))
    base.update(kw)
    return P.m.JoinConfig(**base)


def flat_rows(out, counts) -> list:
    return sorted(r for shard in rows(out, counts) for r in shard)


def events(P, types=SERVE_EVENTS) -> list:
    """The drained events of ``types`` without times, query ids as q1,
    q2, ... in order of appearance, spans of the query lifecycle only."""
    ids: dict = {}

    def qid(x):
        return ids.setdefault(x, f"q{len(ids) + 1}")

    out = []
    for e in P.obs.drain():
        if e["type"] not in types:
            continue
        if e["type"] == "span" and e.get("span") not in ("query", "queued", "run"):
            continue
        e = {k: v for k, v in e.items() if k not in TIMES}
        if "query_id" in e:
            e["query_id"] = qid(e["query_id"])
        if "members" in e:
            e["members"] = [qid(m) for m in e["members"]]
        out.append(e)
    return norm(out)


def no_bytes(evs) -> list:
    """Events without the byte model's numbers (cases that dispatch run
    dj_tpu's CPU default plan)."""
    drop = {"forecast_bytes", "actual_bytes", "ratio"}
    return [{k: v for k, v in e.items() if k not in drop} for e in evs]


def counters(P, names=SERVE_COUNTERS) -> dict:
    return P.counters(names)


def raised(fn):
    """(class name, the exception) of what ``fn()`` raised, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, e
    return None


# --- host parity: nothing dispatches ----------------------------------------


def config_from_env(P):
    full = dict(SERVE_HBM_BUDGET="123456", SERVE_QUEUE_DEPTH="3", SERVE_DEADLINE_S="2.5",
                SERVE_COALESCE="0", SERVE_COALESCE_MAX="5", SERVE_PRESSURE_WINDOW="7",
                SERVE_PRESSURE_REJECT_RATE="0.25", SERVE_MATCH_FACTOR="2",
                SERVE_SLO_WINDOW="9", SERVE_DRIFT_THRESHOLD="3")
    with envs(P, **full):
        a = dataclasses.asdict(P.SC.from_env())
    with envs(P, SERVE_DEADLINE_S="oops", SERVE_QUEUE_DEPTH="x", SERVE_HBM_BUDGET="y"):
        b = dataclasses.asdict(P.SC.from_env())
    return {"set": a, "malformed": b, "default": dataclasses.asdict(P.SC()),
            "from_unset_env": dataclasses.asdict(P.SC.from_env())}


def queue_full(P):
    topo, left, lc, right, rc, _, _ = tables(P)
    out = {}
    with P.QS(P.SC(queue_depth=2, coalesce=False), worker=False) as s:
        t1 = s.submit(topo, left, lc, right, rc, [0], [0])
        t2 = s.submit(topo, left, lc, right, rc, [0], [0])
        name, e = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0]))
        out["raised"] = [name, e.depth, isinstance(e, RuntimeError), bool(e.query_id)]
        out["depth"] = s.queue_depth
        s.close()
        out["terminals"] = [[t.done, t.outcome, type(t.error).__name__] for t in (t1, t2)]
    out["counters"] = counters(P)
    out["events"] = no_bytes(events(P))
    return out


def deadline_queued(P):
    topo, left, lc, right, rc, _, _ = tables(P)
    with P.QS(P.SC(), worker=False) as s:
        t = s.submit(topo, left, lc, right, rc, [0], [0], deadline_s=0.0)
        time.sleep(0.002)
        pumped = s.pump()
        name, e = raised(lambda: t.result(timeout=1))
    return {"pumped": pumped, "raised": [name, e.where, e.deadline_s], "outcome": t.outcome,
            "counters": counters(P), "events": no_bytes(events(P)),
            "gauges": [P.obs.gauge_value("dj_slo_shed_rate", scheduler=s.name),
                       P.obs.gauge_value("dj_serve_queue_depth")]}


def admission_budget(P):
    with aligned(P):
        topo, left, lc, right, rc, _, _ = tables(P)
        out = {}
        with P.QS(P.SC(hbm_budget_bytes=1.0), worker=False) as s:
            name, e = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0]))
            out["reject"] = [name, e.budget_bytes, e.forecast_bytes, e.reserved_bytes,
                             e.signature, e.forecast_bytes > e.budget_bytes, s.reserved_bytes]
        with P.QS(P.SC(hbm_budget_bytes=0.0), worker=False) as s:
            t = s.submit(topo, left, lc, right, rc, [0], [0])
            out["zero_budget"] = [t.done, s.queue_depth, s.reserved_bytes == t.forecast.bytes]
        out["counters"] = counters(P)
        out["events"] = events(P)
    return out


def forecasts(P):
    """forecast's integer on the unprepared (cold, ledger-warmed, a
    smaller learned factor), broadcast and salted (the plan_adapt
    record), prepared (each merge tier) and pipeline cases."""
    led = P.ledger
    with aligned(P):
        topo, left, lc, right, rc, _, _ = tables(P)
        cfg = P.m.JoinConfig(over_decom_factor=2, join_out_factor=1.0)

        def fc(r=right, on=(0,), c=cfg):
            f = P.serve.forecast(topo, left, r, [0], None if on is None else list(on), c)
            return {"bytes": f.bytes, "warmed": f.ledger_warmed, "factors": f.factors,
                    "tier": f.plan_tier, "replicas": f.salt_replicas, "prepared": f.prepared,
                    "autotuned": f.autotuned, "rows": f.rows, "right_rows": f.right_rows}

        out = {"cold": fc()}
        sig = P.serve.query_signature(topo, left, right, [0], [0], cfg)
        out["sig"] = [sig, sig == P.ledger.plan_signature(topo, left, right, [0], [0], cfg)]
        led.update(sig, factors={"join_out_factor": 8.0})
        out["warm"] = fc()
        led.reset()
        led.update(sig, factors={"join_out_factor": 0.5})
        out["smaller"] = fc()
        led.reset()
        with envs(P, PLAN_ADAPT="1"):
            led.update(sig, plan_adapt={"tier": "broadcast", "salt": [], "replicas": 1,
                                        "ratio": 1.0})
            out["broadcast"] = fc()
            led.reset()
            led.update(sig, plan_adapt={"tier": "salted", "salt": [0], "replicas": 3,
                                        "ratio": 4.0})
            out["salted"] = fc()
            led.reset()
        c1 = P.m.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
        prep = P.m.prepare_join_side(topo, right, rc, [0], c1, left_capacity=left.capacity)
        for tier in ("sort", "merge", "probe"):
            with envs(P, JOIN_MERGE=MERGE_NAMES[tier] if P.name == "jax" else tier):
                out[f"prepared_{tier}"] = fc(prep, None, c1)
        stages = [P.pipeline.JoinStage(right, rc, [0], [0]),
                  P.pipeline.JoinStage(right, rc, [0], [0])]
        plan = P.pipeline.plan_pipeline(topo, left, lc, stages, cfg, resolve_ranges=False)
        pf = P.admission.forecast_pipeline(topo, plan, cfg)
        out["pipeline"] = [pf.bytes, pf.plan_tier, pf.signature, pf.ledger_warmed,
                           P.admission.reprice(pf, cfg) == pf.bytes]
        f = P.serve.forecast(topo, left, right, [0], [0], cfg)
        out["reprice_same_config"] = P.admission.reprice(f, cfg) == f.bytes
        out["reprice_grown"] = P.admission.reprice(
            f, dataclasses.replace(cfg, join_out_factor=2.0)) / f.bytes
    return out


def pressure(P):
    with aligned(P):
        topo, left, lc, right, rc, _, _ = tables(P)
        sc = P.SC(hbm_budget_bytes=1.0, pressure_window=4, pressure_reject_rate=0.5)
        out = {"pins": []}
        with P.QS(sc, worker=False) as s:
            for i in range(12):
                assert raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0]))[0] == \
                    "AdmissionRejected"
                if i % 4 == 3:
                    # dj_tpu pins its bucketed "sort" tier beside merge (a
                    # recorded difference: the port has no such tier).
                    out["pins"].append(sorted(t for t in P.errors.pinned_tiers() if t != "sort"))
            out["level"] = s.pressure_level
            cfg4 = P.m.JoinConfig(over_decom_factor=4)
            tk = P.scheduler.Ticket(s, 0, (topo, left, lc, right, rc, (0,), (0,)), cfg4, None,
                                    None, P.serve.forecast(topo, left, right, [0], [0], cfg4))
            out["halved"] = s._dispatch_config(tk).over_decom_factor
            for _ in range(6):
                raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0]))
            out["capped"] = s.pressure_level
            out["gauge"] = P.obs.gauge_value("dj_serve_pressure_level")
            s.reset_pressure()
            out["reset"] = [s.pressure_level, P.obs.gauge_value("dj_serve_pressure_level")]
        out["events"] = events(P, ("pressure",))
        out["counters"] = counters(P)
    return out


def heal_deadline(P):
    calls, factors = [], {"f": 1.0}

    def run_attempt(a):
        calls.append(a)
        return None, {"ovf": True}

    kw = dict(name="t", stage="t", budget=P.heal.HealBudget(max_attempts=5),
              run_attempt=run_attempt, heal_map={"ovf": ("f",)},
              read_factors=lambda: dict(factors), apply_factors=lambda g: factors.update(g))
    with P.heal.deadline_scope(time.monotonic(), 0.0):
        name, e = raised(lambda: P.heal.run_healed(**kw))
    out = {"expired": [name, list(calls), e.where, e.deadline_s]}
    calls.clear()
    factors["f"] = 1.0
    out["unscoped"] = [raised(lambda: P.heal.run_healed(**kw))[0], list(calls)]

    def attempt():
        raise P.errors.DeadlineExceeded("late", where="healing")

    name, _ = raised(lambda: P.errors.degrade_guard("t", attempt, tiers=("wire",),
                                                    compression=object()))
    out["guard"] = [name, P.errors.tier_pinned("wire")]
    return out


def terminal_once(P):
    topo, left, lc, right, rc, _, _ = tables(P)
    with P.QS(P.SC(), worker=False) as s:
        t = s.submit(topo, left, lc, right, rc, [0], [0])
        with s._cv:
            s._queue.clear()
        s._finish(t, error=P.errors.BackendError("first"))
        name, e = raised(lambda: s._finish(t, error=P.errors.BackendError("second")))
    return {"second": [name, "finished twice" in str(e)], "outcome": t.outcome}


def reset_series(P):
    topo, left, lc, right, rc, _, _ = tables(P)
    with P.QS(P.SC(hbm_budget_bytes=1.0), worker=False) as s:
        raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0]))
        before = P.obs.counter_value("dj_serve_rejected_total", reason="admission")
        P.obs.inc("dj_tenant_device_seconds_total", 1.0, tenant="t")
        P.obs.inc("dj_fleet_tenant_shed_total", tenant="t")
        P.serve.reset()
        after = [P.obs.counter_value("dj_serve_rejected_total", reason="admission"),
                 P.obs.counter_value("dj_tenant_device_seconds_total", tenant="t"),
                 P.obs.counter_value("dj_fleet_tenant_shed_total", tenant="t")]
        return {"before": before, "after": after, "state": [s.pressure_level, s.queue_depth],
                "snapshots": len(P.serve.schedulers_snapshot()) >= 1}


# --- dispatch -------------------------------------------------------------------


def served(P):
    topo, left, lc, right, rc, lk, rk = tables(P)
    cfg = cfg_of(P)
    direct = P.m.distributed_inner_join_auto(topo, left, lc, right, rc, [0], [0], cfg)
    P.obs.drain()
    with P.QS(P.SC(), worker=False) as s:
        t = s.submit(topo, left, lc, right, rc, [0], [0], cfg)
        out, counts, info, used = t.result(timeout=600)
    got = flat_rows(out, counts)
    return {"rows": got, "total": [len(got), oracle(lk, rk)],
            "direct": got == flat_rows(direct[0], direct[1]), "used": used == cfg,
            "outcome": t.outcome, "events": no_bytes(events(P)), "counters": counters(P),
            "ratio": [P.metrics.histogram_raw("dj_forecast_error_ratio")[3],
                      P.metrics.histogram_quantile("dj_forecast_error_ratio", 0.5) <= 1.0],
            "latency": P.metrics.histogram_raw("dj_serve_latency_seconds", tenant="default",
                                               outcome="result")[3]}


def _queries(P, topo, seed, k, key_hi=KEY_HI):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        pk = rng.integers(0, key_hi, N).astype(np.int64)
        out.append(P.shard(topo, [pk, np.arange(N, dtype=np.int64)]))
    return out


def coalesced(P):
    topo, left, lc, right, rc, _, _ = tables(P)
    cfg = cfg_of(P, over_decom_factor=2)
    prep = P.m.prepare_join_side(topo, right, rc, [0], cfg, left_capacity=left.capacity)
    qs = _queries(P, topo, 42, 3)
    want = []
    for lq, lcq in qs:
        o, c, info = P.m.distributed_inner_join(topo, lq, lcq, prep, None, [0], None, cfg)
        assert not any(np.asarray(v).any() for v in info.values())
        want.append(flat_rows(o, c))
    P.obs.drain()
    with P.QS(P.SC(), worker=False) as s:
        ts = [s.submit(topo, lq, lcq, prep, None, [0], None, cfg) for lq, lcq in qs]
        got = [t.result(timeout=600) for t in ts]
    out = {"same": [flat_rows(r[0], r[1]) == w for r, w in zip(got, want)],
           "prepared_back": [r[4] is prep for r in got], "coalesced": [t.coalesced for t in ts],
           "events": no_bytes(events(P)), "counters": counters(P)}
    # Member 0's flag forced: it demotes to the singleton heal; member 1
    # keeps the group's result.
    P.faults.configure("prepared.join_overflow@call=1")
    with P.QS(P.SC(), worker=False) as s:
        ts = [s.submit(topo, lq, lcq, prep, None, [0], None, cfg) for lq, lcq in qs[:2]]
        got = [t.result(timeout=600) for t in ts]
    P.faults.reset()
    out["demote"] = {"same": [flat_rows(r[0], r[1]) == w for r, w in zip(got, want)],
                     "outcomes": [t.outcome for t in ts], "coalesced": [t.coalesced for t in ts],
                     "grew": got[0][3].join_out_factor > cfg.join_out_factor,
                     "coalesce_events": [e["size"] for e in events(P, ("coalesce",))]}
    return out


def deadline_healing(P, slow=None):
    """Every attempt's join overflow forced; the deadline covers about
    one attempt, so the check between attempts sheds the query."""
    topo, left, lc, right, rc, _, _ = tables(P)
    cfg = cfg_of(P, join_out_factor=2.0)
    P.faults.configure(",".join(f"join.join_overflow@call={i}" for i in range(1, 9)))
    with slow() if slow is not None else contextlib.nullcontext():
        with P.QS(P.SC(), worker=False) as s:
            t = s.submit(topo, left, lc, right, rc, [0], [0], cfg, deadline_s=0.2)
            name, e = raised(lambda: t.result(timeout=600))
    P.faults.reset()
    evs = events(P, ("shed", "heal"))
    return {"raised": [name, e.where, e.deadline_s], "outcome": t.outcome,
            "shed": [x for x in evs if x["type"] == "shed"],
            "healed": sum(x["type"] == "heal" for x in evs) >= 1,
            "counter": P.obs.counter_value("dj_serve_shed_total", reason="deadline_healing"),
            "slo": P.obs.gauge_value("dj_slo_shed_rate", scheduler=s.name)}


# --- the join-index cache through the door (test_index_cache.py) -------------


@contextlib.contextmanager
def counting(module, name):
    real = getattr(module, name)
    box = [0]

    def counted(*a, **k):
        box[0] += 1
        return real(*a, **k)

    setattr(module, name, counted)
    try:
        yield box
    finally:
        setattr(module, name, real)


def index_hit(P):
    topo, left, lc, right, rc, lk, rk = tables(P)
    cfg = cfg_of(P)
    cache = P.cache.JoinIndexCache()
    with P.QS(P.SC(), worker=False, index=cache) as s:
        r1 = s.submit(topo, left, lc, right, rc, [0], [0], cfg, tenant="a").result(timeout=600)
        miss = P.obs.counter_value("dj_index_miss_total")
        P.obs.drain()
        with counting(P.dist_join, "prepare_join_side") as prepares:
            t2 = s.submit(topo, left, lc, right, rc, [0], [0], cfg, tenant="a")
            r2 = t2.result(timeout=600)
        evs = events(P, SERVE_EVENTS + ("index", "heal", "reprepare"))
        out = {"rows": [flat_rows(r1[0], r1[1]) == flat_rows(r2[0], r2[1]),
                        len(flat_rows(r2[0], r2[1])) == oracle(lk, rk)],
               "tuple": [len(r1), len(r2)], "miss": miss,
               "hit": P.obs.counter_value("dj_index_hit_total"), "prepares": prepares[0],
               "pins": [v["pins"] for v in cache.stats().values()],
               "index_events": [e["op"] for e in evs if e["type"] == "index"],
               "heals": [e for e in evs if e["type"] in ("heal", "reprepare")],
               "tenants": [e["tenant"] for e in evs if e["type"] == "serve"]}
    cache.clear()
    return out


def index_budget(P):
    """One budget for the cache and admission: an unpinned entry is shed
    to admit; a pinned one cannot be, and the reject counts it."""
    with aligned(P):
        topo, left, lc, right, rc, _, _ = tables(P)
        cfg = P.m.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
        cache = P.cache.JoinIndexCache()
        cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="t",
                             left_capacity=left.capacity).release()
        resident = cache.resident_bytes
        fc = P.serve.forecast(topo, left, right, [0], [0], cfg)
        budget = fc.bytes + resident / 2
        out = {"resident": resident, "forecast": fc.bytes}
        with P.QS(P.SC(hbm_budget_bytes=budget), worker=False) as s:
            t = s.submit(topo, left, lc, right, rc, [0], [0], cfg)
            out["admitted"] = [t.done, cache.resident_bytes]
        P.obs.drain()
        lease = cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="t",
                                     left_capacity=left.capacity)
        with P.QS(P.SC(hbm_budget_bytes=budget), worker=False) as s:
            name, e = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0], cfg))
            out["reject"] = [name, e.reserved_bytes == cache.resident_bytes]
        out["events"] = events(P, ("admission", "index"))
        lease.release()
        cache.clear()
    return out


def index_own_pinned(P):
    """The pool does not fit because of the query's own pinned side: the
    submit unpins it, serves unprepared and sheds the entry."""
    topo, left, lc, right, rc, lk, rk = tables(P, seed=11, nr=8192)
    cfg = P.m.JoinConfig(bucket_factor=8.0, join_out_factor=4.0)
    cache = P.cache.JoinIndexCache()
    lease0 = cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="t", left_capacity=N)
    fc_prep = P.serve.forecast(topo, left, lease0.prepared, [0], None, cfg)
    lease0.release()
    resident = cache.resident_bytes
    fc_unprep = P.serve.forecast(topo, left, right, [0], [0], cfg)
    premise = fc_prep.bytes + resident > fc_unprep.bytes
    budget = max(fc_unprep.bytes, fc_prep.bytes + resident / 2)
    with P.QS(P.SC(hbm_budget_bytes=budget), worker=False, index=cache) as s:
        t = s.submit(topo, left, lc, right, rc, [0], [0], cfg, tenant="t")
        state = [t.lease is None, cache.resident_bytes]
        out = t.result(timeout=600)
    return {"premise": premise, "state": state, "tuple": len(out),
            "total": len(flat_rows(out[0], out[1])) == oracle(lk, rk),
            "evicts": [e.get("reason") for e in events(P, ("index",)) if e["op"] == "evict"]}


# --- the fleet through the door (test_fleet.py) --------------------------------


def peer_bytes(P, d):
    topo, left, lc, right, rc, _, _ = tables(P)
    child = subprocess.Popen(["sleep", "30"])
    out = {}
    try:
        with envs(P, FLEET_DIR=d):
            os.makedirs(os.path.join(d, "budget"), exist_ok=True)
            peer = os.path.join(d, "budget", f"{child.pid}.json")
            with open(peer, "w") as f:
                f.write('{"pid": %d, "host": "%s", "reserved_bytes": 1e15, '
                        '"index_bytes": 0.0, "ts": %.3f}' % (child.pid, HOST, time.time()))
            with P.QS(P.SC(hbm_budget_bytes=1e12, coalesce=False), worker=False) as s:
                name, e = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0]))
                out["reject"] = [name, "fleet peers" in str(e), e.reserved_bytes >= 1e15]
            os.unlink(peer)
            with P.QS(P.SC(hbm_budget_bytes=1e12, coalesce=False), worker=False) as s:
                t = s.submit(topo, left, lc, right, rc, [0], [0])
                out["admitted"] = [t is not None, t.done]
            out["fleet_bytes"] = [e.get("fleet_bytes") for e in events(P, ("admission",))]
    finally:
        child.kill()
        child.wait()
    return out


def fair_share(P):
    topo, left, lc, right, rc, _, _ = tables(P)
    out = {}
    with envs(P, FLEET_TENANT_WEIGHTS="hog:1,polite:1"):
        P.metrics.inc("dj_tenant_device_seconds_total", 10.0, tenant="hog")
        P.metrics.inc("dj_tenant_device_seconds_total", 0.1, tenant="polite")
        with P.QS(P.SC(queue_depth=2, coalesce=False), worker=False) as s:
            t1 = s.submit(topo, left, lc, right, rc, [0], [0], tenant="hog")
            t2 = s.submit(topo, left, lc, right, rc, [0], [0], tenant="hog")
            s._pressure_level = 1
            t3 = s.submit(topo, left, lc, right, rc, [0], [0], tenant="polite")
            out["redirect"] = [t3 is not None, t2.done, type(t2.error).__name__,
                               "fair-share" in str(t2.error), t1.done]
            out["hog_again"] = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0],
                                                       tenant="hog"))[0]
            s.close()
    out["counters"] = counters(P)
    out["events"] = no_bytes(events(P, ("shed",)))
    return out


def fair_share_inert(P):
    topo, left, lc, right, rc, _, _ = tables(P)
    P.metrics.inc("dj_tenant_device_seconds_total", 10.0, tenant="hog")
    out = {}
    with P.QS(P.SC(queue_depth=1, coalesce=False), worker=False) as s:
        s.submit(topo, left, lc, right, rc, [0], [0], tenant="hog")
        s._pressure_level = 1
        out["no_weights"] = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0],
                                                    tenant="polite"))[0]
        with envs(P, FLEET_TENANT_WEIGHTS="hog:1,polite:1"):
            s._pressure_level = 0
            out["no_pressure"] = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0],
                                                         tenant="polite"))[0]
        s.close()
    return out


def drain_finishes(P):
    gc.collect()  # a drain flips every live scheduler: leave only this case's
    topo, left, lc, right, rc, lk, rk = tables(P)
    cfg = cfg_of(P)
    with P.QS(P.SC(coalesce=False), worker=False) as s:
        t1 = s.submit(topo, left, lc, right, rc, [0], [0], cfg)
        flipped = P.drain.begin(reason="test")
        out = {"flipped": [s in flipped, P.drain.draining(), s.snapshot()["draining"]]}
        name, e = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0], cfg))
        out["reject"] = [name, e.scheduler == s.name,
                         P.obs.counter_value("dj_serve_rejected_total", reason="draining")]
        out["before"] = s.drained()
        while s.pump():
            pass
        r = t1.result(timeout=60)
        out["rows"] = len(flat_rows(r[0], r[1])) == oracle(lk, rk)
        out["after"] = [s.drained(), P.drain.wait_quiesced(1.0)]
        out["phases"] = [e["phase"] for e in events(P, ("drain",))]
    return out


def born_draining(P):
    gc.collect()
    P.drain.begin(reason="test")
    topo, left, lc, right, rc, _, _ = tables(P)
    with P.QS(P.SC(coalesce=False), worker=False) as s:
        name = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0]))[0]
        snap = s.snapshot()["draining"]
    return {"raised": name, "draining": snap, "phases": [e["phase"] for e in
                                                         events(P, ("drain",))]}


# --- the autotuner, truth, skew and traces through the door ------------------


def autotune_replay(P, d):
    topo, left, lc, right, rc, lk, rk = tables(P)
    cfg = cfg_of(P, over_decom_factor=2)
    # The probes' timing picks the winner; a wide drift bound keeps the
    # first query's audit (forecast before the tune) from flagging a
    # re-tune whichever odf won.
    sc = P.SC(coalesce=False, drift_threshold=1e6)
    with envs(P, LEDGER=os.path.join(d, f"{P.name}_ledger.jsonl"), AUTOTUNE="1",
              AUTOTUNE_ODF="1,2"):
        with P.QS(sc, worker=False) as s:
            r1 = s.submit(topo, left, lc, right, rc, [0], [0], cfg).result(timeout=600)
            r2 = s.submit(topo, left, lc, right, rc, [0], [0], cfg).result(timeout=600)
        evs = events(P, ("tune", "serve"))
        out = {"rows": [len(flat_rows(r[0], r[1])) == oracle(lk, rk) for r in (r1, r2)],
               "tunes": [e["action"] for e in evs if e["type"] == "tune"],
               "autotuned": [e["autotuned"] for e in evs if e["type"] == "serve"],
               "outcomes": [e["outcome"] for e in evs if e["type"] == "serve"],
               "counter": P.obs.counter_value("dj_autotune_total", action="tune")}
        P.autotune._clear()
        P.ledger.reset()
        with P.QS(sc, worker=False) as s:
            r3 = s.submit(topo, left, lc, right, rc, [0], [0], cfg).result(timeout=600)
        out["restart"] = [len(flat_rows(r3[0], r3[1])) == oracle(lk, rk),
                          [e["action"] for e in events(P, ("tune",))]]
    return out


class _FakeDev:
    def __init__(self, i, in_use, limit=16e9):
        self.id, self._in_use, self._limit = i, int(in_use), int(limit)

    def memory_stats(self):
        return {"bytes_in_use": self._in_use, "peak_bytes_in_use": self._in_use + 512,
                "bytes_limit": self._limit}


def measured(P):
    topo, left, lc, right, rc, _, _ = tables(P)
    cfg = cfg_of(P)
    out = {}
    with envs(P, SERVE_MEASURED_HBM="1"):
        real = P.truth._device_list
        P.truth._device_list = lambda: [_FakeDev(0, 16e9)]
        try:
            with P.QS(P.SC(), worker=False) as s:
                name, e = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0], cfg,
                                                  tenant="tM"))
        finally:
            P.truth._device_list = real
        m = e.measured
        tr = P.obs.query_trace(e.query_id)
        out["reject"] = [name, m["device"], m["bytes_in_use"], m["headroom_bytes"] <= 0,
                         "MEASURED" in str(e), tr is not None and tr["complete"]]
        out["counter"] = P.obs.counter_value("dj_serve_rejected_total", reason="measured_hbm")
        out["events"] = [{k: v for k, v in x.items() if k != "forecast_bytes"}
                         for x in events(P, ("admission",))]
        # Armed on a backend with no device stats: a strict no-op.
        s = P.QS(P.SC(), worker=False)
        t = s.submit(topo, left, lc, right, rc, [0], [0], cfg)
        out["noop"] = [bool(t.query_id), t.done, s.queue_depth]
        s.close()
    return out


def tenant_accounting(P):
    topo, left, lc, right, rc, _, _ = tables(P, seed=3)
    cfg = cfg_of(P)
    cache = P.cache.JoinIndexCache()
    with P.QS(P.SC(), worker=False, index=cache) as s:
        for _ in range(2):
            r = s.submit(topo, left, lc, right, rc, [0], [0], cfg, tenant="tE").result(
                timeout=600)
            assert len(flat_rows(r[0], r[1])) > 0
        summ = P.truth.tenant_summary()["tenants"]["tE"]
        out = {"prepares": P.obs.counter_value("dj_tenant_prepares_total", tenant="tE"),
               "wire": P.obs.counter_value("dj_tenant_wire_bytes_total", tenant="tE") > 0,
               "seconds": P.obs.counter_value("dj_tenant_device_seconds_total",
                                              tenant="tE") > 0,
               "index_bytes": P.obs.gauge_value("dj_tenant_index_bytes", tenant="tE") > 0,
               "summary": [summ["queries_ok"], summ["prepares"]]}
    cache.clear(force=True)
    out["cleared"] = P.obs.gauge_value("dj_tenant_index_bytes", tenant="tE")
    return out


def skew_trace(P):
    n = 1024
    topo, left, lc, right, rc, _, _ = tables(P, n=n, seed=37, w=4)
    cfg = cfg_of(P, over_decom_factor=2, key_range=None)
    with envs(P, OBS_SKEW="1"):
        with P.QS(P.SC(), worker=False) as s:
            t = s.submit(topo, left, lc, right, rc, [0], [0], cfg)
            r = t.result(timeout=300)
    tr = P.obs.query_trace(t.query_id)
    phases = [e for e in tr["events"] if e["type"] == "phase"]
    sk = [e for e in tr["events"] if e["type"] == "skew"]
    run = [e for e in phases if e["phase"] == "run"]
    return {"total": int(np.asarray(r[1]).sum()) > 0, "complete": tr["complete"],
            "run_phase": [(e["kind"], e["roofline_frac"] is not None) for e in run],
            "skew": [[e["stage"], list(e["rows"])] for e in sk],
            "skew_total": sum(sum(e["rows"]) for e in sk) == n,
            "gauge": P.obs.gauge_value("dj_skew_ratio", stage="join") > 0,
            "run_hist": P.metrics.histogram_raw("dj_roofline_frac", phase="run", kind="hbm")[3]
            if P.name == "torch" else P.metrics.histogram_raw("dj_roofline_frac",
                                                               phase="run")[3]}


def trace_slo(P):
    topo, left, lc, right, rc, _, _ = tables(P)
    cfg = P.m.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    with P.QS(P.SC(hbm_budget_bytes=50e6), worker=False) as s:
        t_ok = s.submit(topo, left, lc, right, rc, [0], [0], cfg, tenant="tA")
        r = t_ok.result(timeout=300)
        t_dead = s.submit(topo, left, lc, right, rc, [0], [0], cfg, tenant="tA", deadline_s=0.0)
        dead = raised(lambda: t_dead.result(timeout=300))[0]
        name, e = raised(lambda: s.submit(topo, left, lc, right, rc, [0], [0],
                                          P.m.JoinConfig(join_out_factor=1e9), tenant="tA"))
        out = {"rows": int(np.asarray(r[1]).sum()) > 0, "dead": dead, "reject": name}
        traces = []
        for qid in (t_ok.query_id, t_dead.query_id):
            tr = P.obs.query_trace(qid)
            traces.append([tr["complete"], tr["orphans"], tr["terminal"]])
        tr = P.obs.query_trace(e.query_id)
        traces.append([tr["complete"], tr["terminal"],
                       any(x["type"] == "admission" and x["decision"] == "reject"
                           for x in tr["events"])])
        out["traces"] = traces
        out["collectives"] = P.trace.event_count(t_ok.query_id, "collectives") >= 1
        out["slo"] = [P.obs.gauge_value("dj_slo_deadline_hit_rate", scheduler=s.name),
                      P.obs.gauge_value("dj_slo_shed_rate", scheduler=s.name) > 0,
                      P.obs.gauge_value("dj_slo_window_terminals", scheduler=s.name),
                      s.snapshot()["slo"]["shed_rate"] == P.obs.gauge_value(
                          "dj_slo_shed_rate", scheduler=s.name)]
        out["latency"] = P.metrics.histogram_raw("dj_serve_latency_seconds", tenant="tA",
                                                 outcome="result")[3]
        out["ratio"] = [P.metrics.histogram_raw("dj_forecast_error_ratio")[3],
                        P.metrics.histogram_quantile("dj_forecast_error_ratio", 0.5) <= 1.0]
        text = P.obs.metrics_text()
        out["text"] = [n in text for n in ("dj_serve_latency_seconds_bucket",
                                           "dj_slo_deadline_hit_rate",
                                           "dj_forecast_error_ratio_bucket",
                                           "dj_serve_admitted_total")]
    return out


CASES = {
    "config_from_env": config_from_env,
    "queue_full": queue_full,
    "deadline_queued": deadline_queued,
    "admission_budget": admission_budget,
    "forecasts": forecasts,
    "pressure": pressure,
    "heal_deadline": heal_deadline,
    "terminal_once": terminal_once,
    "reset_series": reset_series,
    "served": served,
    "coalesced": coalesced,
    "deadline_healing": deadline_healing,
    "index_hit": index_hit,
    "index_budget": index_budget,
    "index_own_pinned": index_own_pinned,
    "peer_bytes": peer_bytes,
    "fair_share": fair_share,
    "fair_share_inert": fair_share_inert,
    "drain_finishes": drain_finishes,
    "born_draining": born_draining,
    "autotune_replay": autotune_replay,
    "measured": measured,
    "tenant_accounting": tenant_accounting,
    "skew_trace": skew_trace,
    "trace_slo": trace_slo,
}
_TMP_CASES = ("peer_bytes", "autotune_replay")


@contextlib.contextmanager
def _slow_attempts(P):
    """The port's attempts are fast on tiny tables: each sleeps past the
    0.2 s deadline, as dj_tpu's first attempt does while it compiles."""
    real = P.dist_join.run_spmd

    def slow(*a, **k):
        time.sleep(0.25)
        return real(*a, **k)

    P.dist_join.run_spmd = slow
    try:
        yield
    finally:
        P.dist_join.run_spmd = real


def run_case(P, name, tmp):
    P.reset()
    try:
        fn = CASES[name]
        if name in _TMP_CASES:
            d = tmp / f"{P.name}_{name}"
            d.mkdir(parents=True, exist_ok=True)
            return fn(P, str(d))
        if name == "deadline_healing" and P.name == "torch":
            return fn(P, slow=lambda: _slow_attempts(P))
        return fn(P)
    finally:
        P.reset()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """dj_tpu's side of every case, run once."""
    P = SPkg("jax")
    tmp = tmp_path_factory.mktemp("jax_serve")
    with pytest.MonkeyPatch.context() as mp:
        for name in list(knobs.reset_names()) + [n.replace("DJT_", "DJ_")
                                                 for n in knobs.reset_names()]:
            mp.delenv(name, raising=False)
        was = P.obs.enabled()
        try:
            return {name: run_case(P, name, tmp) for name in CASES}
        finally:
            P.obs.reset(reenable=was)


@pytest.fixture
def port(monkeypatch):
    """The port on one torch thread, its reset-class knobs unset, obs on."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    P = SPkg("torch")
    was = P.obs.enabled()
    yield P
    P.reset()
    P.obs.reset(reenable=was)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(CASES))
def test_the_scheduler_matches_dj_tpu(name, jax_runs, port, tmp_path):
    got = norm(run_case(port, name, tmp_path))
    want = norm(jax_runs[name])
    assert got == want


def test_the_scenarios_check_what_they_claim(jax_runs):
    """The dj_tpu side reads as dj_tpu's own tests assert, so equality
    with it means the port's does too."""
    r = norm(jax_runs)
    assert r["config_from_env"]["set"]["queue_depth"] == 3
    assert r["config_from_env"]["malformed"]["default_deadline_s"] is None
    assert r["queue_full"]["raised"][:3] == ["QueueFull", 2, True]
    assert r["queue_full"]["terminals"] == [[True, "BackendError", "BackendError"]] * 2
    assert r["deadline_queued"]["raised"] == ["DeadlineExceeded", "queued", 0.0]
    assert r["admission_budget"]["reject"][0] == "AdmissionRejected"
    assert r["admission_budget"]["reject"][5] is True
    assert r["forecasts"]["warm"]["bytes"] > r["forecasts"]["cold"]["bytes"]
    assert r["forecasts"]["smaller"]["bytes"] == r["forecasts"]["cold"]["bytes"]
    assert r["forecasts"]["broadcast"]["tier"] == "broadcast"
    assert r["forecasts"]["salted"]["replicas"] == 3
    assert len({r["forecasts"][f"prepared_{t}"]["bytes"] for t in ("sort", "merge")}) == 2
    assert r["pressure"]["pins"] == [["wire"], ["merge", "wire"], ["merge", "wire"]]
    assert [r["pressure"]["level"], r["pressure"]["halved"], r["pressure"]["capped"]] == [3, 2, 3]
    assert r["heal_deadline"]["expired"][:3] == ["DeadlineExceeded", [1], "healing"]
    assert r["heal_deadline"]["unscoped"] == ["CapacityExhausted", [1, 2, 3, 4, 5]]
    assert r["served"]["direct"] and r["served"]["used"]
    assert r["coalesced"]["same"] == [True] * 3 and r["coalesced"]["coalesced"] == [True] * 3
    assert r["coalesced"]["demote"]["same"] == [True, True]
    assert r["coalesced"]["demote"]["coalesced"] == [False, True]
    assert r["deadline_healing"]["raised"][:2] == ["DeadlineExceeded", "healing"]
    assert r["index_hit"]["hit"] == 1 and r["index_hit"]["prepares"] == 0
    assert r["index_budget"]["admitted"] == [False, 0.0]
    assert r["index_own_pinned"]["premise"] and r["index_own_pinned"]["state"] == [True, 0.0]
    assert r["peer_bytes"]["reject"] == ["AdmissionRejected", True, True]
    assert r["fair_share"]["redirect"] == [True, True, "QueueFull", True, False]
    assert r["fair_share_inert"] == {"no_weights": "QueueFull", "no_pressure": "QueueFull"}
    assert r["drain_finishes"]["reject"][:2] == ["Draining", True]
    assert r["born_draining"]["raised"] == "Draining"
    assert r["autotune_replay"]["tunes"] == ["tune"]
    assert r["autotune_replay"]["autotuned"] == [False, True]
    assert r["measured"]["reject"][0] == "AdmissionRejected"
    assert r["tenant_accounting"]["summary"] == [2, 1]
    assert len(r["skew_trace"]["skew"]) == 2 and r["skew_trace"]["skew_total"]
    assert r["trace_slo"]["slo"][:3] == [0.0, True, 2]


# --- the port's own cases ----------------------------------------------------------


def test_the_worker_thread_serves_a_world_of_four(port):
    P = port
    P.reset()
    topo, left, lc, right, rc, lk, rk = tables(P, w=4)
    cfg = cfg_of(P, over_decom_factor=2)
    direct = P.m.distributed_inner_join_auto(topo, left, lc, right, rc, [0], [0], cfg)
    with P.QS(P.SC(), worker=True) as s:
        assert s.has_worker and s.snapshot()["worker_alive"]
        ts = [s.submit(topo, left, lc, right, rc, [0], [0], cfg) for _ in range(3)]
        got = [t.result(timeout=120) for t in ts]
    for r in got:
        assert rows(r[0], r[1]) == rows(direct[0], direct[1])
        assert r[3] == direct[3]
    # Three same-signature Table queries coalesce on a flat world.
    assert sum(e["size"] for e in P.obs.events("coalesce")) >= 2 or \
        not any(t.coalesced for t in ts)


def test_a_query_id_carries_the_process_rank(port, monkeypatch):
    from dj_tpu_torch.serve import scheduler

    monkeypatch.setattr(scheduler, "_QUERY_RANK", None)
    monkeypatch.setenv("DJT_PROCESS_ID", "3")
    assert scheduler._mint_query_id().startswith(f"3:q{os.getpid()}-")
    monkeypatch.setattr(scheduler, "_QUERY_RANK", None)
    monkeypatch.delenv("DJT_PROCESS_ID")
    assert scheduler._mint_query_id().startswith("0:q")
    assert scheduler._QUERY_RANK is None  # 0 is asked again later


@pytest.mark.parametrize("failure", ["kernel", "device"])
def test_a_kernel_or_device_failure_ends_the_ticket_typed_and_pins_nothing(port, failure):
    from dj_tpu_torch.ops import join as tjoin
    from dj_tpu_torch.resilience.errors import KernelError

    P = port
    P.reset()
    topo, left, lc, right, rc, _, _ = tables(P)
    cfg = cfg_of(P)
    exc = (KernelError("join_scans did not launch") if failure == "kernel"
           else torch.AcceleratorError("an illegal memory access"))

    def broken(*a, **k):
        raise exc

    real = tjoin.join_scans
    tjoin.join_scans = broken
    try:
        with P.QS(P.SC(), worker=False) as s:
            # Through the merge tier and its ladder too: nothing pins.
            t = s.submit(topo, left, lc, right, rc, [0], [0], cfg)
            name, e = raised(lambda: t.result(timeout=60))
    finally:
        tjoin.join_scans = real
    assert t.done and P.errors.pinned_tiers() == {}
    if failure == "kernel":
        assert name == "KernelError" and e is exc
    else:
        assert name == "BackendError" and e.__cause__ is exc
    assert [x["outcome"] for x in P.obs.events("serve")] == [name]


def test_a_kernel_failure_ends_a_coalesced_group_without_demotion(port):
    from dj_tpu_torch.resilience.errors import KernelError

    P = port
    P.reset()
    topo, left, lc, right, rc, _, _ = tables(P)
    cfg = cfg_of(P)
    prep = P.m.prepare_join_side(topo, right, rc, [0], cfg, left_capacity=left.capacity)
    qs = _queries(P, topo, 5, 2)

    def broken(*a, **k):
        raise KernelError("merge_sorted_u64 did not launch")

    real = P.dist_join.distributed_inner_join_coalesced
    P.dist_join.distributed_inner_join_coalesced = broken
    try:
        with counting(P.dist_join, "distributed_inner_join_auto") as singles:
            with P.QS(P.SC(), worker=False) as s:
                ts = [s.submit(topo, lq, lcq, prep, None, [0], None, cfg) for lq, lcq in qs]
                outs = [raised(lambda t=t: t.result(timeout=60))[0] for t in ts]
    finally:
        P.dist_join.distributed_inner_join_coalesced = real
    assert outs == ["KernelError", "KernelError"] and singles[0] == 0
    assert P.errors.pinned_tiers() == {}


def test_a_cache_routed_heal_publishes_its_side_with_replace(port):
    """Probe keys past the cached side's declared range: the query's auto
    loop re-prepares, and the scheduler swaps the healed side into the
    cache, so the next query of the signature starts from it."""
    P = port
    P.reset()
    topo, _, _, right, rc, _, rk = tables(P)
    lk = np.random.default_rng(9).integers(0, 2 * KEY_HI, N).astype(np.int64)
    left, lc = P.shard(topo, [lk, np.arange(N, dtype=np.int64)])
    cfg = cfg_of(P)  # declares (0, 499): half the probe keys fall outside
    cache = P.cache.JoinIndexCache()
    with counting(cache, "replace") as replaces:
        with P.QS(P.SC(), worker=False, index=cache) as s:
            t = s.submit(topo, left, lc, right, rc, [0], [0], cfg)
            r = t.result(timeout=120)
            side = r[4]
            assert replaces[0] == 1
            [key] = cache.keys()
            assert cache._entry_prepared(key) is side
            assert len(flat_rows(r[0], r[1])) == oracle(lk, rk)
            r2 = s.submit(topo, left, lc, right, rc, [0], [0], cfg).result(timeout=120)
            assert r2[4] is side and replaces[0] == 1
    ops = [e["op"] for e in P.obs.events("index")]
    assert ops.count("reprepare") == 1
    cache.clear()


def test_a_served_query_launches_what_the_direct_call_launches(port, monkeypatch):
    """dj_tpu holds the scheduler's compiled module equal to the direct
    call's (test_serve.py:575); the port compiles none, so a served query
    must call the same kernels and collectives as many times."""
    from dj_tpu_torch.ops import join as tjoin
    from dj_tpu_torch.parallel.communicator import InProcessTransport

    P = port
    P.reset()
    calls = {}
    for name in ("join_scans", "expand_values", "expand_ranks", "merge_sorted_u64"):
        real = getattr(tjoin, name)

        def counted(*a, _real=real, _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(tjoin, name, counted)
    for name in ("all_to_all_start", "all_gather", "all_reduce", "shift_start"):
        fn = getattr(InProcessTransport, name)

        def counted_coll(*a, _fn=fn, _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(InProcessTransport, name, counted_coll)
    topo, left, lc, right, rc, _, _ = tables(P, w=4)
    for odf in (1, 2):
        cfg = cfg_of(P, over_decom_factor=odf)
        P.m.distributed_inner_join_auto(topo, left, lc, right, rc, [0], [0], cfg)  # warm
        calls.clear()
        P.m.distributed_inner_join_auto(topo, left, lc, right, rc, [0], [0], cfg)
        direct = dict(calls)
        calls.clear()
        with P.QS(P.SC(coalesce=False), worker=False) as s:
            s.submit(topo, left, lc, right, rc, [0], [0], cfg).result(timeout=60)
        assert calls == direct and direct["join_scans"] == 4 * odf
        assert direct["all_to_all_start"] >= 1


def test_a_drained_scheduler_is_flipped_by_fleet_drain_begin(port):
    P = port
    P.reset()
    with P.QS(P.SC(), worker=True) as s:
        assert s in list(P.drain._SCHEDULERS)
        assert P.drain.begin(reason="test") and s.snapshot()["draining"]
        assert P.drain.wait_quiesced(1.0)


def test_chip_smoke_serve_phase_rehearses_on_cpu(capsys, monkeypatch):
    """chip_smoke's phase 15 at 20,000 rows on CPU tables, every check as
    on the card (the card's calls stubbed, the kernel wrappers counting
    their plain calls, and one fake device for the measured gate whose
    bytes in use are the stubbed allocator's)."""
    from test_torch_smoke_prepared import _dj, _main_path, cs as cs_fixture
    from dj_tpu_torch.obs import truth

    class Dev:
        id = 0

        def memory_stats(self):
            n = torch.cuda.memory_allocated()
            return {"bytes_in_use": n, "peak_bytes_in_use": n, "bytes_limit": 80 * 2**30}

    mp = pytest.MonkeyPatch()
    gen = cs_fixture.__wrapped__(mp)
    cs = next(gen)
    mp.setattr(truth, "_device_list", lambda: [Dev()])
    for name in knobs.reset_names():
        mp.delenv(name, raising=False)
    try:
        dj = _dj()
        rows = 20_000
        _, build, probe, expected, topo, left, lcnt, right, rcnt, ref = _main_path(cs, dj, rows)
        with cs.released("15"):
            one, world = cs.run_serve(dj, "cpu", topo, left, lcnt, right, rcnt, build, probe,
                                      expected, ref, rows, 0, "cpu")
        cs.check_no_pins("15")
    finally:
        gen.close()
        mp.undo()
        tj.serve.reset()
        tj.fleet.reset()
        tj.cache.reset()
    assert one["served_unprepared"][4]["join_scans"] == 4
    assert one["served_coalesced_merge"][1]["merge_sorted_u64"] == 4
    assert one["served_pressure_merge_pinned"][1]["merge_sorted_u64"] == 0
    assert one["served_pressure_halved"][4]["join_scans"] == 2
    assert world["served_world"][1]["join_scans"] == cs.WORLD
    out = capsys.readouterr().out
    for case in ("(a)", "(b)", "(b) demote", "(c)", "(d)", "(e)", "(f)", "(g)", "(h)"):
        assert f'"case": "{case}"' in out, case
    assert "[serve_phase]" in out


def test_a_failed_group_is_released_before_its_members_run_alone(port):
    """The group's failure (an out-of-memory, say) holds the group's
    buffers in its traceback; the members must run alone after it is
    gone, or the card that could not hold the group would also hold its
    remains beside each member."""
    import weakref

    P = port
    P.reset()
    topo, left, lc, right, rc, _, _ = tables(P)
    cfg = cfg_of(P)
    prep = P.m.prepare_join_side(topo, right, rc, [0], cfg, left_capacity=left.capacity)
    qs = _queries(P, topo, 6, 2)
    held = []

    class Buffers:
        pass

    def broken(*a, **k):
        buffers = Buffers()  # noqa: F841 - a local of the failing frame
        held.append(weakref.ref(buffers))
        raise RuntimeError("CUDA out of memory")

    alive_at_demotion = []
    real_single = P.scheduler.QueryScheduler._execute_single

    def single(self, t, *a, **k):
        alive_at_demotion.append(held[0]() is not None)
        return real_single(self, t, *a, **k)

    real = P.dist_join.distributed_inner_join_coalesced
    P.dist_join.distributed_inner_join_coalesced = broken
    P.scheduler.QueryScheduler._execute_single = single
    try:
        with P.QS(P.SC(), worker=False) as s:
            ts = [s.submit(topo, lq, lcq, prep, None, [0], None, cfg) for lq, lcq in qs]
            outs = [t.result(timeout=60) for t in ts]
    finally:
        P.dist_join.distributed_inner_join_coalesced = real
        P.scheduler.QueryScheduler._execute_single = real_single
    assert [t.outcome for t in ts] == ["result", "result"] and len(outs[0]) == 5
    assert [t.coalesced for t in ts] == [False, False]
    assert alive_at_demotion == [False, False]


def test_a_failed_ticket_holds_no_frame_of_its_dispatch(port):
    """A ticket keeps its error for as long as its caller keeps it; the
    error's frames must not keep the failed dispatch's buffers."""
    import weakref

    P = port
    P.reset()
    topo, left, lc, right, rc, _, _ = tables(P)
    held = []

    class Buffers:
        pass

    def broken(*a, **k):
        buffers = Buffers()  # noqa: F841 - a local of the failing frame
        held.append(weakref.ref(buffers))
        raise RuntimeError("CUDA out of memory")

    real = P.dist_join.distributed_inner_join_auto
    P.dist_join.distributed_inner_join_auto = broken
    try:
        with P.QS(P.SC(), worker=False) as s:
            t = s.submit(topo, left, lc, right, rc, [0], [0], cfg_of(P))
            name, e = raised(lambda: t.result(timeout=60))
    finally:
        P.dist_join.distributed_inner_join_auto = real
    assert name == "BackendError" and isinstance(e.__cause__, RuntimeError)
    assert "broken" in "".join(__import__("traceback").format_tb(e.__cause__.__traceback__))
    assert held[0]() is None


def test_a_raised_result_leaves_no_cycle_through_its_ticket(port):
    """Ticket.result() raises the stored error, which puts its own frame
    (holding the ticket) in the error's traceback: the ticket must still
    go with its last reference, not wait for the cyclic collector, since
    a ticket's inputs and a dispatch's remains sit on the card."""
    P = port
    P.reset()
    topo, left, lc, right, rc, _, _ = tables(P)
    with P.QS(P.SC(), worker=False) as s:
        t = s.submit(topo, left, lc, right, rc, [0], [0], cfg_of(P), deadline_s=0.0)
        time.sleep(0.002)
        try:
            t.result(timeout=60)
        except P.errors.DeadlineExceeded as e:
            err = e
        # This frame's name and getrefcount's argument, nothing else.
        assert sys.getrefcount(t) == 2
        assert err.where == "queued"

"""dj_tpu_torch's join-index cache against dj_tpu's, call for call.

Each case is one scenario function run through both packages (``Pkg``
adapts the names: the env prefix, the modules, the table constructors): dj_tpu's
runs once for every case in a module fixture, on as many devices of the
CPU mesh as the case's world; the port's runs in the test, on CPU ranks of
one torch thread. Compared are the ``index`` events, the cache's counters
and gauges, typed errors, the manifest's records (apart from ``pid``,
``host`` and ``ts``), the plan decisions and the row multisets. The cases
follow dj_tpu's ``tests/test_index_cache.py``: a hit returns the same side
and the plan signature is byte equal; LRU eviction of unpinned entries and
a pinned entry never evicted; ``append_rows`` against a fresh prepare, and
an append escaping the range re-prepares; the manifest with a torn tail,
then ``warm_restart``; ``warmup_join_index`` with an entry that fails and
is skipped; ``available_broadcast_bytes`` with an entry resident flipping a
broadcast decision. The port's own cases: an evicted side's memory is
released (nothing else of the port keeps its tensors), and a kernel
failure under the cache propagates. dj_tpu's scheduler cases
(``test_index_cache.py:205``, ``:499``, ``:547``) run in
``test_torch_serve.py``.
"""

import gc
import json
import re
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dj_tpu_torch as tj
from dj_tpu_torch import convert, knobs

HIDDEN = ("seq", "ts")
COUNTERS = ("dj_index_hit_total", "dj_index_miss_total", "dj_index_evict_total",
            "dj_index_pin_total", "dj_index_reprepare_total", "dj_warmup_total")


class Pkg:
    """One package's names for the scenarios: ``name`` "jax" or "torch"."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            import dj_tpu as m
            from dj_tpu import cache, fleet, obs, serve
            from dj_tpu.fleet import budget, drain, leases
            from dj_tpu.parallel import dist_join, plan_adapt
            from dj_tpu.parallel.api import shard_table
            from dj_tpu.parallel.topology import make_topology
            from dj_tpu.resilience import errors, faults, ledger

            self.prefix = "DJ_"
            self.make_topology = lambda w: make_topology(jax.devices()[:w])
            self._shard = shard_table
        else:
            import dj_tpu_torch as m
            from dj_tpu_torch import cache, fleet, obs, serve
            from dj_tpu_torch.fleet import budget, drain, leases
            from dj_tpu_torch.parallel import dist_join, plan_adapt
            from dj_tpu_torch.resilience import errors, faults, ledger

            self.prefix = "DJT_"
            self.make_topology = lambda w: m.make_topology(["cpu"] * w)
            self._shard = m.shard_table
        self.m = m
        for k, v in dict(cache=cache, fleet=fleet, obs=obs, serve=serve, budget=budget,
                         drain=drain, leases=leases, dist_join=dist_join, plan_adapt=plan_adapt,
                         errors=errors, faults=faults, ledger=ledger).items():
            setattr(self, k, v)

    def env(self, name: str) -> str:
        return self.prefix + name

    def table(self, arrays):
        names = [a.dtype.name for a in arrays]
        if self.name == "jax":
            return self.m.from_arrays(*[jnp.asarray(a) for a in arrays],
                                      dtypes=[self.m.dtypes.by_name(n) for n in names])
        return convert.table_from_numpy(arrays, names, device="cpu")

    def shard(self, topo, arrays):
        return self._shard(topo, self.table(arrays))

    def reset(self):
        self.faults.reset()
        self.errors.reset_pins()
        self.ledger.reset()
        self.serve.reset()
        self.cache.reset()
        self.fleet.reset()
        self.obs.reset(reenable=True)
        self.obs.drain()

    def recorded(self, types_=("index", "fleet", "degrade", "warmup", "plan_adapt")) -> list:
        """The events so far of ``types_``, without times, drained."""
        return norm([{k: v for k, v in e.items() if k not in HIDDEN}
                     for e in self.obs.drain() if e["type"] in types_])

    def counters(self, names=COUNTERS) -> dict:
        return {n: sorted([[list(p) for p in labels], v]
                          for labels, v in self.obs.counter_series(n).items())
                for n in names}


def norm(x):
    """JSON-normal form (tuples as lists, numpy ints as ints), with the
    port's ``DJT_`` names read as dj_tpu's ``DJ_`` and an entry key's
    tensor identity (ids differ between the packages) blanked."""
    text = json.dumps(x, default=int).replace("DJT_", "DJ_")
    return json.loads(re.sub(r"\|[0-9a-f]{12}\|", "|<ident>|", text))


def rows(out, counts) -> list:
    """Each shard's valid rows, sorted."""
    counts = np.asarray(counts).tolist()
    cols = [np.asarray(c.data) for c in out.columns]
    cap = cols[0].shape[0] // len(counts)
    return [sorted(zip(*[c[r * cap: r * cap + n].tolist() for c in cols]))
            for r, n in enumerate(counts)]


def keys(n, seed, hi=500):
    return np.random.default_rng(seed).integers(0, hi, n).astype(np.int64)


def side(P, topo, k, base=0):
    return P.shard(topo, [k, np.arange(base, base + len(k), dtype=np.int64)])


def query(P, topo, left, lc, prepared, cfg):
    out, counts, info = P.m.distributed_inner_join(topo, left, lc, prepared, None, [0], None, cfg)
    return {"rows": rows(out, counts), "flags": {k: np.asarray(v).tolist() for k, v in
                                                 sorted(info.items())}}


# --- the scenarios (one argument: the package) -------------------------------


def hit_and_miss(P, w):
    """Miss, hit of the same side, two pins, a same-schema dataset as
    another entry, the key's signature suffix; then clear."""
    topo = P.make_topology(w)
    n = 256
    right, rc = side(P, topo, keys(n, 0))
    cfg = P.m.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    cache = P.cache.JoinIndexCache()
    l1 = cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="t0", left_capacity=n)
    l2 = cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="t0", left_capacity=n)
    sig = P.ledger.plan_signature(topo, None, right, None, (0,), cfg)
    out = {"same_side": l2.prepared is l1.prepared, "sig": sig,
           "key_suffix": l1.key.endswith("|" + sig), "key_prefix": l1.key.startswith("t0|"),
           "pins": cache.stats()[l1.key]["pins"], "resident": cache.resident_bytes,
           "module_resident": P.cache.resident_bytes(),
           "side_bytes": P.obs.prepared_side_bytes(l1.prepared)}
    right2, rc2 = side(P, topo, np.full(n, 7, np.int64))
    with cache.get_or_prepare(topo, right2, rc2, [0], cfg, tenant="t0", left_capacity=n) as l3:
        out["other_dataset"] = (l3.key != l1.key, l3.prepared is not l1.prepared)
    out["entries"] = cache.entry_count
    l1.release()
    l2.release()
    cache.clear()
    out["cleared"] = (cache.entry_count, cache.resident_bytes)
    out["gauges"] = [P.obs.gauge_value("dj_index_resident_bytes"),
                     P.obs.gauge_value("dj_index_entries"),
                     P.obs.gauge_value("dj_tenant_index_bytes", tenant="t0")]
    out["events"], out["counters"] = P.recorded(), P.counters()
    return out


def eviction(P, w):
    """A budget of 2.5 entries evicts the LRU unpinned one (one evict
    event); a budget of 1.5 with the one entry pinned rejects the next,
    typed, and evicts nothing; clear refuses a pinned entry."""
    topo = P.make_topology(w)
    n = 256
    right, rc = side(P, topo, keys(n, 1))
    cfg = P.m.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    probe = P.cache.JoinIndexCache()
    with probe.get_or_prepare(topo, right, rc, [0], cfg, tenant="probe", left_capacity=n):
        one = probe.resident_bytes
    probe.clear()
    P.obs.drain()
    cache = P.cache.JoinIndexCache(P.cache.IndexConfig(hbm_budget_bytes=2.5 * one))
    la = cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="a", left_capacity=n)
    lb = cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="b", left_capacity=n)
    la.release()
    lb.release()
    cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="b", left_capacity=n).release()
    cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="c", left_capacity=n).release()
    out = {"tenants": sorted(v["tenant"] for v in cache.stats().values()),
           "resident": cache.resident_bytes, "one": one,
           "tenant_bytes": [P.obs.gauge_value("dj_tenant_index_bytes", tenant=t)
                            for t in "abc"]}
    cache.clear()
    tight = P.cache.JoinIndexCache(P.cache.IndexConfig(hbm_budget_bytes=1.5 * one))
    la = tight.get_or_prepare(topo, right, rc, [0], cfg, tenant="a", left_capacity=n)
    try:
        tight.get_or_prepare(topo, right, rc, [0], cfg, tenant="b", left_capacity=n)
        out["rejected"] = None
    except P.errors.AdmissionRejected as e:
        out["rejected"] = [type(e).__name__, e.budget_bytes, e.forecast_bytes,
                           e.reserved_bytes, e.signature == la.key.split("|", 3)[3]]
    out["survivor"] = tight.keys() == [la.key] and la.prepared is not None
    try:
        tight.clear()
        out["clear_refused"] = None
    except ValueError as e:
        out["clear_refused"] = str(e)
    la.release()
    tight.clear()
    out["events"], out["counters"] = P.recorded(), P.counters()
    return out


def appends(P, w):
    """An in-range append (one append event, its touched batches) whose
    query equals a fresh prepare of the combined table; then an append
    escaping the declared range: one reprepare event, a query over old
    and new keys."""
    topo = P.make_topology(w)
    n = 512
    rk = keys(n, 2)
    right, rc = side(P, topo, rk)
    cfg = P.m.JoinConfig(over_decom_factor=2, bucket_factor=4.0, join_out_factor=4.0,
                         key_range=(0, 511))
    cache = P.cache.JoinIndexCache()
    lease = cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="t", left_capacity=n)
    ak = keys(64, 3)
    app, ac = side(P, topo, ak, base=10_000)
    P.obs.drain()
    cache.append_rows(lease.key, app, ac)
    out = {"append_events": P.recorded()}
    left, lc = side(P, topo, keys(n, 4))
    out["incremental"] = query(P, topo, left, lc, lease.prepared, cfg)
    comb, cc = side(P, topo, np.concatenate([rk, ak]))
    # The combined table's payloads: the source's rows then the appended.
    comb, cc = P.shard(topo, [np.concatenate([rk, ak]),
                              np.concatenate([np.arange(n), np.arange(10_000, 10_064)])])
    fresh = P.m.prepare_join_side(topo, comb, cc, [0], cfg, left_capacity=n,
                                  key_range=(0, 511))
    out["fresh"] = query(P, topo, left, lc, fresh, cfg)
    far, fc = side(P, topo, keys(64, 5, hi=1000) + 5000)
    cache.append_rows(lease.key, far, fc)
    out["reprepare_events"] = P.recorded()
    lk2 = np.concatenate([keys(n - 64, 6), keys(64, 7, hi=1000) + 5000])
    left2, lc2 = side(P, topo, lk2)
    out["healed"] = query(P, topo, left2, lc2, lease.prepared, lease.prepared.config)
    out["key_range"] = norm(lease.prepared.key_range)
    out["resident"] = cache.resident_bytes
    lease.release()
    out["counters"] = P.counters()
    return out


def manifest(P, w, path):
    """Two tenants' inserts in the manifest, a torn tail line, then
    warm_restart: two restores, and the restored inventory hits."""
    topo = P.make_topology(w)
    n = 256
    right, rc = side(P, topo, keys(n, 8))
    cfg = P.m.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    cache = P.cache.JoinIndexCache(P.cache.IndexConfig(manifest_path=path))
    for t in ("a", "b"):
        cache.get_or_prepare(topo, right, rc, [0], cfg, tenant=t, left_capacity=n).release()
    with open(path) as f:
        written = [json.loads(x) for x in f]
    with open(path, "a") as f:
        f.write('{"op": "insert", "tenant": "c", "sig"')
    restored = P.cache.JoinIndexCache(P.cache.IndexConfig(manifest_path=path))
    resolved = []

    def resolver(rec):
        resolved.append(rec["tenant"])
        return {"topology": topo, "right": right, "right_counts": rc}

    P.obs.drain()
    out = {"restored": restored.warm_restart(resolver), "resolved": sorted(resolved),
           "entries": restored.entry_count}
    restored.get_or_prepare(topo, right, rc, [0], cfg, tenant="a", left_capacity=n).release()
    with open(path) as f:
        compacted = [json.loads(x) for x in f]
    hide = ("pid", "host", "ts")
    out["written"] = norm([{k: v for k, v in r.items() if k not in hide} for r in written])
    out["compacted"] = norm([{k: v for k, v in r.items() if k not in hide} for r in compacted])
    out["events"], out["counters"] = P.recorded(), P.counters()
    restored.clear()
    cache.clear()
    return out


def warmup(P, w):
    """warmup_join_index over two entries, one of which the example probe
    cannot query (two key columns against one): one warmed, one skipped."""
    topo = P.make_topology(w)
    n = 256
    k = keys(n, 9)
    right, rc = side(P, topo, k)
    two, tc = P.shard(topo, [k, k % 7, np.arange(n, dtype=np.int64)])
    cfg = P.m.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    cache = P.cache.JoinIndexCache()
    cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="one", left_capacity=n).release()
    cache.get_or_prepare(topo, two, tc, [0, 1], cfg, tenant="two", left_capacity=n).release()
    left, lc = side(P, topo, keys(n, 10))
    P.obs.drain()
    out = {"warmed": P.m.warmup_join_index(topo, cache, left, lc, [0], cfg),
           "events": P.recorded(("warmup",)),
           "pins": sorted(v["pins"] for v in cache.stats().values())}
    with cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="one", left_capacity=n) as ls:
        out["query"] = query(P, topo, left, lc, ls.prepared, cfg)
    cache.clear()
    out["counters"] = P.counters(("dj_warmup_total",))
    return out


def broadcast_budget(P, w):
    """The adaptive plan's broadcast fit against the budget less the
    resident bytes: with DJ(T)_BROADCAST_BYTES between the build side's
    bytes and those plus the entry's, the decision is broadcast (fit)
    with the cache empty and shuffle with the entry resident; the rows of
    both plans are equal."""
    import os

    topo = P.make_topology(w)
    n = 512
    right, rc = side(P, topo, keys(n, 11))
    left, lc = side(P, topo, keys(n, 12))
    cfg = P.m.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    rb = float(P.dist_join._global_table_bytes(topo, right) if P.name == "torch"
               else P.dist_join.replicated_table_bytes(right))
    cache = P.cache.JoinIndexCache()
    lease = cache.get_or_prepare(topo, right, rc, [0], cfg, tenant="t", left_capacity=n)
    resident = cache.resident_bytes
    lease.release()
    out = {"rb": rb, "resident": resident}
    os.environ[P.env("PLAN_ADAPT")] = "1"
    os.environ[P.env("BROADCAST_BYTES")] = str(rb + resident / 2)
    try:
        out["available_with_entry"] = P.plan_adapt.available_broadcast_bytes()
        d = P.dist_join._resolve_plan_decision(topo, left, lc, right, rc, (0,), (0,), cfg)
        out["with_entry"] = [d.tier, d.source]
        res_with = P.m.distributed_inner_join(topo, left, lc, right, rc, [0], [0], cfg)
        cache.clear()
        P.ledger.reset()
        out["available_empty"] = P.plan_adapt.available_broadcast_bytes()
        d = P.dist_join._resolve_plan_decision(topo, left, lc, right, rc, (0,), (0,), cfg)
        out["empty"] = [d.tier, d.source]
        res_empty = P.m.distributed_inner_join(topo, left, lc, right, rc, [0], [0], cfg)
    finally:
        os.environ.pop(P.env("PLAN_ADAPT"))
        os.environ.pop(P.env("BROADCAST_BYTES"))
    out["rows_equal"] = (sorted(sum(rows(*res_with[:2]), []))
                         == sorted(sum(rows(*res_empty[:2]), [])))
    out["events"] = P.recorded(("plan_adapt",))
    return out


CASES = {
    "hit_and_miss_w1": (hit_and_miss, 1),
    "hit_and_miss_w4": (hit_and_miss, 4),
    "eviction_w1": (eviction, 1),
    "appends_w4": (appends, 4),
    "manifest_w1": (manifest, 1),
    "warmup_w1": (warmup, 1),
    "broadcast_budget_w4": (broadcast_budget, 4),
}


def run_case(P, name, tmp):
    fn, w = CASES[name]
    P.reset()
    try:
        if fn is manifest:
            return fn(P, w, str(tmp / f"{P.name}_{name}.jsonl"))
        return fn(P, w)
    finally:
        P.reset()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """dj_tpu's side of every case, run once."""
    P = Pkg("jax")
    tmp = tmp_path_factory.mktemp("jax_index")
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
def port(monkeypatch, tmp_path):
    """The port's package on one torch thread, its reset-class knobs
    unset and its obs on."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    P = Pkg("torch")
    was = P.obs.enabled()
    yield P
    P.reset()
    P.obs.reset(reenable=was)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(CASES))
def test_the_cache_matches_dj_tpu(name, jax_runs, port, tmp_path):
    got = norm(run_case(port, name, tmp_path))
    want = norm(jax_runs[name])
    assert got == want


def total(series) -> float:
    return sum(v for _, v in series)


def test_the_scenarios_check_what_they_claim(jax_runs):
    """The dj_tpu side reads as dj_tpu's own tests assert, so equality
    with it means the port does too."""
    r = norm(jax_runs)
    for w in (1, 4):
        h = r[f"hit_and_miss_w{w}"]
        assert h["same_side"] and h["key_suffix"] and h["key_prefix"] and h["pins"] == 2
        assert h["resident"] == h["module_resident"] == h["side_bytes"] > 0
        assert h["other_dataset"] == [True, True] and h["entries"] == 2
        assert h["cleared"] == [0, 0.0] and total(h["counters"]["dj_index_hit_total"]) == 1
        assert [e["op"] for e in h["events"]] == ["miss", "insert", "hit", "miss", "insert"]
    e = r["eviction_w1"]
    assert e["tenants"] == ["b", "c"] and e["resident"] <= 2.5 * e["one"]
    assert [x["tenant"] for x in e["events"] if x.get("op") == "evict"] == ["a"]
    assert e["rejected"][0] == "AdmissionRejected" and e["rejected"][1] == 1.5 * e["one"]
    assert e["survivor"] and "pinned" in e["clear_refused"]
    a = r["appends_w4"]
    assert [x["op"] for x in a["append_events"]] == ["append"]
    assert a["append_events"][0]["touched"]
    assert a["incremental"] == a["fresh"]
    assert not any(any(v) for v in a["fresh"]["flags"].values())
    assert [x["op"] for x in a["reprepare_events"]] == ["reprepare"]
    assert not any(any(v) for v in a["healed"]["flags"].values())
    m = r["manifest_w1"]
    assert m["restored"] == 2 and m["resolved"] == ["a", "b"] and m["entries"] == 2
    assert [x["op"] for x in m["events"] if x["type"] == "index"].count("restore") == 2
    wu = r["warmup_w1"]
    assert wu["warmed"] == 1 and wu["pins"] == [0, 0]
    assert [x["kind"] for x in wu["events"]] == ["prepared_join", "join_index_skip",
                                                  "join_index"]
    b = r["broadcast_budget_w4"]
    assert b["available_with_entry"] == b["rb"] + b["resident"] / 2 - b["resident"]
    assert b["with_entry"][0] == "shuffle" and b["empty"] == ["broadcast", "fit"]
    assert b["rows_equal"]


def test_an_evicted_side_leaves_no_reference_in_the_port(port):
    """After the evict and the last lease's release nothing of the port
    keeps the side's tensors: the range memo, the shape buckets' alias
    registry, obs and the tuner hold none (the card's allocator gets the
    memory back; chip_smoke phase 14(b) measures it)."""
    P = port
    P.reset()
    topo = P.make_topology(4)
    right, rc = side(P, topo, keys(512, 13))
    left, lc = side(P, topo, keys(512, 14))
    cfg = tj.JoinConfig(join_out_factor=4.0)
    cache = P.cache.JoinIndexCache()

    def held_by(lease):
        query(P, topo, left, lc, lease.prepared, cfg)  # the memos see the side
        return [weakref.ref(t) for words, ptab, cnt in lease.prepared.batches
                for t in (words, cnt, *[c.data for c in ptab.columns])]

    # Released, then evicted by the budget's shedding.
    lease = cache.get_or_prepare(topo, right, rc, [0], cfg, left_capacity=512)
    held = held_by(lease)
    lease.release()
    assert cache.shed_bytes(float("inf")) > 0 and cache.entry_count == 0
    gc.collect()
    assert [r() for r in held] == [None] * len(held)
    # Dropped while leased (clear(force=True)), then the lease released.
    lease = cache.get_or_prepare(topo, right, rc, [0], cfg, left_capacity=512)
    held = held_by(lease)
    cache.clear(force=True)
    lease.release()
    gc.collect()
    assert [r() for r in held] == [None] * len(held)


def test_a_kernel_failure_under_the_cache_propagates(port, monkeypatch, tmp_path):
    """A KernelError raised by the prepare under the fleet gate is not a
    fleet failure: it propagates, pins nothing and inserts nothing; in
    warmup_join_index's walk it fails the walk instead of a skip."""
    from dj_tpu_torch.parallel import dist_join as tdist
    from dj_tpu_torch.parallel import warmup as twarmup

    P = port
    P.reset()
    topo = P.make_topology(1)
    right, rc = side(P, topo, keys(64, 15))
    warm = P.cache.JoinIndexCache()
    warm.get_or_prepare(topo, right, rc, [0]).release()

    def broken_warmup(*a, **k):
        raise P.errors.KernelError("expand_values did not launch")

    monkeypatch.setattr(twarmup, "warmup_prepared_join", broken_warmup)
    with pytest.raises(P.errors.KernelError):
        tj.warmup_join_index(topo, warm, *side(P, topo, keys(64, 16)), [0])
    assert warm.stats()[warm.keys()[0]]["pins"] == 0
    warm.clear()
    monkeypatch.setenv("DJT_FLEET_DIR", str(tmp_path))

    def broken(*a, **k):
        raise P.errors.KernelError("join_scans did not launch")

    monkeypatch.setattr(tdist, "prepare_join_side", broken)
    cache = P.cache.JoinIndexCache()
    with pytest.raises(P.errors.KernelError):
        cache.get_or_prepare(topo, right, rc, [0])
    assert P.errors.pinned_tiers() == {} and cache.entry_count == 0
    assert not list((tmp_path / "leases").iterdir())  # the lease went back


def test_chip_smoke_index_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase 14 at 20,000 rows on CPU tables, every check
    as on the card (the card's calls stubbed, the kernel wrappers
    counting their plain calls; the allocator's checks run on the card
    only)."""
    from test_torch_smoke_prepared import _dj, _main_path, cs as cs_fixture

    mp = pytest.MonkeyPatch()
    gen = cs_fixture.__wrapped__(mp)
    cs = next(gen)
    try:
        dj = _dj()
        rows = 20_000
        _, build, probe, expected, topo, left, lcnt, right, rcnt, ref = _main_path(cs, dj, rows)
        one, world = cs.run_index_cache(dj, "cpu", topo, left, lcnt, right, rcnt, build, probe,
                                        expected, ref, rows, 0.0,
                                        {(1, t): 0.0 for t in cs.TIERS}, "cpu")
        cs.check_no_pins("14")
    finally:
        gen.close()
        mp.undo()
    assert one["index_prepared_merge"][1]["merge_sorted_u64"] == 1
    assert one["index_append_probe"][4]["expand_ranks"] == 4
    assert one["index_fleet_degraded_sort"][1]["join_scans"] == 1
    assert world["index_world_sort"][1]["join_scans"] == cs.WORLD
    assert world["index_world_plan_shuffle"][1]["expand_values"] == cs.WORLD
    out = capsys.readouterr().out
    for case in ("(a)", "(b)", "(c)", "(d)", "(e)", "(f)"):
        assert f'"case": "{case}"' in out, case
    assert "[index_cache_phase]" in out

"""dj_tpu_torch's fleet coordination against dj_tpu's, call for call.

Each case is one scenario run through both packages (``Pkg`` of
``test_torch_index_cache.py``): dj_tpu's in a module fixture, the port's in
the test, each in a fresh directory under the same knobs (``DJ_*`` and
``DJT_*``). Compared are the outcomes, the ``fleet``, ``degrade`` and
``drain`` events and the counters, pids read as "ours", "a live peer" or
"dead". The cases follow dj_tpu's ``tests/test_fleet.py``: the lease
(exclusive, a stale lease of a dead owner reclaimed, a live owner never,
the heartbeat, racers of which exactly one wins); each ``fleet.*`` fault
degrading and pinning the ladder's ``fleet`` tier; the ledger's consult
refreshing on a miss under fleet mode; the prepare gate's defer, replay
and build, the replay config of a dead owner and the whole front door; the
budget rows and ``peer_bytes``; SIGTERM draining, withdrawing the row and
chaining to the handler installed before; ``snapshot`` and the tenant
weights. The port's own: ``append_line`` from two processes that import no
JAX interleaving whole lines, two such processes racing one lease, the
drain registry the scheduler joins, and the same kernel launches and
collectives with the fleet on and off (dj_tpu holds its compiled modules
equal there, ``test_fleet.py:745``; the port compiles none). The
scheduler's cases (``test_fleet.py:536``, ``:575``, ``:616``, ``:644``,
``:681``) run in ``test_torch_serve.py``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from test_torch_index_cache import Pkg, keys, norm, query, side
import dj_tpu_torch as tj
from dj_tpu_torch import knobs

HOST = socket.gethostname()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENTS = ("fleet", "degrade", "drain", "index")


def _dead_pid() -> int:
    p = subprocess.Popen(["sleep", "0"])
    p.wait()
    return p.pid


def _live_child():
    return subprocess.Popen(["sleep", "30"])


def _events(P) -> list:
    """The fleet's, the ladder's, the drain's and the cache's events,
    with the measured seconds read as bounds and pids as roles."""
    out = []
    for e in P.recorded(EVENTS):
        e = dict(e)
        if "age_s" in e:
            e["age_s"] = e["age_s"] > 0.2
        if "waited_s" in e:
            e["waited_s"] = round(e["waited_s"], 2)
        for k in ("pid", "dead_pid"):
            if k in e:
                e[k] = "ours" if e[k] == os.getpid() else "other"
        if "key" in e and isinstance(e["key"], str):
            e["key"] = e["key"].split("|")[0]
        out.append(e)
    return out


def _pins(P) -> dict:
    return {t: r.replace("DJT_", "DJ_") for t, r in P.errors.pinned_tiers().items()}


# --- the scenarios --------------------------------------------------------


def lease_exclusive(P, d):
    os.environ[P.env("FLEET_DIR")] = d
    lease = P.leases.acquire("prepare|t|n|sig1")
    payload = json.loads(open(lease.path).read())
    t0 = time.monotonic()
    contender = P.leases.acquire("prepare|t|n|sig1", wait_s=0.15)
    waited = time.monotonic() - t0
    out = {"held": os.path.exists(lease.path), "payload": [payload["pid"] == os.getpid(),
                                                          payload["host"] == HOST],
           "contender": contender, "waited": waited >= 0.14}
    lease.release()
    out["released"] = not os.path.exists(lease.path)
    lease.release()
    with P.leases.acquire("prepare|t|n|sig1") as again:
        out["again"] = [again is not None, again.reclaimed]
    out["again_released"] = not os.path.exists(again.path)
    out["events"] = _events(P)
    return out


def _stale_file(P, key, pid, age_s=60):
    path = P.leases.lease_path(key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"pid": pid, "host": HOST, "key": key}))
    old = time.time() - age_s
    os.utime(path, (old, old))
    return path


def lease_reclaim(P, d):
    """A stale lease of a dead owner is reclaimed; a live owner's is not;
    two in-process racers on a stale lease: one reclaim, one holder; the
    heartbeat refreshes the mtime."""
    os.environ[P.env("FLEET_DIR")] = d
    os.environ[P.env("FLEET_LEASE_TTL_S")] = "0.2"
    path = _stale_file(P, "k", _dead_pid())
    lease = P.leases.acquire("k", wait_s=1.0)
    out = {"reclaimed": [lease is not None, lease.reclaimed],
           "owner_now_ours": json.loads(open(path).read())["pid"] == os.getpid(),
           "counter": P.obs.counter_value("dj_fleet_lease_reclaimed_total")}
    lease.release()
    os.environ[P.env("FLEET_LEASE_TTL_S")] = "0.1"
    child = _live_child()
    try:
        path = _stale_file(P, "live", child.pid)
        out["live_owner"] = P.leases.acquire("live", wait_s=0.3)
        out["live_untouched"] = json.loads(open(path).read())["pid"] == child.pid
    finally:
        child.kill()
        child.wait()
    _stale_file(P, "race", _dead_pid())
    results = [None, None]

    def racer(i):
        results[i] = P.leases.acquire("race", wait_s=0.5, poll_s=0.01)

    threads = [threading.Thread(target=racer, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    held = [r for r in results if r is not None]
    out["racers_held"] = len(held)
    for r in held:
        r.release()
    with P.leases.acquire("hb") as hb:
        old = time.time() - 60
        os.utime(hb.path, (old, old))
        hb.heartbeat()
        out["heartbeat"] = time.time() - os.stat(hb.path).st_mtime < 5
    out["counter_after"] = P.obs.counter_value("dj_fleet_lease_reclaimed_total")
    out["events"] = [e for e in _events(P) if e.get("action") != "lease_wait_expired"]
    return out


def faults(P, d):
    """Each fleet.* site degrades through the fleet tier: the knob pinned
    empty, the caller process-local, no raise and no deadlock."""
    out = {}
    os.environ[P.env("FLEET_DIR")] = d
    os.environ[P.env("FAULT")] = "fleet.publish@call=1"
    P.fleet.publish_guarded(100.0, 50.0)
    out["publish"] = [_pins(P), os.environ[P.env("FLEET_DIR")], P.fleet.enabled(),
                      P.fleet.peer_bytes_guarded()]
    P.errors.reset_pins()
    P.faults.reset()
    os.environ[P.env("FAULT")] = "fleet.lease_acquire@call=1"
    t0 = time.monotonic()
    got = P.fleet.guarded("test_gate", lambda: P.leases.acquire("k", wait_s=0.2)
                          if P.fleet.enabled() else None)
    out["acquire"] = [got, time.monotonic() - t0 < 5.0, _pins(P), P.fleet.enabled()]
    P.errors.reset_pins()
    P.faults.reset()
    os.environ.pop(P.env("FAULT"))
    lease = P.leases.acquire("k")
    os.environ[P.env("FAULT")] = "fleet.lease_heartbeat@call=1"
    P.fleet.guarded("test_hb", lambda: lease.heartbeat() if P.fleet.enabled() else None)
    out["heartbeat"] = _pins(P)
    lease.release()
    P.errors.reset_pins()
    P.faults.reset()
    os.environ[P.env("FAULT")] = "fleet.lease_acquire@call=1"
    cache = P.cache.JoinIndexCache()
    gate = P.fleet.guarded("index_fleet_gate",
                           lambda: cache._fleet_prepare_gate("t", "n", "sig"))
    out["gate"] = [list(gate), _pins(P)]
    out["degraded"] = P.obs.counter_value("dj_degrade_total", tier="fleet")
    out["events"] = _events(P)
    return out


def ledger_refresh(P, d):
    led = os.path.join(d, "ledger.jsonl")
    os.environ[P.env("LEDGER")] = led
    sig = "join|w=4,test=1"
    out = {"first": P.ledger.consult(sig)}
    P.ledger.append_line(led, {"sig": sig, "factors": {"bucket_factor": 8.0}})
    out["stale"] = P.ledger.consult(sig)
    os.environ[P.env("FLEET_DIR")] = d
    out["refreshed"] = P.ledger.consult(sig)
    out["counters"] = [P.obs.counter_value("dj_ledger_miss_total"),
                       P.obs.counter_value("dj_ledger_hit_total")]
    return out


def _manifest_rec(pid, sig="sigX", **extra):
    rec = {"op": "insert", "tenant": "t", "name": "n", "sig": sig,
           "key_range": [[0, 999]], "factors": {"bucket_factor": 6.0}, "odf": 2, "on": [0],
           "left_capacity": 64, "pid": pid, "host": HOST}
    rec.update(extra)
    return rec


def gate_triage(P, d):
    os.environ[P.env("FLEET_DIR")] = d
    manifest = os.path.join(d, "manifest.jsonl")
    cache = P.cache.JoinIndexCache(P.cache.IndexConfig(manifest_path=manifest))
    action, lease = cache._fleet_prepare_gate("t", "n", "sigX")
    out = {"empty": [action, lease is not None]}
    lease.release()
    child = _live_child()
    try:
        P.ledger.append_line(manifest, _manifest_rec(child.pid))
        action, rec = cache._fleet_prepare_gate("t", "n", "sigX")
        out["live_peer"] = [action, rec["pid"] == child.pid,
                            os.path.exists(P.leases.lease_path("prepare|t|n|sigX"))]
    finally:
        child.kill()
        child.wait()
    with open(manifest, "w") as f:
        f.write(json.dumps(_manifest_rec(_dead_pid())) + "\n")
    action, (lease, rec) = cache._fleet_prepare_gate("t", "n", "sigX")
    out["dead_owner"] = [action, lease is not None, rec["factors"]]
    lease.release()
    with open(manifest, "w") as f:
        f.write(json.dumps(_manifest_rec(os.getpid())) + "\n")
    action, (lease, rec) = cache._fleet_prepare_gate("t", "n", "sigX")
    out["own_record"] = [action, lease is not None]
    lease.release()
    P.ledger.append_line(manifest, {"op": "evict", "tenant": "t", "name": "n", "sig": "sigX"})
    action, lease = cache._fleet_prepare_gate("t", "n", "sigX")
    out["tombstoned"] = [action, lease is not None]
    lease.release()
    cfg = P.m.JoinConfig()
    rec = _manifest_rec(123, odf=4)
    c, kr, lcap = P.cache.JoinIndexCache._fleet_replay_config(cfg, rec, None, None)
    out["replay_config"] = [c.bucket_factor, c.over_decom_factor, kr, lcap]
    c, kr, lcap = P.cache.JoinIndexCache._fleet_replay_config(cfg, rec, ((5, 7),), 32)
    out["caller_wins"] = [kr, lcap]
    return out


def front_door(P, d):
    """Worker A builds and stamps the manifest with its pid and host,
    releasing the lease after the line; a second cache defers to a live
    owner (typed), a third replays a dead owner's record."""
    os.environ[P.env("FLEET_DIR")] = d
    manifest = os.path.join(d, "manifest.jsonl")
    topo = P.make_topology(4)
    n = 256
    right, rc = side(P, topo, keys(n, 5, hi=999))
    left, lc = side(P, topo, keys(n, 6, hi=999))
    cfg = P.m.JoinConfig(key_range=(0, 999))
    cache_a = P.cache.JoinIndexCache(P.cache.IndexConfig(manifest_path=manifest))
    with cache_a.get_or_prepare(topo, right, rc, [0], cfg, tenant="t", name="n",
                                left_capacity=n) as la:
        first = query(P, topo, left, lc, la.prepared, cfg)
    recs = [json.loads(x) for x in open(manifest)]
    out = {"stamp": [recs[-1]["pid"] == os.getpid(), recs[-1]["host"] == HOST],
           "leases_left": os.listdir(os.path.join(d, "leases"))}

    def rewrite(pid):
        with open(manifest, "w") as f:
            f.write(json.dumps(dict(recs[-1], pid=pid)) + "\n")

    child = _live_child()
    try:
        rewrite(child.pid)
        cache_b = P.cache.JoinIndexCache(P.cache.IndexConfig(manifest_path=manifest))
        try:
            cache_b.get_or_prepare(topo, right, rc, [0], cfg, tenant="t", name="n",
                                   left_capacity=n)
            out["deferred"] = None
        except P.errors.AdmissionRejected as e:
            out["deferred"] = ["fleet peer" in str(e), e.signature is not None]
    finally:
        child.kill()
        child.wait()
    rewrite(_dead_pid())
    cache_c = P.cache.JoinIndexCache(P.cache.IndexConfig(manifest_path=manifest))
    with cache_c.get_or_prepare(topo, right, rc, [0], cfg, tenant="t", name="n",
                                left_capacity=n) as lc_:
        out["replayed_range"] = lc_.prepared.key_range
        out["rows_equal"] = query(P, topo, left, lc, lc_.prepared, cfg) == first
    out["counters"] = [P.obs.counter_value(n) for n in
                       ("dj_fleet_peer_defer_total", "dj_fleet_replay_total",
                        "dj_index_miss_total", "dj_index_hit_total")]
    out["events"] = _events(P)
    return out


def budget_rows(P, d):
    os.environ[P.env("FLEET_DIR")] = d
    P.budget.publish(100.0, 50.0)
    rows = P.budget.rows_snapshot()
    out = {"own": [len(rows), rows[0]["pid"] == os.getpid()],
           "own_not_charged": P.budget.peer_bytes()}
    child = _live_child()
    try:
        peer = os.path.join(d, "budget", f"{child.pid}.json")

        def write(ts):
            with open(peer, "w") as f:
                f.write(json.dumps({"pid": child.pid, "host": HOST, "reserved_bytes": 1000.0,
                                    "index_bytes": 500.0, "ts": round(ts, 3)}))

        write(time.time())
        out["live_peer"] = P.budget.peer_bytes()
        os.environ[P.env("FLEET_LEASE_TTL_S")] = "2.0"
        write(time.time() - 60)
        out["stale_peer"] = P.budget.peer_bytes()
    finally:
        child.kill()
        child.wait()
    pid = _dead_pid()
    dead = os.path.join(d, "budget", f"{pid}.json")
    with open(dead, "w") as f:
        f.write(json.dumps({"pid": pid, "host": HOST, "reserved_bytes": 7.0,
                            "index_bytes": 0.0, "ts": round(time.time(), 3)}))
    out["dead"] = [P.budget.peer_bytes(), os.path.exists(dead)]
    P.budget.withdraw()
    out["withdrawn"] = P.budget.rows_snapshot()
    out["events"] = _events(P)
    return out


def sigterm(P, d):
    os.environ[P.env("FLEET_DIR")] = d
    os.environ[P.env("FLEET_DRAIN_GRACE_S")] = "0.5"
    P.budget.publish(100.0, 0.0)
    out = {"rows": len(P.budget.rows_snapshot())}
    hits = []
    orig = signal.signal(signal.SIGTERM, lambda s, f: hits.append("prev"))
    try:
        out["installed"] = P.drain.install()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not hits and time.monotonic() < deadline:
            time.sleep(0.01)
        out["chained"] = hits
        out["draining"] = P.drain.draining()
        out["rows_after"] = P.budget.rows_snapshot()
        out["gauge"] = P.obs.gauge_value("dj_fleet_draining")
    finally:
        P.drain.uninstall()
        signal.signal(signal.SIGTERM, orig)
    out["events"] = [{k: v for k, v in e.items() if k != "grace_s"} for e in _events(P)]
    return out


def snapshot(P, d):
    out = {"off": P.fleet.snapshot()}
    out["off"] = [out["off"]["enabled"], out["off"]["draining"], out["off"]["dir"]]
    os.environ[P.env("FLEET_DIR")] = d
    os.environ[P.env("FLEET_TENANT_WEIGHTS")] = "a:2,b:1"
    P.budget.publish(10.0, 5.0)
    snap = P.fleet.snapshot()
    out["on"] = [snap["enabled"], snap["dir"] == d, snap["tenant_weights"],
                 len(snap["budget_rows"]), snap["pid"] == os.getpid()]
    os.environ.pop(P.env("FLEET_TENANT_WEIGHTS"))
    out["no_weights"] = P.fleet.tenant_weights()
    os.environ[P.env("FLEET_TENANT_WEIGHTS")] = "a:2, b:1.5,c,:9,bad:x,d:0"
    out["weights"] = P.fleet.tenant_weights()
    return out


CASES = {"lease_exclusive": lease_exclusive, "lease_reclaim": lease_reclaim,
         "faults": faults, "ledger_refresh": ledger_refresh, "gate_triage": gate_triage,
         "front_door": front_door, "budget_rows": budget_rows, "sigterm": sigterm,
         "snapshot": snapshot}


def _env_names() -> list:
    names = list(knobs.reset_names())
    return names + [n.replace("DJT_", "DJ_") for n in names]


def run_case(P, name, d):
    saved = {n: os.environ.get(n) for n in _env_names()}
    for n in saved:
        os.environ.pop(n, None)
    P.reset()
    try:
        return norm(CASES[name](P, str(d)))
    finally:
        P.reset()
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    P = Pkg("jax")
    was = P.obs.enabled()
    try:
        return {name: run_case(P, name, tmp_path_factory.mktemp(f"jax_{name}"))
                for name in CASES}
    finally:
        P.obs.reset(reenable=was)


@pytest.fixture
def port(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    P = Pkg("torch")
    was = P.obs.enabled()
    yield P
    P.reset()
    P.obs.reset(reenable=was)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(CASES))
def test_the_fleet_matches_dj_tpu(name, jax_runs, port, tmp_path):
    assert run_case(port, name, tmp_path) == jax_runs[name]


def test_the_scenarios_check_what_they_claim(jax_runs):
    """dj_tpu's side reads as its own tests assert."""
    r = jax_runs
    le = r["lease_exclusive"]
    assert le["held"] and le["payload"] == [True, True] and le["contender"] is None
    assert le["waited"] and le["released"] and le["again"] == [True, False]
    assert [e["action"] for e in le["events"]] == ["lease_wait_expired"]
    lr = r["lease_reclaim"]
    assert lr["reclaimed"] == [True, True] and lr["owner_now_ours"] and lr["counter"] == 1
    assert lr["live_owner"] is None and lr["live_untouched"]
    assert lr["racers_held"] == 1 and lr["heartbeat"] and lr["counter_after"] == 2
    f = r["faults"]
    assert f["publish"] == [{"fleet": f["publish"][0]["fleet"]}, "", False, 0.0]
    assert f["acquire"][0] is None and f["acquire"][1] and not f["acquire"][3]
    assert "fleet" in f["heartbeat"] and f["gate"][0] == ["build", None]
    assert f["degraded"] == 4  # one pin in each of the four steps
    lf = r["ledger_refresh"]
    assert lf["first"] is None and lf["stale"] is None
    assert lf["refreshed"]["factors"]["bucket_factor"] == 8.0
    g = r["gate_triage"]
    assert g["empty"] == ["build", True] and g["live_peer"] == ["defer", True, False]
    assert g["dead_owner"] == ["replay", True, {"bucket_factor": 6.0}]
    assert g["own_record"] == ["replay", True] and g["tombstoned"] == ["build", True]
    assert g["replay_config"] == [6.0, 4, [[0, 999]], 64]
    fd = r["front_door"]
    assert fd["stamp"] == [True, True] and fd["leases_left"] == []
    assert fd["deferred"] == [True, True] and fd["replayed_range"] == [[0, 999]]
    assert fd["rows_equal"] and fd["counters"][:2] == [1, 1]
    b = r["budget_rows"]
    assert b["own"] == [1, True] and b["own_not_charged"] == 0.0
    assert b["live_peer"] == 1500.0 and b["stale_peer"] == 0.0
    assert b["dead"] == [0.0, False] and b["withdrawn"] == []
    s = r["sigterm"]
    assert s["rows"] == 1 and s["chained"] == ["prev"] and s["draining"]
    assert s["rows_after"] == []
    sn = r["snapshot"]
    assert sn["off"] == [False, False, None]
    assert sn["on"] == [True, True, {"a": 2.0, "b": 1.0}, 1, True]
    assert sn["no_weights"] == {} and sn["weights"] == {"a": 2.0, "b": 1.5, "c": 1.0}


# --- the port's own -------------------------------------------------------

_APPEND_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[3])
from dj_tpu_torch.resilience import ledger
path, writer = sys.argv[1], sys.argv[2]
for i in range(1000):
    ledger.append_line(path, {"writer": writer, "i": i, "pad": "x" * 120})
print("jax" in sys.modules)
"""

_RACER_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[2])
os.environ["DJT_FLEET_DIR"] = sys.argv[1]
from dj_tpu_torch.fleet import leases
lease = leases.acquire("racekey", wait_s=0.6, poll_s=0.02)
if lease is not None:
    time.sleep(2.0)
    lease.release()
print(json.dumps({"won": lease is not None, "jax": "jax" in sys.modules}))
"""


def _children(script, argvs):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DJT_")}
    procs = [subprocess.Popen([sys.executable, "-c", script, *argv], env=env,
                              stdout=subprocess.PIPE, text=True) for argv in argvs]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0
        outs.append(out.strip().splitlines()[-1])
    return outs


def test_append_line_two_processes_interleave_whole_lines(tmp_path):
    """Two processes (no JAX loaded) append 1000 records each to one
    file: every line parses and every (writer, i) lands once."""
    path = tmp_path / "shared.jsonl"
    outs = _children(_APPEND_CHILD, [[str(path), w, REPO] for w in ("a", "b")])
    assert outs == ["False", "False"]
    lines = path.read_text().splitlines()
    assert len(lines) == 2000
    seen = set()
    for line in lines:
        rec = json.loads(line)
        assert rec["pad"] == "x" * 120
        seen.add((rec["writer"], rec["i"]))
    assert seen == {(w, i) for w in ("a", "b") for i in range(1000)}


def test_append_line_fsync_knob_and_broken_path(monkeypatch, tmp_path):
    from dj_tpu_torch.resilience import ledger

    calls = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd), real(fd))[1])
    p = tmp_path / "x.jsonl"
    ledger.append_line(str(p), {"k": 0})
    assert calls == []
    monkeypatch.setenv("DJT_LEDGER_FSYNC", "1")
    ledger.append_line(str(p), {"k": 1})
    assert len(calls) == 1
    assert [json.loads(x) for x in p.read_text().splitlines()] == [{"k": 0}, {"k": 1}]
    ledger.append_line(str(tmp_path / "no" / "dir.jsonl"), {"k": 2})  # never raises


def test_two_processes_race_one_lease_exactly_one_wins(tmp_path):
    outs = [json.loads(o) for o in _children(_RACER_CHILD, [[str(tmp_path), REPO]] * 2)]
    assert sum(o["won"] for o in outs) == 1 and not any(o["jax"] for o in outs)


class _Sched:
    def __init__(self):
        self.flipped = 0
        self.busy = True

    def drain(self):
        self.flipped += 1

    def drained(self):
        return not self.busy


def test_the_drain_walks_the_schedulers_that_registered(port):
    """The registry the query scheduler joins: begin flips each registered
    door once, wait_quiesced waits (bounded) for each to drain, and a
    scheduler registered while the process drains is flipped at once."""
    P = port
    P.reset()
    a = _Sched()
    P.drain.register(a)
    assert P.drain.begin(reason="test") == [a] and a.flipped == 1
    assert not P.drain.wait_quiesced(0.05, poll_s=0.01)
    a.busy = False
    assert P.drain.wait_quiesced(1.0)
    b = _Sched()
    P.drain.register(b)
    assert b.flipped == 1 and P.drain.draining()
    begins = [e for e in P.recorded(("drain",)) if e["phase"] == "begin"]
    assert len(begins) == 1 and begins[0]["schedulers"] == 1
    P.fleet.reset()
    assert not P.drain.draining()


def test_launches_and_collectives_equal_with_the_fleet_on_and_off(port, tmp_path,
                                                                  monkeypatch):
    """Coordination is host-side file I/O: a cached side's miss and its
    query issue the same kernel calls and collectives with
    ``DJT_FLEET_DIR`` armed as without (dj_tpu's module-equality guard,
    ``test_fleet.py:745``, in the port's terms)."""
    from dj_tpu_torch.ops import join as tjoin
    from dj_tpu_torch.parallel.communicator import InProcessTransport

    calls = {}
    for name in ("join_scans", "expand_values", "expand_ranks", "merge_sorted_u64"):
        real = getattr(tjoin, name)
        monkeypatch.setattr(tjoin, name, lambda *a, _n=name, _r=real, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _r(*a, **k))[1])
    for name in ("all_to_all_start", "all_gather", "all_reduce"):
        real = getattr(InProcessTransport, name)
        monkeypatch.setattr(InProcessTransport, name, lambda self, *a, _n=name, _r=real, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _r(self, *a, **k))[1])
    P = port
    topo = P.make_topology(4)
    right, rc = side(P, topo, keys(512, 20))
    left, lc = side(P, topo, keys(512, 21))
    cfg = tj.JoinConfig(join_out_factor=4.0)

    def run():
        calls.clear()
        P.reset()
        cache = P.cache.JoinIndexCache(P.cache.IndexConfig(
            manifest_path=str(tmp_path / "m.jsonl")))
        with cache.get_or_prepare(topo, right, rc, [0], cfg, left_capacity=512) as lease:
            rows = query(P, topo, left, lc, lease.prepared, cfg)
        cache.clear()
        return dict(calls), rows

    off = run()
    monkeypatch.setenv("DJT_FLEET_DIR", str(tmp_path / "fleet"))
    on = run()
    assert on == off and off[0]["join_scans"] >= 1 and off[0]["all_to_all_start"] >= 1
    assert os.listdir(tmp_path / "fleet" / "leases") == []

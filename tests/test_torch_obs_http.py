"""dj_tpu_torch.obs.http (the DJT_OBS_HTTP endpoint) against dj_tpu's.

The same state is driven through both packages (a counter, a gauge, a
served latency, a tenant's wire bytes, one query timeline, two history
samples, a two-rank fleet with a straggler), both servers run on
loopback at ephemeral ports, and every route is scraped from both:
status codes, content types and payloads must be equal, apart from
timing (``ts``, ``dur``, ``epoch_ts``), the ring's ``seq``, the bound port, the registry's
HELP text (it names its package), the root line (likewise), the live
schedulers `/healthz` lists (each package's, left by earlier tests), the knob
names (``DJ_*`` against ``DJT_*``) and the roofline's peaks and phase
set (the port's own). The cases follow dj_tpu's
``tests/test_fleet_obs.py`` (``:206`` /tracez, ``:320`` /fleetz,
``:351`` the ephemeral port, ``:373`` and ``:395`` /profilez),
``tests/test_trace.py`` (``:179`` the routes, ``:225`` the env gate,
the scrape half of ``:253``) and ``tests/test_truth.py:575`` (the
sampler under the server). Then the bootstrap hooks and a CPU
rehearsal of chip_smoke's phase 16.
"""

import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import dj_tpu.obs as jobs
import dj_tpu_torch as tj
import dj_tpu_torch.obs as tobs
from dj_tpu.obs import fleet as jfleet
from dj_tpu.obs import history as jhist
from dj_tpu.obs import http as jhttp
from dj_tpu_torch import knobs
from dj_tpu_torch.obs import fleet as tfleet
from dj_tpu_torch.obs import forensics as tforensics
from dj_tpu_torch.obs import history as thist
from dj_tpu_torch.obs import http as thttp

PKGS = {"dj_tpu": (jobs, jhttp, jhist, jfleet, "DJ_"),
        "dj_tpu_torch": (tobs, thttp, thist, tfleet, "DJT_")}
ROUTES = ("/", "/metrics", "/healthz", "/queryz", "/queryz?n=0", "/varz", "/skewz",
          "/rooflinez", "/tenantz", "/trendz?n=8", "/knobz", "/tunez", "/tracez?q=q-http",
          "/tracez?q=q-http&format=perfetto", "/fleetz", "/profilez", "/tracez",
          "/tracez?q=q-http&format=xml", "/tracez?q=no-such-query", "/nope",
          "/queryz?n=junk", "/skewz?n=-1", "/trendz?n=junk", "/profilez?secs=abc")
# Timing, and the ring's sequence numbers (they count what the process
# recorded before the test).
VOLATILE = frozenset({"ts", "dur", "epoch_ts", "seconds", "seq"})
_PROM = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")


@pytest.fixture
def both(monkeypatch):
    """Both packages' obs on with a clean registry, ring, history and
    anomaly window, on one torch thread; every server and sampler
    stopped after, whatever the test did."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    was = {k: p[0].enabled() for k, p in PKGS.items()}
    for obs, http, hist, fleet, _ in PKGS.values():
        http.stop()
        obs.reset(reenable=True)
        obs.drain()
    yield monkeypatch
    for k, (obs, http, hist, fleet, _) in PKGS.items():
        http.stop()
        hist.stop()
        obs.reset(reenable=was[k])
        obs.drain()
    torch.set_num_threads(threads)
    assert not [t for t in threading.enumerate()
                if t.name in ("dj-obs-http", "dj-obs-history") and t.is_alive()]


def _get(url):
    """(status, content type, body) of a GET, errors included."""
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _setenv(mp, **kv):
    for *_, prefix in PKGS.values():
        for k, v in kv.items():
            mp.setenv(prefix + k, str(v))


def _drive(obs, hist, fleet):
    obs.inc("t_endpoint_total", kind="x")
    obs.set_gauge("t_endpoint_gauge", 2.5)
    obs.observe("dj_serve_latency_seconds", 0.12, tenant="tA", outcome="result")
    obs.inc("dj_tenant_wire_bytes_total", 256, tenant="tR")
    with obs.query_ctx("q-http", "tA"):
        with obs.span("query"):
            obs.record("t_mark")
    hist.sample_now(now=1.0)
    hist.sample_now(now=2.0)
    for v in ((0.0, 0.0), (1.0, 10.0)):
        fleet.note_snapshot({"ranks": [{"rank": r, "phase_seconds": {"join": x},
                                        "wire_total_bytes": 0.0} for r, x in enumerate(v)]})


def _untimed(v):
    if isinstance(v, dict):
        return {k: _untimed(x) for k, x in v.items() if k not in VOLATILE}
    if isinstance(v, list):
        return [_untimed(x) for x in v]
    return v


def _norm(route, pkg, port, body):
    """A route's body with what differs by design taken out (module
    docstring)."""
    if route == "/":
        return body.replace(pkg, "<pkg>")
    if route == "/metrics":
        return [ln.replace(f"dj_obs_http_port {port}", "dj_obs_http_port <port>")
                for ln in body.splitlines() if not ln.startswith("# HELP")]
    try:
        payload = json.loads(body)
    except ValueError:
        return body.replace("DJT_", "DJ_")
    if route == "/varz":
        payload["gauges"]["dj_obs_http_port"] = "<port>"
    if route == "/healthz":
        payload["schedulers"] = "<live schedulers>"
    if route == "/rooflinez":
        return {k: sorted(v) for k, v in payload.items()}
    if route == "/knobz":
        # dj_tpu's deprecated aliases and trace-env cache key have no
        # counterpart (dj_tpu_torch/knobs.py's docstring).
        return sorted({k for row in payload["knobs"] for k in row}
                      - {"aliases", "alias_used", "env_key"})
    return _untimed(payload)


def _scrape_both(routes=ROUTES):
    got = {}
    for pkg, (obs, http, hist, fleet, _) in PKGS.items():
        host, port = http.start(0)
        try:
            got[pkg] = {r: _get(f"http://{host}:{port}{r}") for r in routes}
        finally:
            http.stop()
        got[pkg] = {r: (c, t, _norm(r.split("?")[0], pkg, port, b))
                    for r, (c, t, b) in got[pkg].items()}
    return got["dj_tpu"], got["dj_tpu_torch"]


def test_every_route_matches_dj_tpu(both):
    for obs, http, hist, fleet, _ in PKGS.values():
        _drive(obs, hist, fleet)
    j, t = _scrape_both()
    assert {r: v[:2] for r, v in t.items()} == {r: v[:2] for r, v in j.items()}
    for r in ROUTES:
        assert t[r] == j[r], r
    codes = {r: v[0] for r, v in t.items()}
    assert codes["/tracez"] == codes["/queryz?n=junk"] == codes["/profilez"] == 400
    assert codes["/nope"] == codes["/tracez?q=no-such-query"] == 404
    assert t["/queryz?n=0"][2] == {"traces": []}
    health = t["/healthz"][2]
    assert health["ok"] and health["history_snapshots"] == 2 and health["device_hbm"] is None
    assert t["/fleetz"][2]["anomalous"] == [[1, "join"]]


def test_knobz_matches_dj_tpu_knob_for_knob(both):
    """Each observatory knob of /knobz carries dj_tpu's kind, default,
    cleanup class and parsed value; a malformed number is flagged and
    runs the default."""
    _setenv(both, SLO_BURN_RATE="oops", OBS_HISTORY="64")
    rows = {}
    for pkg, (obs, http, hist, fleet, prefix) in PKGS.items():
        host, port = http.start(0)
        try:
            _, _, body = _get(f"http://{host}:{port}/knobz")
        finally:
            http.stop()
        rows[pkg] = {k["name"][len(prefix):]: k for k in json.loads(body)["knobs"]}
    names = ("OBS_HISTORY", "OBS_HISTORY_S", "SLO_BURN_RATE", "SLO_BURN_FAST_S",
             "SLO_BURN_SLOW_S", "OBS_ANOMALY_WINDOW", "OBS_ANOMALY_RATIO", "OBS_ANOMALY_Z",
             "OBS_HTTP", "OBS_HTTP_HOST", "OBS_PROFILE_DIR", "OBS_BLACKBOX",
             "OBS_BLACKBOX_TRACES")
    keys = ("kind", "default", "cleanup", "set", "raw", "effective", "malformed")
    for n in names:
        assert {k: rows["dj_tpu_torch"][n][k] for k in keys} == \
            {k: rows["dj_tpu"][n][k] for k in keys}, n
    assert rows["dj_tpu_torch"]["SLO_BURN_RATE"]["malformed"] is True
    assert rows["dj_tpu_torch"]["OBS_HISTORY"]["effective"] == 64


def test_tracez_both_formats_and_errors_match_dj_tpu(both):
    for obs, http, hist, fleet, _ in PKGS.values():
        with obs.query_ctx("0:q1-7", "tT"):
            obs.span_begin("query")
            obs.record("admission", decision="admit")
            obs.span_end("query", outcome="result")
    routes = ("/tracez?q=0:q1-7", "/tracez?q=0:q1-7&format=perfetto", "/tracez",
              "/tracez?q=0:q1-7&format=xml", "/tracez?q=no-such-query")
    j, t = _scrape_both(routes)
    assert t == j
    assert t[routes[0]][0] == 200 and t[routes[1]][2]["metadata"]["format"] == "perfetto"
    assert t[routes[2]][0] == 400 and "q is required" in t[routes[2]][2]
    assert t[routes[3]][0] == 400 and "unknown export format" in t[routes[3]][2]
    assert t[routes[4]][0] == 404 and "no-such-query" in t[routes[4]][2]
    assert json.loads(_get_once("/tracez?q=0:q1-7")) == tobs.export_trace("0:q1-7")


def _get_once(route):
    host, port = thttp.start(0)
    try:
        return _get(f"http://{host}:{port}{route}")[2]
    finally:
        thttp.stop()


def test_fleetz_matches_dj_tpu(both):
    _setenv(both, OBS_ANOMALY_WINDOW=4)
    for obs, http, hist, fleet, _ in PKGS.values():
        _drive(obs, hist, fleet)
    j, t = _scrape_both(("/fleetz", "/"))
    assert t == j
    payload = t["/fleetz"][2]
    assert payload["window"]["capacity"] == 4 and payload["window"]["stored"] >= 2
    assert payload["thresholds"] == {"ratio": 2.0, "z": 2.0}
    assert [1, "join"] in payload["anomalous"] and payload["fleet"]["ranks"]
    for route in ("/tracez", "/fleetz", "/profilez"):
        assert route in t["/"][2]


def test_ephemeral_port_from_env_matches_dj_tpu(both):
    got = []
    for pkg, (obs, http, hist, fleet, prefix) in PKGS.items():
        both.setenv(prefix + "OBS_HTTP", "0")
        try:
            host, port = http.maybe_start_from_env()
            assert port > 0 and obs.gauge_value("dj_obs_http_port") == port
            (ev,) = obs.events("obs_http")
            code, _, body = _get(f"http://{host}:{port}/healthz")
            got.append((ev["port"] == port, ev["requested"], code, json.loads(body)["ok"]))
        finally:
            http.stop()
    assert got[1] == got[0] == (True, 0, 200, True)


def test_env_gate_and_a_bind_failure_match_dj_tpu(both):
    got = []
    for pkg, (obs, http, hist, fleet, prefix) in PKGS.items():
        both.delenv(prefix + "OBS_HTTP", raising=False)
        unset = http.maybe_start_from_env()
        both.setenv(prefix + "OBS_HTTP", "not-a-port")
        malformed = http.maybe_start_from_env()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            s.listen(1)
            both.setenv(prefix + "OBS_HTTP", str(s.getsockname()[1]))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                busy = http.maybe_start_from_env()
        warned = [str(w.message) for w in caught]
        mirrored = [e["name"] for e in obs.events("warning")]
        got.append((unset, malformed, busy, http.server_address(), len(warned), mirrored))
        assert warned and f"{prefix}OBS_HTTP=" in warned[0]
    assert got[1] == got[0] == (None, None, None, None, 1, ["obs_http_bind_failed"])


def test_routes_and_lifecycle_as_dj_tpu_test_trace(both):
    """dj_tpu's tests/test_trace.py:179 on the port: the scrapes, the
    idempotent start, server_address, stop and a second stop."""
    obs = tobs
    obs.inc("t_endpoint_total", kind="x")
    obs.set_gauge("t_endpoint_gauge", 2.5)
    obs.observe("dj_serve_latency_seconds", 0.12, tenant="tA", outcome="result")
    with obs.query_ctx("q-http", "tA"):
        with obs.span("query"):
            obs.record("t_mark")
    host, port = thttp.start(0)
    try:
        base = f"http://{host}:{port}"
        code, ctype, text = _get(f"{base}/metrics")
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert all(_PROM.match(ln) for ln in text.splitlines() if ln and ln[0] != "#")
        assert "dj_serve_latency_seconds_bucket" in text
        assert 't_endpoint_total{kind="x"} 1' in text
        h = json.loads(_get(f"{base}/healthz")[2])
        assert h["ok"] and h["obs_enabled"] and "schedulers" in h and "pressure_level" in h
        traces = json.loads(_get(f"{base}/queryz?n=5")[2])["traces"]
        assert traces[-1]["query_id"] == "q-http" and traces[-1]["complete"]
        assert json.loads(_get(f"{base}/varz")[2])["gauges"]["t_endpoint_gauge"] == 2.5
        assert _get(f"{base}/nope")[0] == 404
        assert thttp.start(0) == (host, port)
        assert thttp.server_address() == (host, port)
    finally:
        thttp.stop()
    assert thttp.server_address() is None
    thttp.stop()


def test_a_failing_route_answers_500_with_its_type_in_both(both, monkeypatch):
    def boom():
        raise RuntimeError("scrape fault")

    got = []
    for pkg, (obs, http, hist, fleet, _) in PKGS.items():
        monkeypatch.setattr(http._truth, "tenant_summary", boom)
        host, port = http.start(0)
        try:
            got.append(_get(f"http://{host}:{port}/tenantz"))
        finally:
            http.stop()
    assert got[1] == got[0]
    assert got[1][0] == 500 and json.loads(got[1][2]) == {"ok": False, "error": "RuntimeError"}


def test_profilez_validation_and_busy_match_dj_tpu(both, tmp_path):
    got = []
    for pkg, (obs, http, hist, fleet, prefix) in PKGS.items():
        host, port = http.start(0)
        base = f"http://{host}:{port}"
        try:
            both.delenv(prefix + "OBS_PROFILE_DIR", raising=False)
            unset = _get(f"{base}/profilez?secs=1")
            both.setenv(prefix + "OBS_PROFILE_DIR", str(tmp_path / pkg))
            bad = [_get(f"{base}/profilez?secs={b}") for b in ("abc", "0", "-1", "601")]
            assert http._profile_busy.acquire(blocking=False)
            try:
                busy = _get(f"{base}/profilez?secs=1")
            finally:
                http._profile_busy.release()
        finally:
            http.stop()
        got.append([(c, t, b.replace(prefix, "<P>")) for c, t, b in [unset, *bad, busy]]
                   + [obs.events("profile")])
    assert got[1] == got[0]
    assert [g[0] for g in got[1][:6]] == [400, 400, 400, 400, 400, 409]
    assert "<P>OBS_PROFILE_DIR" in got[1][0][2] and json.loads(got[1][5][2])["busy"] is True


def test_profilez_takes_a_real_cpu_capture(both, tmp_path):
    """A real torch.profiler capture on the CPU: its Chrome trace lands in
    DJT_OBS_PROFILE_DIR and holds the ops a query ran on another thread
    while it ran; one capture counts dj_profile_captures_total."""
    both.setenv("DJT_OBS_PROFILE_DIR", str(tmp_path))
    host, port = thttp.start(0)
    try:
        code, _, body = _get(f"http://{host}:{port}/profilez?secs=0.5")
        assert code == 200, body
        started = json.loads(body)
        assert started["ok"] and started["dir"] == str(tmp_path) and started["secs"] == 0.5
        worker = threading.Thread(target=lambda: torch.sort(torch.arange(4096) % 97))
        worker.start()
        worker.join(timeout=30)
        deadline = time.monotonic() + 60
        while not [e for e in tobs.events("profile") if e["state"] != "started"]:
            assert time.monotonic() < deadline, "the capture never ended"
            time.sleep(0.05)
        for th in threading.enumerate():
            if th.name == "dj-obs-profile":
                th.join(timeout=30)
    finally:
        thttp.stop()
    assert [e["state"] for e in tobs.events("profile")] == ["started", "stopped"]
    assert tobs.counter_value("dj_profile_captures_total") == 1
    with open(started["path"]) as f:
        trace = json.load(f)
    assert any("sort" in str(e.get("name", "")) for e in trace["traceEvents"])


def test_a_profiler_refusal_answers_500(both, tmp_path, monkeypatch):
    """The profiler's own refusal is the route's 500, not a swallowed
    success, and frees the busy guard."""
    both.setenv("DJT_OBS_PROFILE_DIR", str(tmp_path))

    class Refuses:
        def __init__(self, *a, **k):
            raise RuntimeError("profiler already running")

    monkeypatch.setattr(torch.profiler, "profile", Refuses)
    host, port = thttp.start(0)
    try:
        code, _, body = _get(f"http://{host}:{port}/profilez?secs=1")
    finally:
        thttp.stop()
    assert code == 500
    assert json.loads(body) == {"ok": False, "error": "RuntimeError: profiler already running"}
    assert thttp._profile_busy.acquire(blocking=False)
    thttp._profile_busy.release()


def test_sampler_lifecycle_under_the_server_matches_dj_tpu(both):
    """dj_tpu's test_truth.py:575: the server starts the sampler and
    stops it; a sampler started before the server is its starter's."""
    got = []
    for pkg, (obs, http, hist, fleet, _) in PKGS.items():
        http.start(0)
        running = hist.trend_view(1)["sampler_running"]
        http.stop()
        after = hist.trend_view(1)["sampler_running"]
        own = hist.start()
        http.start(0)
        http.stop()
        kept = hist.trend_view(1)["sampler_running"]
        hist.stop()
        got.append((running, after, own, kept, hist.trend_view(1)["sampler_running"]))
    assert got[1] == got[0] == (True, False, True, True, False)


def test_served_scrape_parses_with_latency_buckets(both):
    """The scrape half of dj_tpu's test_trace.py:253 on the port's
    scheduler: a result, a queued deadline shed and a door reject, then
    /metrics parsed as Prometheus text with dj_serve_latency_seconds
    buckets and the SLO gauges."""
    rng = np.random.default_rng(0)
    topo = tj.make_topology(["cpu"])
    def table():
        keys = torch.from_numpy(rng.integers(0, 500, 512))
        return tj.Table((tj.Column(keys, tj.dtypes.int64),
                         tj.Column(torch.arange(512, dtype=torch.int64), tj.dtypes.int64)))

    left, lc = tj.shard_table(topo, table())
    right, rc = tj.shard_table(topo, table())
    cfg = tj.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    try:
        with tj.QueryScheduler(tj.ServeConfig(hbm_budget_bytes=50e6), worker=False) as s:
            r = s.submit(topo, left, lc, right, rc, [0], [0], cfg, tenant="tA").result(60)
            assert int(r[1].sum()) > 0
            t_dead = s.submit(topo, left, lc, right, rc, [0], [0], cfg, tenant="tA",
                              deadline_s=0.0)
            with pytest.raises(tj.DeadlineExceeded):
                t_dead.result(timeout=60)
            with pytest.raises(tj.AdmissionRejected):
                s.submit(topo, left, lc, right, rc, [0], [0],
                         tj.JoinConfig(join_out_factor=1e9), tenant="tA")
            host, port = thttp.start(0)
            try:
                code, _, text = _get(f"http://{host}:{port}/metrics")
            finally:
                thttp.stop()
    finally:
        tj.serve.reset()
    assert code == 200
    series = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            m = _PROM.match(ln)
            assert m, ln
            series[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    buckets = [k for k in series if k.startswith("dj_serve_latency_seconds_bucket")]
    assert buckets and any('outcome="result"' in k for k in buckets)
    assert any('outcome="DeadlineExceeded"' in k for k in buckets)
    assert any(k.startswith("dj_slo_deadline_hit_rate") for k in series)
    assert sum(v for k, v in series.items() if k.startswith("dj_serve_rejected_total")) == 1


def test_init_distributed_starts_the_endpoint_and_arms_the_box(both, tmp_path):
    """The bootstrap hooks: with DJT_OBS_HTTP=0 and DJT_OBS_BLACKBOX set,
    init_distributed (no coordinator: a world of one) starts the endpoint
    and arms the black box; with neither set it does neither."""
    both.delenv("DJT_OBS_HTTP", raising=False)
    both.delenv("DJT_OBS_BLACKBOX", raising=False)
    for v in ("DJT_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        both.delenv(v, raising=False)
    try:
        assert tj.init_distributed() is False
        assert thttp.server_address() is None and tforensics.armed_dir() is None
        both.setenv("DJT_OBS_HTTP", "0")
        both.setenv("DJT_OBS_BLACKBOX", str(tmp_path / "bb"))
        assert tj.init_distributed() is False
        host, port = thttp.server_address()
        assert port > 0 and tforensics.armed_dir() == str(tmp_path / "bb")
        assert _get(f"http://{host}:{port}/healthz")[0] == 200
    finally:
        thttp.stop()
        tforensics.disarm()


def test_chip_smoke_observatory_phase_rehearses_on_cpu(capsys):
    """chip_smoke's phase 16 at 20,000 rows on CPU tables, every check as
    on the card but the capture's kernel names (the card's calls stubbed,
    the kernel wrappers counting their plain calls, one fake device for
    the allocator's sample)."""
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
    mp.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    for name in knobs.reset_names():
        mp.delenv(name, raising=False)
    try:
        dj = _dj()
        rows = 20_000
        _, build, probe, expected, topo, left, lcnt, right, rcnt, ref = _main_path(cs, dj, rows)
        with cs.released("16"):
            one, world = cs.run_observatory(dj, "cpu", topo, left, lcnt, right, rcnt, build,
                                            probe, expected, ref, rows, "cpu")
        cs.check_no_pins("16")
    finally:
        gen.close()
        mp.undo()
        tj.serve.reset()
        tj.fleet.reset()
        tj.cache.reset()
    assert one["observatory_served"][1]["join_scans"] == 3
    assert one["observatory_profiled"][1]["merge_sorted_u64"] == 1
    assert world["observatory_fleet"][1]["expand_values"] == cs.WORLD
    out = capsys.readouterr().out
    for case in ("(a)", "(b)", "(c)", "(d)", "(e)"):
        assert f'"case": "{case}"' in out, case
    assert "[observatory_phase]" in out

"""dj_tpu_torch.obs.history against dj_tpu.obs.history, drive for drive.

The same serve-counter drive goes through both packages' registries,
under ``DJ_*`` and ``DJT_*`` knobs of the same values, and each
``sample_now(now=)`` gives equal snapshots (``now`` is given, so even
``ts`` and ``mono`` agree), apart from the live schedulers' SLO rates,
each package's own. Compared besides: the ``slo_alert`` events
(their ``seq`` and ``ts`` dropped), ``dj_slo_alert_total``, the views and
the sampler's lifecycle. The cases follow dj_tpu's
``tests/test_truth.py:419`` (the fast window fires before the slow one),
``:495`` (a no-op with obs off) and ``:588`` (the sampler under the
endpoint), plus the ring's capacity and its rebuild on a knob change and
the clamp after the counters reset mid-flight.
"""

import threading

import pytest

from dj_tpu.obs import history as jhist
from dj_tpu_torch.obs import history as thist

import dj_tpu.obs as jobs
import dj_tpu_torch.obs as tobs

PKGS = ((jobs, jhist, "DJ_"), (tobs, thist, "DJT_"))


@pytest.fixture
def both(monkeypatch):
    """Both packages' obs on with a clean registry, ring and history;
    restored after, with no sampler left running."""
    was = [o.enabled() for o, _, _ in PKGS]
    for o, h, _ in PKGS:
        o.reset(reenable=True)
        o.drain()
        h.reset()
    yield monkeypatch
    for (o, h, _), w in zip(PKGS, was):
        h.stop()
        h.reset()
        o.reset(reenable=w)
        o.drain()


def _setenv(mp, **kv):
    for k, v in kv.items():
        for _, _, prefix in PKGS:
            mp.setenv(prefix + k, str(v))


def _drive(obs, n, deadline=False, rejects=0, full=0):
    for _ in range(n):
        obs.inc("dj_serve_admitted_total")
        obs.observe("dj_serve_latency_seconds", 0.01, tenant="t",
                    outcome="DeadlineExceeded" if deadline else "result")
        if deadline:
            obs.inc("dj_serve_shed_total", reason="deadline_queued")
    for _ in range(rejects):
        obs.inc("dj_serve_rejected_total")
    for _ in range(full):
        obs.inc("dj_serve_shed_total", reason="queue_full")


def _alerts(obs):
    return [{k: v for k, v in e.items() if k not in ("seq", "ts")}
            for e in obs.events("slo_alert")]


def _series(obs):
    return sorted(obs.counter_series("dj_slo_alert_total").items())


def _snap(h, **kw):
    """One sample, without the live schedulers' SLO rates (each package's
    own, which earlier tests in the process may have left alive)."""
    snap = h.sample_now(**kw)
    snap.pop("slo", None)
    return snap


def _no_slo(snaps):
    return [{k: v for k, v in s.items() if k != "slo"} for s in snaps]


def _storm(obs, h):
    """dj_tpu's test_truth.py:419 timeline: 11 healthy ticks spanning the
    slow window, then a deadline-miss storm until the slow window fires,
    then recovery. Returns what each step saw."""
    seen = {"snaps": [], "fired": []}
    t0 = 1_000_000.0
    for k in range(11):
        _drive(obs, 10)
        seen["snaps"].append(_snap(h, now=t0 + 60 * k))
    for k in range(1, 12):
        _drive(obs, 10, deadline=True)
        seen["snaps"].append(_snap(h, now=t0 + 600 + 60 * k))
        seen["fired"].append(sorted((e["slo"], e["window"]) for e in obs.events("slo_alert")
                                    if e["state"] == "firing"))
        if ("deadline_miss", "slow") in seen["fired"][-1]:
            break
    seen["trend"] = h.trend_view(64)
    for snap in seen["trend"]["snapshots"]:
        snap.pop("slo", None)
    for k in range(3):
        _drive(obs, 10)
        seen["snaps"].append(_snap(h, now=t0 + 1800 + 60 * k))
    seen["alerts"], seen["series"] = _alerts(obs), _series(obs)
    seen["view"] = h.alerts_view()
    return seen


def test_burn_rate_storm_matches_dj_tpu(both):
    _setenv(both, SLO_BURN_FAST_S=60, SLO_BURN_SLOW_S=600, SLO_BURN_RATE=0.3)
    jseen, tseen = (_storm(o, h) for o, h, _ in PKGS)
    assert tseen == jseen
    # The port on its own: fast before slow, one event a transition.
    fired = tseen["fired"]
    assert fired[0] == [("deadline_miss", "fast")]
    assert ("deadline_miss", "slow") in fired[-1] and len(fired) > 1
    states = [(a["slo"], a["window"], a["state"]) for a in tseen["alerts"]]
    assert states[:2] == [("deadline_miss", "fast", "firing"), ("deadline_miss", "slow", "firing")]
    assert ("deadline_miss", "fast", "resolved") in states
    assert tobs.counter_value("dj_slo_alert_total", slo="deadline_miss", window="fast") == 1
    assert not any(s[0] == "shed" for s in states)
    assert tseen["trend"]["alerts"]["deadline_miss:fast"] is True
    assert tseen["trend"]["snapshots"][-1]["deadline_shed"] > 0
    # obs.reset clears the history too (an aux-reset hook).
    tobs.reset(reenable=True)
    assert thist.snapshot_count() == 0 and thist.alerts_view() == {}


def test_shed_slo_counts_door_sheds_only(both):
    """Door rejects and queue-full sheds fire the shed SLO's windows;
    its rate stays within 1.0."""
    _setenv(both, SLO_BURN_FAST_S=60, SLO_BURN_SLOW_S=120, SLO_BURN_RATE=0.2)
    got = []
    for obs, h, _ in PKGS:
        for k in range(4):
            _drive(obs, 5, rejects=3 if k >= 2 else 0, full=2 if k == 3 else 0)
            h.sample_now(now=100.0 + 60 * k)
        got.append((_alerts(obs), _series(obs), _no_slo(h.recent(4))))
    assert got[1] == got[0]
    assert all(a["rate"] <= 1.0 for a in got[1][0])
    assert {(a["slo"], a["window"]) for a in got[1][0]} == {("shed", "fast"), ("shed", "slow")}


def test_ring_capacity_and_rebuild_match_dj_tpu(both):
    got = []
    for obs, h, prefix in PKGS:
        both.setenv(prefix + "OBS_HISTORY", "3")  # below the floor of 8
        caps = [h.capacity()]
        for k in range(12):
            _drive(obs, 1)
            h.sample_now(now=float(k))
        counts = [h.snapshot_count()]
        both.setenv(prefix + "OBS_HISTORY", "10")
        for k in range(12, 15):
            h.sample_now(now=float(k))
        caps.append(h.capacity())
        counts.append(h.snapshot_count())
        trend = h.trend_view(2)
        trend["snapshots"] = _no_slo(trend["snapshots"])
        got.append((caps, counts, [s["mono"] for s in h.recent(32)], h.recent(0), trend))
    assert got[1] == got[0]
    assert got[1][0] == [8, 10] and got[1][1] == [8, 10]
    assert got[1][2] == [float(k) for k in range(5, 15)]


def test_clamp_after_a_mid_flight_reset_matches_dj_tpu(both):
    """Counters cleared under a live ring give a quiet window (deltas
    clamped at zero), never a negative rate or a spurious alert."""
    _setenv(both, SLO_BURN_FAST_S=60, SLO_BURN_SLOW_S=600, SLO_BURN_RATE=0.1)
    got = []
    for obs, h, _ in PKGS:
        _drive(obs, 10, deadline=True)
        h.sample_now(now=0.0)
        obs.clear_prefix("dj_serve_")
        _drive(obs, 2)
        h.sample_now(now=60.0)
        rate = h._window_rate(h.recent(8), 60.0, 60.0, "deadline_shed", "terminals")
        got.append((rate, _alerts(obs), _no_slo(h.recent(8))))
    assert got[1] == got[0]
    assert got[1][0] == 0.0 and got[1][1] == []


def test_sample_with_obs_off_is_a_noop_in_both(both):
    for obs, h, _ in PKGS:
        obs.disable()
        assert h.sample_now() == {}
        assert h.snapshot_count() == 0
        obs.enable()


def test_sampler_lifecycle_matches_dj_tpu(both):
    got = []
    for obs, h, _ in PKGS:
        first, second = h.start(interval_s=0.05), h.start()
        running = h.trend_view(1)["sampler_running"]
        alive = [t for t in threading.enumerate() if t.name == "dj-obs-history"]
        h.stop()
        h.stop()
        got.append((first, second, running, len(alive), h.trend_view(1)["sampler_running"]))
        for t in alive:
            t.join(timeout=5)
            assert not t.is_alive()
    assert got[1] == got[0] == (True, False, True, 1, False)

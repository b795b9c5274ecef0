"""dj_tpu_torch.obs.fleet (the rank anomaly window) against dj_tpu's.

The synthetic fleets of dj_tpu's ``tests/test_fleet_obs.py:241`` (a
2-rank straggler fires and resolves), ``:273`` (the z gate at 8 ranks)
and ``:298`` (the ``wire`` pseudo-phase and the window's capacity) go
through ``note_snapshot`` in both packages, under ``DJ_*`` and ``DJT_*``
knobs of the same values; the scored rows, ``anomalous()``, the
``anomaly`` events (``seq`` and ``ts`` dropped), the gauges and the trip
counters must be equal. Then the hook: a port ``fleet_snapshot`` in a
one-process world feeds the window through ``skew._fleet_sink``.
"""

import pytest

import dj_tpu.obs as jobs
import dj_tpu_torch.obs as tobs
from dj_tpu.obs import fleet as jfleet
from dj_tpu_torch.obs import fleet as tfleet
from dj_tpu_torch.obs import skew as tskew

PKGS = ((jobs, jfleet, "DJ_"), (tobs, tfleet, "DJT_"))


@pytest.fixture
def both(monkeypatch):
    was = [o.enabled() for o, _, _ in PKGS]
    for o, f, _ in PKGS:
        o.reset(reenable=True)
        o.drain()
        f.reset()
    yield monkeypatch
    for (o, f, _), w in zip(PKGS, was):
        f.reset()
        o.reset(reenable=w)
        o.drain()


def _snap(phase_vals, wire=None, phase="join"):
    return {"ranks": [{"rank": r, "phase_seconds": {phase: float(v)},
                       "wire_total_bytes": float(wire[r]) if wire else 0.0}
                      for r, v in enumerate(phase_vals)]}


def _state(obs, fleet):
    return {
        "anomalous": fleet.anomalous(),
        "events": [{k: v for k, v in e.items() if k not in ("seq", "ts")}
                   for e in obs.events("anomaly")],
        "gauges": sorted(obs.gauge_series("dj_rank_anomaly").items()),
        "trips": sorted(obs.counter_series("dj_rank_anomaly_trips_total").items()),
        "window": fleet.window_size(),
    }


def _run(both, window, feeds):
    """Each feed through both packages; returns (dj_tpu's, the port's)
    rows and state after every feed."""
    out = []
    for obs, fleet, prefix in PKGS:
        both.setenv(prefix + "OBS_ANOMALY_WINDOW", str(window))
        out.append([(fleet.note_snapshot(s), _state(obs, fleet)) for s in feeds])
    return out


def test_two_rank_straggler_fires_and_resolves_as_dj_tpu(both):
    j, t = _run(both, 4, [_snap([0.0, 0.0]), _snap([1.0, 10.0]), _snap([11.0, 11.0]),
                          _snap([21.0, 20.0])])
    assert t == j
    assert t[1][1]["anomalous"] == [[1, "join"]]
    (r1,) = [r for r in t[1][0] if r["rank"] == 1 and r["phase"] == "join"]
    assert r1["firing"] and r1["ratio"] == pytest.approx(10.0)
    assert [e["state"] for e in t[-1][1]["events"]] == ["firing", "resolved"]
    assert t[-1][1]["anomalous"] == []
    assert tobs.counter_value("dj_rank_anomaly_trips_total", rank="1", phase="join") == 1


def test_z_gate_suppresses_a_spread_fleet_as_dj_tpu(both):
    base = list(range(1, 9))
    nxt = [v + 1 for v in base]
    nxt[7] = base[7] + 100.0
    j, t = _run(both, 2, [_snap([0.0] * 8), _snap(base), _snap(nxt)])
    assert t == j
    (r7,) = [r for r in t[1][0] if r["rank"] == 7 and r["phase"] == "join"]
    assert r7["ratio"] >= 2.0 and r7["z"] < 2.0 and t[1][1]["anomalous"] == []
    assert t[2][1]["anomalous"] == [[7, "join"]]
    assert t[2][1]["events"][0]["z"] >= 2.0


def test_wire_pseudo_phase_and_window_cap_as_dj_tpu(both):
    feeds = [_snap([0.0, 0.0], wire=[0.0, 0.0]), _snap([1.0, 1.0], wire=[100.0, 1000.0])]
    feeds += [_snap([2.0 + i, 2.0 + i], wire=[1100.0, 1100.0]) for i in range(5)]
    j, t = _run(both, 3, feeds)
    assert t == j
    assert [1, "wire"] in t[1][1]["anomalous"] and [1, "join"] not in t[1][1]["anomalous"]
    assert t[-1][1]["window"] == 3
    assert tfleet.window_capacity() == 3


def test_thresholds_and_an_empty_snapshot_match_dj_tpu(both):
    got = []
    for obs, fleet, prefix in PKGS:
        both.setenv(prefix + "OBS_ANOMALY_WINDOW", "1")  # below the floor of 2
        both.setenv(prefix + "OBS_ANOMALY_RATIO", "0")  # <= 0 disables
        rows = [fleet.note_snapshot({"ranks": []}), fleet.note_snapshot(_snap([0.0, 0.0])),
                fleet.note_snapshot(_snap([1.0, 50.0]))]
        got.append((fleet.window_capacity(), rows, _state(obs, fleet)))
    assert got[1] == got[0]
    assert got[1][0] == 2 and got[1][1][0] == [] and got[1][2]["anomalous"] == []


def test_port_fleet_snapshot_feeds_the_window_through_the_hook(both):
    """One process: fleet_snapshot gathers its own row and hands the
    merged view to obs.fleet's note_snapshot; fleet_health (/fleetz's
    payload) gathers again through fleet_view."""
    assert tskew._fleet_sink is tfleet.note_snapshot
    tobs.roofline.observe_phase("dispatch", 0.5)
    view = tobs.fleet_snapshot()
    assert tfleet.window_size() == 1 and len(view["ranks"]) == 1
    health = tfleet.fleet_health()
    assert health["window"] == {"capacity": 16, "stored": 2}
    assert health["thresholds"] == {"ratio": 2.0, "z": 2.0}
    assert {r["phase"] for r in health["scores"]} >= {"dispatch", "wire"}
    assert all(r["ratio"] == 1.0 and not r["firing"] for r in health["scores"])
    assert health["anomalous"] == [] and tobs.events("anomaly") == []
    assert health["coordination"]["enabled"] is False
    tobs.reset(reenable=True)
    assert tfleet.window_size() == 0

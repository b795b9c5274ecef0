"""Rank anomaly detection over the fleet snapshots' history.

Counterpart of ``dj_tpu/obs/fleet.py``. ``skew.fleet_snapshot`` names
the slowest rank of one gathered sample; a fleet scheduler needs the
rank that has been slow (or wire-heavy) over a window. Every merged view
reaches :func:`note_snapshot` through ``skew._fleet_sink``; this module
keeps the last ``DJT_OBS_ANOMALY_WINDOW`` of them (min 2) and scores each
rank's windowed phase seconds and wire bytes (the pseudo-phase
``wire``) against the fleet:

- **ratio**: the rank's windowed work over the median of the other
  ranks (leave-one-out, so a fleet of 2 can trip; a zero median falls
  back to the others' mean);
- **z**: its distance from the fleet mean in population standard
  deviations, the cross-check that the whole fleet is not just spread.

A (rank, phase) fires when ratio >= ``DJT_OBS_ANOMALY_RATIO`` and, on
fleets of 4 or more ranks, z >= ``DJT_OBS_ANOMALY_Z``. Each evaluation
sets ``dj_rank_anomaly{rank,phase}`` to the ratio; each transition
records one ``anomaly`` event and each firing counts
``dj_rank_anomaly_trips_total{rank,phase}``. ``/fleetz`` serves
:func:`fleet_health`. Deltas are newest minus oldest, clamped at zero.
Host-side only: scoring runs when a fleet gather (or a one-process
``/fleetz`` scrape) happens.
"""

from __future__ import annotations

import statistics
import threading
from collections import deque
from typing import Optional

from .. import knobs as _knobs
from . import metrics as _metrics
from . import recorder as _recorder
from . import skew as _skew

__all__ = [
    "anomalous",
    "fleet_health",
    "note_snapshot",
    "reset",
    "window_capacity",
    "window_size",
]

_lock = threading.Lock()
# Compacted snapshots: {rank: {"phases": {phase: cumulative s}, "wire": bytes}}.
_window: deque = deque()
_window_cap = 0
# (rank, phase) -> currently firing.
_state: dict = {}
# The last evaluation's scored rows (the /fleetz payload's body).
_last_scores: list = []

WIRE_PHASE = "wire"


def window_capacity() -> int:
    return max(2, _knobs.read_int("DJT_OBS_ANOMALY_WINDOW"))


def window_size() -> int:
    with _lock:
        return len(_window)


def _window_locked() -> deque:
    """The window at the current capacity knob (rebuilt on a change)."""
    global _window, _window_cap
    cap = window_capacity()
    if _window_cap != cap:
        _window = deque(_window, maxlen=cap)
        _window_cap = cap
    return _window


def _compact(fleet: dict) -> dict:
    """One merged view reduced to the scored signals, by rank."""
    out: dict = {}
    for row in fleet.get("ranks") or []:
        rank = int(row.get("rank", 0))
        out[rank] = {
            "phases": {str(p): float(v) for p, v in (row.get("phase_seconds") or {}).items()},
            "wire": float(row.get("wire_total_bytes") or sum(row.get("wire_row_totals") or [])),
        }
    return out


def _deltas(win: list) -> dict:
    """Each rank's windowed work: newest minus oldest, clamped at zero,
    per phase and ``wire``. A rank missing from the oldest scores its
    newest cumulative value."""
    newest, oldest = win[-1], win[0]
    out: dict = {}
    for rank, row in newest.items():
        base = oldest.get(rank, {"phases": {}, "wire": 0.0})
        phases = {p: max(0.0, v - float(base["phases"].get(p, 0.0)))
                  for p, v in row["phases"].items()}
        phases[WIRE_PHASE] = max(0.0, row["wire"] - float(base["wire"]))
        out[rank] = phases
    return out


def _score(deltas: dict) -> list:
    """Every (rank, phase) scored (module docstring); a fleet of one, or
    all zero, scores 1.0."""
    phases: set = set()
    for row in deltas.values():
        phases |= set(row)
    ranks = sorted(deltas)
    rows = []
    for p in sorted(phases):
        vals = [float(deltas[r].get(p, 0.0)) for r in ranks]
        mean = statistics.fmean(vals) if vals else 0.0
        stdev = statistics.pstdev(vals) if len(vals) > 1 else 0.0
        for i, (r, v) in enumerate(zip(ranks, vals)):
            others = vals[:i] + vals[i + 1:]
            med = statistics.median(others) if others else v
            base = med if med > 0 else (statistics.fmean(others) if others else 0.0)
            rows.append({
                "rank": r,
                "phase": p,
                "value": round(v, 6),
                "median": round(med, 6),
                "ratio": round(v / base, 4) if base > 0 else 1.0,
                "z": round((v - mean) / stdev, 4) if stdev > 0 else 0.0,
                "ranks": len(vals),
            })
    return rows


def note_snapshot(fleet: dict) -> list:
    """Feed one merged fleet view (``skew._fleet_sink``), score the
    window, publish the gauges and record one ``anomaly`` event a
    transition. Returns the scored rows."""
    compacted = _compact(fleet)
    if not compacted:
        return []
    ratio_t = _knobs.read_float("DJT_OBS_ANOMALY_RATIO")
    z_t = _knobs.read_float("DJT_OBS_ANOMALY_Z")
    pending: list = []
    global _last_scores
    with _lock:
        win = _window_locked()
        win.append(compacted)
        rows = _score(_deltas(list(win)))
        for row in rows:
            firing = (row["ratio"] >= ratio_t > 0 and row["value"] > 0
                      and (row["ranks"] < 4 or row["z"] >= z_t))
            row["firing"] = firing
            key = (row["rank"], row["phase"])
            was = _state.get(key, False)
            _state[key] = firing
            if firing != was:
                pending.append(dict(row))
        _last_scores = rows
        window_n = len(win)
    # Gauges and events outside the lock (a record may write a log line).
    for row in rows:
        _metrics.set_gauge("dj_rank_anomaly", row["ratio"], rank=str(row["rank"]),
                           phase=row["phase"])
    for row in pending:
        _recorder.record("anomaly", rank=row["rank"], phase=row["phase"],
                         state="firing" if row["firing"] else "resolved", ratio=row["ratio"],
                         z=row["z"], value=row["value"], median=row["median"], window=window_n)
        if row["firing"]:
            _metrics.inc("dj_rank_anomaly_trips_total", rank=str(row["rank"]),
                         phase=row["phase"])
    return rows


def anomalous() -> list:
    """The firing (rank, phase) pairs, sorted."""
    with _lock:
        return sorted([list(k) for k, v in _state.items() if v], key=lambda kv: (kv[0], kv[1]))


def fleet_health(refresh: Optional[bool] = None) -> dict:
    """The ``/fleetz`` payload: the merged view without a collective
    (``skew.fleet_view``: one process gathers afresh, which feeds this
    window through the hook), the scored window, the thresholds, the
    firing set and the coordination layer's view (``fleet.snapshot``;
    None if it fails)."""
    del refresh  # reserved; fleet_view decides gather or cache
    fleet = _skew.fleet_view()
    with _lock:
        scores = list(_last_scores)
        stored = len(_window)
    try:
        from .. import fleet as _coord

        coordination = _coord.snapshot()
    except Exception:  # noqa: BLE001 - health must always answer
        coordination = None
    return {
        "window": {"capacity": window_capacity(), "stored": stored},
        "thresholds": {"ratio": _knobs.read_float("DJT_OBS_ANOMALY_RATIO"),
                       "z": _knobs.read_float("DJT_OBS_ANOMALY_Z")},
        "scores": scores,
        "anomalous": anomalous(),
        "fleet": fleet,
        "coordination": coordination,
    }


def reset() -> None:
    """Drop the window, the states and the scores (an ``obs.reset`` hook)."""
    global _last_scores
    with _lock:
        _window.clear()
        _state.clear()
        _last_scores = []


# A hook, not an import: skew does not import its consumer.
_skew._fleet_sink = note_snapshot
_recorder._aux_resets.append(reset)

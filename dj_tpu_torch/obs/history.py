"""Retained telemetry: a snapshot ring and multi-window burn-rate alerts.

Counterpart of ``dj_tpu/obs/history.py``. The serving gauges are
instantaneous (``dj_slo_*`` is a window over the last terminals,
``/healthz`` a point read), so "when did the shed rate start climbing"
needs a history:

- **The ring.** :func:`sample_now` takes one JSON-able snapshot (wall and
  monotonic time, the cumulative serve counters, the queue, pressure,
  reservation and resident-index gauges, each scheduler's SLO rates and
  the allocator's sample from :func:`obs.truth.sample_device_hbm`, which
  never synchronizes the card) into a ring of ``DJT_OBS_HISTORY``
  snapshots (min 8). A sampler thread takes one every
  ``DJT_OBS_HISTORY_S`` seconds; ``obs.http.start`` starts it and
  ``obs.http.stop`` stops it. ``/trendz?n=`` serves the last n.
- **Burn-rate alerts.** Each sample judges two SLOs, ``deadline_miss``
  (deadline sheds over terminals) and ``shed`` (door rejects and
  queue-full sheds over submissions, so it is bounded at 1.0), over a
  fast (``DJT_SLO_BURN_FAST_S``) and a slow (``DJT_SLO_BURN_SLOW_S``)
  window against ``DJT_SLO_BURN_RATE``. A window is judged only once the
  ring spans it (a snapshot at or before ``now - window``), so a miss
  storm fires the fast window first. Each (slo, window) pair keeps its
  state: one ``slo_alert`` event a transition and
  ``dj_slo_alert_total{slo,window}`` a firing.

Rates are counter deltas between snapshots, clamped at zero, so a
mid-flight ``obs.reset`` gives a quiet sample, not a negative rate.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from .. import knobs
from . import metrics as _metrics
from . import recorder as _recorder
from . import truth as _truth

__all__ = [
    "alerts_view",
    "capacity",
    "recent",
    "reset",
    "sample_now",
    "snapshot_count",
    "start",
    "stop",
    "trend_view",
]

_lock = threading.Lock()
_ring: deque = deque()
_ring_cap = 0
# (slo, window) -> currently firing.
_alert_state: dict = {}
_thread: Optional[threading.Thread] = None
_stop_event: Optional[threading.Event] = None

_SLOS = (
    # (slo name, numerator key, denominator key)
    ("deadline_miss", "deadline_shed", "terminals"),
    ("shed", "door_shed", "submits"),
)


def capacity() -> int:
    return max(8, knobs.read_int("DJT_OBS_HISTORY"))


def _ring_locked() -> deque:
    """The ring at the current capacity knob (rebuilt on a change)."""
    global _ring, _ring_cap
    cap = capacity()
    if _ring_cap != cap:
        _ring = deque(_ring, maxlen=cap)
        _ring_cap = cap
    return _ring


def _shed_split() -> tuple:
    """(every shed, the deadline sheds) from the labelled shed counter."""
    total = deadline = 0.0
    for labels, v in _metrics.counter_series("dj_serve_shed_total").items():
        total += v
        if str(dict(labels).get("reason", "")).startswith("deadline"):
            deadline += v
    return total, deadline


def _scheduler_slo() -> list:
    # Lazy and guarded: obs stays importable without the serving layer,
    # and a sample never raises.
    try:
        from ..serve import schedulers_snapshot

        return [{"name": s.get("name"), **(s.get("slo") or {})} for s in schedulers_snapshot()]
    except Exception:  # noqa: BLE001 - sampling must never raise
        return []


def sample_now(now: Optional[float] = None) -> dict:
    """Take one snapshot, append it to the ring, judge the burn-rate
    alerts and return it. ``now`` stands for both the wall ``ts`` and the
    monotonic ``mono`` the windows anchor on (tests drive a timeline);
    the sampler passes nothing. ``{}`` with obs disabled."""
    if not _metrics.enabled():
        return {}
    ts = time.time() if now is None else float(now)
    mono = time.monotonic() if now is None else float(now)
    shed_total, deadline_shed = _shed_split()
    admitted = _metrics.counter_value("dj_serve_admitted_total")
    rejected = _metrics.counter_value("dj_serve_rejected_total")
    latency = _metrics.histogram_raw("dj_serve_latency_seconds")
    snap = {
        "ts": round(ts, 3),
        "mono": round(mono, 3),
        "admitted": admitted,
        "rejected": rejected,
        "shed": shed_total,
        "deadline_shed": deadline_shed,
        # The latency histogram observes once a terminal and never evicts.
        "terminals": 0 if latency is None else latency[3],
        # Door sheds only: a deadline shed is an admitted query that died
        # later (the deadline_miss SLO), so this rate stays within 1.0.
        "door_shed": rejected + (shed_total - deadline_shed),
        "submits": admitted + rejected + (shed_total - deadline_shed),
        "queue_depth": _metrics.gauge_value("dj_serve_queue_depth"),
        "reserved_bytes": _metrics.gauge_value("dj_serve_reserved_bytes"),
        "pressure_level": _metrics.gauge_value("dj_serve_pressure_level"),
        "index_bytes": _metrics.gauge_value("dj_index_resident_bytes"),
        "slo": _scheduler_slo(),
        "device_hbm": _truth.sample_device_hbm(),
    }
    with _lock:
        _ring_locked().append(snap)
        snaps = list(_ring)
    _check_alerts(snaps, mono)
    return snap


def _window_rate(snaps: list, now: float, window_s: float, num: str,
                 den: str) -> Optional[float]:
    """The burn rate over the trailing window: deltas between the newest
    snapshot and the newest anchor at or before ``now - window_s``. None
    until the ring spans the window."""
    if len(snaps) < 2:
        return None
    anchor = None
    horizon = now - window_s
    for s in snaps[:-1]:
        if s["mono"] <= horizon:
            anchor = s
        else:
            break
    if anchor is None:
        return None
    cur = snaps[-1]
    dn = max(0.0, cur[num] - anchor[num])
    dd = max(0.0, cur[den] - anchor[den])
    if dd <= 0:
        return 0.0
    return dn / dd


def _check_alerts(snaps: list, now: float) -> None:
    threshold = knobs.read_float("DJT_SLO_BURN_RATE")
    windows = (("fast", knobs.read_float("DJT_SLO_BURN_FAST_S")),
               ("slow", knobs.read_float("DJT_SLO_BURN_SLOW_S")))
    # Transitions resolve under the lock (a concurrent reset must not be
    # overwritten by a stale state); events are recorded outside it.
    pending: list = []
    with _lock:
        for slo, num, den in _SLOS:
            for window, wsec in windows:
                rate = _window_rate(snaps, now, wsec, num, den)
                if rate is None:
                    continue
                key = (slo, window)
                firing = rate >= threshold > 0
                was = _alert_state.get(key, False)
                _alert_state[key] = firing
                if firing != was:
                    pending.append((slo, window, firing, rate, wsec))
    for slo, window, firing, rate, wsec in pending:
        _recorder.record("slo_alert", slo=slo, window=window,
                         state="firing" if firing else "resolved", rate=round(rate, 4),
                         threshold=threshold, window_s=wsec)
        if firing:
            _metrics.inc("dj_slo_alert_total", slo=slo, window=window)


# --- views -------------------------------------------------------------


def recent(n: int = 32) -> list:
    with _lock:
        return list(_ring)[-max(0, int(n)):] if n else []


def snapshot_count() -> int:
    with _lock:
        return len(_ring)


def alerts_view() -> dict:
    with _lock:
        return {f"{slo}:{window}": bool(v) for (slo, window), v in sorted(_alert_state.items())}


def trend_view(n: int = 32) -> dict:
    """The ``/trendz`` payload: the ring's settings, the last n snapshots
    (oldest first) and the alert states."""
    return {
        "capacity": capacity(),
        "interval_s": knobs.read_float("DJT_OBS_HISTORY_S"),
        "stored": snapshot_count(),
        "sampler_running": _thread is not None,
        "snapshots": recent(n),
        "alerts": alerts_view(),
        "burn": {
            "threshold": knobs.read_float("DJT_SLO_BURN_RATE"),
            "fast_s": knobs.read_float("DJT_SLO_BURN_FAST_S"),
            "slow_s": knobs.read_float("DJT_SLO_BURN_SLOW_S"),
        },
    }


# --- the sampler -------------------------------------------------------


def start(interval_s: Optional[float] = None) -> bool:
    """Start the sampler thread (idempotent). True when this call started
    it, False when one was running: ``obs.http.stop`` stops only a
    sampler its own start started."""
    global _thread, _stop_event
    with _lock:
        if _thread is not None:
            return False
        _stop_event = threading.Event()
        interval = (float(interval_s) if interval_s is not None
                    else knobs.read_float("DJT_OBS_HISTORY_S"))
        interval = max(0.05, interval)
        stop_event = _stop_event

        def _loop():
            while not stop_event.wait(interval):
                try:
                    sample_now()
                except Exception:  # noqa: BLE001 - the sampler must survive
                    pass

        _thread = threading.Thread(target=_loop, name="dj-obs-history", daemon=True)
        _thread.start()
        return True


def stop() -> None:
    """Stop and join the sampler thread (a no-op when none runs). The
    ring and the alert states stay."""
    global _thread, _stop_event
    with _lock:
        th, ev = _thread, _stop_event
        _thread = _stop_event = None
    if ev is not None:
        ev.set()
    if th is not None:
        th.join(timeout=5)


def reset() -> None:
    """Drop every snapshot and alert state (an ``obs.reset`` hook)."""
    with _lock:
        _ring.clear()
        _alert_state.clear()


_recorder._aux_resets.append(reset)

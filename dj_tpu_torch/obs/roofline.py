"""Per-query phase attribution and measured-vs-roofline fractions.

Counterpart of ``dj_tpu/obs/roofline.py``: the phases of every query
that the host sees, each timed and priced against a peak bandwidth, so
``obs.query_trace(query_id)`` answers which phase of one query ran at
what fraction of peak.

- :func:`phase` / :func:`observe_phase` time one phase; emit a ``phase``
  event (stamped with the ambient query like every event), observe
  ``dj_phase_seconds{phase}`` and, when the caller gives modeled bytes,
  ``dj_roofline_frac{phase,kind}`` with ``roofline_frac = model_bytes /
  (seconds x peak_GBps x 1e9)``. The peaks are the card's that measures
  the port, an NVIDIA H100 80GB HBM3: ``DJT_PEAK_HBM_GBPS`` (default
  3350, HBM3's 3.35 TB/s) and ``DJT_PEAK_WIRE_GBPS`` (default 450,
  NVLink each way).
- The phases the join path emits: ``probe`` (the host key-range
  probe), ``dispatch`` (one ``run_spmd`` of the ranks; its roofline is
  the wire model, the per-shard send bytes of the exchanges it issued),
  ``sync`` (the heal engine's host read of the flags, where the host
  waits for the device) and ``prep`` (``prepare_join_side``'s run, on
  the wire model too). dj_tpu's ``build`` phase (trace and compile of a
  module) has no counterpart: the port builds no module per shape.
  The finer phases inside a rank (partition, exchange, join, ...) are
  ``timing.annotate`` ranges in a profiler trace, not phases here.
- :func:`observe_events` records a phase between two CUDA events its
  caller recorded: the scheduler's ``run`` (its ``serve_run`` span), whose
  resolved seconds also feed ``dj_tenant_device_seconds_total``.

The clock. Given a CUDA ``device``, :func:`phase` brackets the body with
two CUDA events on the current stream and adds no synchronize: the
phase stays pending until its end event has completed, and is resolved
(its event recorded, with the ``ts`` of its end on the host) at a sync
the query already makes (the heal engine resolves after its flag read),
at the start of the next phase (without waiting: only the phases whose
end event has completed), or when a reader asks (``obs.events``,
``drain``, ``query_trace``, ``export_trace``, ``metrics_text``,
``metrics_summary``, the histogram readers, :func:`summary`), which then
waits for the device. At most ``PENDING_MAX`` phases stay pending: past
that the oldest is dropped and counted in
``dj_phase_dropped_total{phase}``, so a process that keeps obs on never
grows without bound. Elsewhere it is the host clock. A phase's device
time covers the work the device ran between the two events, which on
one stream includes work queued before the phase's start that had not
run yet.

Per-process phase totals ride a :class:`~..utils.timing.PhaseTimer`.
Unlike dj_tpu's, the totals grow only while obs is enabled: a disabled
phase creates no event and reads no clock.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import torch

from .. import knobs
from ..utils.timing import PhaseTimer
from . import metrics as _metrics
from . import recorder as _recorder

__all__ = [
    "FRAC_BUCKETS",
    "PENDING_MAX",
    "clear",
    "hbm_peak_gbps",
    "observe_events",
    "observe_phase",
    "pending_count",
    "phase",
    "phase_totals",
    "query_timer",
    "resolve",
    "summary",
    "wire_peak_gbps",
]

# Bucket ladder for roofline fractions: fine at the low end, where most
# phases run; > 1 means the byte model over-counted or the clock missed
# work, and gets its own bucket rather than vanishing into +Inf.
FRAC_BUCKETS = (
    1e-4, 3e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.2, 0.4, 0.7, 1.0, 2.0,
)

# The most device phases left pending; the host would have to run this
# many phases ahead of the device to reach it.
PENDING_MAX = 4096

_timer = PhaseTimer()
_lock = threading.Lock()
# Device phases not yet resolved, oldest first: (start event, end event,
# host end ts, (query_id, tenant) or None, observe_phase arguments[, a
# callable given the seconds once resolved]).
_pending: list = []
# Threads on which resolve() leaves the pending phases as they are (see
# _deferred).
_defer = threading.local()


def hbm_peak_gbps() -> float:
    """``DJT_PEAK_HBM_GBPS``, default 3350.0 (H100 80GB HBM3)."""
    return knobs.read_float("DJT_PEAK_HBM_GBPS")


def wire_peak_gbps() -> float:
    """``DJT_PEAK_WIRE_GBPS``, default 450.0 (NVLink, each way)."""
    return knobs.read_float("DJT_PEAK_WIRE_GBPS")


def observe_phase(
    name: str,
    seconds: float,
    *,
    model_bytes: Optional[float] = None,
    kind: str = "hbm",
    stage: Optional[str] = None,
    **fields,
) -> Optional[float]:
    """Record one completed phase: the per-process total,
    ``dj_phase_seconds{phase}``, the roofline fraction when
    ``model_bytes`` is given (``kind`` "hbm" or "wire" picks the peak)
    and one ``phase`` event. Returns the fraction (None without a byte
    model, or while obs is disabled)."""
    if not _metrics.enabled():
        return None
    seconds = float(seconds)
    with _lock:
        _timer.note(name, seconds * 1e3)
    frac = None
    if model_bytes and seconds > 0:
        peak = hbm_peak_gbps() if kind == "hbm" else wire_peak_gbps()
        # peak <= 0 means no fraction, never a failed query.
        if peak > 0:
            frac = float(model_bytes) / (seconds * peak * 1e9)
    _metrics.observe("dj_phase_seconds", seconds, phase=name)
    if frac is not None:
        _metrics.observe("dj_roofline_frac", frac, buckets=FRAC_BUCKETS, phase=name, kind=kind)
    _recorder.record(
        "phase",
        phase=name,
        stage=stage,
        seconds=round(seconds, 6),
        model_bytes=None if model_bytes is None else int(model_bytes),
        kind=kind,
        roofline_frac=None if frac is None else float(f"{frac:.4g}"),
        **fields,
    )
    return frac


def resolve(wait: bool = False) -> int:
    """Record the pending device phases whose end event has completed
    (all of them with ``wait``, which synchronizes each one's end event
    first). Returns how many stay pending; under :func:`_deferred` on
    this thread, resolves none."""
    if not _pending:
        return 0
    if getattr(_defer, "on", False):
        return len(_pending)
    with _lock:
        todo = list(_pending)
        _pending.clear()
    keep = []
    for item in todo:
        start, end, ts, ids, (name, kw), *then = item
        if not end.query():
            if not wait:
                keep.append(item)
                continue
            end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
        # Stamped with the query the phase ran in, not the ambient one.
        observe_phase(name, seconds, **kw, ts=ts, _ids=ids)
        for fn in then:
            fn(seconds)
    if keep:
        with _lock:
            _pending[:0] = keep
    return len(keep)


def pending_count() -> int:
    with _lock:
        return len(_pending)


@contextlib.contextmanager
def phase(
    name: str,
    *,
    stage: Optional[str] = None,
    model_bytes: Optional[float] = None,
    bytes_fn=None,
    kind: str = "hbm",
    device=None,
    **fields,
):
    """Bracket a body as one phase (module docstring), observed on exit,
    exception or not. ``bytes_fn`` gives the byte model at exit (a
    dispatch's bytes exist only after it ran; a failing ``bytes_fn``
    gives no fraction, never a failed query). ``device``: a CUDA device
    times the phase with CUDA events, resolved later; anything else
    with the host clock. A no-op while obs is disabled."""
    if not _metrics.enabled():
        yield
        return
    resolve()
    dev = None if device is None else torch.device(device)
    start = None
    if dev is not None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
    t0 = time.perf_counter()
    try:
        yield
    finally:
        mb = model_bytes
        if bytes_fn is not None:
            try:
                mb = bytes_fn()
            except Exception:  # noqa: BLE001 - observation must not raise
                mb = None
        kw = dict(model_bytes=mb, kind=kind, stage=stage, **fields)
        if start is None:
            observe_phase(name, time.perf_counter() - t0, **kw)
        else:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(dev))
            _push(start, end, name, kw)


def _push(start, end, name: str, kw: dict, then=None) -> None:
    """A device phase pending until ``end`` completes (``resolve``),
    stamped with the ambient query."""
    ids = _recorder._ctx_hook() if _recorder._ctx_hook is not None else None
    item = (start, end, round(time.time(), 6), ids, (name, kw)) + ((then,) if then else ())
    with _lock:
        _pending.append(item)
        dropped = _pending[:-PENDING_MAX]
        del _pending[:-PENDING_MAX]
    for old in dropped:
        _metrics.inc("dj_phase_dropped_total", phase=old[4][0])


def observe_events(name: str, start, end, *, then=None, model_bytes: Optional[float] = None,
                   kind: str = "hbm", stage: Optional[str] = None, **fields) -> None:
    """Record phase ``name`` between two CUDA events the caller recorded
    (both with timing), as :func:`phase` records its own: pending until
    ``end`` has completed, then observed with its device seconds;
    ``then(seconds)``, when given, runs once it is. A no-op while obs is
    disabled."""
    if not _metrics.enabled():
        return
    resolve()
    _push(start, end, name, dict(model_bytes=model_bytes, kind=kind, stage=stage, **fields),
          then)


def query_timer(**timer_kwargs) -> PhaseTimer:
    """A :class:`PhaseTimer` whose phases also feed this module (one
    ``phase`` event and the totals at each phase exit)."""
    return PhaseTimer(on_phase=lambda name, ms: observe_phase(name, ms / 1e3), **timer_kwargs)


def phase_totals() -> dict:
    """Accumulated per-phase seconds of this process."""
    resolve(wait=True)
    with _lock:
        return {k: v / 1e3 for k, v in _timer.phases.items()}


@contextlib.contextmanager
def _deferred():
    """On this thread, for the body, every resolve (a reader's hook
    included) leaves the pending phases pending: a resolve takes this
    module's, the registry's, the ring's and the timelines' locks, which
    a crash dump on an interrupted main thread must not wait for."""
    prev = getattr(_defer, "on", False)
    _defer.on = True
    try:
        yield
    finally:
        _defer.on = prev


def summary() -> dict:
    """Per-phase {seconds, count, mean_s, frac_p50, frac_p95}; the
    fraction quantiles come from ``dj_roofline_frac`` (None for a phase
    with no byte model). Resolves the pending device phases first."""
    resolve(wait=True)
    with _lock:
        snap = _timer.summary()
    out = {}
    for name, s in snap.items():
        out[name] = {
            "seconds": round(s["total_ms"] / 1e3, 6),
            "count": s["count"],
            "mean_s": round(s["mean_ms"] / 1e3, 6),
            "frac_p50": _metrics.histogram_quantile("dj_roofline_frac", 0.5, phase=name),
            "frac_p95": _metrics.histogram_quantile("dj_roofline_frac", 0.95, phase=name),
        }
    return out


def clear() -> None:
    """Drop the phase totals and the pending phases. The
    ``dj_phase_seconds`` / ``dj_roofline_frac`` series are registry
    state and clear with ``metrics.reset``."""
    with _lock:
        _timer.phases.clear()
        _timer.counts.clear()
        _pending.clear()


# obs.reset() clears the totals; a reader of the ring, of a timeline or
# of the registry resolves the pending phases first (hooks: the metrics
# registry and the recorder import no sibling).
_recorder._aux_resets.append(clear)
_metrics._resolve_hook = lambda: resolve(wait=True)

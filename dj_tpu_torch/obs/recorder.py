"""The flight recorder: a bounded ring of structured events.

Counterpart of ``dj_tpu/obs/recorder.py``. Every decision the join path
takes that a result does not show (a heal, a ledger hit, a plan tier, a
codec choice, a shape-bucket pad, a pipeline stage's mode, a warmup)
records one event here. The ring is bounded (``DJT_OBS_RING``, default
1024 events), so a long-lived process can keep obs on. Read it through

- ``DJT_OBS_LOG=<path>``: every event is also appended to that file as
  one JSON line when it is recorded (line-buffered), or
- :func:`drain` (return and clear) and :func:`events` (a snapshot).

Every event has ``seq`` (a process-wide counter), ``ts`` (unix seconds)
and ``type``, then its own fields. Inside ``obs.trace.query_ctx`` it
also has ``query_id`` and ``tenant`` and joins that query's timeline.

Recording is a strict no-op while obs is disabled: :func:`record`'s
first statement is the enabled check.

Collective accounting. dj_tpu counts a compiled module's collectives
at trace time and replays the count per query (``record_epoch``,
``capture_epochs``, ``run_accounted``, ``cached_build``). The port has
no jit to hook: ``Communicator.exchange_start`` and ``broadcast_table``
count each exchange epoch as they issue it (:func:`count_collectives`),
on one rank a process, so a world of threads counts a query once, as
dj_tpu's one controller does. :func:`account_epochs` brackets one
dispatch and gives its epochs to the query's ``collectives`` event and
to the dispatch phase's wire roofline. Each epoch also feeds the per-link
wire matrix (``obs.skew``) through the ``_wire_sink`` hook, as dj_tpu's
``count_collectives`` does. A :func:`suppress_epochs` scope mutes all of
it, and the dispatch observation around it (``dist_join._dispatch``):
the autotuner's probe runs a candidate's real dispatch inside one, so
tuning counts no collective, query or tenant byte, as dj_tpu's probe of
an AOT executable counts none. The ``retrace`` event, the
build-cache and compile counters, the trace-time ``collective_epoch``
event and ``dj_collective_epochs_traced_total`` have nothing to count
here and are left out.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from collections import deque
from typing import Optional

from .. import knobs
from .metrics import (
    _resolve_pending,
    enable as _metrics_enable,
    enabled,
    inc,
    metrics_summary,
    observe,
    reset as _metrics_reset,
    set_gauge,
)

__all__ = [
    "account_epochs",
    "count_collectives",
    "drain",
    "enabled",
    "events",
    "inc",
    "mirror_warning",
    "observe",
    "record",
    "reset",
    "ring_capacity",
    "set_gauge",
    "set_log_path",
    "suppress_epochs",
    "suppressed",
    "table_sig",
    "write_snapshot",
]

# The ring and the JSONL sink serialize on this lock, not on the metrics
# registry's: a stalled log filesystem must never block another thread's
# inc() / observe().
_rlock = threading.Lock()

_ring: deque = deque(maxlen=max(1, knobs.read_int("DJT_OBS_RING")))
_seq = itertools.count()
_log_path: Optional[str] = knobs.read("DJT_OBS_LOG") or None
_log_file = None

# Hooks that obs.trace registers at import: the ambient (query_id,
# tenant) or None, the per-query timeline sink, and its clear.
_ctx_hook = None
_trace_sink = None
_trace_clear = None

# Per-link wire-matrix hook, registered by obs.skew at import: receives
# every epoch count_collectives counts, so the dj_wire_bytes_total matrix
# and the dj_collective_bytes_total counters are fed alike.
_wire_sink = None

# Resets of sibling modules (obs.roofline's phase totals, obs.skew's
# aggregates, the autotuner's state), run by reset().
_aux_resets: list = []


def ring_capacity() -> int:
    return _ring.maxlen or 0


def set_log_path(path: Optional[str]) -> None:
    """(Re)direct the JSONL sink; None closes it. Like ``DJT_OBS_LOG``, a
    path also enables obs (a sink on a disabled recorder would collect
    nothing)."""
    global _log_path, _log_file
    with _rlock:
        if _log_file is not None:
            _log_file.close()
            _log_file = None
        _log_path = path
    if path is not None:
        _metrics_enable()


def _jsonable(v):
    """Plain Python of a field: 0-d tensors and numpy scalars through
    ``.item()``, containers recursively, anything else as its str."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        try:
            return v.item()
        except Exception:  # noqa: BLE001 - the recorder must never raise
            return str(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


_AMBIENT = object()


def record(etype: str, /, _ids=_AMBIENT, **fields) -> Optional[dict]:
    """Append one event to the ring (and the JSONL sink when set).
    Returns the event, or None while obs is disabled. ``_ids``, the
    (query_id, tenant) or None to stamp, defaults to the ambient query's:
    a device phase resolved later passes the query it ran in."""
    if not enabled():
        return None
    global _log_file
    evt = {"seq": next(_seq), "ts": round(time.time(), 6), "type": etype}
    for k, v in fields.items():
        evt[k] = _jsonable(v)
    ids = _ids
    if ids is _AMBIENT:
        ids = _ctx_hook() if _ctx_hook is not None else None
    if ids is not None:
        evt.setdefault("query_id", ids[0])
        evt.setdefault("tenant", ids[1])
    with _rlock:
        _ring.append(evt)
        if _log_path is not None:
            try:
                if _log_file is None:
                    _log_file = open(_log_path, "a", buffering=1)
                _log_file.write(json.dumps(evt) + "\n")
            except OSError:
                # A broken sink never fails the join; the ring keeps the event.
                _log_file = None
    if _trace_sink is not None and "query_id" in evt:
        _trace_sink(evt)
    return evt


def events(etype: Optional[str] = None) -> list[dict]:
    """The ring's events, oldest first (only ``etype``'s when given),
    without clearing it. Pending device phases are resolved first."""
    _resolve_pending()
    with _rlock:
        snap = list(_ring)
    return snap if etype is None else [e for e in snap if e["type"] == etype]


def drain() -> list[dict]:
    """The ring's events, oldest first; clears the ring. Pending device
    phases are resolved first."""
    _resolve_pending()
    with _rlock:
        out = list(_ring)
        _ring.clear()
    return out


# --- collective accounting ------------------------------------------------

# The open account_epochs scope's totals. Rank threads run in a copy of
# the caller's context, so they add to the caller's scope.
_epochs: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "dj_tpu_torch_epochs", default=None)


# Open suppress_epochs scopes; rank threads run in a copy of the
# caller's context, so a scope covers its world's ranks.
_suppress: contextvars.ContextVar[int] = contextvars.ContextVar(
    "dj_tpu_torch_suppress_epochs", default=0)


@contextlib.contextmanager
def suppress_epochs():
    """Mute the collective accounting for the body (module docstring):
    :func:`count_collectives`, the wire sink, :func:`account_epochs` and
    with it the tenant bytes, the ``collectives`` event and the dispatch
    observation of ``dist_join._dispatch``."""
    token = _suppress.set(_suppress.get() + 1)
    try:
        yield
    finally:
        _suppress.reset(token)


def suppressed() -> bool:
    """Whether a :func:`suppress_epochs` scope is open."""
    return _suppress.get() > 0


def count_collectives(accts, queries: int = 1) -> None:
    """Count exchange epochs: each of ``accts`` is one epoch's ``{"n":
    the group size, "launches": collectives after the backend's fusion,
    "bytes_by_width": {element width: per-shard send bytes}}``, issued
    ``queries`` times. Adds to ``dj_collective_launches_total`` and
    ``dj_collective_bytes_total{width}``, to the open
    :func:`account_epochs` scope and to the wire matrix."""
    if not enabled() or not accts or suppressed():
        return
    acc = _epochs.get()
    for a in accts:
        inc("dj_collective_launches_total", a["launches"] * queries)
        total = 0
        for w, b in a["bytes_by_width"].items():
            inc("dj_collective_bytes_total", b * queries, width=str(w))
            total += b * queries
        if _wire_sink is not None:
            _wire_sink(a, queries)
        if acc is not None:
            acc["epochs"] += queries
            acc["launches"] += a["launches"] * queries
            acc["total_bytes"] += total


@contextlib.contextmanager
def account_epochs(stage: str):
    """Bracket one dispatch's exchanges: yields a dict whose
    ``total_bytes`` the body's epochs add to (the dispatch phase's wire
    bytes; None while obs is disabled). On a normal exit inside a
    ``query_ctx``, a dispatch that moved anything adds its bytes to
    ``dj_tenant_wire_bytes_total{tenant}`` and records one
    ``collectives`` event (stage, epochs, launches, total_bytes), as
    dj_tpu's ``run_accounted`` does. Yields None while obs is disabled
    or a :func:`suppress_epochs` scope is open."""
    if not enabled() or suppressed():
        yield None
        return
    acc = {"epochs": 0, "launches": 0, "total_bytes": 0}
    token = _epochs.set(acc)
    try:
        yield acc
    finally:
        _epochs.reset(token)
    ids = _ctx_hook() if _ctx_hook is not None else None
    if acc["epochs"] and ids is not None:
        inc("dj_tenant_wire_bytes_total", acc["total_bytes"], tenant=str(ids[1]))
        record("collectives", stage=stage, **acc)


def table_sig(table, force: bool = False) -> tuple:
    """A table's column schema: each fixed-width column's physical dtype
    name ("int64", ...), "str" for a string column (duck-typed on
    ``.chars``). ``force`` is dj_tpu's, kept for its callers; the schema
    is always computed."""
    del force
    return tuple("str" if hasattr(c, "chars") else str(c.data.dtype).removeprefix("torch.")
                 for c in table.columns)


# Names whose once-a-process warning mirror fired; a shot is consumed
# only while obs is enabled.
_warned_once: set = set()


def mirror_warning(name: str, detail: str) -> None:
    """Mirror a join-path ``warnings.warn`` into the ring (one
    ``warning`` event) and ``dj_warnings_total{name}``, once a process
    a name. :func:`reset` re-arms it."""
    if not enabled() or name in _warned_once:
        return
    _warned_once.add(name)
    record("warning", name=name, detail=detail)
    inc("dj_warnings_total", name=name)


def reset(reenable: Optional[bool] = None) -> None:
    """Clear the metrics registry, the query timelines (obs.trace), the
    roofline totals and the warning mirrors. The ring is not cleared:
    that is :func:`drain`. ``reenable`` optionally forces the enabled
    flag."""
    _metrics_reset(reenable)
    with _rlock:
        _warned_once.clear()
    if _trace_clear is not None:
        _trace_clear()
    for fn in list(_aux_resets):
        fn()


def write_snapshot(path: str) -> dict:
    """``metrics_summary()`` plus the drained ring under ``"events"``,
    written as JSON to ``path``; returns it."""
    snap = metrics_summary()
    snap["events"] = drain()
    with open(path, "w") as f:
        json.dump(snap, f)
    return snap

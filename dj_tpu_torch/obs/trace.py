"""Query-scoped tracing: correlate every event of one query.

Counterpart of ``dj_tpu/obs/trace.py``.

- :func:`query_ctx` makes ``(query_id, tenant)`` the ambient identity
  of the body, on a ``contextvars.ContextVar``: ``recorder.record``
  stamps both onto every event recorded inside it. ``run_spmd`` runs
  each rank of a world of threads in a copy of the caller's context, so
  events recorded inside a rank carry the query too.
- a bounded store of per-query timelines (``DJT_OBS_TRACES`` queries,
  default 256, oldest closed one evicted first; 512 events a timeline):
  every stamped event also joins its query's timeline, so a timeline
  outlives the ring's eviction.
- spans: begin/end markers (``span`` events with ``span`` and ``phase``
  fields); :func:`query_trace` reconstructs a timeline and names the
  spans whose begins and ends differ (orphans).
- :func:`export_trace` renders one timeline as Chrome trace-event JSON,
  which Perfetto also reads.

Nothing records while obs is disabled.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from collections import OrderedDict
from typing import Optional

from .. import knobs
from . import recorder as _recorder

__all__ = [
    "blackbox_traces",
    "clear",
    "current_query",
    "event_count",
    "export_trace",
    "query_ctx",
    "query_trace",
    "recent_traces",
    "span",
    "span_begin",
    "span_end",
    "trace_count",
]

# The stack of active (query_id, tenant) pairs, innermost last.
_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "dj_tpu_torch_query", default=())


# Cap on events kept a query, so one runaway query cannot eat the
# host's memory. Past it the timeline counts what it drops.
_EVENTS_PER_TRACE = 512

# query_id -> {query_id, tenant, events: [...], dropped: int}
# OrderedDict for FIFO eviction at capacity; guarded by its own lock
# (never the recorder's _rlock — see recorder.py on lock isolation).
_traces: "OrderedDict[str, dict]" = OrderedDict()
_traces_lock = threading.Lock()
_TRACES_MAX = max(1, knobs.read_int("DJT_OBS_TRACES"))


def current_query() -> Optional[tuple]:
    """The innermost active ``(query_id, tenant)`` of this context, or
    None outside any :func:`query_ctx`."""
    stack = _stack.get()
    return stack[-1] if stack else None


@contextlib.contextmanager
def query_ctx(query_id: str, tenant: str = "default"):
    """Make ``(query_id, tenant)`` the ambient query identity of the
    body: every ``recorder.record`` inside it stamps both onto the event
    and appends it to the query's timeline. Contexts nest; entering one
    id again, on any thread, appends to the same timeline."""
    token = _stack.set(_stack.get() + ((str(query_id), str(tenant)),))
    try:
        yield
    finally:
        _stack.reset(token)


def _evict_locked() -> None:
    """Make room for one more timeline: evict the oldest CLOSED trace
    first (its query reached a terminal state; the timeline is pure
    history), falling back to the oldest open one only when every
    stored query is still in flight — evicting an open query's
    timeline mid-life would resurrect it later as a permanently
    incomplete orphan, undercounting heal rates for exactly the slow
    queries an operator is debugging. Bounded memory still wins the
    pathological all-open case."""
    for qid, tr in _traces.items():
        if not tr["open"]:
            del _traces[qid]
            return
    _traces.popitem(last=False)


def _sink(evt: dict) -> None:
    """Append one already-stamped event to its query's timeline
    (called by recorder.record under no lock of its own)."""
    qid = evt.get("query_id")
    if qid is None:
        return
    with _traces_lock:
        tr = _traces.get(qid)
        if tr is None:
            while len(_traces) >= _TRACES_MAX:
                _evict_locked()
            tr = _traces[qid] = {
                "query_id": qid,
                "tenant": evt.get("tenant", "default"),
                "events": [],
                "dropped": 0,
                "open": True,
            }
        if evt["type"] == "span" and evt.get("span") == "query":
            # The lifecycle bracket drives evictability: a closed
            # `query` span means the terminal transition happened.
            tr["open"] = evt.get("phase") == "begin"
        if len(tr["events"]) < _EVENTS_PER_TRACE:
            tr["events"].append(evt)
        else:
            tr["dropped"] += 1


def span_begin(name: str, **fields) -> None:
    """Record a ``span`` begin event for the ambient query (no-op with
    obs disabled, like every record)."""
    _recorder.record("span", span=name, phase="begin", **fields)


def span_end(name: str, **fields) -> None:
    _recorder.record("span", span=name, phase="end", **fields)


@contextlib.contextmanager
def span(name: str, **fields):
    """Bracket a body with begin/end span events. The end event always
    fires (exception or not) so a raised error can never orphan the
    span; the exception still propagates."""
    span_begin(name, **fields)
    try:
        yield
    finally:
        span_end(name, **fields)


def _summarize(tr: dict) -> dict:
    """The :func:`query_trace` view of one stored timeline: the raw
    events plus derived completeness — ``spans`` (per-name begin/end
    counts), ``orphans`` (names whose begins != ends), ``complete``
    (the ``query`` span closed and nothing orphaned), ``terminal``
    (a ``serve`` event's outcome, when one arrived)."""
    begins: dict[str, int] = {}
    ends: dict[str, int] = {}
    terminal = None
    for e in tr["events"]:
        if e["type"] == "span":
            d = begins if e.get("phase") == "begin" else ends
            n = e.get("span", "?")
            d[n] = d.get(n, 0) + 1
        elif e["type"] == "serve":
            terminal = e.get("outcome")
    names = sorted(set(begins) | set(ends))
    orphans = [
        n for n in names if begins.get(n, 0) != ends.get(n, 0)
    ]
    return {
        "query_id": tr["query_id"],
        "tenant": tr["tenant"],
        "events": list(tr["events"]),
        "spans": {
            n: {"begin": begins.get(n, 0), "end": ends.get(n, 0)}
            for n in names
        },
        "orphans": orphans,
        "complete": (
            ends.get("query", 0) >= 1
            and begins.get("query", 0) == ends.get("query", 0)
            and not orphans
        ),
        "terminal": terminal,
        "dropped": tr["dropped"],
    }


def query_trace(query_id: str) -> Optional[dict]:
    """The reconstructed timeline for one query id (module docstring),
    or None if the id was never seen (or was FIFO-evicted past
    ``DJT_OBS_TRACES`` queries)."""
    _recorder._resolve_pending()
    with _traces_lock:
        tr = _traces.get(str(query_id))
        if tr is None:
            return None
        tr = {**tr, "events": list(tr["events"])}
    return _summarize(tr)


def recent_traces(n: int = 32) -> list[dict]:
    """The last ``n`` query timelines, oldest first."""
    _recorder._resolve_pending()
    with _traces_lock:
        keep = list(_traces.values())[-max(0, int(n)):]
        keep = [{**tr, "events": list(tr["events"])} for tr in keep]
    return [_summarize(tr) for tr in keep]


def event_count(query_id: str, etype: str) -> int:
    """How many events of ``etype`` one query's timeline holds (0 for
    unknown or evicted ids), without copying the timeline."""
    with _traces_lock:
        tr = _traces.get(str(query_id))
        if tr is None:
            return 0
        return sum(1 for e in tr["events"] if e["type"] == etype)


def trace_count() -> int:
    with _traces_lock:
        return len(_traces)


def blackbox_traces(closed_n: int = 8) -> dict:
    """The timelines a crash report keeps: EVERY
    open timeline (a process dying mid-query is exactly when the open
    ones matter) plus the last ``closed_n`` closed ones for context,
    each summarized like :func:`query_trace` so the dead query's open
    span is marked (``complete`` false, the orphan named)."""
    _recorder._resolve_pending()
    with _traces_lock:
        items = [
            {**tr, "events": list(tr["events"])}
            for tr in _traces.values()
        ]
    open_ = [_summarize(t) for t in items if t["open"]]
    closed = [_summarize(t) for t in items if not t["open"]]
    return {
        "open": open_,
        "closed": closed[-max(0, int(closed_n)):] if closed_n else [],
    }


# --- cross-process trace export ---------------------------------------
#
# Lane (Chrome "tid") assignment for one exported query: the lifecycle
# spans nest by containment (query ⊃ queued/run) so they share a lane;
# phases (which overlap spans arbitrarily) and instant events get
# their own.
_LANE_SPANS, _LANE_PHASES, _LANE_EVENTS = 0, 1, 2
_EXPORT_FORMATS = ("chrome", "perfetto")


def _export_rank(query_id: str) -> int:
    """The rank component of a ``rank:seq`` query id: the exported
    trace's "process", so merged exports of several ranks lay out one
    track group a rank. Ids without the prefix map to rank 0."""
    head = str(query_id).split(":", 1)[0]
    try:
        return int(head)
    except ValueError:
        return 0


def export_trace(query_id: str, fmt: str = "chrome") -> Optional[dict]:
    """Render one stored timeline as Chrome trace-event JSON.
    Both accepted formats emit the same trace-event object — Perfetto
    ingests Chrome JSON natively — so ``fmt`` exists to validate the
    caller's intent, not to fork the encoding. Returns None for an
    unknown/evicted id; raises ValueError on an unknown format.

    Encoding: ``span`` begin/end pairs become complete ("X") slices on
    the lifecycle lane; a begin with no end (the dead query's open
    span) becomes a bare "B" so Perfetto renders the unfinished slice
    to the end of the trace; ``phase`` events (which carry their
    duration) become "X" slices on the phase lane, named by pipeline
    stage when one is set, with ``roofline_frac`` in args; everything
    else (heal attempts, coalesce membership, collectives, skew,
    terminal serve) becomes an instant ("i") on the event lane.
    Timestamps are microseconds relative to the first event."""
    if fmt not in _EXPORT_FORMATS:
        raise ValueError(
            f"unknown export format {fmt!r}: expected one of "
            f"{_EXPORT_FORMATS}"
        )
    _recorder._resolve_pending()
    with _traces_lock:
        tr = _traces.get(str(query_id))
        if tr is None:
            return None
        tr = {**tr, "events": list(tr["events"])}
    events = tr["events"]
    pid = _export_rank(tr["query_id"])
    t0 = events[0]["ts"] if events else 0.0

    def _us(ts: float) -> float:
        return round((ts - t0) * 1e6, 1)

    def _args(evt: dict, skip: tuple) -> dict:
        return {
            k: v for k, v in evt.items()
            if k not in skip and k not in ("seq", "ts", "type")
        }

    out = []
    for lane, name in (
        (_LANE_SPANS, "lifecycle spans"),
        (_LANE_PHASES, "phases"),
        (_LANE_EVENTS, "events"),
    ):
        out.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": lane,
            "args": {"name": name},
        })
    out.append({
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": f"rank {pid}"},
    })
    open_spans: dict[str, list] = {}
    for evt in events:
        et = evt["type"]
        if et == "span":
            nm = str(evt.get("span", "?"))
            if evt.get("phase") == "begin":
                open_spans.setdefault(nm, []).append(evt)
            else:
                stack = open_spans.get(nm)
                if stack:
                    begin = stack.pop()
                    out.append({
                        "ph": "X", "name": nm, "cat": "span",
                        "pid": pid, "tid": _LANE_SPANS,
                        "ts": _us(begin["ts"]),
                        "dur": round((evt["ts"] - begin["ts"]) * 1e6, 1),
                        "args": {
                            **_args(begin, ("span", "phase")),
                            **_args(evt, ("span", "phase")),
                        },
                    })
        elif et == "phase":
            secs = float(evt.get("seconds") or 0.0)
            stage = evt.get("stage")
            nm = str(evt.get("phase", "?"))
            out.append({
                "ph": "X",
                "name": f"{stage}:{nm}" if stage else nm,
                "cat": "phase", "pid": pid, "tid": _LANE_PHASES,
                "ts": _us(evt["ts"] - secs),
                "dur": round(secs * 1e6, 1),
                "args": _args(evt, ("phase",)),
            })
        else:
            nm = et
            if et == "heal":
                nm = f"heal:{evt.get('stage', '?')}"
            elif et == "serve":
                nm = f"serve:{evt.get('outcome', '?')}"
            elif et == "pipeline":
                nm = f"pipeline:{evt.get('stage', '?')}"
            out.append({
                "ph": "i", "s": "t", "name": nm, "cat": et,
                "pid": pid, "tid": _LANE_EVENTS, "ts": _us(evt["ts"]),
                "args": _args(evt, ()),
            })
    # Open spans LAST (the dead/in-flight query's marker): a bare "B"
    # renders as a slice running to the end of the trace.
    for nm, stack in open_spans.items():
        for begin in stack:
            out.append({
                "ph": "B", "name": nm, "cat": "span",
                "pid": pid, "tid": _LANE_SPANS, "ts": _us(begin["ts"]),
                "args": {**_args(begin, ("span", "phase")), "open": True},
            })
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "metadata": {
            "query_id": tr["query_id"],
            "tenant": tr["tenant"],
            "rank": pid,
            "format": fmt,
            "dropped_events": tr["dropped"],
            "epoch_ts": round(t0, 6),
        },
    }


def clear() -> None:
    """Drop every stored timeline (tests; measurement windows). The
    ambient contexts on live threads are untouched — an in-flight
    query simply starts a fresh timeline on its next event."""
    with _traces_lock:
        _traces.clear()


# Register with the recorder (hooks, not imports: recorder stays
# importable standalone and pays one None-check when tracing is idle).
_recorder._ctx_hook = current_query
_recorder._trace_sink = _sink
_recorder._trace_clear = clear

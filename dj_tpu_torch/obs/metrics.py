"""In-process metrics registry: counters, gauges, histograms.

Counterpart of ``dj_tpu/obs/metrics.py``. Stdlib only, and a strict
no-op while disabled: every mutator's first statement is the enabled
check, so a disabled registry allocates nothing and takes no lock.

Enablement: ``DJT_OBS=1`` (or any truthy value), or implicitly by
``DJT_OBS_LOG=<path>`` (the flight recorder's JSONL sink, recorder.py),
or :func:`enable` / :func:`disable`.

Series are keyed by (name, sorted label items); :func:`metrics_text`
renders them in the Prometheus text format, :func:`metrics_summary` as a
JSON-able dict. The metric names are dj_tpu's (``dj_*``), so one
dashboard reads both packages.
"""

from __future__ import annotations

import threading
from typing import Optional

from .. import knobs

_TRUTHY = ("1", "true", "yes", "on")


def _env_enabled() -> bool:
    v = knobs.read("DJT_OBS")
    if v is not None:
        return str(v).strip().lower() in _TRUTHY
    return bool(knobs.read("DJT_OBS_LOG"))


_enabled: bool = _env_enabled()
_lock = threading.Lock()

# (name, ((label, value), ...)) -> float
_counters: dict[tuple, float] = {}
_gauges: dict[tuple, float] = {}
# (name, labels) -> [bucket_counts list, sum, count, bounds tuple].
_hists: dict[tuple, list] = {}

# Default histogram bounds: seconds, from sub-ms dispatches to minute
# runs. A fixed geometric ladder keeps the observe path allocation-free.
HIST_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


# obs.roofline's resolve of its pending device phases, run before a read
# of the histograms (the recorder's readers run it too). Set at import of
# obs.roofline: this module imports no sibling.
_resolve_hook = None


def _resolve_pending() -> None:
    if _resolve_hook is not None:
        _resolve_hook()


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def inc(name: str, value: float = 1.0, /, **labels) -> None:
    """Add ``value`` to counter ``name`` (label set = one series)."""
    if not _enabled:
        return
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + float(value)


def inc_items(items) -> None:
    """Batched counter update under one lock acquisition: ``items`` is
    an iterable of (name, labels dict, value)."""
    if not _enabled:
        return
    with _lock:
        for name, labels, value in items:
            k = _key(name, labels)
            _counters[k] = _counters.get(k, 0.0) + float(value)


def set_gauge(name: str, value: float, /, **labels) -> None:
    if not _enabled:
        return
    k = _key(name, labels)
    with _lock:
        _gauges[k] = float(value)


def observe(name: str, value: float, /, buckets=None, **labels) -> None:
    """Record ``value`` into histogram ``name``. ``buckets`` pins this
    SERIES' bucket bounds on first observation (default
    ``HIST_BUCKETS``, the latency ladder; ``roofline.FRAC_BUCKETS`` for
    roofline fractions) — later observations of the same series keep
    the established bounds, so mixed callers can't corrupt a
    histogram."""
    if not _enabled:
        return
    k = _key(name, labels)
    v = float(value)
    with _lock:
        h = _hists.get(k)
        if h is None:
            bounds = tuple(buckets) if buckets is not None else HIST_BUCKETS
            h = [[0] * (len(bounds) + 1), 0.0, 0, bounds]
            _hists[k] = h
        for i, bound in enumerate(h[3]):
            if v <= bound:
                h[0][i] += 1
                break
        else:
            h[0][-1] += 1
        h[1] += v
        h[2] += 1


def counter_value(name: str, /, **labels) -> float:
    """Current counter value; with no labels, the SUM over every series
    of that name. Reads work regardless of the enabled flag (the
    registry may hold history)."""
    if labels:
        return _counters.get(_key(name, labels), 0.0)
    # Under _lock: a writer inserting a new label series must not
    # break a concurrent reader's iteration.
    with _lock:
        return sum(v for (n, _), v in _counters.items() if n == name)


def gauge_value(name: str, /, default: float = 0.0, **labels) -> float:
    """Current gauge value (``default`` when the series was never set
    — gauges have no meaningful label-sum, unlike counters)."""
    return _gauges.get(_key(name, labels), default)


def histogram_raw(name: str, /, **labels):
    """Aggregate the bucket state of every series of ``name`` whose
    labels INCLUDE ``labels`` (so ``histogram_raw("h", outcome="ok")``
    sums across tenants): returns ``(bounds, counts, sum, count)`` or
    None if nothing matched. Series whose bounds differ from the first
    match are skipped — summing counts across different ladders would
    be nonsense (one ``observe`` caller per metric name keeps bounds
    uniform in practice). Pending device phases are resolved first."""
    _resolve_pending()
    want = set(labels.items())
    bounds = None
    counts: list = []
    total = 0.0
    n_obs = 0
    with _lock:
        for (nm, la), h in _hists.items():
            if nm != name or not want <= set(la):
                continue
            if bounds is None:
                bounds = h[3]
                counts = [0] * len(h[0])
            elif h[3] != bounds:
                continue
            for i, c in enumerate(h[0]):
                counts[i] += c
            total += h[1]
            n_obs += h[2]
    if bounds is None:
        return None
    return bounds, counts, total, n_obs


def histogram_quantile(name: str, q: float, /, **labels):
    """Prometheus-style quantile estimate (``q`` in [0, 1]) from the
    aggregated bucket counts of ``name`` (filtered by ``labels`` as in
    :func:`histogram_raw`): linear interpolation inside the winning
    bucket, the bucket's lower bound resolution at the +Inf tail.
    Returns None with no observations. Bucket-resolution estimates are
    the POINT for serving percentiles — the exact per-event numbers
    live in the flight recorder, which evicts; the histogram never
    does."""
    raw = histogram_raw(name, **labels)
    if raw is None:
        return None
    bounds, counts, _total, n_obs = raw
    if n_obs == 0:
        return None
    rank = max(0.0, min(1.0, float(q))) * n_obs
    cum = 0
    for i, c in enumerate(counts[:-1]):
        prev_cum = cum
        cum += c
        if cum >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            if c == 0:
                return float(hi)
            frac = (rank - prev_cum) / c
            return float(lo + (hi - lo) * frac)
    # Landed in +Inf: the best honest answer is the last finite bound.
    return float(bounds[-1])


def gauge_series(name: str) -> dict:
    """Every series of gauge ``name``: {label-items tuple: value}."""
    with _lock:
        return {la: v for (n, la), v in _gauges.items() if n == name}


def counter_series(name: str) -> dict:
    """Every series of counter ``name``: {label-items tuple: value}
    (``dj_collective_bytes_total`` by width, for one)."""
    with _lock:
        return {la: v for (n, la), v in _counters.items() if n == name}


def _escape_label(v) -> str:
    """Prometheus exposition label-value escaping: backslash, double
    quote, and newline must be escaped or the line grammar breaks."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_series(name: str, label_items: tuple) -> str:
    if not label_items:
        return name
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in label_items
    )
    return f"{name}{{{inner}}}"


def metrics_text() -> str:
    """Prometheus-style exposition of every series in the registry.
    Pending device phases are resolved first."""
    _resolve_pending()
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        hists = {
            k: [list(h[0]), h[1], h[2], h[3]] for k, h in _hists.items()
        }
    lines: list[str] = []
    seen_type: set[str] = set()

    def _type_line(name: str, kind: str):
        # HELP immediately before TYPE, once per name.
        if name not in seen_type:
            seen_type.add(name)
            lines.append(
                f"# HELP {name} dj_tpu_torch {kind}"
            )
            lines.append(f"# TYPE {name} {kind}")

    for (name, labels), v in sorted(counters.items()):
        _type_line(name, "counter")
        lines.append(f"{_fmt_series(name, labels)} {v:g}")
    for (name, labels), v in sorted(gauges.items()):
        _type_line(name, "gauge")
        lines.append(f"{_fmt_series(name, labels)} {v:g}")
    for (name, labels), (buckets, total, count, bounds) in sorted(
        hists.items()
    ):
        _type_line(name, "histogram")
        cum = 0
        for bound, c in zip(bounds, buckets):
            cum += c
            le = (f"{bound:g}", labels + (("le", f"{bound:g}"),))
            lines.append(
                f"{_fmt_series(name + '_bucket', le[1])} {cum}"
            )
        cum += buckets[-1]
        lines.append(
            f"{_fmt_series(name + '_bucket', labels + (('le', '+Inf'),))}"
            f" {cum}"
        )
        lines.append(f"{_fmt_series(name + '_sum', labels)} {total:g}")
        lines.append(f"{_fmt_series(name + '_count', labels)} {count}")
    return "\n".join(lines) + ("\n" if lines else "")


def metrics_summary() -> dict:
    """JSON-able snapshot: {"counters": {series: value}, "gauges":
    {...}, "histograms": {series: {count, sum, mean}}}. Pending device
    phases are resolved first."""
    _resolve_pending()
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        hists = {k: (h[1], h[2]) for k, h in _hists.items()}
    return {
        "counters": {
            _fmt_series(n, la): v for (n, la), v in sorted(counters.items())
        },
        "gauges": {
            _fmt_series(n, la): v for (n, la), v in sorted(gauges.items())
        },
        "histograms": {
            _fmt_series(n, la): {
                "count": count,
                "sum": round(total, 9),
                "mean": round(total / count, 9) if count else None,
            }
            for (n, la), (total, count) in sorted(hists.items())
        },
    }


def clear_prefix(prefix: str) -> None:
    """Drop every series whose metric name starts with ``prefix``: a
    targeted :func:`reset`."""
    with _lock:
        for d in (_counters, _gauges, _hists):
            for k in [k for k in d if k[0].startswith(prefix)]:
                del d[k]


def reset(reenable: Optional[bool] = None) -> None:
    """Clear every series (tests; serving resets between measurement
    windows). ``reenable`` optionally forces the enabled flag."""
    global _enabled
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
    if reenable is not None:
        _enabled = reenable

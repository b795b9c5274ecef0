"""What the per-layer readers share.

Each per-layer metric is ``metrics/<name>.py`` with ``read(ctx)``,
returning the metric's value or None where the traced run holds
nothing to read. ``ctx`` is what a traced run recorded:

- ``loop``: "closed" (joins back to back) or "open" (served queries);
- ``phases``: per call of the window, one {phase: device ms} per rank
  (the program's ``record_phases``);
- ``profiles``: per rank, the profiled stretch's summary
  (``profiling.summarize``), and ``stretch_calls``, the joins in it;
- ``work``: a join's merged positions and matches, summed over ranks;
- ``queued_s``: the seconds from submit to dispatch of each served
  query due before the traced stretches began (tracing slows the
  dispatcher, so the queue behind it would be the tracer's);
- ``query_cover``: (device-busy seconds, seconds) of the intervals in
  which a served query ran, inside the stretch;
- ``device_kind``: the card's name.
"""

from __future__ import annotations

import math
import statistics
from typing import Optional


def phase_ms(ctx: dict, phase: str, loop: str) -> Optional[float]:
    """The median over the window's calls of the slowest rank's device
    ms in ``phase``, in a run of ``loop``; None where no call marked it."""
    if ctx.get("loop") != loop:
        return None
    per_call = [max(r.get(phase, 0.0) for r in ranks) for ranks in ctx.get("phases") or []
                if any(phase in r for r in ranks)]
    return statistics.median(per_call) if per_call else None


def idle_pct(busy_s: float, span_s: float) -> Optional[float]:
    if span_s <= 0 or busy_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / span_s)


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1) of ``values``."""
    xs = sorted(values)
    k = math.ceil(q * len(xs) - 1e-9)
    return xs[min(len(xs), max(1, k)) - 1]

"""The per-batch destination skew of a partition-count matrix.

Counterpart of ``dj_tpu/obs/skew.py:203-239`` (``batch_skew``), the
signal the skew-adaptive planner (``parallel.plan_adapt``) and the
salted-prepared tier read.
"""

from __future__ import annotations

import numpy as np


def batch_skew(counts, n: int, odf: int, *, topk: int = 3) -> list[dict]:
    """Per odf batch, the destination skew of a per-source partition-count
    matrix ``counts`` ([w, m] with m = n * odf, as
    ``dist_join._partition_probe_counts`` returns it). Batch b's
    destinations are the n group peers of partitions [b n, (b + 1) n);
    a destination's rows are the column sum over the source shards.
    Returns one dict a batch: ``batch``, ``rows`` (the vector),
    ``max_rows``, ``mean_rows``, ``ratio`` (max / mean, 1.0 when empty)
    and ``top`` ([(dest, rows)] heaviest first, ``topk`` entries)."""
    counts = np.asarray(counts)
    out = []
    for b in range(odf):
        rows = counts[:, b * n:(b + 1) * n].sum(axis=0)
        mx = int(rows.max()) if rows.size else 0
        mean = float(rows.mean()) if rows.size else 0.0
        ratio = (mx / mean) if mean > 0 else 1.0
        k = min(topk, len(rows))
        heavy = sorted(((int(d), int(rows[d])) for d in range(len(rows))),
                       key=lambda t: -t[1])[:k]
        out.append({"batch": b, "rows": [int(r) for r in rows], "max_rows": mx,
                    "mean_rows": mean, "ratio": ratio, "top": heavy})
    return out

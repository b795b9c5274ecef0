"""dj_tpu_torch.cache: the join-index cache.

Counterpart of ``dj_tpu/cache/__init__.py``: a multi-tenant store of
resident :class:`~..parallel.dist_join.PreparedSide` keyed by tenant, name,
the source tensors' identity and the plan signature, with budgeted
admission and LRU eviction (``DJT_INDEX_HBM_BUDGET``; pinned entries are
never evicted), appends to a resident side
(:meth:`JoinIndexCache.append_rows`) and a JSONL warm restart
(``DJT_INDEX_MANIFEST``). ``index.py``'s docstring has the design.
"""

from __future__ import annotations

from .index import (
    IndexConfig,
    JoinIndexCache,
    Lease,
    reset,
    resident_bytes,
    shed_bytes,
)

__all__ = [
    "IndexConfig",
    "JoinIndexCache",
    "Lease",
    "reset",
    "resident_bytes",
    "shed_bytes",
]

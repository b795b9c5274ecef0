"""Rank queries against a sorted vector.

Counterpart of ``dj_tpu/core/search.py``. The JAX package builds the
``arange`` queries from a scatter-add histogram, the run ranks from an
unrolled gather loop and ``rank_in_sorted`` from one stable sort,
because XLA's searchsorted is a slow gather loop on a TPU; here
``torch.searchsorted`` is the direct form of all three. Every function requires its sorted operand ascending
under the tensor's own (signed) order: a caller holding u64 words as
int64 bit patterns maps them to an order-preserving image first.
"""

from __future__ import annotations

import torch


def _queries(sorted_vals: torch.Tensor, length: int) -> torch.Tensor:
    return torch.arange(length, dtype=sorted_vals.dtype, device=sorted_vals.device)


def count_leq_arange(sorted_vals: torch.Tensor, length: int) -> torch.Tensor:
    """out[j] = #{k : sorted_vals[k] <= j} for j in [0, length), int32."""
    return torch.searchsorted(
        sorted_vals, _queries(sorted_vals, length), right=True, out_int32=True
    )


def count_lt_arange(sorted_vals: torch.Tensor, length: int) -> torch.Tensor:
    """out[j] = #{k : sorted_vals[k] < j} for j in [0, length), int32."""
    return torch.searchsorted(
        sorted_vals, _queries(sorted_vals, length), right=False, out_int32=True
    )


def interval_of_arange(offsets: torch.Tensor, length: int, n: int) -> torch.Tensor:
    """out[j] = clip(count_leq_arange(offsets, length) - 1, 0, n - 1): the
    interval of an ascending offsets vector with a leading 0 that holds
    position j, for j in [0, length)."""
    return torch.clamp(count_leq_arange(offsets, length) - 1, 0, n - 1)


def rank_in_run(
    sorted_ref: torch.Tensor, queries: torch.Tensor, side: str = "left"
) -> torch.Tensor:
    """Insertion rank of each query in a sorted run, int32:
    ``side="left"`` is the first index with ref >= q, ``side="right"``
    the first with ref > q. Queries need not be sorted."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if sorted_ref.shape[0] == 0:
        return torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    return torch.searchsorted(
        sorted_ref, queries, right=side == "right", out_int32=True
    )


def rank_in_sorted(
    sorted_ref: torch.Tensor, queries: torch.Tensor, side: str = "left"
) -> torch.Tensor:
    """Position of each query in a sorted reference array, int32: the
    ``searchsorted(sorted_ref, queries, side)`` of dj_tpu's
    ``rank_in_sorted`` (core/search.py:62-93), which computes by a sort
    what ``rank_in_run`` computes by a search."""
    return rank_in_run(sorted_ref, queries, side)


def run_bounds(
    sorted_ref: torch.Tensor, queries: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) = (side-left, side-right) ranks of each query in the
    sorted run; ``hi - lo`` is each query's match count."""
    return rank_in_run(sorted_ref, queries, "left"), rank_in_run(sorted_ref, queries, "right")


def segment_index_arange(csum: torch.Tensor, length: int) -> torch.Tensor:
    """out[j] = #{k : csum[k] <= j} for j in [0, length), for a sorted
    (non-decreasing) csum: the rank form of ``count_leq_arange``."""
    return rank_in_run(csum, _queries(csum, length), "right")

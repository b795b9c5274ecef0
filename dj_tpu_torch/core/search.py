"""Rank queries of ``arange(length)`` against a sorted vector.

Counterpart of ``dj_tpu/core/search.py:25-50``. The JAX package builds
these from a scatter-add histogram because XLA's searchsorted is a slow
gather loop on a TPU; here ``torch.searchsorted`` is the direct form.
Both require ``sorted_vals`` ascending and non-negative.
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

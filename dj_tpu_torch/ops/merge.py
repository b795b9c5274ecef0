"""Merge of two ascending u64 word arrays: the prepared join's merge tier.

Counterpart of ``dj_tpu/ops/pallas_merge.py``. The words are u64 bit
patterns held in int64 tensors (padding all-ones, -1 as int64), ascending
in unsigned order. ``merge_sorted_u64`` launches the CUDA kernel
``csrc/merge_sorted_u64.cu`` for tensors on the card and takes the plain
version, ``merge_sorted_u64_plain`` (an unsigned sort of the
concatenation), for tensors on the CPU. ``merge_splits`` is the tile
split rule the kernel's first pass computes, in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1

launches = 0  # kernel launches made by merge_sorted_u64
TILE = 4096  # merged words per block (csrc/merge_sorted_u64.cu)


def sort_u64(words: torch.Tensor) -> torch.Tensor:
    """``words`` sorted ascending as unsigned 64-bit: flipping the top
    bit maps unsigned order onto int64's signed order, and back. The
    flip is made in place, so ``words`` is left scrambled: pass a tensor
    the caller no longer needs (it saves a copy of the operand)."""
    return torch.sort(words.bitwise_xor_(INT64_MIN)).values.bitwise_xor_(INT64_MIN)


def _at(x: torch.Tensor, idx: torch.Tensor, fill: int) -> torch.Tensor:
    """``x[idx]`` with ``fill`` where idx is outside [0, len(x))."""
    n = x.shape[0]
    if n == 0:
        return torch.full(idx.shape, fill, dtype=x.dtype, device=idx.device)
    return torch.where((idx >= 0) & (idx < n), x[idx.clamp(0, n - 1)], fill)


def merge_splits(a: torch.Tensor, b: torch.Tensor, tile: int) -> torch.Tensor:
    """Merge-path diagonal splits, int32[P+1] with P = ceil(S / tile):
    ia[p] = #words of ``a`` among the first min(p * tile, S) words of
    merge(a, b), A first on ties (the largest i with a[i-1] <= b[k-i])."""
    R, L = a.shape[0], b.shape[0]
    S = R + L
    P = -(-S // tile) if S else 1
    af, bf = a ^ INT64_MIN, b ^ INT64_MIN  # unsigned order as signed
    k = torch.clamp_max(torch.arange(P + 1, dtype=torch.int64, device=a.device) * tile, S)
    lo = torch.clamp_min(k - L, 0)
    hi = torch.clamp_max(k, R)
    for _ in range(max(1, R.bit_length() + 1)):
        mid = (lo + hi + 1) // 2
        take = _at(af, mid - 1, INT64_MAX) <= _at(bf, k - mid, INT64_MAX)
        go = lo < hi
        lo, hi = (
            torch.where(go & take, mid, lo),
            torch.where(go & ~take, mid - 1, hi),
        )
    return lo.to(torch.int32)


def merge_sorted_u64_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch formulation: the unsigned sort of the concatenation
    (``lax.sort(concatenate([a, b]))`` in the JAX package)."""
    return sort_u64(torch.cat([a, b]))


def merge_sorted_u64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """merge(a, b), (R + L,) int64 bit patterns ascending in unsigned
    order; the CUDA kernel on the card, the plain version on the CPU."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int64 (u64 bits), got {t.dtype} {tuple(t.shape)}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    R, L = a.shape[0], b.shape[0]
    if R + L >= 2**31 - 1:
        raise ValueError(f"R + L = {R + L} outside the int32 split domain")
    dev = a.device
    if dev.type == "cpu":
        return merge_sorted_u64_plain(a, b)
    if dev.type != "cuda":
        raise ValueError(f"merge_sorted_u64: unsupported device {dev}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("merge_sorted_u64: a and b must be contiguous")
    out = torch.empty(R + L, dtype=torch.int64, device=dev)
    if R + L == 0:
        return out
    lib = cuda_build.load("merge_sorted_u64")
    lib.dj_merge_sorted_u64_scratch_ints.argtypes = [ctypes.c_longlong]
    lib.dj_merge_sorted_u64_scratch_ints.restype = ctypes.c_longlong
    fn = lib.dj_merge_sorted_u64
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits = torch.empty(
        lib.dj_merge_sorted_u64_scratch_ints(R + L), dtype=torch.int32, device=dev
    )
    global launches
    launches += 1
    rc = fn(
        a.data_ptr(), b.data_ptr(), splits.data_ptr(), out.data_ptr(), R, L,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "merge_sorted_u64")
    return out

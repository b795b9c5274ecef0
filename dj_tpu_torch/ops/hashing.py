"""Row hashing: vectorized MurmurHash3_x86_32, bit-exact with dj_tpu.

Counterpart of ``dj_tpu/ops/hashing.py:38-105, 194-229`` for fixed-width
columns. PyTorch's uint32 arithmetic has little operator coverage (less
on CUDA), so every 32-bit value is held in an int64 tensor in
[0, 2^32), and each multiply is split into two 16-bit halves so that no
product leaves the int64 range. Hashes are returned in that int64 form.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.table import Column, Table

M32 = 0xFFFFFFFF

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_N = 0xE6546B64

DEFAULT_HASH_SEED = 0  # cudf::DEFAULT_HASH_SEED

HASH_MURMUR3 = "murmur3"
HASH_IDENTITY = "identity"


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c,
    with every partial product below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def _mix_block(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    k = _mul32(k, _C1)
    k = _rotl32(k, 15)
    k = _mul32(k, _C2)
    h = h ^ k
    h = _rotl32(h, 13)
    return (_mul32(h, 5) + _N) & M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 16)


def _bits64(data: torch.Tensor) -> torch.Tensor:
    """The element's little-endian bits as int64 (same width view)."""
    if data.is_floating_point():
        # -0.0 and the subnormals -> 0.0: dj_tpu's ``data == 0`` under
        # XLA, which flushes subnormals to zero.
        zero = data.abs() < torch.finfo(data.dtype).tiny
        data = torch.where(zero, torch.zeros_like(data), data)
        data = data.view(torch.int64 if data.element_size() == 8 else torch.int32)
    if data.dtype == torch.uint64:
        return data.view(torch.int64)
    return data.to(torch.int64)


def murmur3_32(data: torch.Tensor, seed: int = DEFAULT_HASH_SEED) -> torch.Tensor:
    """MurmurHash3_x86_32 of each element's little-endian bytes.

    1/2/4-byte elements and 8-byte elements (two 32-bit blocks). Returns
    the uint32 hash values held in an int64 tensor.
    """
    nbytes = data.element_size()
    bits = _bits64(data)
    h = torch.full_like(bits, int(seed) & M32)
    if nbytes == 8:
        h = _mix_block(h, bits & M32)
        h = _mix_block(h, (bits >> 32) & M32)
        h = h ^ 8
    elif nbytes == 4:
        h = _mix_block(h, bits & M32)
        h = h ^ 4
    elif nbytes in (1, 2):
        k = bits & ((1 << (8 * nbytes)) - 1)
        k = _mul32(k, _C1)
        k = _rotl32(k, 15)
        k = _mul32(k, _C2)
        h = h ^ k ^ nbytes
    else:
        raise TypeError(f"unsupported element width {nbytes}")
    return _fmix32(h)


def hash_combine(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """cuDF/boost-style 32-bit hash combine (values in [0, 2^32))."""
    return lhs ^ ((rhs + 0x9E3779B9 + ((lhs << 6) & M32) + (lhs >> 2)) & M32)


def hash_columns(
    columns: Sequence[Column],
    seed: int = DEFAULT_HASH_SEED,
    hash_function: str = HASH_MURMUR3,
) -> torch.Tensor:
    """Combined 32-bit row hash over the given columns (int64 tensor)."""
    for col in columns:
        if not isinstance(col, Column):
            raise NotImplementedError(
                "string columns come with ROADMAP queue 1 item 6 (strings)"
            )
    if hash_function == HASH_IDENTITY:
        assert len(columns) == 1, "identity hash takes one column"
        data = columns[0].data
        if data.is_floating_point():
            # The value converted to uint32 (dj_tpu's astype(uint32)):
            # truncation toward zero, for values in [0, 2^31).
            return data.to(torch.int64) & M32
        return _bits64(data) & M32
    h = murmur3_32(columns[0].data, seed)
    for col in columns[1:]:
        h = hash_combine(h, murmur3_32(col.data, seed))
    return h


def hash_table(
    table: Table,
    on_columns: Sequence[int],
    seed: int = DEFAULT_HASH_SEED,
    hash_function: str = HASH_MURMUR3,
) -> torch.Tensor:
    return hash_columns([table.columns[i] for i in on_columns], seed, hash_function)

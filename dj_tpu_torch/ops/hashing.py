"""Row hashing: vectorized MurmurHash3_x86_32, bit-exact with dj_tpu.

Counterpart of ``dj_tpu/ops/hashing.py``. PyTorch's uint32 arithmetic
has little operator coverage (less on CUDA), so every 32-bit value is
held in an int64 tensor in [0, 2^32), and each multiply is split into
two 16-bit halves so that no product leaves the int64 range. Hashes are
returned in that int64 form.

A string hashes its first min(len, 64) bytes with murmur3 and XORs in
its true length (``_string_hash``); ``string_surrogate64`` packs two
such hashes under two seeds into the int64 a string join key joins
through. dj_tpu builds a dense [rows, 64] byte matrix for this; here
the words are walked one at a time, four one-byte gathers each, so the
memory stays O(rows).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.table import Column, StringColumn, Table, take_fill

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


# Bytes of each string the surrogate hash reads (plus the true length).
# The join's collision verifier compares exactly this window
# (ops/join.py _verify_string_pairs): the two must stay one constant.
SURROGATE_MAX_LEN = 64

# The two seeds of string_surrogate64 (dj_tpu/ops/hashing.py:180-181).
_SURROGATE_SEEDS = (0xB0F57EE3, 0x83B58237)


def _string_hashes(col: StringColumn, seeds: Sequence[int],
                   max_len: int = SURROGATE_MAX_LEN) -> list[torch.Tensor]:
    """``_string_hash`` of ``col`` under each seed, sharing the byte
    gathers. Word w of a row is its bytes 4w..4w+3 below min(len,
    max_len), little-endian, zero past them; the full words mix in
    order, a 1-3 byte tail mixes without the h-rotate step, and the true
    length is XORed in before the final mix. Words past the longest
    string's prefix change no hash and are not walked (one host read of
    that length)."""
    true_sizes = col.sizes().to(torch.int64)
    n = true_sizes.shape[0]
    sizes = true_sizes.clamp_max(max_len)
    full_blocks = sizes // 4
    tail_len = sizes % 4
    starts = col.offsets[:-1].to(torch.int64)
    nwords = -(-min(max_len, int(sizes.max())) // 4) if n else 0
    hs = [torch.full((n,), int(s) & M32, dtype=torch.int64, device=col.device) for s in seeds]
    tail = torch.zeros(n, dtype=torch.int64, device=col.device)
    for w in range(nwords):
        word = torch.zeros(n, dtype=torch.int64, device=col.device)
        for b in range(4):
            j = 4 * w + b
            byte = take_fill(col.chars, starts + j).to(torch.int64)
            word |= byte.masked_fill_(sizes <= j, 0) << (8 * b)
        is_block = w < full_blocks
        hs = [torch.where(is_block, _mix_block(h, word), h) for h in hs]
        tail = torch.where(full_blocks == w, word, tail)
    has_tail = tail_len > 0
    k1 = tail & ((1 << (8 * tail_len)) - 1)
    k1 = _mul32(_rotl32(_mul32(k1, _C1), 15), _C2)
    return [_fmix32(torch.where(has_tail, h ^ k1, h) ^ (true_sizes & M32)) for h in hs]


def _string_hash(col: StringColumn, seed: int, max_len: int = SURROGATE_MAX_LEN
                 ) -> torch.Tensor:
    """Murmur3 of each string's first min(len, max_len) bytes, XOR its
    true length (``_string_hash``, dj_tpu/ops/hashing.py:114-162): the
    exact MurmurHash3_x86_32 of strings up to ``max_len`` bytes, a
    prefix hash of longer ones. uint32 values in an int64 tensor."""
    return _string_hashes(col, (seed,), max_len)[0]


def string_surrogate64(col: StringColumn, max_len: int = SURROGATE_MAX_LEN) -> torch.Tensor:
    """The int64 join surrogate of a string key column: two
    ``_string_hash`` values under two seeds packed ``(h1 << 32) | h2``,
    as int64 bits (``string_surrogate64``, dj_tpu/ops/hashing.py:
    165-191). Equal strings get equal surrogates; distinct ones collide
    with probability about n^2 / 2^65, which the join's verifier
    catches. Strings longer than ``max_len`` that share that prefix and
    their length are equal by design."""
    h1, h2 = _string_hashes(col, _SURROGATE_SEEDS, max_len)
    return (h1 << 32) | h2


def hash_columns(
    columns: Sequence,
    seed: int = DEFAULT_HASH_SEED,
    hash_function: str = HASH_MURMUR3,
) -> torch.Tensor:
    """Combined 32-bit row hash over the given columns (int64 tensor):
    murmur3 of each fixed-width column, ``_string_hash`` of each string
    column, combined in order. The identity hash takes one fixed-width
    column."""
    if hash_function == HASH_IDENTITY:
        assert len(columns) == 1, "identity hash takes one column"
        assert isinstance(columns[0], Column), "identity hash takes a fixed-width column"
        data = columns[0].data
        if data.is_floating_point():
            # The value converted to uint32 (dj_tpu's astype(uint32)):
            # truncation toward zero, for values in [0, 2^31).
            return data.to(torch.int64) & M32
        return _bits64(data) & M32
    hashes = [
        _string_hash(col, seed) if isinstance(col, StringColumn) else murmur3_32(col.data, seed)
        for col in columns
    ]
    h = hashes[0]
    for other in hashes[1:]:
        h = hash_combine(h, other)
    return h


def hash_table(
    table: Table,
    on_columns: Sequence[int],
    seed: int = DEFAULT_HASH_SEED,
    hash_function: str = HASH_MURMUR3,
) -> torch.Tensor:
    return hash_columns([table.columns[i] for i in on_columns], seed, hash_function)

"""Local inner join, packed single-int-key path: one merged sort + scans.

Counterpart of ``dj_tpu/ops/join.py::inner_join`` on the path the
reference's headline benchmark takes, with its column-order contract:
the result is every left column (the join column included) followed by
the right columns without ``right_on``. The output has a static
capacity and the true int64 match total comes back beside it, so a
caller can detect overflow.

1. Key and row tag pack into one u64 word, ``(key - min) << tag_bits |
   tag``, refs (right rows) tagged 0..R-1 before queries (left rows)
   R..R+L-1; padding rows pack to all-ones. One ``torch.sort`` orders
   the words (as int64 with the top bit flipped, which is unsigned
   order under a signed compare).
2. ``ops.scan.join_scans`` (CUDA kernel) turns the sorted words into
   (stag, run_start, cnt, csum).
3. ``ops.expand.expand_values`` (CUDA kernel) gives each output slot
   its left row's merged tag and its matched ref's merged position.
4. Row gathers build the output columns.

Multi-key joins, carry modes and keys that the packed word cannot hold
(float keys, mixed key dtypes, uint64 keys, a key range too wide) raise
NotImplementedError: they come with later slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.table import Column, Table, take_fill
from .expand import expand_values
from .scan import join_scans

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1


def _unsigned_order_int(v: int, dtype) -> int:
    """Host mirror of _to_unsigned_order for a python int."""
    d = np.dtype(dtype)
    v = int(v)
    if np.issubdtype(d, np.signedinteger):
        return v + (1 << (8 * d.itemsize - 1))
    return v


class KeyPackPlan(NamedTuple):
    """Static pack decision for a declared/probed per-key value range:
    ``fits`` says the packed single-word plan is legal; ``widths`` and
    ``shifts`` give each key's field (one entry for a single key)."""

    fits: bool
    widths: tuple[int, ...]
    shifts: tuple[int, ...]


def normalize_key_range(key_range, n_keys: int):
    """Accept one (min, max) pair or a sequence of per-key pairs; return
    a tuple of python-int pairs, or None."""
    if key_range is None:
        return None
    kr = tuple(key_range)
    if len(kr) == 2 and not hasattr(kr[0], "__len__"):
        kr = (kr,)
    if len(kr) != n_keys:
        raise ValueError(f"key_range has {len(kr)} entries for {n_keys} join keys")
    out = []
    for lo, hi in kr:
        lo, hi = int(lo), int(hi)
        if hi < lo:
            raise ValueError(f"key_range pair ({lo}, {hi}) has max < min")
        out.append((lo, hi))
    return tuple(out)


def plan_key_pack(key_range, dtypes, S: int) -> KeyPackPlan:
    """Static pack decision for keys bounded by ``key_range`` (normalized
    physical bounds per key) at merged capacity ``S``. Only the spans
    matter: the pack subtracts the observed minimum."""
    tag_bits = max(1, int(S).bit_length())
    spans = [
        _unsigned_order_int(hi, d) - _unsigned_order_int(lo, d)
        for (lo, hi), d in zip(key_range, dtypes)
    ]
    widths = [s.bit_length() for s in spans]
    shifts = []
    acc = 0
    for w in reversed(widths):
        shifts.append(acc)
        acc += w
    shifts = tuple(reversed(shifts))
    # Strictly below the all-ones sentinel's key field.
    m = sum(s << sh for s, sh in zip(spans, shifts))
    fits = sum(widths) + tag_bits <= 64 and m < (1 << (64 - tag_bits)) - 1
    return KeyPackPlan(fits, tuple(widths), shifts)


def canonical_key_range(key_range, dtypes):
    """Quantize a probed range to its width-canonical form (0, 2^w - 1)."""
    out = []
    for (lo, hi), d in zip(key_range, dtypes):
        w = (_unsigned_order_int(hi, d) - _unsigned_order_int(lo, d)).bit_length()
        out.append((0, (1 << w) - 1))
    return tuple(out)


def _to_unsigned_order(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of an integer column to u64 bits (int64
    tensor): signed values get their sign bit flipped."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    bits = 8 * x.element_size()
    signed = x.dtype.is_signed
    if bits == 64:
        return x ^ INT64_MIN
    u = x.to(torch.int64)
    return u + (1 << (bits - 1)) if signed else u


def _from_unsigned_order(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of _to_unsigned_order for the physical dtype."""
    if dtype == torch.uint64:
        return u.view(torch.uint64)
    bits = 8 * torch.empty((), dtype=dtype).element_size()
    if bits == 64:
        return u ^ INT64_MIN
    if dtype.is_signed:
        u = u - (1 << (bits - 1))
    return u.to(dtype)


def _flag(value: bool, device) -> torch.Tensor:
    return torch.tensor(value, device=device)


def _check_supported(left, right, left_on, right_on, carry_payloads):
    if carry_payloads:
        raise NotImplementedError(
            "carry_payloads (payloads riding the sort) comes with a later "
            "slice of the port"
        )
    if len(left_on) != 1:
        raise NotImplementedError(
            "multi-key joins come with a later slice of the port"
        )
    a, b = left.columns[left_on[0]], right.columns[right_on[0]]
    if not (
        dt.is_integer(a.dtype)
        and a.data.dtype == b.data.dtype
        and a.data.dtype != torch.uint64
    ):
        raise NotImplementedError(
            "keys that are not one signed or <= 32-bit unsigned integer "
            "dtype on both sides take the unpacked sort, which comes with "
            "a later slice of the port"
        )


def _packed_sorted_words(
    lk: torch.Tensor, rk: torch.Tensor, l_count, r_count, tag_bits: int,
    static_fit: Optional[bool],
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ascending packed words (u64 bits in int64) and the
    pack_range_overflow flag. ``_packed_merged_sort`` + ``_pack_sort_core``
    of dj_tpu/ops/join.py:500-716, monolithic sort only."""
    L, R = lk.shape[0], rk.shape[0]
    S = L + R
    dev = lk.device
    valid = torch.cat(
        [
            torch.arange(R, device=dev) < r_count,
            torch.arange(L, device=dev) < l_count,
        ]
    )
    pack_ovf = _flag(False, dev)
    if 8 * lk.element_size() + tag_bits <= 64:
        # Narrow keys: the unsigned-order image fits beside the tag as is.
        word = _to_unsigned_order(torch.cat([rk, lk]))
    else:
        if static_fit is False:
            raise NotImplementedError(
                "a declared key range wider than the packed word takes the "
                "unpacked sort, which comes with a later slice of the port"
            )
        # 64-bit keys: signed order of the key is unsigned order of its
        # image, and (key - kmin) in wrapping int64 is the u64 span.
        word = torch.cat([rk, lk])
        kmin = torch.where(valid, word, INT64_MAX).min()
        kmax = torch.where(valid, word, INT64_MIN).max()
        span = kmax - kmin
        limit = (1 << (64 - tag_bits)) - 1
        fits = (span >= 0) & (span < limit)
        pack_ovf = ~fits & (l_count > 0) & (r_count > 0)
        if static_fit is None and bool(pack_ovf):
            raise NotImplementedError(
                "keys whose observed range does not fit the packed word take "
                "the unpacked sort, which comes with a later slice of the port"
            )
        word = word - kmin
    word.bitwise_left_shift_(tag_bits)
    word.bitwise_or_(torch.arange(S, dtype=torch.int64, device=dev))
    word.masked_fill_(~valid, -1)
    # Sort u64 words as int64: flipping the top bit maps unsigned order
    # onto signed order, and back after the sort.
    word.bitwise_xor_(INT64_MIN)
    sp = torch.sort(word).values
    del word
    return sp.bitwise_xor_(INT64_MIN), pack_ovf


def inner_join(
    left: Table,
    right: Table,
    left_on: Sequence[int],
    right_on: Sequence[int],
    out_capacity: Optional[int] = None,
    carry_payloads: Optional[bool] = None,
    return_flags: bool = False,
    key_range=None,
):
    """Inner-join two tables on one integer key column of each.

    Returns (result, total), or (result, total, flags) with
    ``return_flags``: ``result`` has static capacity ``out_capacity``
    (default max(left, right) capacity) and valid_count = min(total,
    out_capacity); ``total`` is the true int64 match count. On overflow
    (total > out_capacity) the whole output is unspecified. ``flags``
    holds ``surrogate_collision`` (always False: no string keys here) and
    ``pack_range_overflow`` (a declared ``key_range`` lied about the
    span so the packed word overflowed; the output is then
    unspecified). ``key_range`` makes the pack decision static, as in
    dj_tpu; without it a 64-bit key's range is checked on the host.
    """
    if len(left_on) != len(right_on):
        raise ValueError(
            f"left_on and right_on must have equal length, got "
            f"{len(left_on)} and {len(right_on)}"
        )
    for name, on, tbl in (("left_on", left_on, left), ("right_on", right_on, right)):
        for c in on:
            if not 0 <= c < tbl.num_columns:
                raise IndexError(
                    f"{name} index {c} out of range for table with "
                    f"{tbl.num_columns} columns"
                )
    _check_supported(left, right, left_on, right_on, carry_payloads)
    key_range = normalize_key_range(key_range, 1)
    if out_capacity is None:
        out_capacity = max(left.capacity, right.capacity)
    L, R = left.capacity, right.capacity
    S = L + R
    if S > 2**31 - 1:
        raise ValueError(
            f"combined capacity {S} exceeds the int32 merged-position "
            f"domain (2^31 - 1); shard the join (distributed_inner_join "
            f"batches via over_decom_factor) instead"
        )
    if out_capacity > 2**31 - 1:
        raise ValueError(
            f"out_capacity {out_capacity} exceeds the int32 output-"
            f"position domain (2^31 - 1); shard the join instead"
        )
    dev = left.device
    out_cols_src = list(left.columns) + [
        c for i, c in enumerate(right.columns) if i != right_on[0]
    ]
    flags = {"surrogate_collision": _flag(False, dev), "pack_range_overflow": _flag(False, dev)}
    if S == 0:
        cols = tuple(
            Column(torch.zeros(out_capacity, dtype=c.data.dtype, device=dev), c.dtype)
            for c in out_cols_src
        )
        result = (
            Table(cols, torch.zeros((), dtype=torch.int32, device=dev)),
            torch.zeros((), dtype=torch.int64, device=dev),
        )
        return result + (flags,) if return_flags else result

    l_count, r_count = left.count(), right.count()
    lk = left.columns[left_on[0]].data
    rk = right.columns[right_on[0]].data
    tag_bits = max(1, S.bit_length())
    static_fit = None
    if key_range is not None:
        static_fit = plan_key_pack(key_range, [np.dtype(left.columns[left_on[0]].dtype.physical)], S).fits
    sp, pack_ovf = _packed_sorted_words(lk, rk, l_count, r_count, tag_bits, static_fit)
    flags["pack_range_overflow"] = pack_ovf

    stag, run_start, cnt, csum = join_scans(sp, l_count, r_count, tag_bits, L, R)
    del sp
    total = cnt.sum(dtype=torch.int64)
    stag_j, rpos = expand_values(csum, cnt, stag, run_start, out_capacity)
    del csum, cnt, run_start

    valid_out = torch.arange(out_capacity, device=dev) < total
    li = torch.where(valid_out, stag_j, L)
    rpos = torch.where(valid_out, rpos, S)
    in_range = (rpos >= 0) & (rpos < S)
    rtag = torch.where(in_range, stag[rpos.clamp(0, S - 1)], L)
    rrow = torch.where(valid_out, rtag - L, R)
    del stag_j, rpos, in_range, rtag, stag

    cols = [c.take(li) for c in left.columns] + [
        c.take(rrow) for i, c in enumerate(right.columns) if i != right_on[0]
    ]
    count = torch.minimum(total, torch.tensor(out_capacity, device=dev)).to(torch.int32)
    result = (Table(tuple(cols), count), total)
    return result + (flags,) if return_flags else result

"""Local inner join: one merged sort, the match scans, the expansion.

Counterpart of ``dj_tpu/ops/join.py::inner_join`` for every fixed-width
key, with its column-order contract: the result is every left column
(the join columns included) followed by the right columns without
``right_on``. The output has a static capacity and the true int64 match
total comes back beside it, so a caller can detect overflow.

1. The merged sort puts refs (right rows) before queries (left rows) in
   each run of equal keys. ``effective_plan`` picks one of three forms:

   - packed, one int key (``_single_key_pack``): key and row tag pack
     into one u64 word, ``(key - min) << tag_bits | tag``, refs tagged
     0..R-1 before queries R..R+L-1, padding all-ones. One
     ``torch.sort`` orders the words (``ops.merge.sort_u64``: as int64
     with the top bit flipped, which is unsigned order under a signed
     compare). uint64 keys pack as int64 with the top bit flipped. A
     64-bit key whose declared range does not fit (``static_fit`` False)
     or whose observed span does not fit takes the unpacked sort;
   - packed, several int keys (``_multi_key_pack_word``): a declared or
     probed range whose fields fit the word packs them mixed-radix into
     the same word, which then takes the single-key machinery;
   - unpacked (``_unpacked_words``): float keys, keys of two dtypes
     (promoted as ``jnp.concatenate`` promotes them), several keys
     without a packable range, ``carry_payloads`` and ``DJT_JOIN_PACK=0``.
     PyTorch has no variadic sort: stable ``torch.sort`` passes over an
     order-preserving int64 image of each key column, last column
     first, compose the lexicographic order (valid rows first, then the
     keys, refs before queries). The dense run id and the row re-pack
     into ascending words ``run_id << tag_bits | row``, padding
     all-ones, so the scans below read every path alike.
2. ``ops.scan.join_scans`` (CUDA kernel) turns the sorted words into
   (stag, run_start, cnt, csum).
3. The duplicate expansion (``ops/expand.py``, one CUDA kernel per
   mode) tells each output slot which rows it joins.
4. Row gathers build the output columns, one column at a time.

The expansion mode is ``DJT_JOIN_EXPAND`` (``resolve_expand_impl``),
``dj_tpu``'s ``DJ_JOIN_EXPAND`` under the port's short names:

- "vmeta" (default; ``pallas-vmeta``): ``expand_values`` gives (left
  tag, matched ref's merged position) per slot;
- "ranks" (``pallas``): ``expand_ranks`` gives src, then src's own run
  starts give the within-run offset t (``_run_offsets``) and one gather
  the (stag, run_start) metadata at src;
- "hist" (``hist``, dj_tpu's non-TPU default): as "ranks" with src from
  ``core.search.count_leq_arange``, no kernel;
- "fused" (``pallas-fused``): ``expand_gather`` gives src and that
  metadata in one pass, t as in "ranks";
- "join" (``pallas-join``): ``expand_join`` gives both row tags;
- "vcarry" (``pallas-vcarry``): the payloads ride the sort as union u64
  slots (``_union_slots``); ``expand_carry`` expands the left payloads
  at src and gathers at the matched refs give the key and the right
  payloads;
- "vfull" (``pallas-vfull``): as "vcarry", but ``expand_vfull`` also
  reads the key and the right payloads at the matched refs.

``carry_payloads`` (``DJT_JOIN_CARRY``, dj_tpu's ``DJ_JOIN_CARRY``)
carries the payload slots through the unpacked sort and expands with
"ranks" or "hist". ``effective_plan`` applies ``dj_tpu``'s gates: vcarry
and vfull need one int key on the packed path, at most three payload
slots and no string column, and run vmeta otherwise. Every plan gives
the same rows.

String payload columns ride the output gather (``StringColumn.take``)
with ``char_out_factor`` times their input char capacity; a result that
needs more bytes keeps true offsets and reports ``char_overflow()``.
A string key pair joins through ``hashing.string_surrogate64``
(``_surrogate_string_keys``): the int64 surrogates are appended to both
sides and joined as an int key, the left string key stays in the output
as a payload and the right one is dropped. With ``return_flags`` the
verifier re-reads both keys' first 64 bytes and lengths at every matched
pair (``_verify_string_pairs``, ``DJT_STRING_VERIFY``, default on) and
raises ``surrogate_collision`` where distinct strings shared a
surrogate.

The prepared build side (``dj_tpu/ops/join.py:1861-2497``) shares the
scans and expansion: ``plan_prepared_pack`` anchors the pack to a key
range so that words packed at different times compare,
``prepare_packed_batch`` sorts a build batch once, and each query joins
a probe batch against it with ``inner_join_prepared`` under one of three
merge tiers (``DJT_JOIN_MERGE``): "sort" re-sorts the concatenation,
"merge" sorts the probe words alone and merges them in one pass
(``ops.merge.merge_sorted_u64``, CUDA kernel), "probe"
(``inner_join_probe``) sorts nothing and binary-searches each probe key
in the resident run, expanding under ``DJT_PROBE_EXPAND``: "segment"
(default) and "hist" rank with ``ops.expand.expand_ranks`` (CUDA kernel),
"pallas" takes (row, offset) from ``ops.expand.expand_values`` (CUDA
kernel). String payloads of either side ride the output gather as in the
unprepared join, and ``merge_packed_batch`` merges appended build rows
into a prepared batch in place of a fresh prepare.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.search import count_leq_arange, run_bounds
from ..core.table import Column, StringColumn, Table, concatenate, gather_fill, take_fill
from . import hashing
from .expand import (
    expand_carry,
    expand_gather,
    expand_join,
    expand_ranks,
    expand_values,
    expand_vfull,
)
from .merge import merge_sorted_u64, sort_u64
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


def intersect_key_ranges(a, b):
    """Elementwise intersection of two normalized per-key ranges
    (dj_tpu/ops/join.py:206-226): the bounds of an inner join's output
    key columns, whose every value exists on both sides. A disjoint pair
    (the join is empty) collapses to the point at the higher low; either
    side None gives None."""
    if a is None or b is None:
        return None
    out = []
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        out.append((lo, max(lo, hi)))
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


def _signed_image64(x: torch.Tensor) -> torch.Tensor:
    """A 64-bit integer key as int64 in the same order: int64 itself,
    uint64 with its top bit flipped. PyTorch's CUDA build has no uint64
    sort, min, max, where or comparison, so uint64 keys live here."""
    return x.view(torch.int64) ^ INT64_MIN if x.dtype == torch.uint64 else x


def _flag(value: bool, device) -> torch.Tensor:
    return torch.tensor(value, device=device)


def _dtype_bits(d: torch.dtype) -> int:
    return 8 * torch.empty((), dtype=d).element_size()


_SIGNED_OF_BITS = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}


def promote_key_dtype(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """The dtype two key columns compare in: ``jnp.promote_types`` with
    64-bit types enabled (the lattice ``jnp.concatenate`` applies in
    dj_tpu's unpacked sort). Any int with a float gives the float; a
    signed and an unsigned int give the signed int twice the unsigned
    width, and uint64 with any signed int gives float64."""
    if a == b or b == torch.bool:
        return a
    if a == torch.bool:
        return b
    fa, fb = a.is_floating_point, b.is_floating_point
    if fa and fb:
        if {a, b} == {torch.float16, torch.bfloat16}:
            return torch.float32
        return a if _dtype_bits(a) >= _dtype_bits(b) else b
    if fa or fb:
        return a if fa else b
    if a.is_signed == b.is_signed:
        return a if _dtype_bits(a) >= _dtype_bits(b) else b
    s, u = (a, b) if a.is_signed else (b, a)
    if u == torch.uint64:
        return torch.float64
    return _SIGNED_OF_BITS[max(_dtype_bits(s), 2 * _dtype_bits(u))]


def _order_image(x: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the key order of ``x``, as
    ``jax.lax.sort`` and ``!=`` order it under XLA: ints by value;
    floats with -0.0 and the subnormals equal to 0.0 (XLA flushes
    subnormals to zero) and every NaN equal and above +inf (INT64_MAX).
    A finite float's bits, negative ones with the magnitude bits
    flipped, compare as signed ints in the float's order."""
    if not x.is_floating_point():
        return _signed_image64(x) if _dtype_bits(x.dtype) == 64 else x.to(torch.int64)
    if x.dtype == torch.float64:
        b = x.view(torch.int64)
        img = b ^ ((b >> 63) & INT64_MAX)
    else:
        x32 = x.to(torch.float32)
        b = x32.view(torch.int32)
        img = (b ^ ((b >> 31) & (2**31 - 1))).to(torch.int64)
    tiny = torch.finfo(x.dtype).tiny
    return img.masked_fill_(x.abs() < tiny, 0).masked_fill_(torch.isnan(x), INT64_MAX)


def _single_int_key(left: Table, right: Table, left_on, right_on) -> bool:
    """One fixed-width key column of the same integer dtype on both
    sides (``_single_int_key``, dj_tpu/ops/join.py:1160-1171)."""
    if len(left_on) != 1:
        return False
    return _same_int_dtype(left.columns[left_on[0]], right.columns[right_on[0]])


def _same_int_dtype(a, b) -> bool:
    """Two fixed-width columns of one integer dtype."""
    if not (isinstance(a, Column) and isinstance(b, Column)):
        return False
    a, b = a.data, b.data
    return a.dtype == b.dtype and not a.is_floating_point() and a.dtype != torch.bool


def _surrogate_string_keys(left: Table, right: Table, left_on, right_on):
    """String key pairs as int64 surrogate keys (``_surrogate_string_keys``,
    dj_tpu/ops/join.py:826-888). Each pair's ``string_surrogate64``
    columns are appended to both tables and the key indices redirected
    to them. Returns (left, right, left_on, right_on, left_drop,
    right_drop, str_pairs): ``left_drop`` holds the appended left
    surrogates (never output), ``right_drop`` the original right string
    keys (dropped like any right key; the left string key stays as a
    payload), ``str_pairs`` the original (left, right) string key
    columns the verifier reads. A string key against a fixed-width one
    raises TypeError."""
    lcols, rcols = list(left.columns), list(right.columns)
    left_on, right_on = list(left_on), list(right_on)
    left_drop, right_drop, str_pairs = set(), set(), []
    for k in range(len(left_on)):
        a, b = lcols[left_on[k]], rcols[right_on[k]]
        a_str, b_str = isinstance(a, StringColumn), isinstance(b, StringColumn)
        if not (a_str or b_str):
            continue
        if not (a_str and b_str):
            raise TypeError(
                f"join key pair {k}: cannot join a string column against "
                f"a fixed-width column"
            )
        str_pairs.append((left_on[k], right_on[k]))
        lcols.append(Column(hashing.string_surrogate64(a), dt.int64))
        left_on[k] = len(lcols) - 1
        left_drop.add(left_on[k])
        rcols.append(Column(hashing.string_surrogate64(b), dt.int64))
        right_drop.add(right_on[k])
        right_on[k] = len(rcols) - 1
    if not str_pairs:
        return left, right, tuple(left_on), tuple(right_on), frozenset(), frozenset(), ()
    return (
        Table(tuple(lcols), left.valid_count), Table(tuple(rcols), right.valid_count),
        tuple(left_on), tuple(right_on), frozenset(left_drop), frozenset(right_drop),
        tuple(str_pairs),
    )


def _window_byte(col: StringColumn, starts: torch.Tensor, sizes: torch.Tensor, j: int
                 ) -> torch.Tensor:
    """Byte j of each gathered string, 0 at or past min(size, 64)."""
    return take_fill(col.chars, starts + j).masked_fill_(sizes <= j, 0)


def _verify_string_pairs(left: Table, right: Table, str_pairs, li: torch.Tensor,
                         rrow: torch.Tensor, max_len: int) -> torch.Tensor:
    """True if some matched pair's string keys differ in what the
    surrogate hashed: the true length or a byte of the first ``max_len``
    (``_verify_string_pairs``, dj_tpu/ops/join.py:906-943). Rows out of
    range (slots past the total) read as empty on both sides. dj_tpu
    compares a dense [slots, max_len] window; here one byte position at
    a time, up to the longest window either side holds."""
    bad = torch.zeros((), dtype=torch.bool, device=li.device)
    for lc, rc in str_pairs:
        sides = []
        for col, rows in ((left.columns[lc], li), (right.columns[rc], rrow)):
            starts = take_fill(col.offsets[:-1], rows).to(torch.int64)
            sizes = take_fill(col.sizes(), rows)
            sides.append((col, starts, sizes, sizes.clamp_max(max_len)))
        (lcol, ls, lsz, lw), (rcol, rs, rsz, rw) = sides
        diff = lsz != rsz
        width = int(torch.maximum(lw.max(), rw.max())) if li.shape[0] else 0
        for j in range(width):
            diff |= _window_byte(lcol, ls, lw, j) != _window_byte(rcol, rs, rw, j)
        bad = bad | diff.any()
    return bad


_warned_unverified_string_keys = False


def _warn_unverified_string_keys() -> None:
    """Warn once per process that a string-key join without
    ``return_flags`` skips the collision verifier."""
    global _warned_unverified_string_keys
    if _warned_unverified_string_keys:
        return
    _warned_unverified_string_keys = True
    warnings.warn(
        "inner_join with string join keys and return_flags=False: the "
        "surrogate-collision verifier is SKIPPED (its flag would be "
        "unobservable), so two distinct keys sharing a 64-bit surrogate "
        "would join silently. Pass return_flags=True and check the "
        "'surrogate_collision' flag (distributed_inner_join does this "
        "automatically), or pass verify_string_keys=False to "
        "acknowledge and silence this warning.",
        RuntimeWarning,
        stacklevel=3,
    )


def _fill_column(c, out_capacity: int):
    """An all-zero output column of ``out_capacity`` rows (an empty
    side's; ``_fill_column``, dj_tpu/ops/join.py:977-987)."""
    if isinstance(c, StringColumn):
        return StringColumn(
            torch.zeros(out_capacity + 1, dtype=torch.int32, device=c.device),
            torch.zeros(max(1, c.chars.shape[0]), dtype=torch.uint8, device=c.device),
            c.dtype,
        )
    return Column(torch.zeros(out_capacity, dtype=c.data.dtype, device=c.data.device), c.dtype)


def _take_output(c, rows: torch.Tensor, side_capacity: int, out_capacity: int,
                 char_out_factor: float):
    """Column ``c`` gathered at ``rows`` (out-of-range rows give 0 or
    empty strings): a string column into ``char_out_factor`` times its
    char capacity, and all-fill from a capacity-0 side."""
    if not isinstance(c, StringColumn):
        return c.take(rows)
    if side_capacity == 0:
        return _fill_column(c, out_capacity)
    return c.take(rows, max(1, int(c.chars.shape[0] * char_out_factor)))


EXPAND_IMPLS = ("vmeta", "ranks", "hist", "fused", "join", "vcarry", "vfull")
# The CUDA kernel each expansion mode runs (join_scans runs in every mode;
# "hist" runs none: its ranks come from ``count_leq_arange``).
EXPAND_KERNELS = {
    "vmeta": "expand_values", "ranks": "expand_ranks", "fused": "expand_gather",
    "join": "expand_join", "vcarry": "expand_carry", "vfull": "expand_vfull",
}


def resolve_expand_impl() -> str:
    """The unprepared join's expansion mode: ``DJT_JOIN_EXPAND`` ("vmeta",
    the default; "ranks", "hist", "fused", "join", "vcarry" or "vfull",
    which are dj_tpu's ``DJ_JOIN_EXPAND`` = "pallas-vmeta", "pallas",
    "hist", "pallas-fused", "pallas-join", "pallas-vcarry" and
    "pallas-vfull")."""
    impl = os.environ.get("DJT_JOIN_EXPAND", "vmeta")
    if impl not in EXPAND_IMPLS:
        raise ValueError(f"DJT_JOIN_EXPAND={impl!r}: expected one of {EXPAND_IMPLS}")
    return impl


class JoinPlan(NamedTuple):
    """The plan a join runs: the expansion mode, whether the merged sort
    is the packed single-word one, and whether the payloads ride the
    (unpacked) sort as union slots."""

    expand: str
    packed: bool
    carry: bool


def effective_plan(
    n_payload: int = 1,
    *,
    single_int_key: bool = True,
    has_strings: bool = False,
    carry_payloads: Optional[bool] = None,
    multi_key_packed: bool = False,
) -> JoinPlan:
    """The plan a join of the given shape runs under the knobs, with
    dj_tpu's gates (``effective_plan``, dj_tpu/ops/join.py:1055-1123).

    ``n_payload`` is the larger number of fixed-width non-key columns of
    the two sides; ``has_strings`` says a side holds a string column;
    ``carry_payloads`` mirrors inner_join's (None reads
    ``DJT_JOIN_CARRY``); ``multi_key_packed`` says a multi-column int key
    has a declared or probed range whose fields fit the packed word.
    Carry needs one int key and sorts unpacked; the packed sort needs
    one int key or a packable multi-key, no carry and ``DJT_JOIN_PACK``
    unset or "1". vcarry and vfull need one int key on the packed path,
    no string column and at most three payload slots, and run vmeta
    otherwise; carry expands with "ranks" (any kernel mode) or "hist".
    The prepared join does not read this: see
    ``prepared_effective_plan``."""
    if carry_payloads is None:
        carry_payloads = os.environ.get("DJT_JOIN_CARRY", "0") == "1"
    carry = bool(carry_payloads) and single_int_key
    packed = (
        (single_int_key or multi_key_packed)
        and not carry
        and os.environ.get("DJT_JOIN_PACK", "1") == "1"
    )
    expand = resolve_expand_impl()
    if expand in ("vcarry", "vfull") and not (
        not carry and single_int_key and packed and not has_strings and n_payload <= 3
    ):
        expand = "vmeta"
    if carry and expand != "hist":
        expand = "ranks"
    return JoinPlan(expand, packed, carry)


def _resolve_plan(left: Table, right: Table, left_on, right_on, key_range,
                  carry_payloads, l_drop=frozenset(), r_drop=frozenset()
                  ) -> tuple[JoinPlan, bool, Optional[KeyPackPlan]]:
    """(plan, single int key, key pack plan) of a join whose string keys
    are already surrogates (``l_drop`` / ``r_drop`` as
    ``_surrogate_string_keys`` gives them): effective_plan's gates on the
    key columns, with a multi-column key packed when a declared
    ``key_range`` (normalized) fits the word."""
    single = _single_int_key(left, right, left_on, right_on)
    pairs = [(left.columns[lc], right.columns[rc]) for lc, rc in zip(left_on, right_on)]
    pack_plan = None
    if key_range is not None and all(_same_int_dtype(a, b) for a, b in pairs):
        pack_plan = plan_key_pack(key_range, [dt.numpy_dtype(a.data.dtype) for a, _ in pairs],
                                  left.capacity + right.capacity)
    n_payload = 0
    if single:
        n_payload = max(
            sum(isinstance(c, Column) for i, c in enumerate(left.columns)
                if i not in l_drop and i != left_on[0]),
            sum(isinstance(c, Column) for i, c in enumerate(right.columns)
                if i not in right_on and i not in r_drop),
        )
    plan = effective_plan(
        n_payload, single_int_key=single, has_strings=left.has_strings or right.has_strings,
        carry_payloads=carry_payloads,
        multi_key_packed=not single and pack_plan is not None and pack_plan.fits,
    )
    return plan, single, pack_plan


def join_plan(left: Table, right: Table, left_on, right_on, key_range=None,
              carry_payloads: Optional[bool] = None) -> JoinPlan:
    """The plan ``inner_join`` takes on these tables under the knobs.
    ``packed`` is False where a declared ``key_range`` does not fit the
    word; without a range, a single 64-bit key the plan packs still
    sorts unpacked when its observed span does not fit (a host check in
    the join)."""
    key_range = normalize_key_range(key_range, len(left_on))
    left, right, left_on, right_on, l_drop, r_drop, str_pairs = _surrogate_string_keys(
        left, right, left_on, right_on)
    if str_pairs:
        key_range = None
    plan, single, pack_plan = _resolve_plan(left, right, left_on, right_on, key_range,
                                            carry_payloads, l_drop, r_drop)
    if single and pack_plan is not None and not pack_plan.fits:
        plan = plan._replace(packed=False)
    return plan


def _valid_mask(l_count, r_count, L: int, R: int, device) -> torch.Tensor:
    """The merged operand's validity, refs first."""
    return torch.cat([
        torch.arange(R, device=device) < r_count,
        torch.arange(L, device=device) < l_count,
    ])


def _tag_words(word: torch.Tensor, valid: torch.Tensor, tag_bits: int) -> torch.Tensor:
    """``word << tag_bits | row`` in place, padding all-ones."""
    word.bitwise_left_shift_(tag_bits)
    word.bitwise_or_(torch.arange(word.shape[0], dtype=torch.int64, device=word.device))
    return word.masked_fill_(~valid, -1)


class _SingleKeyPack(NamedTuple):
    word: Optional[torch.Tensor]  # the unsorted packed words; None: sort unpacked
    pack_ovf: torch.Tensor
    kmin: Optional[torch.Tensor]  # what 64-bit keys were packed relative to


def _single_key_pack(
    lk: torch.Tensor, rk: torch.Tensor, l_count, r_count, tag_bits: int,
    static_fit: Optional[bool],
) -> _SingleKeyPack:
    """The packed words of one int key (``_packed_merged_sort``,
    dj_tpu/ops/join.py:592-716), or word None when the plan takes the
    unpacked sort: a 64-bit key with ``static_fit`` False, or with
    ``static_fit`` None and an observed span that does not fit the word
    (the host reads the fit, where dj_tpu's ``lax.cond`` branches on
    it). Keys of at most 64 - tag_bits bits pack their unsigned-order
    image as is. A 64-bit key packs ``key - kmin`` in its int64 image;
    under ``static_fit`` True, data whose span overflows the word raises
    ``pack_range_overflow`` when both sides have rows."""
    L, R = lk.shape[0], rk.shape[0]
    dev = lk.device
    pack_ovf = _flag(False, dev)
    valid = _valid_mask(l_count, r_count, L, R, dev)
    if 8 * lk.element_size() + tag_bits <= 64:
        word = _to_unsigned_order(torch.cat([rk, lk]))
        return _SingleKeyPack(_tag_words(word, valid, tag_bits), pack_ovf, None)
    if static_fit is False:
        return _SingleKeyPack(None, pack_ovf, None)
    word = _signed_image64(torch.cat([rk, lk]))
    kmin = torch.where(valid, word, INT64_MAX).min()
    kmax = torch.where(valid, word, INT64_MIN).max()
    span = kmax - kmin  # the u64 span, wrapping past 2^63
    fits = (span >= 0) & (span < (1 << (64 - tag_bits)) - 1)
    if static_fit is None:
        if not bool(fits):
            return _SingleKeyPack(None, pack_ovf, None)
    else:
        pack_ovf = ~fits & (l_count > 0) & (r_count > 0)
    word = word - kmin
    return _SingleKeyPack(_tag_words(word, valid, tag_bits), pack_ovf, kmin)


def _multi_key_pack_word(
    left: Table, right: Table, left_on, right_on, pack: KeyPackPlan, l_count, r_count,
    tag_bits: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(unsorted words, ok): the mixed-radix u64 word of N int key
    columns, refs first (``_multi_key_pack_word``, dj_tpu/ops/join.py:
    719-778). Each column's unsigned-order image less its observed
    minimum sits in its static field; ``ok`` is False iff an observed
    span overflows its field or the combined spans reach the sentinel,
    with rows on both sides (the caller raises pack_range_overflow).
    Unsigned compares are signed compares of top-bit-flipped images."""
    L, R = left.capacity, right.capacity
    dev = left.device
    valid = _valid_mask(l_count, r_count, L, R, dev)
    rel = torch.zeros(L + R, dtype=torch.int64, device=dev)
    mdyn = torch.zeros((), dtype=torch.int64, device=dev)
    ok = _flag(True, dev)
    for lc, rc, w, sh in zip(left_on, right_on, pack.widths, pack.shifts):
        u = torch.cat([_to_unsigned_order(right.columns[rc].data),
                       _to_unsigned_order(left.columns[lc].data)])
        uf = u ^ INT64_MIN
        umin = torch.where(valid, uf, INT64_MAX).min() ^ INT64_MIN
        umax = torch.where(valid, uf, INT64_MIN).max() ^ INT64_MIN
        span = umax - umin
        ok = ok & ((span ^ INT64_MIN) <= (((1 << w) - 1) ^ INT64_MIN))
        rel |= (u - umin) << sh
        mdyn = mdyn | (span << sh)
    limit = (1 << (64 - tag_bits)) - 1
    ok = ok & ((mdyn ^ INT64_MIN) < (limit ^ INT64_MIN))
    ok = ok | (l_count == 0) | (r_count == 0)
    return _tag_words(rel, valid, tag_bits), ok


def _unpacked_words(
    images: list, float_keys: Sequence[bool], l_count, r_count, L: int, R: int,
    tag_bits: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted words, perm) of the unpacked merged sort
    (``_multi_key_merged_sort`` and the stable ``(vals, tag)`` fallback,
    dj_tpu/ops/join.py:287-338, 679-700).

    ``images`` holds each key column's int64 order image over the
    concatenation (refs first; the list is emptied); ``float_keys``
    marks float columns, whose NaNs (INT64_MAX) each start a run of their
    own, as ``!=`` decides in ``_run_starts``. The order is (valid rows
    first, key columns, row): the valid rows in concatenation order
    first, padding after, then a stable ``torch.sort`` per key column,
    last column first, padding pinned at INT64_MAX (it stays behind the
    valid rows of that value, and so at the tail). ``perm`` maps each
    merged position to its concatenated row. The dense run id of each
    position and that row re-pack into ``run_id << tag_bits | row``:
    ascending, since one run's rows stay in concatenation order, refs
    first. Padding packs to all-ones."""
    S = L + R
    dev = images[0].device
    i = torch.arange(S, device=dev)
    rc = torch.as_tensor(r_count, device=dev).to(torch.int64)
    lc = torch.as_tensor(l_count, device=dev).to(torch.int64)
    nv = rc + lc
    pad = i >= nv
    j = i - nv
    perm = torch.where(
        pad, torch.where(j < R - rc, rc + j, j + nv), torch.where(i < rc, i, i + (R - rc))
    )
    del j, i
    first = None
    for k in reversed(range(len(images))):
        v = images[k][perm].masked_fill_(pad, INT64_MAX)
        v, p = torch.sort(v, stable=True)
        perm = perm[p]
        del p
        first = v
    boundary = torch.zeros(S, dtype=torch.bool, device=dev)
    boundary[0] = True
    for k, img in enumerate(images):
        s = first if k == 0 else img[perm]
        boundary[1:] |= s[1:] != s[:-1]
        if float_keys[k]:
            boundary |= s == INT64_MAX
    images.clear()
    del first
    words = torch.cumsum(boundary, 0).sub_(1)
    del boundary
    words.bitwise_left_shift_(tag_bits).bitwise_or_(perm)
    return words.masked_fill_(pad, -1), perm


def _key_images(left: Table, right: Table, left_on, right_on) -> tuple[list, list]:
    """(order images, float flags) of each key pair over the
    concatenation (refs first), both sides cast to the pair's promoted
    dtype first."""
    images, floats = [], []
    for lc, rc in zip(left_on, right_on):
        a, b = left.columns[lc].data, right.columns[rc].data
        d = promote_key_dtype(a.dtype, b.dtype)
        col = torch.cat([b.to(d), a.to(d)])
        images.append(_order_image(col))
        floats.append(col.is_floating_point())
    return images, floats


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _to_u64(data: torch.Tensor) -> torch.Tensor:
    """Any fixed-width column's bits, zero-extended to u64 (int64)."""
    w = data.element_size()
    bits = data.view(_INT_OF_SIZE[w])
    return bits if w == 8 else bits.to(torch.int64) & ((1 << (8 * w)) - 1)


def _from_u64(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of _to_u64: the low bits of ``bits`` as ``dtype``."""
    return bits.to(_INT_OF_SIZE[dtype.itemsize]).view(dtype)


def _union_slots(l_carry, r_fixed, L: int, R: int, device) -> list:
    """Union u64 sort operands (``_union_slots``, dj_tpu/ops/join.py:
    946-964): slot k holds the right payload k on ref rows and the left
    payload k on query rows, zero where a side has fewer columns."""
    slots = []
    for k in range(max(len(l_carry), len(r_fixed))):
        parts = [
            _to_u64(cols[k][1].data) if k < len(cols)
            else torch.zeros(n, dtype=torch.int64, device=device)
            for cols, n in ((r_fixed, R), (l_carry, L))
        ]
        slots.append(torch.cat(parts))
    return slots


def _gather_slots(slots: list, perm: torch.Tensor) -> list:
    """Each slot gathered by ``perm``; ``slots`` is emptied as it goes, so
    one unsorted slot is alive at a time."""
    out = []
    while slots:
        out.append(slots.pop(0)[perm])
    return out


def _carry_sorted(packed: _SingleKeyPack, key_dtype: torch.dtype, tag_bits: int,
                  slots: list) -> tuple[torch.Tensor, torch.Tensor, list]:
    """vcarry's packed sort (the ``carry_ops`` branch of
    ``_pack_sort_core``, dj_tpu/ops/join.py:564-581): (sorted words,
    sorted keys, sorted slots). ``torch.sort`` has no variadic form, so
    the words sort with their permutation and each slot is gathered by
    it; valid words are distinct, so the valid prefix's permutation is
    unique (padding slots are unspecified and never read below the
    total). The key is recovered
    from the sorted word as int64 bits: the key field under a logical
    shift, plus kmin for 64-bit keys (uint64 flipped back), or less the
    unsigned-order bias for narrower signed ones (sign-extended)."""
    sp, perm = torch.sort(packed.word.bitwise_xor_(INT64_MIN))
    sp.bitwise_xor_(INT64_MIN)
    sslots = _gather_slots(slots, perm)
    del perm
    key = (sp >> tag_bits).bitwise_and_((1 << (64 - tag_bits)) - 1)
    if packed.kmin is not None:
        key.add_(packed.kmin)
        if key_dtype == torch.uint64:
            key.bitwise_xor_(INT64_MIN)
    elif key_dtype.is_signed:
        key.sub_(1 << (8 * torch.empty((), dtype=key_dtype).element_size() - 1))
    return sp, key, sslots


def _run_offsets(src: torch.Tensor) -> torch.Tensor:
    """t = j - cummax(where(first, j, -1)) per slot, int32, where first
    marks the slots whose src differs from the slot before: the
    within-run offset from src's own run starts (dj_tpu/ops/join.py:
    1660-1665). Slot 0 is always a start, so the cummax is the start of
    j's run, found here as a cumsum (run id), a scatter of each start to
    its run id and a gather: ``torch.cummax`` of one long row runs as a
    single block (524 ms at 200M slots on an H100)."""
    n = src.shape[0]
    j = torch.arange(n, dtype=torch.int32, device=src.device)
    first = torch.ones(n, dtype=torch.bool, device=src.device)
    first[1:] = src[1:] != src[:-1]
    run_id = torch.cumsum(first, 0).sub_(1)
    # Non-start slots write to a spare last entry, which nothing reads.
    starts = torch.empty(n + 1, dtype=torch.int32, device=src.device)
    starts.scatter_(0, torch.where(first, run_id, n), j)
    return j - starts[run_id]


def _ranks_src(csum: torch.Tensor, out_capacity: int, mode: str) -> torch.Tensor:
    """src = #{csum <= j} per output slot, clipped to [0, S - 1]:
    ``expand_ranks`` (CUDA kernel) or, under "hist", ``count_leq_arange``
    (dj_tpu/ops/join.py:1653-1659)."""
    rank = count_leq_arange if mode == "hist" else expand_ranks
    return rank(csum, out_capacity).clamp_(0, csum.shape[0] - 1)


def _expand_matches(
    words: list, l_count, r_count, tag_bits: int, L: int, R: int, out_capacity: int,
    mode: str = "vmeta",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(li, rrow, total) from the sorted packed words of a merged L + R
    operand: the scans and the expansion under ``mode`` ("vmeta",
    "ranks", "hist", "fused" or "join"). Output slot j joins left row
    li[j] (L past the total) with right row rrow[j] (R past it);
    ``total`` is the exact int64 match count. ``words`` is a one-element
    list whose tensor this function takes, so the words are freed once
    the scans have read them."""
    S = L + R
    stag, run_start, cnt, csum = join_scans(words.pop(), l_count, r_count, tag_bits, L, R)
    total = cnt.sum(dtype=torch.int64)
    valid_out = torch.arange(out_capacity, device=stag.device) < total
    rtag = None
    if mode == "vmeta":
        stag_j, rpos = expand_values(csum, cnt, stag, run_start, out_capacity)
    elif mode == "join":
        stag_j, rtag = expand_join(csum, stag, run_start, out_capacity)
    elif mode == "fused":
        src, stag_j, rstart_j = expand_gather(csum, stag, run_start, out_capacity)
        rpos = rstart_j + _run_offsets(src.clamp_(0, S - 1))
    else:  # ranks or hist, then the meta gather: (stag, run_start) at src
        src = _ranks_src(csum, out_capacity, mode)
        stag_j = stag[src]
        rpos = run_start[src] + _run_offsets(src)
    del csum, cnt, run_start

    li = torch.where(valid_out, stag_j, L)
    if rtag is None:
        rpos = torch.where(valid_out, rpos, S)
        in_range = (rpos >= 0) & (rpos < S)
        rtag = torch.where(in_range, stag[rpos.clamp(0, S - 1)], L)
    rrow = torch.where(valid_out, rtag - L, R)
    return li, rrow, total


def _carry_expand(
    words: list, key: torch.Tensor, sslots: list, l_count, r_count, tag_bits: int,
    L: int, R: int, out_capacity: int, mode: str,
) -> tuple[torch.Tensor, list, list, torch.Tensor, Optional[tuple]]:
    """(key_j, left payload slots, right payload slots, total, rows) per
    output slot, from the sorted words (a one-element list this function
    takes), keys and slots; ``rows`` is the (left row, right row) pair
    of carry's "ranks" and "hist" (L and R past the total), which gather
    string payloads, and None under "vcarry" and "vfull", which take no
    string column. The scans, then under "vcarry"
    ``expand_carry`` (left slots at src) and a gather of key and slots at
    the matched refs (``rpos``), under "vfull" ``expand_vfull`` (all of
    it in one kernel), under carry's "ranks" or "hist" src by ranks and
    rpos from src's run (dj_tpu/ops/join.py:1653-1673) and a gather of
    key and left slots at src. Slots past the total are unspecified.
    dj_tpu stacks the key and slots into one gather (dj_tpu/ops/join.py:
    1699-1701, 1667-1669); here each column is gathered alone: PyTorch's
    gather of 16-byte rows took 121 ms at 200M slots on an H100."""
    S = L + R
    stag, run_start, cnt, csum = join_scans(words.pop(), l_count, r_count, tag_bits, L, R)
    total = cnt.sum(dtype=torch.int64)
    n = len(sslots)
    if mode == "vfull":
        outs = expand_vfull(csum, cnt, run_start, sslots, key, out_capacity)
        return outs[n], list(outs[:n]), list(outs[n + 1:]), total, None
    rows = None
    if mode == "vcarry":
        rpos, *lpay = expand_carry(csum, cnt, run_start, sslots, out_capacity)
        rpos = rpos.clamp_(0, S - 1)
        key_j = key[rpos]
    else:
        src = _ranks_src(csum, out_capacity, mode)
        rpos = (run_start[src] + _run_offsets(src)).clamp_(0, S - 1)
        lpay = [s[src] for s in sslots]
        key_j = key[src]
        valid_out = torch.arange(out_capacity, device=stag.device) < total
        rows = (torch.where(valid_out, stag[src], L), torch.where(valid_out, stag[rpos] - L, R))
    del csum, cnt, run_start, stag
    return key_j, lpay, [s[rpos] for s in sslots], total, rows


def inner_join(
    left: Table,
    right: Table,
    left_on: Sequence[int],
    right_on: Sequence[int],
    out_capacity: Optional[int] = None,
    char_out_factor: float = 1.0,
    carry_payloads: Optional[bool] = None,
    verify_string_keys: Optional[bool] = None,
    return_flags: bool = False,
    key_range=None,
):
    """Inner-join two tables on the key columns ``left_on`` / ``right_on``.

    Returns (result, total), or (result, total, flags) with
    ``return_flags``: ``result`` has static capacity ``out_capacity``
    (default max(left, right) capacity) and valid_count = min(total,
    out_capacity); ``total`` is the true int64 match count. On overflow
    (total > out_capacity) the whole output is unspecified. ``flags``
    holds ``surrogate_collision`` (distinct string keys shared a
    surrogate: the rows are wrong) and ``pack_range_overflow`` (a
    declared ``key_range`` lied about a span, so the packed word
    overflowed; the output is then unspecified).
    ``key_range`` (one (min, max) pair, or one per key) makes the pack
    decision static, as in dj_tpu; without it a 64-bit key's range is
    checked on the host. It is ignored when a key is a string. Keys
    compare as ``jax.lax.sort`` and ``!=`` compare them in dj_tpu: two
    dtypes in their promoted dtype, -0.0 and subnormals equal to 0.0,
    NaN equal to nothing. ``carry_payloads`` (None reads
    ``DJT_JOIN_CARRY``) carries the payloads through the merged sort;
    every plan gives the same rows (see the module docstring).

    A string payload's output chars hold ``char_out_factor`` times its
    input char capacity; a result that needs more reports
    ``char_overflow()``. String keys join through their int64
    surrogates. Two keys equal in their first 64 bytes and their length
    are equal by design. The verifier runs when ``return_flags`` is set
    and ``verify_string_keys`` (None reads ``DJT_STRING_VERIFY``, default
    on) allows it; without ``return_flags`` it is skipped and a warning
    says so once per process.
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
    key_range = normalize_key_range(key_range, len(left_on))
    left, right, left_on, right_on, l_drop, r_drop, str_pairs = _surrogate_string_keys(
        left, right, left_on, right_on)
    if str_pairs:
        # The surrogates span the whole 64-bit range.
        key_range = None
    if verify_string_keys is None:
        verify_string_keys = os.environ.get("DJT_STRING_VERIFY", "1") == "1"
    verify_eligible = (bool(verify_string_keys) and bool(str_pairs)
                       and left.capacity > 0 and right.capacity > 0)
    if verify_eligible and not return_flags:
        _warn_unverified_string_keys()
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
    right_on_set = set(right_on) | r_drop
    l_out = [(i, c) for i, c in enumerate(left.columns) if i not in l_drop]
    r_out = [(i, c) for i, c in enumerate(right.columns) if i not in right_on_set]
    r_fixed = [(i, c) for i, c in r_out if isinstance(c, Column)]
    flags = {"surrogate_collision": _flag(False, dev), "pack_range_overflow": _flag(False, dev)}
    if S == 0:
        cols = tuple(_fill_column(c, out_capacity) for _, c in l_out + r_out)
        result = (
            Table(cols, torch.zeros((), dtype=torch.int32, device=dev)),
            torch.zeros((), dtype=torch.int64, device=dev),
        )
        return result + (flags,) if return_flags else result

    l_count, r_count = left.count(), right.count()
    plan, single, pack_plan = _resolve_plan(left, right, left_on, right_on, key_range,
                                            carry_payloads, l_drop, r_drop)
    l_carry = ([(i, c) for i, c in l_out if isinstance(c, Column) and i != left_on[0]]
               if single else [])
    pairs = [(left.columns[lc].data, right.columns[rc].data) for lc, rc in zip(left_on, right_on)]
    static_fit = pack_plan.fits if single and pack_plan is not None else None
    mode = plan.expand
    carried = plan.carry or mode in ("vcarry", "vfull")
    tag_bits = max(1, S.bit_length())

    # The merged sort: packed words, or the unpacked sort's words and
    # permutation; the carry families also sort their keys and slots.
    packed = None
    if plan.packed and single:
        lk, rk = pairs[0]
        packed = _single_key_pack(lk, rk, l_count, r_count, tag_bits, static_fit)
        flags["pack_range_overflow"] = packed.pack_ovf
        if packed.word is None:
            packed = None
    slots = _union_slots(l_carry, r_fixed, L, R, dev) if carried else []
    if packed is not None and carried:
        sp, key, sslots = _carry_sorted(packed, pairs[0][0].dtype, tag_bits, slots)
    elif packed is not None:
        sp = sort_u64(packed.word)
    elif plan.packed and not single:
        word, ok = _multi_key_pack_word(left, right, left_on, right_on, pack_plan, l_count,
                                        r_count, tag_bits)
        flags["pack_range_overflow"] = ~ok
        sp = sort_u64(word)
    else:
        images, floats = _key_images(left, right, left_on, right_on)
        sp, perm = _unpacked_words(images, floats, l_count, r_count, L, R, tag_bits)
        if carried:
            lk, rk = pairs[0]
            key = _to_u64(torch.cat([rk, lk]))[perm]
            sslots = _gather_slots(slots, perm)
        del perm
    del packed
    words = [sp]
    del sp

    if carried:
        key_j, lpay, rpay, total, rows = _carry_expand(
            words, key, sslots, l_count, r_count, tag_bits, L, R, out_capacity, mode
        )
        del key, sslots
        # Slots past the total read 0 in every column, the key included
        # (dj_tpu/ops/join.py:1703-1716, 1763-1775); the column order is
        # the contract's (1743-1751).
        valid_out = torch.arange(out_capacity, device=dev) < total
        lbits = {left_on[0]: key_j} | {i: b for (i, _), b in zip(l_carry, lpay)}
        rbits = {i: b for (i, _), b in zip(r_fixed, rpay)}
        li, rrow = rows if rows is not None else (None, None)

        def out_col(i, c, bits, side_rows, cap):
            if isinstance(c, StringColumn):
                return _take_output(c, side_rows, cap, out_capacity, char_out_factor)
            return Column(_from_u64(torch.where(valid_out, bits[i], 0), c.data.dtype), c.dtype)

        cols = ([out_col(i, c, lbits, li, L) for i, c in l_out]
                + [out_col(i, c, rbits, rrow, R) for i, c in r_out])
    else:
        li, rrow, total = _expand_matches(
            words, l_count, r_count, tag_bits, L, R, out_capacity, mode
        )
        cols = ([_take_output(c, li, L, out_capacity, char_out_factor) for _, c in l_out]
                + [_take_output(c, rrow, R, out_capacity, char_out_factor) for _, c in r_out])
    if verify_eligible and return_flags:
        # Window = exactly what the surrogate hashed.
        flags["surrogate_collision"] = _verify_string_pairs(
            left, right, str_pairs, li, rrow, hashing.SURROGATE_MAX_LEN)
    count = torch.minimum(total, torch.tensor(out_capacity, device=dev)).to(torch.int32)
    result = (Table(tuple(cols), count), total)
    return result + (flags,) if return_flags else result


# --- prepared build side ----------------------------------------------


class PreparedPackPlan(NamedTuple):
    """Anchored pack plan of a prepared build side: each key's field is
    ``key_uo - anchor`` (``anchors`` are the unsigned-order images of the
    range's lows, python ints), so words packed at different times under
    one plan compare directly. ``tag_bits`` is fixed by the merged
    capacity the plan was built for; ``key_dtypes`` pins the physical key
    dtypes (numpy names)."""

    anchors: tuple[int, ...]
    widths: tuple[int, ...]
    shifts: tuple[int, ...]
    tag_bits: int
    rel_bits: int
    key_dtypes: tuple[str, ...]


def plan_prepared_pack(key_range, dtypes, S: int) -> Optional[PreparedPackPlan]:
    """Anchored pack plan for keys bounded by ``key_range``, or None when
    the canonical widths do not pack into the 64-bit word. The fit is
    judged on the full canonical spans (2^w - 1), so any data inside the
    anchors packs strictly below the all-ones sentinel."""
    dtypes = [dt.numpy_dtype(d) for d in dtypes]
    kr = normalize_key_range(key_range, len(dtypes))
    anchors, widths = [], []
    for (lo, hi), d in zip(kr, dtypes):
        anchors.append(_unsigned_order_int(lo, d))
        widths.append((_unsigned_order_int(hi, d) - anchors[-1]).bit_length())
    canonical = tuple((0, (1 << w) - 1) for w in widths)
    base = plan_key_pack(canonical, dtypes, S)
    if not base.fits:
        return None
    return PreparedPackPlan(
        tuple(anchors), base.widths, base.shifts, max(1, int(S).bit_length()),
        sum(base.widths), tuple(str(d) for d in dtypes),
    )


def _as_int64_bits(v: int) -> int:
    """The int64 holding the u64 bit pattern of ``v`` in [0, 2^64)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _anchored_pack_word(
    table: Table, on: Sequence[int], plan: PreparedPackPlan, tag_offset: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(words, ok): each row's key fields ``key_uo - anchor`` shifted
    above ``plan.tag_bits`` tag bits holding ``tag_offset + row``,
    padding rows all-ones. ``ok`` is False iff a valid key falls outside
    its [anchor, anchor + 2^width) window; an empty side never flags.
    Unsigned compares are signed compares of the top-bit-flipped image."""
    cap = table.capacity
    cnt = table.count()
    dev = table.device
    valid = torch.arange(cap, device=dev) < cnt
    rel = torch.zeros(cap, dtype=torch.int64, device=dev)
    ok = _flag(True, dev)
    for c_idx, anchor, w, sh in zip(on, plan.anchors, plan.widths, plan.shifts):
        u = _to_unsigned_order(table.columns[c_idx].data)
        a = _as_int64_bits(anchor)
        if cap:
            uf = u ^ INT64_MIN
            umin_f = torch.where(valid, uf, INT64_MAX).min()
            umax = torch.where(valid, uf, INT64_MIN).max() ^ INT64_MIN
            span = umax - a  # (umax - anchor) mod 2^64; 2^w - 1 < 2^63
            ok = ok & (umin_f >= (a ^ INT64_MIN)) & (span >= 0) & (span <= (1 << w) - 1)
        rel |= (u - a) << sh
    ok = ok | (cnt == 0)
    tags = torch.arange(tag_offset, tag_offset + cap, dtype=torch.int64, device=dev)
    words = ((rel << plan.tag_bits) | tags).masked_fill_(~valid, -1)
    return words, ok


def prepare_packed_batch(
    right: Table, right_on: Sequence[int], plan: PreparedPackPlan
) -> tuple[torch.Tensor, Table, torch.Tensor]:
    """One-time preparation of a shuffled build batch: pack under the
    anchored ``plan`` (ref tags 0..R-1), sort once, and re-tag the sorted
    words by their rank, so a matched ref's tag indexes the sorted
    payload table directly.

    Returns (words, payload, ok): the ascending words (padding an
    all-ones tail), the non-key columns in sorted order (zero or empty
    past the valid count, which the table carries) and the pack-fit
    flag. Valid words are distinct, so the sort's permutation of the
    valid prefix is unique and the fixed payloads' gather equals the JAX
    package's sort carrying them; string payloads follow the same
    permutation (``StringColumn.take``, padding rows empty), as in
    dj_tpu."""
    R = right.capacity
    r_count = right.count()
    words, ok = _anchored_pack_word(right, right_on, plan, 0)
    sw, perm = torch.sort(words.bitwise_xor_(INT64_MIN))
    del words
    sw.bitwise_xor_(INT64_MIN)
    mask = (1 << plan.tag_bits) - 1
    rank = torch.arange(R, device=sw.device)
    invalid = rank >= r_count  # valid words sort below the sentinel
    words_out = ((sw & ~mask) | rank).masked_fill_(invalid, -1)
    cols = tuple(
        c.take(perm.masked_fill(invalid, R)) if isinstance(c, StringColumn)
        else Column(gather_fill(c.data, perm, invalid), c.dtype)
        for i, c in enumerate(right.columns) if i not in set(right_on)
    )
    return words_out, Table(cols, r_count), ok


def merge_packed_batch(
    words: torch.Tensor, payload: Table, appended: Table, a_words: torch.Tensor,
    right_on: Sequence[int], plan: PreparedPackPlan,
) -> tuple[torch.Tensor, Table, torch.Tensor, torch.Tensor]:
    """Merge appended build rows into one prepared batch, keeping its
    capacity (``merge_packed_batch``, dj_tpu/ops/join.py:1988-2082).

    ``words`` / ``payload`` are a ``prepare_packed_batch`` output
    (capacity R); ``appended`` is the appended rows' shuffled batch (all
    columns, capacity A) and ``a_words`` its anchored pack under the same
    plan with tag offset R, so every valid word of the concatenation is
    distinct. One sort of the concatenated words (``sort_u64``) re-merges
    the run; its first R words are re-tagged by rank as in a fresh
    preparation. A sorted word's old tag is its row in the concatenation
    [resident payload | appended rows], which the fixed payloads are
    gathered at; string payloads are gathered from the row-compacting
    ``concatenate`` of the two sides (so an appended tag t maps to row
    t - R + pcnt), into the concatenation's char capacity.

    Returns (words[R], payload, new_count, overflow): ``overflow`` is
    set when the resident and appended valid rows exceed R, and the
    result is then unspecified (the caller re-prepares)."""
    R = words.shape[0]
    A = appended.capacity
    pcnt, acnt = payload.count(), appended.count()
    new_count = pcnt + acnt
    overflow = new_count > R
    right_on_set = set(right_on)
    pay_idx = [i for i in range(appended.num_columns) if i not in right_on_set]
    sw = sort_u64(torch.cat([words, a_words]))[:R]
    mask = (1 << plan.tag_bits) - 1
    rank = torch.arange(R, device=sw.device)
    invalid = rank >= new_count
    src = (sw & mask).masked_fill_(invalid, R + A)
    words_out = ((sw & ~mask) | rank).masked_fill_(invalid, -1)
    del sw, rank
    cols = []
    str_perm = None
    for pc, i in zip(payload.columns, pay_idx):
        ac = appended.columns[i]
        if isinstance(pc, StringColumn):
            if str_perm is None:
                str_perm = torch.where(src >= R, src - R + pcnt, src)
            both = concatenate([Table((pc,), pcnt), Table((ac,), acnt)]).columns[0]
            cols.append(both.take(str_perm, both.chars.shape[0]))
        else:
            both = torch.cat([pc.data, ac.data])
            cols.append(Column(gather_fill(both, src.clamp_max(R + A - 1), invalid), pc.dtype))
    return words_out, Table(tuple(cols), new_count), new_count, overflow


MERGE_IMPLS = ("sort", "merge", "probe")
PROBE_EXPAND_IMPLS = ("segment", "hist", "pallas")


def resolve_merge_impl() -> str:
    """The prepared join's merge tier: ``DJT_JOIN_MERGE`` ("sort", the
    default; "merge"; or "probe")."""
    impl = os.environ.get("DJT_JOIN_MERGE", "sort")
    if impl not in MERGE_IMPLS:
        raise ValueError(f"DJT_JOIN_MERGE={impl!r}: expected one of {MERGE_IMPLS}")
    return impl


def resolve_probe_expand() -> str:
    """The probe tier's expansion: ``DJT_PROBE_EXPAND`` (dj_tpu's
    ``DJ_PROBE_EXPAND``, dj_tpu/ops/join.py:1025-1037): "segment" (the
    default; src from the rank, the offset from the row's exclusive
    csum), "hist" (the same src, the offset from src's run starts) or
    "pallas" (src and offset from ``expand_values``)."""
    impl = os.environ.get("DJT_PROBE_EXPAND", "segment")
    if impl not in PROBE_EXPAND_IMPLS:
        raise ValueError(f"DJT_PROBE_EXPAND={impl!r}: expected one of {PROBE_EXPAND_IMPLS}")
    return impl


def prepared_effective_plan(merge_impl: str, probe_expand: Optional[str] = None
                            ) -> tuple[str, ...]:
    """The CUDA kernels a prepared join runs on the card under
    ``merge_impl``. The expansion is always vmeta on the merged tiers
    (``prepared_effective_plan``, dj_tpu/ops/join.py:1871-1892, which
    degrades the carry families), after the scans. The probe tier ranks with expand_ranks
    (``DJ_JOIN_EXPAND=pallas``, the TPU plan) under ``probe_expand``
    (None reads ``DJT_PROBE_EXPAND``) "segment" and "hist", and runs
    expand_values under "pallas"."""
    if merge_impl == "probe":
        if probe_expand is None:
            probe_expand = resolve_probe_expand()
        return ("expand_values",) if probe_expand == "pallas" else ("expand_ranks",)
    merge = ("merge_sorted_u64",) if merge_impl == "merge" else ()
    return merge + ("join_scans", "expand_values")


def _gather_prepared_output(
    left: Table, right_payload: Table, li: torch.Tensor, rrow: torch.Tensor,
    out_capacity: int, char_out_factor: float,
) -> list:
    """Every left column at ``li`` (left row ids, L past the total) and
    every prepared payload column at ``rrow`` (sorted ranks in the
    resident table, R past it); out-of-range ids gather zeros or empty
    strings, a string column into ``char_out_factor`` times its char
    capacity, and a capacity-0 side's string columns fill
    (``_gather_prepared_output``, dj_tpu/ops/join.py:2246-2304)."""
    L, R = left.capacity, right_payload.capacity
    return ([_take_output(c, li, L, out_capacity, char_out_factor) for c in left.columns]
            + [_take_output(c, rrow, R, out_capacity, char_out_factor)
               for c in right_payload.columns])


def _check_prepared_geometry(L: int, R: int, plan: PreparedPackPlan) -> None:
    S = L + R
    if S >= 2**31 - 1 or plan.tag_bits >= 32:
        raise ValueError(f"merged size {S} outside the int32 position domain")
    if plan.tag_bits != max(1, S.bit_length()):
        raise ValueError(
            f"prepared plan tag_bits {plan.tag_bits} incompatible with S={S} "
            f"(bit_length {max(1, S.bit_length())}): re-prepare for the new "
            f"batch sizing"
        )


def inner_join_prepared(
    left: Table,
    left_on: Sequence[int],
    pwords: torch.Tensor,
    right_payload: Table,
    plan: PreparedPackPlan,
    out_capacity: int,
    merge_impl: Optional[str] = None,
    char_out_factor: float = 1.0,
) -> tuple[Table, torch.Tensor, dict]:
    """Join a probe batch against a prepared build batch
    (``prepare_packed_batch``'s words and payload table).

    ``merge_impl`` (None reads ``DJT_JOIN_MERGE``) picks how the merged
    operand is made: "sort" sorts the concatenation; "merge" sorts the
    probe words alone and merges them with the resident run
    (``merge_sorted_u64``); "probe" delegates to ``inner_join_probe``.
    The scans and the vmeta expansion follow, and the right payload is
    gathered from the sorted resident table directly (its words' tags
    are sorted ranks). String columns of either side are gathered into
    ``char_out_factor`` times their char capacity; a result that needs
    more reports ``char_overflow()``.

    Returns (result, total, flags): result = every left column, then the
    payload columns, with capacity ``out_capacity``; ``total`` the exact
    int64 match count (total > out_capacity condemns every row); flags
    holds ``prepared_plan_mismatch`` (left keys outside the anchors: the
    output is unspecified).
    """
    L, R = left.capacity, pwords.shape[0]
    _check_prepared_geometry(L, R, plan)
    if merge_impl is None:
        merge_impl = resolve_merge_impl()
    if merge_impl not in MERGE_IMPLS:
        raise ValueError(f"merge_impl {merge_impl!r}: expected one of {MERGE_IMPLS}")
    if merge_impl == "probe":
        return inner_join_probe(left, left_on, pwords, right_payload, plan, out_capacity,
                                char_out_factor)
    l_count, r_count = left.count(), right_payload.count()
    w_l, ok = _anchored_pack_word(left, left_on, plan, R)
    flags = {"prepared_plan_mismatch": ~(ok | (r_count == 0))}
    if merge_impl == "merge":
        words = [merge_sorted_u64(pwords, sort_u64(w_l))]
    else:
        words = [sort_u64(torch.cat([pwords, w_l]))]
    del w_l
    li, rrow, total = _expand_matches(words, l_count, r_count, plan.tag_bits, L, R, out_capacity)
    cols = _gather_prepared_output(left, right_payload, li, rrow, out_capacity, char_out_factor)
    count = torch.minimum(total, torch.tensor(out_capacity, device=total.device)).to(torch.int32)
    return Table(tuple(cols), count), total, flags


def _probe_counts(
    pwords: torch.Tensor, w_l: torch.Tensor, l_count, r_count, tag_bits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, cnt) int32 per probe row: the first resident rank with the
    row's key and the row's match count (0 for padding rows). Keys are
    compared as the words' key fields under a logical shift, which keeps
    unsigned order in non-negative int64 and puts the all-ones sentinel
    last."""
    key_mask = (1 << (64 - tag_bits)) - 1
    lo, hi = run_bounds((pwords >> tag_bits) & key_mask, (w_l >> tag_bits) & key_mask)
    hi = torch.minimum(hi, r_count.to(torch.int32))
    valid = torch.arange(w_l.shape[0], device=w_l.device) < l_count
    cnt = torch.where(valid, (hi - lo).clamp_min_(0), 0).to(torch.int32)
    return lo, cnt


def _probe_expand(csum: torch.Tensor, cnt: torch.Tensor, L: int, out_capacity: int,
                  mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, t) per output slot of the probe tier under ``mode``
    (dj_tpu/ops/join.py:2428-2480): the probe row src, clipped to [0,
    L - 1], and the slot's offset t within that row's run of slots.
    "segment": src from ``expand_ranks``, t = j - (csum - cnt)[src];
    "hist": the same src, t from src's run starts (``_run_offsets``);
    "pallas": ``expand_values`` with stag = arange(L) and run_start = 0,
    whose (stag_j, rpos) are (src, t)."""
    dev = csum.device
    if mode == "pallas":
        src, t = expand_values(csum, cnt, torch.arange(L, dtype=torch.int32, device=dev),
                               torch.zeros(L, dtype=torch.int32, device=dev), out_capacity)
        return src.clamp_(0, L - 1), t
    src = expand_ranks(csum, out_capacity).clamp_(0, L - 1)
    if mode == "hist":
        return src, _run_offsets(src)
    j = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    return src, j - (csum - cnt)[src]


def inner_join_probe(
    left: Table,
    left_on: Sequence[int],
    pwords: torch.Tensor,
    right_payload: Table,
    plan: PreparedPackPlan,
    out_capacity: int,
    char_out_factor: float = 1.0,
) -> tuple[Table, torch.Tensor, dict]:
    """The probe tier of ``inner_join_prepared``: no sort of any size.

    Each probe row's key field is binary-searched in the resident run's
    key fields (lo = side-left rank, hi = side-right rank, count hi - lo).
    csum = cumsum(count) in probe-row order is sorted by construction, so
    output slot j comes from row src = #{csum <= j} at offset t within
    the row's run of slots (``_probe_expand`` under ``DJT_PROBE_EXPAND``:
    the ``expand_ranks`` CUDA kernel under "segment" and "hist", the
    ``expand_values`` one under "pallas"), and its matched ref's sorted
    rank is ``lo[src] + t``. csum is int32 and wraps past 2^31 as the JAX
    package's does; total then exceeds out_capacity and condemns the
    output. The same (result, total, flags) contract, string columns
    included, as ``inner_join_prepared``.
    """
    L, R = left.capacity, pwords.shape[0]
    _check_prepared_geometry(L, R, plan)
    probe_expand = resolve_probe_expand()
    l_count, r_count = left.count(), right_payload.count()
    dev = pwords.device
    w_l, ok = _anchored_pack_word(left, left_on, plan, R)
    flags = {"prepared_plan_mismatch": ~(ok | (r_count == 0))}
    if L == 0 or R == 0:
        # A capacity-0 side joins empty.
        total = torch.zeros((), dtype=torch.int64, device=dev)
        li = torch.full((out_capacity,), L, dtype=torch.int32, device=dev)
        rrow = torch.full((out_capacity,), R, dtype=torch.int32, device=dev)
    else:
        lo, cnt = _probe_counts(pwords, w_l, l_count, r_count, plan.tag_bits)
        del w_l
        # int64 cumsum cut to int32: the int32 wraparound of jnp.cumsum.
        csum = torch.cumsum(cnt, 0, dtype=torch.int64).to(torch.int32)
        total = cnt.sum(dtype=torch.int64)
        src, t = _probe_expand(csum, cnt, L, out_capacity, probe_expand)
        del csum, cnt
        valid_out = torch.arange(out_capacity, device=dev) < total
        li = torch.where(valid_out, src, L)
        rrow = torch.where(valid_out, lo[src] + t, R)
    cols = _gather_prepared_output(left, right_payload, li, rrow, out_capacity, char_out_factor)
    count = torch.minimum(total, torch.tensor(out_capacity, device=dev)).to(torch.int32)
    return Table(tuple(cols), count), total, flags

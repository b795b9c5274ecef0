"""The cascaded wire codec: RLE, zigzag delta and FoR bitpack.

Counterpart of ``dj_tpu/compress/cascaded.py``. Each bucket of a shuffle
slot is compressed before the exchange into a static capacity of
``wire_factor`` times its raw bytes (``compressed_capacity_words``) and
decompressed after it; a bucket whose stream does not fit sets its
overflow bit. The sampling selector picks the cascade and the
wire_factor of each column on the host, from at most 100 strided
1024-element chunks gathered on the device.

The format is dj_tpu's, word for word: per bucket ``cap_words`` u64
words (int64 bit patterns here), zero wherever nothing is written.

  [0] valid value/run count r     [1] bits_v | bits_l << 8
  [2] FoR base of values          [3] delta base (pre-delta first value)
  [4] FoR base of run lengths     [5] packed value words nw_v
  [6] packed length words nw_l    [7] block element count
  [8, 8 + nw_v) packed values     [8 + nw_v, 8 + nw_v + nw_l) packed lengths

Every function works on all peers' buckets at once ([n, B] inputs with
per-bucket counts), with no loop over peers and no read back to the
host; ``compress_block`` / ``decompress_block`` are their one-bucket
view. PyTorch's card build has no unsigned 64-bit arithmetic, so the
codec computes on int64 bit patterns and rebuilds dj_tpu's u64
semantics: right shifts are made logical by a mask, the FoR min and max
compare with the sign bit flipped, every shift count is chosen inside
[0, 63] before the shift, and adds and cumsums wrap as u64's do. The
RLE decode is ``count_leq_arange`` of the run ends, which is the
contract of ``ops.expand.expand_ranks``: its CUDA kernel on the card,
its plain version on the CPU.

The selector records one ``compress_select`` event a column verdict and
counts ``dj_compress_select_total{kind,method}``, as dj_tpu's does.
dj_tpu's fault site ``codec`` (in its ``compress_buckets``, consulted
while a module traces) is consulted by the port's dispatching thread,
once a dispatch attempt whose exchange compresses (:func:`consult_codec`):
``shuffle_on``, and the joins' and the prepare's pre-shuffle. A fault
there, or any failure of a compressed call, pins the ladder's ``wire``
tier (``resilience.errors``) and the call runs again uncompressed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..core.table import StringColumn, Table, signed_view
from ..ops.expand import expand_ranks
from ..resilience import faults

HEADER_WORDS = 8

METHOD_NONE = "none"
METHOD_CASCADED = "cascaded"

# The same-width signed dtype of each element size (the wire's view).
_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_I64 = torch.int64
_INT64_MIN = -(2**63)
_INT64_MAX = 2**63 - 1


@dataclasses.dataclass(frozen=True)
class CascadedOptions:
    """Cascade shape: RLE passes, delta passes, bitpacking (nvcomp's
    {num_RLEs, num_deltas, use_bp}); at most one RLE and one delta pass."""

    num_rles: int = 1
    num_deltas: int = 0
    use_bp: bool = True

    def __post_init__(self):
        assert 0 <= self.num_rles <= 1, "at most one RLE pass supported"
        assert 0 <= self.num_deltas <= 1, "at most one delta pass supported"


@dataclasses.dataclass(frozen=True)
class ColumnCompressionOptions:
    """Per-column compression plan, recursive for a string column's
    (sizes, chars) children. ``wire_factor`` is the static compressed
    bucket capacity as a fraction of the raw bucket bytes."""

    method: str = METHOD_NONE
    cascaded: CascadedOptions = CascadedOptions()
    wire_factor: float = 1.0
    children: tuple["ColumnCompressionOptions", ...] = ()


TableCompressionOptions = tuple[ColumnCompressionOptions, ...]


def compresses(tree) -> bool:
    """Whether a table's options tree (None for a raw table) sends any
    slot through the codec: a column, or a string column's child, whose
    method is ``METHOD_CASCADED``."""
    return tree is not None and any(
        o is not None and (o.method == METHOD_CASCADED or compresses(o.children)) for o in tree)


def consult_codec(group_size: int, *trees) -> None:
    """Fault site ``codec`` for a dispatch attempt whose exchange over a
    group of ``group_size`` ranks compresses (more than one rank, and a
    cascaded slot in one of the options ``trees``): consulted once an
    attempt, on the dispatching thread, by ``shuffle_on`` and by the
    joins' and the prepare's pre-shuffle. dj_tpu consults it in
    ``compress_buckets`` while a module traces."""
    if group_size > 1 and any(compresses(t) for t in trees):
        faults.check("codec")


def compressed_capacity_words(raw_bytes: int, wire_factor: float) -> int:
    """Static u64-word capacity of a compressed block."""
    return HEADER_WORDS + max(1, int(np.ceil(raw_bytes * wire_factor / 8)))


# --- u64 semantics on int64 lanes ----------------------------------------


def _low_mask(m: torch.Tensor) -> torch.Tensor:
    """(1 << m) - 1 as u64 bits for m in [0, 64], no shift by 64."""
    return torch.where(m >= 64, -1, (1 << m.clamp(0, 63)) - 1)


def _srl(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Logical right shift of u64 bits by k in [0, 63]: the arithmetic
    shift masked to its low 64 - k bits (the mask built in two shifts
    below 64)."""
    return (v >> k) & ~((-1 << (63 - k)) << 1)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as u64 for a non-negative a."""
    return (b < 0) | (a < b)


def _bits_needed(maxdiff: torch.Tensor) -> torch.Tensor:
    """Smallest b with maxdiff < 2**b (0..64) per bucket: the count of k
    in [0, 64) with maxdiff >> k nonzero, which an arithmetic shift
    gives as a logical one does."""
    k = torch.arange(64, dtype=_I64, device=maxdiff.device)
    return ((maxdiff[:, None] >> k) != 0).sum(1)


# --- block codec primitives, batched over peers ([n, B] rows) -------------


def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 cumsum of each row of [n, B], wrapping: one flat
    scan less each row's start. PyTorch's scan along the rows is slow
    for a few long rows on the card, and the flat scan is not."""
    n, B = x.shape
    flat = x.reshape(-1).cumsum(0, dtype=_I64).view(n, B)
    before = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    return flat - before[:, None]


def _rle(x: torch.Tensor, count: torch.Tensor):
    """Run-length encode each row's x[:count] -> (values[n, B],
    lengths[n, B], run counts[n])."""
    n, B = x.shape
    i = torch.arange(B, dtype=_I64, device=x.device)
    boundary = torch.cat([(count > 0)[:, None], x[:, 1:] != x[:, :-1]], dim=1)
    boundary &= i < count[:, None]
    r = boundary.sum(1)
    # Run k starts at starts[k]: the boundary positions compacted in
    # order (a cumsum scatter; the rest stay B, through a spare column).
    pos = torch.where(boundary, _row_cumsum(boundary) - 1, B)
    starts = torch.full((n, B + 1), B, dtype=_I64, device=x.device)
    starts.scatter_(1, pos, i.expand(n, B).contiguous())
    starts = starts[:, :B]
    vals = x.gather(1, starts.clamp(0, B - 1))
    ends = torch.cat([starts[:, 1:], torch.full((n, 1), B, dtype=_I64, device=x.device)], 1)
    lens = (torch.minimum(ends, count[:, None]) - starts).clamp_min(0)
    valid = i < r[:, None]
    return torch.where(valid, vals, 0), torch.where(valid, lens, 0), r


def _rle_decode(vals: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Each row's runs expanded to B values: position j takes the run
    count_leq_arange(ends, B)[j], ends = cumsum(lens). One expand_ranks
    call over the n rows, bucket p's ends raised by p * B. A stream
    whose bucket overflowed decodes to unspecified values; its lengths
    are clamped so that the ends stay ascending in [0, B], as
    expand_ranks requires (valid lengths are in range and unchanged)."""
    n, B = vals.shape
    ends = _row_cumsum(lens.clamp(0, B)).clamp_max(B)
    shift = torch.arange(n, dtype=_I64, device=vals.device)[:, None] * B
    run = expand_ranks((ends + shift).reshape(-1), n * B).to(_I64).reshape(n, B) - shift
    return vals.gather(1, run.clamp(0, B - 1))


def _zigzag(x: torch.Tensor) -> torch.Tensor:
    return (x << 1) ^ (x >> 63)


def _unzigzag(z: torch.Tensor) -> torch.Tensor:
    return ((z >> 1) & _INT64_MAX) ^ -(z & 1)


def _pack(vals: torch.Tensor, r: torch.Tensor, b: torch.Tensor, cap_words: int):
    """Pack each row's vals[:r] (b bits each) into cap_words u64 words;
    returns (words[n, cap_words], nw[n]). Element i puts its low bits
    (lo) into word w0 = i * b // 64 and its spill (hi) into w0 + 1, in
    disjoint bit ranges, so a word is the wrapping sum of what lands in
    it, as dj_tpu's add-scatter makes it. w0 ascends with i, so word w's
    sums are differences of the rows' cumsums at the element counts
    ends(w) = #{i < r : w0(i) <= w}, computed from b; words past
    cap_words drop."""
    n, B = vals.shape
    dev = vals.device
    i = torch.arange(B, dtype=_I64, device=dev)
    vals = torch.where(i < r[:, None], vals, 0)
    sh = (i * b[:, None]) & 63
    lo = vals << sh
    hi = torch.where(sh > 0, _srl(vals, (64 - sh).clamp_max(63)), 0)
    del vals, sh
    pad = torch.nn.functional.pad
    lo_sums = pad(_row_cumsum(lo), (1, 0))  # lo_sums[k] = sum(lo[:k])
    del lo
    hi_sums = pad(_row_cumsum(hi), (1, 0))
    del hi
    w = torch.arange(-2, cap_words, dtype=_I64, device=dev)
    ends = torch.minimum(r[:, None], (64 * w + 63) // b.clamp_min(1)[:, None] + 1)
    ends = torch.where(b[:, None] > 0, ends, r[:, None]).clamp_min(0)
    ends[:, :2] = 0  # no element sits before word 0
    e0, e1, e2 = ends[:, 2:], ends[:, 1:-1], ends[:, :-2]  # ends(w), ends(w - 1), ends(w - 2)
    words = (lo_sums.gather(1, e0) - lo_sums.gather(1, e1)
             + hi_sums.gather(1, e1) - hi_sums.gather(1, e2))
    return words, (r * b + 63) >> 6


def _region_word(words: torch.Tensor, off: torch.Tensor, j: torch.Tensor, B: int):
    """Word j of each row's region at offset ``off``: words[off + j] for
    j < B and off + j inside the row, else 0."""
    idx = off[:, None] + j
    ok = (j < B) & (idx >= 0) & (idx < words.shape[1])
    return torch.where(ok, words.gather(1, torch.where(ok, idx, 0)), 0)


def _unpack(words: torch.Tensor, off: torch.Tensor, r: torch.Tensor, b: torch.Tensor, B: int):
    """Inverse of _pack on each row's region at ``off`` -> [n, B] values
    (0 beyond r)."""
    i = torch.arange(B, dtype=_I64, device=words.device)
    bitpos = i * b[:, None]
    w0 = bitpos >> 6
    sh = bitpos & 63
    lo = _srl(_region_word(words, off, w0, B), sh)
    hi = torch.where(sh > 0, _region_word(words, off, w0 + 1, B) << (64 - sh).clamp_max(63), 0)
    v = (lo | hi) & _low_mask(b)[:, None]
    return torch.where(_ult(i, r[:, None]), v, 0)


def _for_encode(vals: torch.Tensor, r: torch.Tensor):
    """Frame of reference: subtract each row's unsigned valid-prefix min;
    returns (rebased values, base[n], bit width[n])."""
    i = torch.arange(vals.shape[1], dtype=_I64, device=vals.device)
    valid = i < r[:, None]
    flipped = vals ^ _INT64_MIN  # unsigned order as signed order
    vmin = torch.where(valid, flipped, _INT64_MAX).amin(1)
    vmax = torch.where(valid, flipped, _INT64_MIN).amax(1)
    vmin = torch.minimum(vmin, vmax) ^ _INT64_MIN  # r == 0 guard
    vmax = vmax ^ _INT64_MIN
    b = _bits_needed(vmax - vmin)
    return torch.where(valid, vals - vmin[:, None], 0), vmin, b


def _compress_rows(x: torch.Tensor, opts: CascadedOptions, cap_words: int,
                   counts: torch.Tensor):
    """compress_block of each row of x ([n, B] u64 bits as int64) ->
    (words[n, cap_words], total_words[n], overflow[n])."""
    n, B = x.shape
    dev = x.device
    i = torch.arange(B, dtype=_I64, device=dev)
    count = counts.to(_I64)
    r = count
    lens = None
    if opts.num_rles:
        vals, lens, r = _rle(x, count)
    else:
        vals = torch.where(i < r[:, None], x, 0)
    base = vals[:, 0]
    if opts.num_deltas:
        prev = torch.cat([vals[:, :1], vals[:, :-1]], 1)
        vals = torch.where((i > 0) & (i < r[:, None]), _zigzag(vals - prev), 0)
    zero = torch.zeros(n, dtype=_I64, device=dev)
    if opts.use_bp:
        vals, vmin, b_v = _for_encode(vals, r)
    else:
        vmin, b_v = zero, torch.full_like(zero, 64)
    pv, nw_v = _pack(vals, r, b_v, cap_words)
    del vals
    if lens is not None:
        if opts.use_bp:
            lens, lmin, b_l = _for_encode(lens, r)
        else:
            lmin, b_l = zero, torch.full_like(zero, 64)
        pl, nw_l = _pack(lens, r, b_l, cap_words)
        del lens
    else:
        pl = None
        lmin, b_l, nw_l = zero, zero, zero
    header = torch.stack([r, b_v | (b_l << 8), vmin, base, lmin, nw_v, nw_l, count], 1)
    out = torch.zeros((n, cap_words), dtype=_I64, device=dev)
    out[:, :HEADER_WORDS] = header[:, :cap_words]
    # Value words at the fixed offset; length words behind the (per row)
    # value region. Words past each region are 0, so the adds are ors.
    out[:, HEADER_WORDS:] += pv[:, : max(0, cap_words - HEADER_WORDS)]
    if pl is not None:
        k = torch.arange(cap_words, dtype=_I64, device=dev)
        src = k - HEADER_WORDS - nw_v[:, None]
        ok = (src >= 0) & (src < cap_words)
        out += torch.where(ok, pl.gather(1, torch.where(ok, src, 0)), 0)
    total = HEADER_WORDS + nw_v + nw_l
    return out, total, total > cap_words


def _decompress_rows(words: torch.Tensor, opts: CascadedOptions, B: int) -> torch.Tensor:
    """Inverse of _compress_rows -> [n, B] u64 bits as int64."""
    n = words.shape[0]
    r, vmin, base, lmin, nw_v, count = (words[:, j] for j in (0, 2, 3, 4, 5, 7))
    b_v = words[:, 1] & 0xFF
    b_l = (words[:, 1] >> 8) & 0xFF
    i = torch.arange(B, dtype=_I64, device=words.device)
    valid = _ult(i, r[:, None])
    header = torch.full((n,), HEADER_WORDS, dtype=_I64, device=words.device)
    vals = _unpack(words, header, r, b_v, B)
    if opts.use_bp:
        vals = torch.where(valid, vals + vmin[:, None], 0)
    if opts.num_deltas:
        d = torch.where((i > 0) & valid, _unzigzag(vals), 0)
        vals = torch.where(valid, base[:, None] + _row_cumsum(d), 0)
    if opts.num_rles:
        lens = _unpack(words, header + nw_v.clamp(0, _INT64_MAX - HEADER_WORDS), r, b_l, B)
        if opts.use_bp:
            lens = torch.where(valid, lens + lmin[:, None], 0)
        vals = _rle_decode(vals, lens)
    return torch.where(_ult(i, count[:, None]), vals, 0)


def _as_bits64(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint64:
        return x.view(_I64)
    if x.dtype != _I64:
        raise ValueError(f"expected u64 bits as int64 or uint64, got {x.dtype}")
    return x


def compress_block(x: torch.Tensor, opts: CascadedOptions, cap_words: int,
                   count: Optional[torch.Tensor] = None):
    """Compress x[:count] (u64 bits, int64 or uint64) into a static
    [cap_words] stream: (words int64[cap_words], total_words, overflow).
    Elements past ``count`` (default all) decompress as zeros."""
    x = _as_bits64(x)
    c = torch.full((1,), x.shape[0], dtype=_I64, device=x.device) if count is None \
        else torch.as_tensor(count, device=x.device).reshape(1)
    out, total, ovf = _compress_rows(x[None], opts, cap_words, c)
    return out[0], total[0], ovf[0]


def decompress_block(words: torch.Tensor, opts: CascadedOptions, out_elems: int) -> torch.Tensor:
    """Inverse of compress_block -> u64 bits as int64 [out_elems]."""
    return _decompress_rows(_as_bits64(words)[None], opts, out_elems)[0]


def compress_buckets(buckets: torch.Tensor, itemsize: int, opts: CascadedOptions,
                     cap_words: int, counts: Optional[torch.Tensor] = None):
    """Compress [n, B] buckets of a physical dtype of ``itemsize`` bytes
    -> (int64 [n, cap_words] words, total_words[n], overflow[n]). Each
    element's same-width bits, zero-extended to 64, are what is encoded;
    ``counts[n]`` bounds each bucket's valid prefix (padding is never
    encoded)."""
    bits = buckets.view(_INT_OF_SIZE[itemsize]).to(_I64)
    if itemsize < 8:
        bits &= (1 << (8 * itemsize)) - 1
    if counts is None:
        counts = torch.full((buckets.shape[0],), buckets.shape[1], dtype=_I64,
                            device=buckets.device)
    return _compress_rows(bits, opts, cap_words, counts)


def decompress_buckets(received: torch.Tensor, itemsize: int, opts: CascadedOptions,
                       out_elems: int, physical: torch.dtype) -> torch.Tensor:
    """Inverse of compress_buckets -> [n, out_elems] of ``physical``."""
    dec = _decompress_rows(received, opts, out_elems)
    return dec.to(_INT_OF_SIZE[itemsize]).view(physical)


# --- option generation: selector, policy, agreement -----------------------

_CANDIDATES = (
    CascadedOptions(num_rles=0, num_deltas=0, use_bp=True),
    CascadedOptions(num_rles=1, num_deltas=0, use_bp=True),
    CascadedOptions(num_rles=0, num_deltas=1, use_bp=True),
    CascadedOptions(num_rles=1, num_deltas=1, use_bp=True),
)


def _simulate_compressed_words(x: np.ndarray, opts: CascadedOptions) -> int:
    """Host-side exact size model of compress_block on a sample."""
    x = x.astype(np.uint64)
    r = x.size
    vals, lens = x, None
    if opts.num_rles and x.size:
        boundary = np.concatenate([[True], x[1:] != x[:-1]])
        vals = x[boundary]
        idx = np.flatnonzero(boundary)
        lens = np.diff(np.concatenate([idx, [x.size]])).astype(np.uint64)
        r = vals.size
    if opts.num_deltas and vals.size:
        d = np.zeros_like(vals)
        s = vals.astype(np.int64)
        d[1:] = ((s[1:] - s[:-1]) << 1 ^ (s[1:] - s[:-1]) >> 63).astype(np.uint64)
        vals = d

    def bits(a):
        if a.size == 0:
            return 0
        diff = int(a.max() - a.min())
        return max(0, diff.bit_length())

    total = HEADER_WORDS + -(-r * bits(vals) // 64)
    if lens is not None:
        total += -(-r * bits(lens) // 64)
    return total


def select_cascaded_options(
    data: np.ndarray, sample_chunks: int = 100, chunk_elems: int = 1024, slack: float = 2.0,
) -> tuple[CascadedOptions, float]:
    """Pick the cascade by measuring the candidates on a sample (nvcomp's
    CascadedSelector of 100 x 1024): the strided sample, permuted with
    default_rng(0) (the shuffle compresses hash-partitioned buckets, so
    an order the partition destroys must not win), then the candidate of
    fewest words. Returns (options, wire_factor): the sampled fraction
    times ``slack``, clamped to [1/64, 1]."""
    data = np.asarray(data)
    data = data.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[data.dtype.itemsize])
    n = data.size
    if n > sample_chunks * chunk_elems:
        stride = n // sample_chunks
        sample = np.concatenate(
            [data[k * stride : k * stride + chunk_elems] for k in range(sample_chunks)])
    else:
        sample = data
    sample = np.random.default_rng(0).permutation(sample)
    raw_words = max(1, sample.size * data.dtype.itemsize // 8)
    best, best_words = _CANDIDATES[0], None
    for cand in _CANDIDATES:
        w = _simulate_compressed_words(sample, cand)
        if best_words is None or w < best_words:
            best, best_words = cand, w
    ratio = best_words / raw_words
    wire_factor = float(np.clip(ratio * slack, 1 / 64, 1.0))
    return best, wire_factor


def selector_sample(data, sample_chunks: int = 100, chunk_elems: int = 1024) -> np.ndarray:
    """The selector's strided sample of a column, gathered on the
    tensor's device: only the sample, at most sample_chunks x chunk_elems
    elements (800 KB of int64), crosses to the host, at the positions
    ``select_cascaded_options`` strides to. A column no longer than the
    sample crosses whole."""
    n = int(data.shape[0])
    budget = sample_chunks * chunk_elems
    if isinstance(data, np.ndarray):
        if n <= budget:
            return data
        stride = n // sample_chunks
        return np.concatenate([data[k * stride : k * stride + chunk_elems]
                               for k in range(sample_chunks)])
    signed = signed_view(data)  # the card indexes no unsigned dtype
    if n <= budget:
        sample = signed.cpu().numpy()
    else:
        stride = n // sample_chunks
        idx = (torch.arange(sample_chunks, dtype=_I64, device=data.device)[:, None] * stride
               + torch.arange(chunk_elems, dtype=_I64, device=data.device)[None, :]).reshape(-1)
        sample = signed[idx].cpu().numpy()
    assert sample.size <= max(n if n <= budget else 0, budget)
    if signed is not data:
        sample = sample.view(f"uint{8 * data.element_size()}")
    return sample


def _record_select(kind: str, method: str, wire_factor=None, opts=None) -> None:
    """The selector's verdict on one column, into the flight recorder
    (dj_tpu's ``_record_select``, compress/cascaded.py:458-472)."""
    obs.inc("dj_compress_select_total", kind=kind, method=method)
    fields = dict(kind=kind, method=method)
    if wire_factor is not None:
        fields["wire_factor"] = round(float(wire_factor), 4)
    if opts is not None:
        fields["cascade"] = f"rle={opts.num_rles},delta={opts.num_deltas},bp={int(opts.use_bp)}"
    obs.record("compress_select", **fields)


def _auto_column_options(col) -> ColumnCompressionOptions:
    if isinstance(col, StringColumn):
        # Compress the sizes sub-buffer, never the chars (the reference's
        # compression.cpp:44-60), with the fixed-width fallback below.
        opts, wf = select_cascaded_options(selector_sample(col.sizes()))
        incompressible = wf >= 0.95
        _record_select("string_sizes", METHOD_NONE if incompressible else METHOD_CASCADED, wf,
                       None if incompressible else opts)
        sizes_child = (ColumnCompressionOptions(METHOD_NONE) if incompressible
                       else ColumnCompressionOptions(METHOD_CASCADED, opts, wf))
        return ColumnCompressionOptions(
            METHOD_NONE, children=(sizes_child, ColumnCompressionOptions(METHOD_NONE)))
    if col.dtype.kind == "float":
        # An integer codec: floats ride uncompressed.
        _record_select("float", METHOD_NONE)
        return ColumnCompressionOptions(METHOD_NONE)
    opts, wf = select_cascaded_options(selector_sample(col.data))
    if wf >= 0.95:
        # Incompressible: the codec would move at least the raw bytes.
        _record_select("column", METHOD_NONE, wf)
        return ColumnCompressionOptions(METHOD_NONE)
    _record_select("column", METHOD_CASCADED, wf, opts)
    return ColumnCompressionOptions(METHOD_CASCADED, opts, wf)


def generate_auto_select_compression_options(table: Table) -> TableCompressionOptions:
    """The sampling selector per column (the reference's
    generate_auto_select_compression_options, compression.cpp:36-73)."""
    return tuple(_auto_column_options(c) for c in table.columns)


def generate_none_compression_options(table: Table) -> TableCompressionOptions:
    """All-none options tree; a string column gets two none children
    (compression.cpp:76-96)."""
    none = ColumnCompressionOptions(METHOD_NONE)
    return tuple(ColumnCompressionOptions(METHOD_NONE, children=(none, none))
                 if isinstance(c, StringColumn) else none for c in table.columns)


def _encode(o: ColumnCompressionOptions) -> list:
    vec = [1.0 if o.method == METHOD_CASCADED else 0.0, float(o.cascaded.num_rles),
           float(o.cascaded.num_deltas), 1.0 if o.cascaded.use_bp else 0.0, o.wire_factor,
           float(len(o.children))]
    for ch in o.children:
        vec.extend(_encode(ch))
    return vec


def _decode(vec: list, pos: int) -> tuple[ColumnCompressionOptions, int]:
    method = METHOD_CASCADED if vec[pos] > 0.5 else METHOD_NONE
    casc = CascadedOptions(num_rles=int(vec[pos + 1]), num_deltas=int(vec[pos + 2]),
                           use_bp=vec[pos + 3] > 0.5)
    wf = float(vec[pos + 4])
    nchild = int(vec[pos + 5])
    pos += 6
    children = []
    for _ in range(nchild):
        ch, pos = _decode(vec, pos)
        children.append(ch)
    return ColumnCompressionOptions(method, casc, wf, tuple(children)), pos


def broadcast_compression_options(options: TableCompressionOptions) -> TableCompressionOptions:
    """Every rank takes rank 0's options tree (the reference's recursive
    MPI_Bcast, compression.cpp:97-168). The options shape the exchange,
    so every rank must use the same ones. In one process (one rank, or a
    world of threads) this is the identity; in a torch.distributed world
    the tree goes as one float64 vector, dj_tpu's encoding, in one
    broadcast (on the card under NCCL, on the CPU under gloo). Every
    rank passes a tree of the same shape (the same table schema)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return options
    flat: list = []
    for o in options:
        flat.extend(_encode(o))
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    vec = torch.tensor(flat, dtype=torch.float64, device=dev)
    dist.broadcast(vec, src=0)
    agreed = vec.cpu().tolist()
    out, pos = [], 0
    for _ in options:
        o, pos = _decode(agreed, pos)
        out.append(o)
    return tuple(out)

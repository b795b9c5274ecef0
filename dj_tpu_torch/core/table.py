"""Columnar Table/Column core: struct-of-arrays over torch tensors.

Counterpart of ``dj_tpu/core/table.py``. A fixed-width column is one
flat tensor; a string column is the (offsets int32[n + 1], chars
uint8[char_capacity]) pair of cuDF's strings column, which the shuffle
moves as two buffers. Every column has a static *capacity*; the number
of valid leading rows is ``valid_count``, a 0-d int32 tensor on the
table's device (``None`` means all rows are valid). Rows beyond it are
padding that every op ignores. Keeping the count on the device lets a
join run without reading it back to the host, as the JAX package keeps
it traced.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import dtypes as dt
from .search import interval_of_arange


@dataclasses.dataclass(frozen=True)
class Column:
    """Fixed-width column: one flat tensor plus a logical dtype."""

    data: torch.Tensor
    dtype: dt.DType

    @property
    def size(self) -> int:
        return self.data.shape[0]

    def take(self, indices: torch.Tensor) -> "Column":
        """Gather rows; out-of-range indices produce 0."""
        return Column(take_fill(self.data, indices), self.dtype)


# The same-width signed dtype of each unsigned dtype wider than a byte.
_SIGNED_OF = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def signed_view(data: torch.Tensor) -> torch.Tensor:
    """``data`` itself, or for a 16/32/64-bit unsigned tensor its
    same-width signed view. PyTorch implements few ops for those dtypes
    (none of indexing, ``masked_fill_``, ``where`` or comparisons on the
    card), so gathers move their bits through this view."""
    signed = _SIGNED_OF.get(data.dtype)
    return data if signed is None else data.view(signed)


def gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``data[idx]`` for any fixed-width dtype, bit for bit."""
    return signed_view(data)[idx].view(data.dtype)


def gather_fill(data: torch.Tensor, idx: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """``data[idx]`` with 0 wherever ``fill`` is set, for any fixed-width
    dtype, bit for bit."""
    return signed_view(data)[idx].masked_fill_(fill, 0).view(data.dtype)


def take_fill(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``data[idx]`` with 0 wherever ``idx`` is outside [0, len(data)) —
    the ``mode="fill"`` gather the JAX package uses throughout."""
    n = data.shape[0]
    if n == 0:
        return torch.zeros(idx.shape + data.shape[1:], dtype=data.dtype, device=data.device)
    bad = (idx < 0) | (idx >= n)
    if data.dim() > 1:  # a row gather: fill whole rows
        bad = bad.reshape(bad.shape + (1,) * (data.dim() - 1))
    return gather_fill(data, idx.clamp(0, n - 1), bad)


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather_rows(cols: Sequence[Column], idx: torch.Tensor) -> list[Column]:
    """The rows ``idx`` of several fixed-width columns (dj_tpu's
    ``gather_rows``, core/table.py:118-153): the columns of one element
    width move as one [n, k] stack of their same-width int bits, one
    gather a width; out-of-range indices give 0, as ``take_fill``."""
    by_width: dict[int, list[int]] = {}
    for pos, c in enumerate(cols):
        by_width.setdefault(c.data.element_size(), []).append(pos)
    out: list[Optional[Column]] = [None] * len(cols)
    for width, positions in by_width.items():
        if len(positions) == 1:
            c = cols[positions[0]]
            out[positions[0]] = Column(take_fill(c.data, idx), c.dtype)
            continue
        stacked = torch.stack([cols[p].data.view(_INT_OF_SIZE[width]) for p in positions], dim=-1)
        rows = take_fill(stacked, idx)
        for k, p in enumerate(positions):
            c = cols[p]
            out[p] = Column(rows[..., k].contiguous().view(c.data.dtype), c.dtype)
    return out  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class StringColumn:
    """Variable-width column: row i's bytes are
    ``chars[offsets[i]:offsets[i + 1]]``, offsets[0] == 0. ``chars`` may
    hold more bytes than ``offsets[-1]``; the tail is padding."""

    offsets: torch.Tensor  # int32 [nrows + 1]
    chars: torch.Tensor  # uint8 [char_capacity]
    dtype: dt.DType = dt.string

    @property
    def size(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def sizes(self) -> torch.Tensor:
        """Per-row byte sizes (the offsets' adjacent difference), int32."""
        return self.offsets[1:] - self.offsets[:-1]

    def take(self, indices: torch.Tensor, out_char_capacity: Optional[int] = None
             ) -> "StringColumn":
        """Gather rows (out-of-range indices give empty rows) into chars of
        ``out_char_capacity`` bytes (default: the input's). Offsets are
        rebuilt from the gathered sizes by a scan and stay true when the
        bytes do not fit, so ``char_overflow()`` detects the truncation.
        Each output byte finds its row by ``interval_of_arange`` over the
        new offsets and reads the source byte at the row's start plus
        its place in the row."""
        cap = self.chars.shape[0] if out_char_capacity is None else out_char_capacity
        if indices.shape[0] == 0:
            return StringColumn(torch.zeros(1, dtype=torch.int32, device=self.device),
                                torch.zeros(cap, dtype=torch.uint8, device=self.device),
                                self.dtype)
        sizes = take_fill(self.sizes(), indices)
        new_offsets = sizes_to_offsets(sizes)
        del sizes
        starts = take_fill(self.offsets, indices)
        pos = torch.arange(cap, dtype=torch.int32, device=self.device)
        row = interval_of_arange(new_offsets, cap, indices.shape[0])
        src = starts[row]
        src += pos
        src -= new_offsets[row]
        del row, starts
        beyond = pos >= new_offsets[-1]
        del pos
        chars = take_fill(self.chars, src).masked_fill_(beyond, 0)
        return StringColumn(new_offsets, chars, self.dtype)

    def char_overflow(self) -> torch.Tensor:
        """True if the offsets claim more bytes than chars holds (the
        truncation ``take`` leaves detectable)."""
        return self.offsets[-1] > self.chars.shape[0]


AnyColumn = Column | StringColumn


@dataclasses.dataclass(frozen=True)
class Table:
    """An ordered collection of equal-capacity columns."""

    columns: tuple[AnyColumn, ...]
    valid_count: Optional[torch.Tensor] = None

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def capacity(self) -> int:
        # A fixed-width column first: a sharded string column's offsets
        # hold w * (cap + 1) entries, one extra a shard.
        for c in self.columns:
            if isinstance(c, Column):
                return c.size
        return self.columns[0].size if self.columns else 0

    @property
    def device(self) -> torch.device:
        c = self.columns[0]
        return c.offsets.device if isinstance(c, StringColumn) else c.data.device

    @property
    def has_strings(self) -> bool:
        return any(isinstance(c, StringColumn) for c in self.columns)

    def count(self) -> torch.Tensor:
        """Valid row count as a 0-d int32 tensor."""
        if self.valid_count is None:
            return torch.tensor(self.capacity, dtype=torch.int32, device=self.device)
        return self.valid_count

    def with_count(self, valid_count) -> "Table":
        return Table(self.columns, valid_count)


def from_arrays(*arrays, dtypes=None, valid_count=None, device="cuda") -> Table:
    """Build a table of fixed-width columns from tensors or numpy arrays."""
    cols = []
    for i, a in enumerate(arrays):
        t = torch.as_tensor(a, device=device)
        d = dtypes[i] if dtypes is not None else dt.from_torch(t.dtype)
        cols.append(Column(t, d))
    if valid_count is not None and not isinstance(valid_count, torch.Tensor):
        valid_count = torch.tensor(int(valid_count), dtype=torch.int32, device=device)
    return Table(tuple(cols), valid_count)


def from_strings(strings: Sequence, device="cuda") -> StringColumn:
    """A StringColumn of python strings or bytes (utf-8), for tests and
    small tables. An empty column keeps one byte of chars."""
    bs = [s.encode() if isinstance(s, str) else bytes(s) for s in strings]
    sizes = np.array([len(b) for b in bs], np.int32)
    offsets = np.zeros(len(bs) + 1, np.int32)
    np.cumsum(sizes, out=offsets[1:])
    chars = np.frombuffer(b"".join(bs), np.uint8).copy()
    if chars.size == 0:
        chars = np.zeros(1, np.uint8)
    return StringColumn(torch.from_numpy(offsets).to(device), torch.from_numpy(chars).to(device))


def to_strings(col: StringColumn, count: Optional[int] = None) -> list[bytes]:
    """The first ``count`` rows (default all) of a StringColumn as bytes."""
    offsets = col.offsets.cpu().numpy()
    chars = col.chars.cpu().numpy()
    n = col.size if count is None else int(count)
    return [chars[offsets[i] : offsets[i + 1]].tobytes() for i in range(n)]


def sizes_to_offsets(sizes: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of sizes into an int32 offsets vector with a
    leading zero."""
    out = torch.zeros(sizes.shape[0] + 1, dtype=torch.int32, device=sizes.device)
    torch.cumsum(sizes.to(torch.int32), 0, dtype=torch.int32, out=out[1:])
    return out


def concatenate(tables: Sequence[Table]) -> Table:
    """Concatenate tables row-wise (capacity = sum of capacities).

    Valid rows of each input are compacted to the front; the result's
    valid_count is the sum of the input counts. Table t writes its whole
    capacity at the running row start, so the next table overwrites its
    padding tail; the last tail is zeroed. The starts are read back to
    the host once, to slice.
    """
    assert tables, "concatenate of zero tables"
    caps = [t.capacity for t in tables]
    total_cap = sum(caps)
    counts = torch.stack([t.count() for t in tables])
    starts = sizes_to_offsets(counts)
    starts_h = starts.tolist()
    total = starts[-1]
    device = tables[0].device
    out_cols = []
    for c, col0 in enumerate(tables[0].columns):
        if isinstance(col0, StringColumn):
            out_cols.append(_concat_strings(tables, c, starts_h, total_cap))
            continue
        out = torch.empty(total_cap, dtype=col0.data.dtype, device=device)
        for t, tbl in enumerate(tables):
            s = starts_h[t]
            out[s : s + caps[t]] = tbl.columns[c].data
        out[starts_h[-1] :] = 0
        out_cols.append(Column(out, col0.dtype))
    return Table(tuple(out_cols), total)


def _write_at(out: torch.Tensor, data: torch.Tensor, start: int) -> None:
    """``out[start : start + len(data)] = data`` with the start clamped so
    the write fits, as ``jax.lax.dynamic_update_slice`` clamps it."""
    start = min(max(start, 0), out.shape[0] - data.shape[0])
    out[start : start + data.shape[0]] = data


def _concat_strings(tables: Sequence[Table], c: int, starts_h: list, total_cap: int
                    ) -> StringColumn:
    """Row-compacting concatenation of string column ``c``
    (``_concat_strings``, dj_tpu/core/table.py:268-301): each table's
    sizes, then its chars, are written at its running start (the next
    table overwrites the padding), the offsets rebuilt by a scan, and
    everything past the valid rows and bytes zeroed."""
    cols = [t.columns[c] for t in tables]
    out_char_cap = sum(col.chars.shape[0] for col in cols)
    dev = cols[0].device
    sizes = torch.zeros(total_cap, dtype=torch.int32, device=dev)
    for t, col in enumerate(cols):
        _write_at(sizes, col.sizes(), starts_h[t])
    sizes[starts_h[-1] :] = 0
    new_offsets = sizes_to_offsets(sizes)
    byte_starts = new_offsets[torch.tensor(starts_h[:-1], device=dev)].tolist()
    chars = torch.zeros(out_char_cap, dtype=torch.uint8, device=dev)
    for t, col in enumerate(cols):
        _write_at(chars, col.chars, byte_starts[t])
    chars[int(new_offsets[-1]) :] = 0
    return StringColumn(new_offsets, chars, cols[0].dtype)


def table_nbytes(t: Table) -> int:
    """Static byte footprint of a table's buffers (capacity-based)."""
    n = 0
    for c in t.columns:
        if isinstance(c, StringColumn):
            n += c.offsets.numel() * 4 + c.chars.numel()
        else:
            n += c.size * c.data.element_size()
    return n

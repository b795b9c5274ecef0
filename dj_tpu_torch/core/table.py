"""Columnar Table/Column core: struct-of-arrays over torch tensors.

Counterpart of ``dj_tpu/core/table.py:32-48, 159-303`` for fixed-width
columns. Every column has a static *capacity*; the number of valid
leading rows is ``valid_count``, a 0-d int32 tensor on the table's
device (``None`` means all rows are valid). Rows beyond it are padding
that every op ignores. Keeping the count on the device lets a join run
without reading it back to the host, as the JAX package keeps it traced.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from . import dtypes as dt


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
        return torch.zeros(idx.shape, dtype=data.dtype, device=data.device)
    bad = (idx < 0) | (idx >= n)
    return gather_fill(data, idx.clamp(0, n - 1), bad)


@dataclasses.dataclass(frozen=True)
class Table:
    """An ordered collection of equal-capacity columns."""

    columns: tuple[Column, ...]
    valid_count: Optional[torch.Tensor] = None

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def capacity(self) -> int:
        return self.columns[0].size if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device

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
        out = torch.empty(total_cap, dtype=col0.data.dtype, device=device)
        for t, tbl in enumerate(tables):
            s = starts_h[t]
            out[s : s + caps[t]] = tbl.columns[c].data
        out[starts_h[-1] :] = 0
        out_cols.append(Column(out, col0.dtype))
    return Table(tuple(out_cols), total)

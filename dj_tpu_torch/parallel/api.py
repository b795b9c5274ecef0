"""Moving tables onto and off a topology.

Counterpart of ``dj_tpu/parallel/api.py::shard_table`` and
``unshard_table``: the sharded form of a table over a world of w ranks
is one [w * cap] column per fixed-width column, shard r in rows
[r * cap, (r + 1) * cap) padded with zeros past its rows, plus an int32
[w] vector of valid rows per shard. A string column shards as
[w * (cap + 1)] offsets, each shard's rebased to start at 0 and held at
its last value past its rows, and [w * char_cap] chars, zero past each
shard's bytes.

In a process world the same calls follow dj_tpu's SPMD input contract
(``dj_tpu/parallel/api.py:100-104``): every process passes the same
global table (or the same pieces), and each gets back only its own
rank's block ([cap] columns) and count ([1]). ``unshard_table`` of such a
block gives this rank's valid rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.table import Column, StringColumn, Table
from .topology import Topology


def shard_table(
    topology: Topology, table: Table, capacity_per_shard: Optional[int] = None,
    char_capacity_per_shard: Optional[int] = None,
) -> tuple[Table, torch.Tensor]:
    """Split an exact table row-balanced across the topology's ranks, on
    its device: shard r takes the next contiguous block of rows, the
    first ``nrows % w`` shards one row more than the others
    (dj_tpu/parallel/api.py:38-44), each padded to
    ``capacity_per_shard`` rows (default: the largest shard) and a
    string column to ``char_capacity_per_shard`` bytes (default: the
    most any shard holds, at least 1). Returns (table, counts[world])."""
    if table.valid_count is not None:
        raise ValueError("shard_table takes exact tables (valid_count None)")
    w = topology.world_size
    nrows = table.capacity
    counts = [nrows // w + (r < nrows % w) for r in range(w)]
    starts = [sum(counts[:r]) for r in range(w)]
    pieces = [_slice_rows(table, starts[r], counts[r]) for r in range(w)]
    return shard_table_pieces(topology, pieces, capacity_per_shard, char_capacity_per_shard)


def _slice_rows(table: Table, start: int, count: int) -> Table:
    """Rows [start, start + count) of an exact table (views; a string
    column's offsets rebased to start at 0, and its bytes, at least one)."""
    cols = []
    for c in table.columns:
        if isinstance(c, StringColumn):
            o = c.offsets[start : start + count + 1]
            lo, hi = int(o[0]), int(o[-1])
            chars = c.chars[lo:hi] if hi > lo else torch.zeros(1, dtype=torch.uint8,
                                                                device=c.device)
            cols.append(StringColumn(o - lo, chars, c.dtype))
        else:
            cols.append(Column(c.data[start : start + count], c.dtype))
    return Table(tuple(cols))


def _schema(table: Table) -> list:
    return [(c.dtype, None if isinstance(c, StringColumn) else c.data.dtype)
            for c in table.columns]


def shard_table_pieces(
    topology: Topology, pieces: Sequence[Table], capacity_per_shard: Optional[int] = None,
    char_capacity_per_shard: Optional[int] = None,
) -> tuple[Table, torch.Tensor]:
    """Place one exact table per rank on the topology's device: piece r
    becomes shard r's rows, padded to ``capacity_per_shard`` rows
    (default: the largest piece) and a string column's bytes to
    ``char_capacity_per_shard`` (default: the most any piece holds, at
    least 1). Returns (table, counts[world]); in a process world, this
    rank's shard and its [1] count."""
    w = topology.world_size
    if len(pieces) != w:
        raise ValueError(f"need {w} pieces, got {len(pieces)}")
    schema = _schema(pieces[0])
    for p in pieces:
        if p.valid_count is not None:
            raise ValueError("pieces must be exact tables (valid_count None)")
        if _schema(p) != schema:
            raise TypeError("piece schema mismatch")
    counts = [p.capacity for p in pieces]
    cap = max(counts) if capacity_per_shard is None else capacity_per_shard
    if cap < max(counts):
        raise ValueError(f"capacity {cap} < needed {max(counts)}")
    dev = topology.device
    here = [topology.rank] if topology.is_process_world else range(w)
    cols = []
    for j, (dtype, tdtype) in enumerate(schema):
        if tdtype is None:
            cols.append(_shard_strings([p.columns[j] for p in pieces], here, counts, cap,
                                       char_capacity_per_shard, dev))
            continue
        data = torch.zeros(len(here) * cap, dtype=tdtype, device=dev)
        for i, r in enumerate(here):
            data[i * cap : i * cap + counts[r]] = pieces[r].columns[j].data
        cols.append(Column(data, dtype))
    return Table(tuple(cols)), torch.tensor([counts[r] for r in here], dtype=torch.int32,
                                            device=dev)


def _shard_strings(cols: list, here, counts: list, cap: int, char_cap: Optional[int], dev
                   ) -> StringColumn:
    """The sharded form of one string column of the pieces."""
    nbytes = [int(c.offsets[-1]) for c in cols]
    ccap = max(1, max(nbytes)) if char_cap is None else char_cap
    if ccap < max(nbytes):
        raise ValueError(f"char capacity {ccap} < needed {max(nbytes)}")
    offsets = torch.zeros(len(here) * (cap + 1), dtype=torch.int32, device=dev)
    chars = torch.zeros(len(here) * ccap, dtype=torch.uint8, device=dev)
    for i, r in enumerate(here):
        o = offsets[i * (cap + 1) : (i + 1) * (cap + 1)]
        o[: counts[r] + 1] = cols[r].offsets
        o[counts[r] + 1 :] = nbytes[r]
        chars[i * ccap : i * ccap + nbytes[r]] = cols[r].chars[: nbytes[r]]
    return StringColumn(offsets, chars, cols[0].dtype)


def unshard_table(table: Table, counts: torch.Tensor) -> Table:
    """The valid rows of every shard the table holds (one per entry of
    ``counts``), concatenated into an exact table."""
    w = counts.shape[0]
    if any(isinstance(c, Column) for c in table.columns):
        cap = table.capacity // w
    else:  # string columns only: each shard's offsets hold cap + 1
        cap = table.columns[0].offsets.shape[0] // w - 1
    counts_h = counts.tolist()
    cols = []
    for c in table.columns:
        if isinstance(c, StringColumn):
            cols.append(_unshard_strings(c, counts_h, cap))
            continue
        parts = [c.data[i * cap : i * cap + counts_h[i]] for i in range(w)]
        cols.append(Column(torch.cat(parts), c.dtype))
    return Table(tuple(cols))


def _unshard_strings(c: StringColumn, counts_h: list, cap: int) -> StringColumn:
    w = len(counts_h)
    ccap = c.chars.shape[0] // w
    offs, chars, base = [torch.zeros(1, dtype=torch.int32, device=c.device)], [], 0
    for i, n in enumerate(counts_h):
        local = c.offsets[i * (cap + 1) : i * (cap + 1) + n + 1]
        nb = int(local[-1])
        offs.append(local[1:] + base)
        chars.append(c.chars[i * ccap : i * ccap + nb])
        base += nb
    merged = torch.cat(chars) if base else torch.zeros(1, dtype=torch.uint8, device=c.device)
    return StringColumn(torch.cat(offs), merged, c.dtype)


# The reference's names for the same pair (dj_tpu/parallel/api.py:245-246).
distribute_table = shard_table
collect_tables = unshard_table

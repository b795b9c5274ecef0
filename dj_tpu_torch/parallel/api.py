"""Moving tables onto and off a topology.

Counterpart of ``dj_tpu/parallel/api.py::shard_table`` and
``unshard_table`` for fixed-width columns: the sharded form of a table
over a world of w ranks is one [w * cap] column per column, shard r in
rows [r * cap, (r + 1) * cap) padded with zeros past its rows, plus an
int32 [w] vector of valid rows per shard.

In a process world the same calls follow dj_tpu's SPMD input contract
(``dj_tpu/parallel/api.py:100-104``): every process passes the same
global table (or the same pieces), and each gets back only its own
rank's block ([cap] columns) and count ([1]). ``unshard_table`` of such a
block gives this rank's valid rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.table import Column, Table
from .topology import Topology


def shard_table(
    topology: Topology, table: Table, capacity_per_shard: Optional[int] = None
) -> tuple[Table, torch.Tensor]:
    """Split an exact table row-balanced across the topology's ranks, on
    its device: shard r takes the next contiguous block of rows, the
    first ``nrows % w`` shards one row more than the others
    (dj_tpu/parallel/api.py:38-44), each padded to
    ``capacity_per_shard`` rows (default: the largest shard). Returns
    (table, counts[world])."""
    if table.valid_count is not None:
        raise ValueError("shard_table takes exact tables (valid_count None)")
    w = topology.world_size
    nrows = table.capacity
    counts = [nrows // w + (r < nrows % w) for r in range(w)]
    starts = [sum(counts[:r]) for r in range(w)]
    pieces = [_slice_rows(table, starts[r], counts[r]) for r in range(w)]
    return shard_table_pieces(topology, pieces, capacity_per_shard)


def _slice_rows(table: Table, start: int, count: int) -> Table:
    """Rows [start, start + count) of an exact table (views)."""
    return Table(tuple(Column(c.data[start : start + count], c.dtype) for c in table.columns))


def shard_table_pieces(
    topology: Topology, pieces: Sequence[Table], capacity_per_shard: Optional[int] = None
) -> tuple[Table, torch.Tensor]:
    """Place one exact table per rank on the topology's device: piece r
    becomes shard r's rows, padded to ``capacity_per_shard`` rows
    (default: the largest piece). Returns (table, counts[world]); in a
    process world, this rank's shard and its [1] count."""
    w = topology.world_size
    if len(pieces) != w:
        raise ValueError(f"need {w} pieces, got {len(pieces)}")
    schema = [(c.dtype, c.data.dtype) for c in pieces[0].columns]
    for p in pieces:
        if p.valid_count is not None:
            raise ValueError("pieces must be exact tables (valid_count None)")
        if [(c.dtype, c.data.dtype) for c in p.columns] != schema:
            raise TypeError("piece schema mismatch")
    counts = [p.capacity for p in pieces]
    cap = max(counts) if capacity_per_shard is None else capacity_per_shard
    if cap < max(counts):
        raise ValueError(f"capacity {cap} < needed {max(counts)}")
    dev = topology.device
    here = [topology.rank] if topology.is_process_world else range(w)
    cols = []
    for j, (dtype, tdtype) in enumerate(schema):
        data = torch.zeros(len(here) * cap, dtype=tdtype, device=dev)
        for i, r in enumerate(here):
            data[i * cap : i * cap + counts[r]] = pieces[r].columns[j].data
        cols.append(Column(data, dtype))
    return Table(tuple(cols)), torch.tensor([counts[r] for r in here], dtype=torch.int32,
                                            device=dev)


def unshard_table(table: Table, counts: torch.Tensor) -> Table:
    """The valid rows of every shard the table holds (one per entry of
    ``counts``), concatenated into an exact table."""
    w = counts.shape[0]
    cap = table.capacity // w
    counts_h = counts.tolist()
    cols = []
    for c in table.columns:
        parts = [c.data[i * cap : i * cap + counts_h[i]] for i in range(w)]
        cols.append(Column(torch.cat(parts), c.dtype))
    return Table(tuple(cols))

"""Table shuffle through one communication epoch.

Counterpart of ``dj_tpu/parallel/all_to_all.py::shuffle_tables`` and its
one-table view ``shuffle_table``. This
slice covers the one-peer group, where the shuffle is the self-copy of
``_single_peer_shuffle`` (dj_tpu/parallel/all_to_all.py:204-249): the
partition's rows are contiguous, so each column is one slice copy into
an output of static capacity. The bucketed exchange across peers comes
with the NCCL communicator.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.table import Column, Table
from .communicator import Communicator

# Split-overflow stat keys: OVF_BUCKET is a send bucket that was too
# small (heals by bucket_factor growth), OVF_OUT an output capacity that
# was exceeded (heals by out_factor growth).
OVF_BUCKET = "bucket_overflow"
OVF_OUT = "out_overflow"


def _single_peer_shuffle(
    table: Table, part_starts: torch.Tensor, part_counts: torch.Tensor,
    out_capacity: int,
) -> tuple[Table, torch.Tensor, torch.Tensor, dict]:
    """Copy rows [part_starts[0], +part_counts[0]) into a table of
    ``out_capacity`` rows, zero past the count. The start and count are
    read back to the host to slice. When the partition is the whole
    table at its own capacity (one rank, one batch) the columns are
    returned as they are: the copy would be the identity."""
    total = part_counts[0].to(torch.int32)
    overflow = total > out_capacity
    start, n = int(part_starts[0]), int(part_counts[0])
    count = min(n, out_capacity)
    dev = table.device
    if start == 0 and count == out_capacity == table.capacity:
        cols = table.columns
    else:
        cols = []
        for col in table.columns:
            out = torch.zeros(out_capacity, dtype=col.data.dtype, device=dev)
            out[:count] = col.data[start : start + count]
            cols.append(Column(out, col.dtype))
        cols = tuple(cols)
    # No send buckets exist on one peer: every overflow is an output one.
    stats = {OVF_BUCKET: torch.tensor(False, device=dev), OVF_OUT: overflow}
    out_count = torch.tensor(count, dtype=torch.int32, device=dev)
    return Table(cols, out_count), total, overflow, stats


def shuffle_tables(
    comm: Communicator,
    tables: Sequence[Table],
    part_starts: Sequence[torch.Tensor],
    part_counts: Sequence[torch.Tensor],
    bucket_rows: Sequence[int],
    out_capacity: Sequence[int],
) -> list[tuple[Table, torch.Tensor, torch.Tensor, dict]]:
    """Shuffle hash-partitioned tables: partition p of every table goes
    to group peer p. Returns one (table, total_recv_rows, overflow,
    stats) per table; ``overflow`` is the OR of the stats' split bits."""
    nt = len(tables)
    n = comm.size
    for seq, name in (
        (part_starts, "part_starts"), (part_counts, "part_counts"),
        (bucket_rows, "bucket_rows"), (out_capacity, "out_capacity"),
    ):
        if len(seq) != nt:
            raise ValueError(f"{name}: expected {nt} entries")
    for t in range(nt):
        if part_starts[t].shape != (n,) or part_counts[t].shape != (n,):
            raise ValueError(f"table {t}: part_starts/part_counts must have shape ({n},)")
    if n != 1:
        raise NotImplementedError(
            "the multi-peer bucketed exchange comes with the NCCL "
            "communicator slice"
        )
    return [
        _single_peer_shuffle(tables[t], part_starts[t], part_counts[t], out_capacity[t])
        for t in range(nt)
    ]


def shuffle_table(
    comm: Communicator,
    table: Table,
    part_starts: torch.Tensor,
    part_counts: torch.Tensor,
    bucket_rows: int,
    out_capacity: int,
) -> tuple[Table, torch.Tensor, torch.Tensor, dict]:
    """Shuffle one hash-partitioned table: the one-table view of
    ``shuffle_tables``, with the same (table, total_recv_rows, overflow,
    stats) result."""
    return shuffle_tables(
        comm, [table], [part_starts], [part_counts], [bucket_rows], [out_capacity]
    )[0]

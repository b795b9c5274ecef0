"""hash_partition: reorder a table by key-hash partition id.

Counterpart of ``dj_tpu/ops/partition.py:30-172``. Partition id =
murmur3(key row, seed) % npartitions; padding rows get id ==
npartitions so they sort to the tail and enter no partition. The
reorder is one stable sort of the ids whose permutation gathers every
column; offsets come from a histogram and a cumsum.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.table import Column, Table, sizes_to_offsets
from . import hashing


def partition_ids(
    table: Table,
    on_columns: Sequence[int],
    npartitions: int,
    seed: int = hashing.DEFAULT_HASH_SEED,
    hash_function: str = hashing.HASH_MURMUR3,
) -> torch.Tensor:
    """int32 partition id per row; padding rows get id == npartitions."""
    h = hashing.hash_table(table, on_columns, seed, hash_function)
    pid = (h % npartitions).to(torch.int32)
    valid = torch.arange(table.capacity, device=pid.device) < table.count()
    return pid.masked_fill_(~valid, npartitions)


def partition_counts_from_ids(pid: torch.Tensor, npartitions: int) -> torch.Tensor:
    """int32 row count of each partition; ids outside [0, npartitions)
    (padding) count in none."""
    hist = torch.bincount(pid.to(torch.int64).clamp(0, npartitions), minlength=npartitions + 1)
    return hist[:npartitions].to(torch.int32)


def partition_by_ids(
    table: Table, pid: torch.Tensor, npartitions: int
) -> tuple[Table, torch.Tensor]:
    """Reorder rows by a partition-id vector (padding rows carry
    ``pid == npartitions``). Returns (table, offsets[npartitions+1])."""
    offsets = sizes_to_offsets(partition_counts_from_ids(pid, npartitions))
    perm = torch.sort(pid, stable=True).indices
    cols = tuple(Column(c.data[perm], c.dtype) for c in table.columns)
    return Table(cols, table.count()), offsets


def hash_partition(
    table: Table,
    on_columns: Sequence[int],
    npartitions: int,
    seed: int = hashing.DEFAULT_HASH_SEED,
    hash_function: str = hashing.HASH_MURMUR3,
) -> tuple[Table, torch.Tensor]:
    """Reorder rows by partition id: partition p occupies rows
    [offsets[p], offsets[p+1]); capacity and valid_count are kept."""
    if npartitions == 1:
        # One partition is the valid prefix: no reorder.
        offsets = torch.stack(
            [torch.zeros((), dtype=torch.int32, device=table.device), table.count()]
        )
        return table, offsets
    pid = partition_ids(table, on_columns, npartitions, seed, hash_function)
    return partition_by_ids(table, pid, npartitions)


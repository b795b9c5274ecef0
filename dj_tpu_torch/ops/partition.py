"""hash_partition: reorder a table by key-hash partition id.

Counterpart of ``dj_tpu/ops/partition.py:30-176``. Partition id =
murmur3(key row, seed) % npartitions; padding rows get id ==
npartitions so they sort to the tail and enter no partition. The
reorder is one stable sort of the ids whose permutation gathers every
column (a string column through ``StringColumn.take``, at its own char
capacity); offsets come from a histogram and a cumsum.
``salted_partition_ids`` (``:72-112``) scatters a heavy destination's
rows over its salt peers, the probe side of the salted tier.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.table import Column, StringColumn, Table, gather, sizes_to_offsets
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


def salted_partition_ids(
    pid: torch.Tensor,
    npartitions: int,
    group_size: int,
    heavy: Sequence[int],
    replicas: int,
) -> torch.Tensor:
    """The probe side's salt of the salted tier: a row whose partition id
    is in ``heavy`` (global ids, batch b's destination d at
    ``b * group_size + d``) moves to ``b * n + (d + pos % replicas) %
    n``, where ``pos`` is its position in the shard, so its batch stays
    the same; every other row, padding's ``pid == npartitions`` among
    them, keeps its id. The build side's heavy partitions go to exactly
    the peers ``(d + c) % n``, c < replicas (the salted join's rotated
    windows), so each probe row meets each matching build row once.
    Needs 2 <= replicas <= group_size."""
    if not 2 <= replicas <= group_size:
        raise ValueError(f"salt replicas {replicas} outside [2, {group_size}]")
    is_heavy = [False] * (npartitions + 1)
    for p in heavy:
        if not 0 <= p < npartitions:
            raise ValueError(f"heavy partition id {p} outside [0, {npartitions})")
        is_heavy[p] = True
    heavy_v = torch.tensor(is_heavy, dtype=torch.bool, device=pid.device)
    j = pid % group_size  # the in-batch destination (garbage for padding)
    salt = torch.arange(pid.shape[0], dtype=torch.int32, device=pid.device) % replicas
    return torch.where(heavy_v[pid.clamp(0, npartitions).long()],
                       pid - j + (j + salt) % group_size, pid)


def partition_by_ids(
    table: Table, pid: torch.Tensor, npartitions: int
) -> tuple[Table, torch.Tensor]:
    """Reorder rows by a partition-id vector (padding rows carry
    ``pid == npartitions``). Returns (table, offsets[npartitions+1])."""
    offsets = sizes_to_offsets(partition_counts_from_ids(pid, npartitions))
    perm = torch.sort(pid, stable=True).indices
    cols = tuple(
        c.take(perm) if isinstance(c, StringColumn) else Column(gather(c.data, perm), c.dtype)
        for c in table.columns
    )
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



def partition_counts(offsets: torch.Tensor) -> torch.Tensor:
    """Per-partition row counts from an offsets vector."""
    return torch.diff(offsets)

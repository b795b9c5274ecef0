"""hash_partition: reorder a table by key-hash partition id.

Counterpart of ``dj_tpu/ops/partition.py:30-176``. Partition id =
murmur3(key row, seed) % npartitions; padding rows get id ==
npartitions so they sort to the tail and enter no partition. The
reorder is one stable sort of the ids whose permutation gathers every
column (a string column through ``StringColumn.take``, at its own char
capacity); offsets come from the partitions' row counts and a cumsum.
``salted_partition_ids`` (``:72-112``) scatters a heavy destination's
rows over its salt peers, the probe side of the salted tier.

The ids and counts of a key of fixed-width columns under murmur3 come
from ``murmur3_partition_ids``: the CUDA kernel ``csrc/partition_ids.cu``
for tensors on the card, its plain version
``murmur3_partition_ids_plain`` (``hashing.murmur3_32`` in int64 lanes,
the modulo, the padding mask and a bincount) for tensors on the CPU. A
key with a string column, and the identity hash, take
``hashing.hash_table``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..core.table import Column, StringColumn, Table, gather, sizes_to_offsets
from ..utils.timing import span
from . import cuda_build, hashing

launches = 0  # kernel launches made by murmur3_partition_ids
SMALL_M = 32  # npartitions up to which each thread of the kernel counts in its own words
SHARED_M = 8192  # npartitions up to which a block of the kernel counts in shared memory
FLOAT_KIND = 16  # a key's kind for the kernel: its width, | FLOAT_KIND for a float
# The key dtypes the kernel hashes: every fixed-width element murmur3_32 takes.
KEY_DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int16, torch.uint16, torch.int32,
              torch.uint32, torch.int64, torch.uint64, torch.float32, torch.float64)


def _check_inputs(keys: Sequence[torch.Tensor], count: torch.Tensor, npartitions: int) -> None:
    """Raise unless keys are 1 to n contiguous 1-D tensors of KEY_DTYPES,
    one length, count a 0-d int32 tensor, all on one CPU or CUDA device,
    and 1 <= npartitions < 2^31."""
    if not keys:
        raise ValueError("murmur3_partition_ids: no key column")
    dev, cap = count.device, keys[0].shape[0] if keys[0].dim() == 1 else -1
    if count.dtype != torch.int32 or count.dim() != 0:
        raise ValueError(f"murmur3_partition_ids: count must be a 0-d int32 tensor, got "
                         f"{count.dtype} {tuple(count.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"murmur3_partition_ids: unsupported device {dev}")
    for i, k in enumerate(keys):
        if k.dtype not in KEY_DTYPES:
            raise ValueError(f"murmur3_partition_ids: key {i} has dtype {k.dtype}, not one of "
                             f"the fixed-width key dtypes")
        if k.dim() != 1 or k.shape[0] != cap:
            raise ValueError(f"murmur3_partition_ids: key {i} must be 1-D of {cap} rows, got "
                             f"shape {tuple(k.shape)}")
        if k.device != dev:
            raise ValueError(f"murmur3_partition_ids: key {i} is on {k.device}, count on {dev}")
        if not k.is_contiguous():
            raise ValueError(f"murmur3_partition_ids: key {i} must be contiguous")
    if not 1 <= npartitions < 2**31:
        raise ValueError(f"murmur3_partition_ids: npartitions {npartitions} outside [1, 2^31)")


def _ids_from_hash(h: torch.Tensor, count: torch.Tensor, npartitions: int) -> torch.Tensor:
    """int32 ``h % npartitions`` a row, npartitions past the count."""
    pid = (h % npartitions).to(torch.int32)
    valid = torch.arange(pid.shape[0], device=pid.device) < count
    return pid.masked_fill_(~valid, npartitions)


def murmur3_partition_ids_plain(keys: Sequence[torch.Tensor], count: torch.Tensor,
                                npartitions: int, seed: int = hashing.DEFAULT_HASH_SEED
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch formulation: murmur3 of each key column combined in
    order (``hashing.hash_columns``), the ids, and their bincount."""
    h = hashing.murmur3_32(keys[0], seed)
    for k in keys[1:]:
        h = hashing.hash_combine(h, hashing.murmur3_32(k, seed))
    pid = _ids_from_hash(h, count, npartitions)
    return pid, partition_counts_from_ids(pid, npartitions)


def murmur3_partition_ids(keys: Sequence[torch.Tensor], count: torch.Tensor, npartitions: int,
                          seed: int = hashing.DEFAULT_HASH_SEED
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int32 partition id a row, npartitions for the rows past ``count``;
    int32 row count of each partition) of the murmur3 hash of the key
    columns under ``seed``; the CUDA kernel on the card, the plain
    version on the CPU."""
    _check_inputs(keys, count, npartitions)
    if count.device.type == "cpu":
        return murmur3_partition_ids_plain(keys, count, npartitions, seed)
    global launches
    dev, cap = count.device, keys[0].shape[0]
    # A fresh allocation: 8-byte aligned, as the kernel's id-pair stores need.
    pid = torch.empty(cap, dtype=torch.int32, device=dev)
    counts = torch.empty(npartitions, dtype=torch.int32, device=dev)
    meta = torch.tensor([k.data_ptr() for k in keys]
                        + [k.element_size() | (FLOAT_KIND if k.is_floating_point() else 0)
                           for k in keys], dtype=torch.int64, pin_memory=True)
    cols = meta.to(dev, non_blocking=True)
    launches += 1
    fn = cuda_build.load("partition_ids").dj_partition_ids
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(cols.data_ptr(), len(keys), count.data_ptr(), pid.data_ptr(), counts.data_ptr(),
            cap, npartitions, int(seed) & hashing.M32,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "partition_ids")
    return pid, counts


def _fixed_width_keys(table: Table, on_columns: Sequence[int],
                      hash_function: str) -> Optional[list[torch.Tensor]]:
    """The key columns' data when the key is murmur3 of fixed-width
    columns of KEY_DTYPES (``murmur3_partition_ids``'s route), else None."""
    cols = [table.columns[i] for i in on_columns]
    if (hash_function != hashing.HASH_MURMUR3 or not cols
            or not all(isinstance(c, Column) and c.data.dtype in KEY_DTYPES for c in cols)):
        return None
    return [c.data.contiguous() for c in cols]


def partition_ids_and_counts(
    table: Table,
    on_columns: Sequence[int],
    npartitions: int,
    seed: int = hashing.DEFAULT_HASH_SEED,
    hash_function: str = hashing.HASH_MURMUR3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(int32 partition id per row, padding rows npartitions; int32 row
    count of each partition). The span ``partition_ids``."""
    with span("partition_ids"):
        count = torch.as_tensor(table.count(), device=table.device).to(torch.int32).reshape(())
        keys = _fixed_width_keys(table, on_columns, hash_function)
        if keys is not None:
            return murmur3_partition_ids(keys, count, npartitions, seed)
        h = hashing.hash_table(table, on_columns, seed, hash_function)
        pid = _ids_from_hash(h, count, npartitions)
        return pid, partition_counts_from_ids(pid, npartitions)


def partition_ids(
    table: Table,
    on_columns: Sequence[int],
    npartitions: int,
    seed: int = hashing.DEFAULT_HASH_SEED,
    hash_function: str = hashing.HASH_MURMUR3,
) -> torch.Tensor:
    """int32 partition id per row; padding rows get id == npartitions."""
    return partition_ids_and_counts(table, on_columns, npartitions, seed, hash_function)[0]


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
    table: Table, pid: torch.Tensor, npartitions: int, counts: Optional[torch.Tensor] = None
) -> tuple[Table, torch.Tensor]:
    """Reorder rows by a partition-id vector (padding rows carry
    ``pid == npartitions``), given the ids' ``partition_counts_from_ids``
    or taking it. Returns (table, offsets[npartitions+1])."""
    if counts is None:
        counts = partition_counts_from_ids(pid, npartitions)
    offsets = sizes_to_offsets(counts)
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
    pid, counts = partition_ids_and_counts(table, on_columns, npartitions, seed, hash_function)
    return partition_by_ids(table, pid, npartitions, counts)



def partition_counts(offsets: torch.Tensor) -> torch.Tensor:
    """Per-partition row counts from an offsets vector."""
    return torch.diff(offsets)

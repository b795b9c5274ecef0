"""Moving tables onto and off a topology.

Counterpart of ``dj_tpu/parallel/api.py::shard_table`` and
``unshard_table`` for a one-rank world: the sharded form of a table is
the table padded to its per-shard capacity, plus an int32 [world]
vector of valid rows per shard.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.table import Column, Table
from .topology import Topology


def shard_table(
    topology: Topology, table: Table, capacity_per_shard: Optional[int] = None
) -> tuple[Table, torch.Tensor]:
    """Place an exact table on the topology's device, padded to
    ``capacity_per_shard`` rows. Returns (table, counts[world])."""
    if table.valid_count is not None:
        raise ValueError("shard_table takes exact tables (valid_count None)")
    if topology.world_size != 1:
        raise NotImplementedError("sharding over several ranks comes with the NCCL slice")
    n = table.capacity
    cap = n if capacity_per_shard is None else capacity_per_shard
    if cap < n:
        raise ValueError(f"capacity {cap} < needed {n}")
    dev = topology.device
    cols = []
    for c in table.columns:
        data = torch.zeros(cap, dtype=c.data.dtype, device=dev)
        data[:n] = c.data
        cols.append(Column(data, c.dtype))
    counts = torch.tensor([n], dtype=torch.int32, device=dev)
    return Table(tuple(cols)), counts


def unshard_table(table: Table, counts: torch.Tensor) -> Table:
    """The valid rows of every shard, concatenated into an exact table."""
    w = counts.shape[0]
    cap = table.capacity // w
    counts_h = counts.tolist()
    cols = []
    for c in table.columns:
        parts = [c.data[i * cap : i * cap + counts_h[i]] for i in range(w)]
        cols.append(Column(torch.cat(parts), c.dtype))
    return Table(tuple(cols))

"""shuffle_on: hash-repartition a sharded table across a communication group.

Counterpart of ``dj_tpu/parallel/shuffle.py:38-359`` (the reference's
shuffle_on): every rank hash-partitions its shard by the on-columns into
group-size parts with a shared seed (``hash_partition``), then one
bucketed all-to-all (``shuffle_table``, strings through its two-buffer
exchange) sends part p to group peer p, so equal keys land on one rank
of the group. On a flat topology the group defaults to the world; a
two-level topology shuffles once per axis ('inter', then 'intra').
``shuffle_on_auto`` grows exactly the factor whose split overflow bit
fired, under the heal engine and the capacity ledger.

``compression`` sends the table through the cascaded wire codec
(``compress.cascaded``; ``STAT_KEYS`` count its bytes), and a wire too
small for a bucket's stream sets the bucket bit, which ``bucket_factor``
heals.

``_local_shuffle`` and ``_local_shuffle_pair`` are the per-rank bodies
that the join's hierarchical pre-shuffle runs over the 'inter' group.

Left out here, as in the rest of the port: dj_tpu's degradation guard
(``resil.degrade_guard``, whose "wire" tier retries a failing codec
uncompressed), fault sites (``faults.check``, ``faults.force_flags``)
and ``obs`` counters, which come with the serving stack (item 10).
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch

from ..core.table import Table
from ..ops import hashing
from ..ops.partition import hash_partition, partition_counts
from ..resilience import heal as heal_engine
from ..resilience import ledger as dj_ledger
from .all_to_all import OVF_BUCKET, OVF_OUT, shuffle_table, shuffle_tables
from .communicator import Communicator, XlaCommunicator
from .spmd import run_spmd
from .topology import CommunicationGroup, Topology

# Compression byte counters per shard (zero when nothing compresses; the
# reference's compression-ratio report).
STAT_KEYS = ("comp_raw_bytes", "comp_wire_bytes", "comp_actual_bytes")


def _local_shuffle(
    local: Table,
    comm: Communicator,
    on_columns: Sequence[int],
    hash_function: str,
    seed: int,
    bucket_rows: int,
    out_capacity: int,
    compression=None,
):
    """One rank's shuffle over ``comm``'s group: (table, total, overflow,
    stats), ``stats`` holding the split bits OVF_BUCKET and OVF_OUT and,
    when a slot compresses, the STAT_KEYS counters."""
    part, offsets = hash_partition(local, on_columns, comm.size, seed=seed,
                                   hash_function=hash_function)
    return shuffle_table(comm, part, offsets[:-1], partition_counts(offsets), bucket_rows,
                         out_capacity, compression)


def _local_shuffle_pair(
    left: Table,
    right: Table,
    comm: Communicator,
    left_on: Sequence[int],
    right_on: Sequence[int],
    hash_function: str,
    seed: int,
    left_bucket_rows: int,
    right_bucket_rows: int,
    left_out_capacity: int,
    right_out_capacity: int,
    left_compression=None,
    right_compression=None,
):
    """One rank's shuffle of a join's two tables through one epoch (one
    batched size exchange, equal-width buffers sharing collectives):
    the two (table, total, overflow, stats) tuples."""
    n = comm.size
    l_part, l_off = hash_partition(left, left_on, n, seed=seed, hash_function=hash_function)
    r_part, r_off = hash_partition(right, right_on, n, seed=seed, hash_function=hash_function)
    return shuffle_tables(
        comm,
        [l_part, r_part],
        [l_off[:-1], r_off[:-1]],
        [partition_counts(l_off), partition_counts(r_off)],
        [left_bucket_rows, right_bucket_rows],
        [left_out_capacity, right_out_capacity],
        compression=[left_compression, right_compression],
    )


def shuffle_on(
    topology: Topology,
    table: Table,
    counts: torch.Tensor,
    on_columns: Sequence[int],
    *,
    group: Optional[CommunicationGroup] = None,
    hash_function: str = hashing.HASH_MURMUR3,
    seed: int = hashing.DEFAULT_HASH_SEED,
    bucket_factor: float = 2.0,
    out_factor: float = 2.0,
    fuse_columns: Optional[bool] = None,
    communicator_cls: Type[Communicator] = XlaCommunicator,
    compression=None,
    with_stats: bool = False,
    with_split_overflow: bool = False,
) -> tuple:
    """Shuffle a sharded table so equal keys land on one shard of the group.

    ``table``/``counts``: a sharded table ([world * cap] columns, in a
    process world this rank's block) and its int32 valid counts.
    ``group`` is the communication group (default: the world of a flat
    topology); a two-level topology shuffles once per axis,
    ``group=topology.group("inter")`` then ``"intra"``. Each rank sends
    buckets of ``bucket_factor * cap / group size`` rows to each peer and
    receives into ``out_factor * cap`` rows.

    ``compression`` is the table's options tree
    (``generate_auto_select_compression_options``, the same on every
    rank: ``broadcast_compression_options``), None for an uncompressed
    wire. A group of one rank compresses nothing.

    Returns (shuffled_table, counts, overflow[world]); with
    ``with_stats`` also {STAT_KEYS: float32[world]}, each shard's raw,
    wire and actual compressed bytes (zeros when nothing compresses),
    with ``with_split_overflow`` also {"bucket": bool[world], "out":
    bool[world]}, the overflow's two components (send buckets and the
    compressed wire, output capacity). A set overflow leaves that
    shard's rows unspecified: grow the factor and shuffle again. In a
    process world the flags and stats hold every rank's."""
    if group is None:
        group = topology.world_group()
    axis = group.axis_name
    if topology.group(axis) != group:
        raise ValueError(f"group {group} is not this topology's {topology.group(axis)}")
    cap = table.capacity // topology.local_ranks
    bucket_rows = max(1, int(cap * bucket_factor / group.size))
    out_capacity = max(1, int(cap * out_factor))
    on_columns = tuple(on_columns)

    def run(comm, t, c):
        out, _, overflow, stats = _local_shuffle(
            t.with_count(c[0]), comm.sub(axis), on_columns, hash_function, seed,
            bucket_rows, out_capacity, compression,
        )
        split = torch.stack([stats[OVF_BUCKET], stats[OVF_OUT]]).reshape(1, 2)
        zero = torch.zeros((), dtype=torch.float32, device=overflow.device)
        stat_row = torch.stack([stats.get(k, zero) for k in STAT_KEYS]).reshape(1, -1)
        return (out.with_count(None), out.count().reshape(1), overflow.reshape(1), split,
                stat_row)

    out, out_counts, overflow, split_mat, stat_mat = run_spmd(
        topology, run, table, counts, communicator_cls=communicator_cls,
        fuse_columns=fuse_columns, gathered=(2, 3, 4),
    )
    res = (out, out_counts, overflow)
    if with_stats:
        res = res + ({k: stat_mat[:, j] for j, k in enumerate(STAT_KEYS)},)
    if with_split_overflow:
        res = res + ({"bucket": split_mat[:, 0], "out": split_mat[:, 1]},)
    return res


# Which shuffle_on factor heals which split overflow bit: the heal engine
# grows only the factor whose component fired.
_SHUFFLE_HEAL_FACTORS = {
    "shuffle_bucket_overflow": ("bucket_factor",),
    "shuffle_out_overflow": ("out_factor",),
}


def shuffle_on_auto(
    topology: Topology,
    table: Table,
    counts: torch.Tensor,
    on_columns: Sequence[int],
    *,
    bucket_factor: float = 1.2,
    out_factor: float = 1.2,
    max_attempts: int = 8,
    growth: float = 2.0,
    max_total_growth: float = 4096.0,
    **kwargs,
):
    """shuffle_on that heals its own overflows (dj_tpu's
    ``shuffle_on_auto``): it runs shuffle_on, reads the split overflow
    bits on the host and runs again with exactly the offending factor
    multiplied by ``growth`` (a send bucket grows ``bucket_factor``, the
    output capacity ``out_factor``; a compressed wire too small for a
    bucket's stream is a send bucket) until no shard overflows. So the
    factors may start tight. Exhausting ``max_attempts``, or one factor
    growing past ``max_total_growth``, raises CapacityExhausted. The
    capacity ledger keeps the healed factors per workload signature, so
    a second call of the same shape starts there.

    Returns (shuffled_table, counts, overflow, bucket_factor,
    out_factor), the final factors last; with ``with_stats=True`` in
    ``kwargs`` the stats dict of the final attempt is appended."""
    factors = {"bucket_factor": bucket_factor, "out_factor": out_factor}
    group = kwargs.get("group")
    ledger_key = dj_ledger.signature(
        "shuffle",
        w=topology.world_size,
        group=getattr(group, "axis_name", None),
        on=tuple(on_columns),
        table=dj_ledger.table_sig(table),
    )

    def run_attempt(attempt):
        res = shuffle_on(
            topology, table, counts, on_columns,
            bucket_factor=factors["bucket_factor"],
            out_factor=factors["out_factor"],
            with_split_overflow=True,
            **kwargs,
        )
        split = res[-1]
        info = {
            "shuffle_bucket_overflow": split["bucket"],
            "shuffle_out_overflow": split["out"],
        }
        return res[:-1], info

    payload, _info, _attempt = heal_engine.run_healed(
        name="shuffle_on_auto",
        stage="shuffle",
        budget=heal_engine.HealBudget(max_attempts, growth, max_total_growth),
        run_attempt=run_attempt,
        heal_map=_SHUFFLE_HEAL_FACTORS,
        read_factors=lambda: dict(factors),
        apply_factors=factors.update,
        ledger_key=ledger_key,
    )
    out, out_counts, overflow = payload[:3]
    tail = payload[3:]  # (stats,) when with_stats=True
    return (out, out_counts, overflow, factors["bucket_factor"], factors["out_factor"], *tail)

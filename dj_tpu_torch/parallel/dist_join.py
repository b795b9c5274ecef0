"""distributed_inner_join: partition, exchange per batch, join, concat.

Counterpart of ``dj_tpu/parallel/dist_join.py`` for the unprepared join
on a flat topology (``JoinConfig``, ``batch_sizing``,
``_local_join_pipeline``, ``_masked_minmax``, ``_resolve_key_range``,
``distributed_inner_join``):

1. hash-partition both tables into world * over_decom_factor parts
   (seed 12345678, the reference's);
2. per batch: exchange one batch of partitions (both tables in one
   epoch), then the local inner join;
3. concatenate the batch results.

The key range is probed on the host once per call (two reductions per
key column) unless the config declares it, so the pack decision is
static exactly as in JAX. PyTorch runs eagerly, so the batches run in
order; the JAX package's prefetch of batch b+1's exchange only
reorders its traced program. Prepared build sides, the skew-adaptive
plans, shape bucketing, the roofline phases, the degradation guard and
the auto/heal wrapper come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.table import Table, concatenate
from ..ops.join import canonical_key_range, inner_join, normalize_key_range
from ..ops.partition import hash_partition
from .all_to_all import shuffle_tables
from .communicator import SingleRankCommunicator, make_communicator
from .topology import Topology

MAIN_JOIN_SEED = 12345678

_FLAG_KEYS = (
    "pre_shuffle_overflow",
    "shuffle_overflow",
    "join_overflow",
    "char_overflow",
    "surrogate_collision",
    "pack_range_overflow",
)


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Static sizing knobs of distributed_inner_join (the fields of
    dj_tpu's JoinConfig that this slice uses).

    over_decom_factor: partitions per rank, joined one batch at a time.
    bucket_factor: slack on the mean partition size for the exchange.
    join_out_factor: per-batch join output capacity as a multiple of the
      received batch capacity.
    char_out_factor: string payload char capacity (no strings yet).
    key_range: declared (min, max) key bounds; skips the range probe.
    """

    over_decom_factor: int = 1
    bucket_factor: float = 2.0
    join_out_factor: float = 1.0
    char_out_factor: float = 1.0
    key_range: Optional[tuple] = None


class BatchSizing(NamedTuple):
    """Static per-batch capacities of the main join stage."""

    m: int  # total partitions = n * over_decom_factor
    sl: int  # slacked left bucket size
    sr: int  # slacked right bucket size
    bl: int  # left batch recv capacity (m == 1 trims to the input cap)
    br: int  # right batch recv capacity
    out_cap: int  # per-batch join output capacity


def batch_sizing(config: JoinConfig, n: int, l_cap: int, r_cap: int) -> BatchSizing:
    m = n * config.over_decom_factor
    sl = max(1, int(l_cap * config.bucket_factor / m))
    sr = max(1, int(r_cap * config.bucket_factor / m))
    # One partition keeps every row, so the batch never exceeds the input
    # capacity; the output capacity keeps its slacked value.
    bl, br = (l_cap, r_cap) if m == 1 else (sl, sr)
    out_cap = max(1, int(config.join_out_factor * n * max(sl, sr)))
    return BatchSizing(m, sl, sr, bl, br, out_cap)


def _local_join_pipeline(
    left: Table, right: Table, left_on: Sequence[int], right_on: Sequence[int],
    topology: Topology, config: JoinConfig, l_cap: int, r_cap: int,
    key_range: Optional[tuple] = None,
):
    """One rank's pipeline: partition, then exchange + join per batch."""
    group = topology.world_group()
    n = group.size
    comm = make_communicator(SingleRankCommunicator, group, None)
    m, _, _, bl, br, batch_out_cap = batch_sizing(config, n, l_cap, r_cap)
    l_part, l_offsets = hash_partition(left, left_on, m, seed=MAIN_JOIN_SEED)
    r_part, r_offsets = hash_partition(right, right_on, m, seed=MAIN_JOIN_SEED)

    dev = left.device
    no = torch.tensor(False, device=dev)
    shuffle_ovf = join_ovf = pack_ovf = coll = no
    batch_results = []
    for b in range(config.over_decom_factor):
        # Batch b moves partitions [b*n, (b+1)*n); partition p lands on
        # group peer p - b*n.
        lo, hi = b * n, (b + 1) * n
        l_starts = l_offsets[lo:hi]
        r_starts = r_offsets[lo:hi]
        (l_batch, _, l_ovf, _), (r_batch, _, r_ovf, _) = shuffle_tables(
            comm,
            [l_part, r_part],
            [l_starts, r_starts],
            [l_offsets[lo + 1 : hi + 1] - l_starts, r_offsets[lo + 1 : hi + 1] - r_starts],
            [bl, br],
            [n * bl, n * br],
        )
        shuffle_ovf = shuffle_ovf | l_ovf | r_ovf
        result, total, jflags = inner_join(
            l_batch, r_batch, left_on, right_on,
            out_capacity=batch_out_cap,
            return_flags=True,
            key_range=key_range,
        )
        del l_batch, r_batch
        join_ovf = join_ovf | (total > batch_out_cap)
        coll = coll | jflags["surrogate_collision"]
        pack_ovf = pack_ovf | jflags["pack_range_overflow"]
        batch_results.append(result)
    out = batch_results[0] if len(batch_results) == 1 else concatenate(batch_results)
    flags = {
        "pre_shuffle_overflow": no,
        "shuffle_overflow": shuffle_ovf,
        "join_overflow": join_ovf,
        "char_overflow": no,
        "surrogate_collision": coll,
        "pack_range_overflow": pack_ovf,
    }
    return out, flags


def _masked_minmax(data: torch.Tensor, counts: torch.Tensor, w: int):
    """(min, max) over the valid rows of a [w * cap] sharded column; an
    empty column gives the inverted sentinel (dtype max, dtype min)."""
    info = torch.iinfo(data.dtype)
    cap = data.shape[0] // w
    if cap == 0:
        return info.max, info.min
    valid = torch.arange(cap, device=data.device)[None, :] < counts[:, None]
    d2 = data.reshape(w, cap)
    return (
        int(torch.where(valid, d2, info.max).min()),
        int(torch.where(valid, d2, info.min).max()),
    )


def _resolve_key_range(
    config: JoinConfig, left: Table, left_counts: torch.Tensor,
    right: Table, right_counts: torch.Tensor,
    left_on: Sequence[int], right_on: Sequence[int], w: int,
) -> Optional[tuple]:
    """The static key range the join plans with: the declared one, else
    the probed global range of a single 64-bit int key canonicalized to
    width form (0, 2^w - 1). None for narrower keys (they pack
    statically), non-integer keys and two empty sides."""
    if config.key_range is not None:
        return normalize_key_range(config.key_range, len(left_on))
    cols = []
    for lc, rc in zip(left_on, right_on):
        a, b = left.columns[lc].data, right.columns[rc].data
        if a.dtype != b.dtype or a.is_floating_point() or a.dtype == torch.bool:
            return None
        cols.append((a, b))
    if len(cols) == 1 and cols[0][0].element_size() * 8 <= 32:
        return None
    ranges, dtypes = [], []
    for a, b in cols:
        amn, amx = _masked_minmax(a, left_counts, w)
        bmn, bmx = _masked_minmax(b, right_counts, w)
        mn, mx = min(amn, bmn), max(amx, bmx)
        if mx < mn:
            return None
        ranges.append((mn, mx))
        dtypes.append(np.dtype(str(a.dtype).removeprefix("torch.")))
    return canonical_key_range(tuple(ranges), dtypes)


def distributed_inner_join(
    topology: Topology,
    left: Table,
    left_counts: torch.Tensor,
    right: Table,
    right_counts: torch.Tensor,
    left_on: Sequence[int] = (),
    right_on: Sequence[int] = (),
    config: Optional[JoinConfig] = None,
) -> tuple[Table, torch.Tensor, dict]:
    """Join two sharded tables; result columns = left + (right - right_on).

    ``left``/``right`` are sharded tables ([world * cap] columns) with
    int32 [world] valid-row counts. Returns (result, result_counts[world],
    info), where ``info`` maps each of pre_shuffle_overflow /
    shuffle_overflow / join_overflow / char_overflow /
    surrogate_collision / pack_range_overflow to a bool[world]; any True
    means that shard's output is unspecified.
    """
    if not isinstance(right, Table):
        raise NotImplementedError("prepared build sides come with a later slice")
    if config is None:
        config = JoinConfig()
    w = topology.world_size
    if left.capacity < w or right.capacity < w:
        raise ValueError(
            f"distributed_inner_join: table capacity "
            f"{min(left.capacity, right.capacity)} < world size {w} "
            f"leaves at least one shard with zero capacity; pad the "
            f"table to >= 1 row per shard"
        )
    key_range = _resolve_key_range(
        config, left, left_counts, right, right_counts, left_on, right_on, w
    )
    out, flags = _local_join_pipeline(
        left.with_count(left_counts[0]), right.with_count(right_counts[0]),
        tuple(left_on), tuple(right_on), topology, config,
        left.capacity // w, right.capacity // w, key_range,
    )
    info = {k: flags[k].reshape(1) for k in _FLAG_KEYS}
    return out.with_count(None), out.count().reshape(1), info

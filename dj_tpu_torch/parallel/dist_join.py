"""distributed_inner_join: partition, exchange per batch, join, concat.

Counterpart of ``dj_tpu/parallel/dist_join.py`` for the join on its
shuffle tier (``JoinConfig``, ``batch_sizing``, ``_local_join_pipeline``,
``_masked_minmax``, ``_resolve_key_range``, ``distributed_inner_join``).
Each rank of the world runs the pipeline on its own shard
(``parallel.spmd.run_spmd``, the counterpart of dj_tpu's ``shard_map``),
with a communicator over the main group: the world on a flat topology,
the rank's 'intra' group on a two-level one.

0. on a two-level topology only, the hierarchical pre-shuffle
   (``dj_pre_shuffle``): both tables hash-partitioned by seed 87654321
   over the 'inter' group and exchanged in one epoch into
   ``pre_shuffle_out_factor`` times their capacity (the
   ``pre_shuffle_overflow`` flag when too small), so the main stage's
   keys stay inside their intra domain. ``JoinConfig.left_compression``
   / ``right_compression`` send this stage through the cascaded wire
   codec, and the info then holds its ``pre_shuffle_comp_*`` byte
   counters; the main stage stays uncompressed, as in the reference;
1. hash-partition both tables into n * over_decom_factor parts, n the
   main group's size (seed 12345678, the reference's);
2. per batch: exchange one batch of partitions (both tables in one
   epoch), then the local inner join. Batch b+1's exchange is issued
   before batch b's join and finished when its own join starts, as
   dj_tpu's software pipeline orders it (``dist_join.py:278-305``):
   under torch.distributed the transfer runs on the backend's stream
   while batch b joins; on one stream the order only moves batch b+1's
   buffers earlier;
3. concatenate the batch results.

The key range is probed on the host once per call (two reductions per
key column over this process's shards, then, in a process world, one
reduction over the processes) unless the config declares it, so the
pack decision is static exactly as in JAX. ``JoinConfig.communicator_cls``
names the backend of every collective (dj_tpu's XlaCommunicator,
BufferedCommunicator or RingCommunicator) and ``fuse_columns`` its
fusing (None: the backend's default).

The prepared build side (``prepare_join_side``, ``PreparedSide``) pays
the build table's partition, exchange, pack and sort once; each query
(``distributed_inner_join`` with a PreparedSide as ``right``) partitions,
exchanges and joins only the probe side; both sides may hold string
payloads. ``append_to_prepared`` merges appended build rows into the odf
batches they hash to, leaving the other batches as they are.

The skew-adaptive tiers (``parallel.plan_adapt``):
under ``DJT_PLAN_ADAPT=1`` the unprepared join runs the plan its
signature decided: broadcast (every rank all-gathers the right side and
joins its own left shard, no all-to-all), salted (heavy destinations'
probe rows scattered over salt peers, their build rows copied there by
rotated windows in the same exchange epoch) or shuffle.
``prepare_join_side`` builds its side on the tier ``DJT_PREPARED_TIER``
(or ``tier=``) names: shuffle, broadcast (one replicated batch a rank,
queried with no collective), salted, or auto. A two-level topology stays
on shuffle. Every tier returns the shuffle plan's flag keys, so the heal
is tier-blind. Under ``DJT_SHAPE_BUCKET=1`` (``parallel.shape_bucket``)
every entry point pads its tables to their shape bucket first.

A key pair of two element widths (int64 against int32 or uint32, ...)
raises ValueError on every entry that takes two tables' keys, at every
world size: the partition hashes a key at its own width, so equal
values of two widths would land on different ranks.

Every entry point is observed as dj_tpu's (``obs``): the roofline
``probe``, ``dispatch`` and ``prep`` phases (``_dispatch``), the query,
plan, tier, range-probe, heal and re-prepare counters and events.

Every dispatch runs under the degradation ladder
(``resilience.errors.degrade_guard``) with dj_tpu's tiers less its
``sort``: the unprepared join and the pipeline's stages ("adapt",
"wire"), the prepare ("wire", "prepared_tier"), the prepared and
coalesced queries ("merge", "wire", "expand", "prepared_tier") and the
coalesced unprepared dispatch ("wire"). Each attempt reads the pins
again (the knobs, ``strip_pinned_wire``), so the retry after a pin runs
the baseline. The fault sites (``resilience.faults``) are dj_tpu's:
``module_build`` before every dispatch; ``broadcast`` / ``salted``,
``prepare_broadcast`` / ``prepare_salted`` and ``bc_prepared_query`` /
``salted_prepared_query`` on their tiers; ``codec`` when a pre-shuffle
compresses; ``pallas_merge``, ``probe_merge`` and ``probe_expand`` on a
prepared query's merge tier (``_merge_tier_sites``), each once an
attempt on the dispatching thread; and the flag sites ``join.<flag>``,
``prepare.<flag>``, ``prepared.<flag>`` (once a member of a coalesced
run) and ``append.<flag>``, forced after the ranks returned.

The co-partitioned join (``TIER_LOCAL``) and the coalesced dispatches
(``distributed_inner_join_coalesced`` against a PreparedSide,
``distributed_inner_join_coalesced_unprepared``: K same-shaped queries,
each odf batch's K exchanges in one epoch) serve the composition layers
(``parallel.pipeline``).

With obs on and ``DJT_OBS_SKEW=1``, each unprepared, prepared and
coalesced query measures its probe side's destination skew
(``_observe_partition_skew``: one partition-count pass, shared with the
plan decision in the unprepared join, and one ``skew`` event a batch,
``obs.skew``). ``price_plan_candidate`` prices one candidate plan for
the autotuner (``parallel.autotune``) by the byte model and probes it
with the candidate's real dispatch, its accounting suppressed.

``distributed_inner_join_auto`` is the entry point that answers any
input: it runs the join under the heal engine (``resilience.heal``),
which doubles exactly the factor whose overflow flag fired, drops a
declared key range the data violates, and, against a PreparedSide,
re-prepares under a range widened to the probe side. The capacity
ledger (``resilience.ledger``) remembers what a workload's signature
healed to, so a later call starts there. ``prepare_join_side`` heals its
own build stage the same way.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
import weakref
from typing import NamedTuple, Optional, Sequence, Type

import torch
import torch.distributed as dist

from ..core import dtypes as dt
from ..core.table import Column, StringColumn, Table, concatenate
from ..compress import cascaded as cz
from ..ops.join import (
    JoinPlan,
    PreparedPackPlan,
    _anchored_pack_word,
    canonical_key_range,
    effective_plan,
    inner_join,
    inner_join_prepared,
    join_plan,
    merge_packed_batch,
    normalize_key_range,
    plan_prepared_pack,
    prepare_packed_batch,
    resolve_merge_impl,
    resolve_probe_expand,
)
from .. import knobs, obs
from ..obs import recorder as obs_recorder
from ..obs import roofline as obs_roofline
from ..obs.bytemodel import replicated_table_bytes
from ..obs import skew as obs_skew
from ..ops.partition import (
    hash_partition,
    partition_by_ids,
    partition_ids,
    partition_ids_and_counts,
    salted_partition_ids,
)
from ..resilience import errors as resil
from ..resilience import faults
from ..resilience import heal as heal_engine
from ..resilience import ledger as dj_ledger
from ..resilience.errors import PreparedPlanMismatch
from ..resilience.heal import HealBudget
from ..ops import hashing
from ..utils.timing import span
from . import plan_adapt, shape_bucket
from .all_to_all import broadcast_table, shuffle_table, shuffle_tables_start
from .communicator import Communicator, XlaCommunicator
from .shuffle import STAT_KEYS, _local_shuffle, _local_shuffle_pair
from .spmd import call_span, run_spmd
from .topology import INTER, Topology

# The reference's two-level seed split: the inter-domain pre-shuffle and
# the main stage's partition are independent.
INTER_DOMAIN_SEED = 87654321
MAIN_JOIN_SEED = 12345678

_FLAG_KEYS = (
    "pre_shuffle_overflow",
    "shuffle_overflow",
    "join_overflow",
    "char_overflow",
    "surrogate_collision",
    "pack_range_overflow",
)


def _dtype_name(col) -> str:
    return str(col.data.dtype).removeprefix("torch.")


def _check_key_widths(left_cols: Sequence, right_cols: Sequence, left_on: Sequence[int],
                      right_on: Sequence[int], what: str) -> None:
    """Refuse a key pair of two element widths with ValueError, naming
    both dtypes and the pair's columns (of ``left_cols`` and
    ``right_cols``, two tables' columns). ``hash_partition`` hashes each
    key column at its own width, so equal values of two widths land on
    different ranks and their rows go missing without a flag (dj_tpu's
    unprepared paths do not check; its prepared path refuses differing
    key dtypes, dj_tpu/parallel/dist_join.py:1463). Pairs of one width
    (int64 with uint64, int32 with uint32) and string keys pass."""
    for j, (lc, rc) in enumerate(zip(left_on, right_on)):
        a, b = left_cols[lc], right_cols[rc]
        if isinstance(a, StringColumn) or isinstance(b, StringColumn):
            continue
        if a.data.element_size() != b.data.element_size():
            raise ValueError(
                f"{what}: key pair {j} (left column {lc}, right column {rc}) joins "
                f"{_dtype_name(a)} with {_dtype_name(b)}: keys of two widths hash to "
                f"different ranks; cast one side to the other's width"
            )


def _check_table_right(left: Table, right: Table, right_counts, left_on, right_on,
                       what: str) -> None:
    """A Table right side's arguments: TypeError without ``right_counts``
    and ``right_on`` (they default to None only so a PreparedSide can
    omit them), then ``_check_key_widths``."""
    if right_counts is None or right_on is None:
        raise TypeError(
            f"{what}: right_counts and right_on are required when `right` is a Table (they "
            f"default to None only so a PreparedSide can omit them)"
        )
    _check_key_widths(left.columns, right.columns, left_on, right_on, what)


def _dispatch(topology: Topology, stage: str, kind: str, run, path: Optional[str] = None,
              queries: int = 1, phase: str = "dispatch"):
    """``run()`` as one dispatch of the ranks, observed as dj_tpu's
    dispatch is: the roofline ``phase`` ("dispatch"; a prepare's is
    "prep"), whose wire model is the
    per-shard send bytes of the exchanges the ranks issued
    (``obs.recorder.account_epochs``, which also records the query's
    ``collectives`` event under ``kind``), and with ``path``
    ``dj_query_dispatch_seconds{path}`` and ``dj_join_queries_total{path}``
    (``queries`` of them: a pipeline's stage counts none, its chain
    one). Just ``run()`` while obs is disabled or the collective
    accounting is suppressed (the autotuner's probe,
    ``obs.recorder.suppress_epochs``)."""
    if not obs.enabled() or obs_recorder.suppressed():
        return run()
    wire: dict = {}
    t0 = time.perf_counter()
    with obs_roofline.phase(phase, stage=stage, kind="wire", device=topology.device,
                            bytes_fn=lambda: wire.get("bytes")):
        with obs_recorder.account_epochs(kind) as acc:
            out = run()
        wire["bytes"] = acc["total_bytes"] or None
    if path is not None:
        if queries:
            obs.inc("dj_join_queries_total", queries, path=path)
        obs.observe("dj_query_dispatch_seconds", time.perf_counter() - t0, path=path)
    return out


def _pre_shuffle_codec(topology: Topology, *trees) -> None:
    """Fault site "codec" for an attempt whose pre-shuffle over 'inter'
    compresses (``cz.consult_codec``); a flat topology has none."""
    if topology.is_hierarchical:
        cz.consult_codec(topology.group(INTER).size, *trees)


def _merge_tier_sites() -> None:
    """The prepared query's tier fault sites, once an attempt on the
    dispatching thread (dj_tpu consults them while the query module
    traces): ``pallas_merge`` under ``DJT_JOIN_MERGE=merge`` (the CUDA
    merge kernel keeps dj_tpu's site name), ``probe_merge`` under
    ``probe``, then ``probe_expand`` when the probe tier expands by
    other than ``hist``."""
    impl = resolve_merge_impl()
    if impl == "merge":
        faults.check("pallas_merge")
    elif impl == "probe":
        faults.check("probe_merge")
        if resolve_probe_expand() != "hist":
            faults.check("probe_expand")


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Static sizing knobs of distributed_inner_join (the fields of
    dj_tpu's JoinConfig that this slice uses).

    over_decom_factor: partitions per rank, joined one batch at a time.
    bucket_factor: slack on the mean partition size for the exchange.
    join_out_factor: per-batch join output capacity as a multiple of the
      received batch capacity.
    pre_shuffle_out_factor: output capacity of the inter-domain
      pre-shuffle (two-level topologies) as a multiple of the input's.
    char_out_factor: join-output char capacity of each string column, as
      a multiple of its input char capacity (raise it when the join
      duplicates string rows).
    key_range: declared (min, max) key bounds; skips the range probe.
    fuse_columns: one collective per dtype class in an exchange (True)
      or one per buffer (False); None defers to the backend's default.
    communicator_cls: the collective backend (XlaCommunicator,
      BufferedCommunicator or RingCommunicator).
    left_compression / right_compression: per-column compression options
      (``compress.cascaded``) of the inter-domain pre-shuffle only: the
      intra-domain batches always run uncompressed, as the reference
      wires it (compressed shuffle_on across domains, none options on
      the main stage, distributed_join.cpp:160-184, 253-264). The info
      then also holds pre_shuffle_comp_raw_bytes / _wire_bytes /
      _actual_bytes, float32 per shard.
    """

    over_decom_factor: int = 1
    bucket_factor: float = 2.0
    join_out_factor: float = 1.0
    pre_shuffle_out_factor: float = 1.5
    char_out_factor: float = 1.0
    key_range: Optional[tuple] = None
    fuse_columns: Optional[bool] = None
    communicator_cls: Type[Communicator] = XlaCommunicator
    left_compression: Optional[tuple] = None
    right_compression: Optional[tuple] = None


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


def _char_overflow(result: Table, flag: torch.Tensor) -> torch.Tensor:
    """``flag`` or any output string column's char_overflow."""
    for col in result.columns:
        if isinstance(col, StringColumn):
            flag = flag | col.char_overflow()
    return flag


def _salt_windows(b: int, n: int, starts: torch.Tensor, counts: torch.Tensor, salt: tuple,
                  replicas: int) -> list:
    """The (starts, counts) of the salted tier's ``replicas - 1`` extra
    copies of batch b's build partitions: copy c sends partition slot j
    to peer (j + c) % n, so peer p gets slot (p - c) % n, masked to the
    slots whose global id ``b * n + slot`` is in ``salt`` (zero rows
    elsewhere). Each copy rides the batch's exchange epoch as one more
    table (dj_tpu/parallel/dist_join.py:1110-1131)."""
    salt_set = frozenset(int(p) for p in salt)
    out = []
    for c in range(1, replicas):
        rot = [(j - c) % n for j in range(n)]
        idx = torch.tensor(rot, dtype=torch.int64, device=starts.device)
        mask = torch.tensor([(b * n + s) in salt_set for s in rot], device=starts.device)
        out.append((starts[idx], torch.where(mask, counts[idx], 0)))
    return out


def _local_join_pipeline(
    comm: Communicator, left: Table, right: Table, left_on: Sequence[int],
    right_on: Sequence[int], config: JoinConfig, l_cap: int, r_cap: int,
    key_range: Optional[tuple] = None, salt: tuple = (), replicas: int = 1,
):
    """One rank's pipeline: on a two-level topology the pre-shuffle over
    'inter', then partition and exchange + join per batch over the main
    group's communicator ``comm``. With a ``salt`` set (the salted tier,
    flat topologies only) the left partition ids are salted over
    ``replicas`` peers and each batch's exchange carries the build
    side's rotated windows (``_salt_windows``), concatenated into the
    batch's right table (dj_tpu's ``_build_salted_join_fn``). The one
    member of ``_shuffle_join_members``."""
    return _shuffle_join_members(comm, [(left, right)], left_on, right_on, config, l_cap, r_cap,
                                 key_range, salt, replicas)[0]


def _shuffle_join_members(
    comm: Communicator, pairs: Sequence[tuple[Table, Table]], left_on: Sequence[int],
    right_on: Sequence[int], config: JoinConfig, l_cap: int, r_cap: int,
    key_range: Optional[tuple] = None, salt: tuple = (), replicas: int = 1,
) -> list[tuple[Table, dict]]:
    """The shuffle plan of K same-shaped joins on one rank (one for
    ``_local_join_pipeline``; K for the coalesced unprepared dispatch,
    dj_tpu's ``_build_coalesced_join_fn``): each member's two tables
    pre-shuffled (two-level topologies) and partitioned, then per batch
    every member's windows in ONE exchange epoch (batch b+1's issued
    before batch b's joins) and each member's join. Returns (result,
    flags) per member."""
    pairs = list(pairs)
    dev = pairs[0][0].device
    no = torch.tensor(False, device=dev)
    k = len(pairs)
    pre_ovf = [no] * k
    pre_stats: list = [{} for _ in range(k)]
    if INTER in comm.axes:
        inter = comm.sub(INTER)
        l_pre_cap = max(1, int(l_cap * config.pre_shuffle_out_factor))
        r_pre_cap = max(1, int(r_cap * config.pre_shuffle_out_factor))
        for q, (left, right) in enumerate(pairs):
            # Both tables' pre-shuffles share one epoch.
            with comm.phase_scope("dj_pre_shuffle"):
                (left, _, l_ovf, l_stats), (right, _, r_ovf, r_stats) = _local_shuffle_pair(
                    left, right, inter, left_on, right_on, hashing.HASH_MURMUR3,
                    INTER_DOMAIN_SEED,
                    max(1, int(l_cap * config.bucket_factor / inter.size)),
                    max(1, int(r_cap * config.bucket_factor / inter.size)),
                    l_pre_cap, r_pre_cap, config.left_compression, config.right_compression,
                )
            pairs[q] = (left, right)
            pre_ovf[q] = l_ovf | r_ovf
            pre_stats[q] = _pre_shuffle_stats(l_stats, r_stats)
        l_cap, r_cap = l_pre_cap, r_pre_cap
    n = comm.size
    m, _, _, bl, br, batch_out_cap = batch_sizing(config, n, l_cap, r_cap)
    parts = []
    for left, right in pairs:
        comm.phase("dj_partition")
        if salt:
            l_pid = salted_partition_ids(partition_ids(left, left_on, m, seed=MAIN_JOIN_SEED), m,
                                         n, salt, replicas)
            l_part, l_offsets = partition_by_ids(left, l_pid, m)
        else:
            l_part, l_offsets = hash_partition(left, left_on, m, seed=MAIN_JOIN_SEED)
        parts.append((l_part, l_offsets) + hash_partition(right, right_on, m, seed=MAIN_JOIN_SEED))
    del pairs

    def issue(b: int):
        # Batch b moves partitions [b*n, (b+1)*n); partition p lands on
        # group peer p - b*n. Member q's tables are its left, its right
        # and the right's salt windows, in that order.
        lo, hi = b * n, (b + 1) * n
        tables, starts, cnts, brows, caps, sizes = [], [], [], [], [], []
        for l_part, l_offsets, r_part, r_offsets in parts:
            l_starts = l_offsets[lo:hi]
            r_starts = r_offsets[lo:hi]
            r_cnt = r_offsets[lo + 1 : hi + 1] - r_starts
            windows = _salt_windows(b, n, r_starts, r_cnt, salt, replicas) if salt else []
            tables += [l_part, r_part] + [r_part] * len(windows)
            starts += [l_starts, r_starts] + [st for st, _ in windows]
            cnts += [l_offsets[lo + 1 : hi + 1] - l_starts, r_cnt] + [ct for _, ct in windows]
            brows += [bl] + [br] * (1 + len(windows))
            caps += [n * bl] + [n * br] * (1 + len(windows))
            sizes.append(2 + len(windows))
        comm.phase("dj_exchange")
        return shuffle_tables_start(comm, tables, starts, cnts, brows, caps), sizes

    flags = [dict.fromkeys(("shuffle_overflow", "join_overflow", "char_overflow",
                            "surrogate_collision", "pack_range_overflow"), no) for _ in range(k)]
    batch_results: list = [[] for _ in range(k)]
    odf = config.over_decom_factor
    inflight = issue(0)
    for b in range(odf):
        # Batch b+1's exchange is issued before batch b's joins.
        prefetch = issue(b + 1) if b + 1 < odf else None
        pending, sizes = inflight
        received = pending.wait()
        inflight = prefetch
        at = 0
        for q, size in enumerate(sizes):
            (l_batch, _, l_ovf, _), *r_parts = received[at : at + size]
            received[at : at + size] = [None] * size  # free the batch after its join
            at += size
            f = flags[q]
            f["shuffle_overflow"] = f["shuffle_overflow"] | l_ovf
            for _, _, r_ovf, _ in r_parts:
                f["shuffle_overflow"] = f["shuffle_overflow"] | r_ovf
            if len(r_parts) == 1:
                r_batch = r_parts[0][0]
            else:
                comm.phase("dj_salt_concat")
                r_batch = concatenate([t for t, _, _, _ in r_parts])
            del r_parts
            comm.phase("dj_join")
            result, total, jflags = inner_join(
                l_batch, r_batch, left_on, right_on,
                out_capacity=batch_out_cap,
                char_out_factor=config.char_out_factor,
                return_flags=True,
                key_range=key_range,
            )
            del l_batch, r_batch
            f["join_overflow"] = f["join_overflow"] | (total > batch_out_cap)
            f["surrogate_collision"] = f["surrogate_collision"] | jflags["surrogate_collision"]
            f["pack_range_overflow"] = f["pack_range_overflow"] | jflags["pack_range_overflow"]
            f["char_overflow"] = _char_overflow(result, f["char_overflow"])
            batch_results[q].append(result)
        del received
    out = []
    for q in range(k):
        comm.phase("dj_concat")
        res = batch_results[q]
        out.append((res[0] if len(res) == 1 else concatenate(res),
                    {"pre_shuffle_overflow": pre_ovf[q], **flags[q], **pre_stats[q]}))
    return out


def _pre_shuffle_stats(*stats: dict) -> dict:
    """The pre-shuffle's STAT_KEYS counters summed over its tables, each
    as ``pre_shuffle_<key>`` (float32, in table order as dj_tpu sums)."""
    out: dict = {}
    for st in stats:
        for k in STAT_KEYS:
            if k in st:
                key = f"pre_shuffle_{k}"
                out[key] = out[key] + st[k] if key in out else st[k]
    return out


def _broadcast_join_pipeline(
    comm: Communicator, left: Table, right: Table, left_on: Sequence[int],
    right_on: Sequence[int], config: JoinConfig, l_cap: int, r_cap: int,
    key_range: Optional[tuple] = None,
):
    """One rank's broadcast-tier join (dj_tpu's
    ``_build_broadcast_join_fn``, dist_join.py:893-969): the right side
    all-gathered into n * r_cap rows (``broadcast_table``), then one
    local join of the rank's own left shard against it. Each left row
    lives on one rank and meets every right row there, so the ranks'
    outputs together are the shuffle plan's rows. No partition and no
    all-to-all; the output capacity is ``join_out_factor * max(l_cap, n *
    r_cap)``, which join_out_factor heals as on the shuffle plan."""
    n = comm.size
    out_cap = max(1, int(config.join_out_factor * max(l_cap, n * r_cap)))
    with comm.phase_scope("dj_broadcast"):
        right_g, _, b_ovf, _ = broadcast_table(comm, right, n * r_cap)
    comm.phase("dj_join")
    result, total, jflags = inner_join(
        left, right_g, left_on, right_on,
        out_capacity=out_cap,
        char_out_factor=config.char_out_factor,
        return_flags=True,
        key_range=key_range,
    )
    del right_g
    no = torch.tensor(False, device=left.device)
    # The default sizing is exact, so shuffle_overflow cannot fire; it
    # heals by bucket_factor like the shuffle plan's.
    return result, {
        "pre_shuffle_overflow": no,
        "shuffle_overflow": b_ovf,
        "join_overflow": total > out_cap,
        "char_overflow": _char_overflow(result, no),
        "surrogate_collision": jflags["surrogate_collision"],
        "pack_range_overflow": jflags["pack_range_overflow"],
    }


def _partition_probe_counts(
    topology: Topology, table: Table, counts: torch.Tensor, on: tuple, odf: int,
    config: Optional[JoinConfig] = None,
):
    """The global [w, m] per-source partition counts of ``table`` under
    the main stage's partition (seed MAIN_JOIN_SEED, m = n * odf), as a
    numpy array on every process (dj_tpu/parallel/dist_join.py:748-773):
    each rank counts its own shard's rows a partition, and the rows are
    gathered over the world, so every process of a process world plans
    from the same matrix."""
    m = topology.world_group().size * odf

    def run(comm, t, c):
        comm.phase("dj_skew_probe")
        _, pcounts = partition_ids_and_counts(t.with_count(c[0]), on, m, seed=MAIN_JOIN_SEED)
        return (pcounts.reshape(1, m),)

    (mat,) = run_spmd(topology, run, table, counts,
                      **_backend(config or JoinConfig(), flags_at=0))
    return mat.cpu().numpy()


def _global_table_bytes(topology: Topology, table: Table) -> int:
    """``replicated_table_bytes`` of the global table: the sharded table
    this process holds, times the shards of the other processes."""
    return replicated_table_bytes(table) * topology.world_size // topology.local_ranks


def _observe_partition_skew(
    topology: Topology, table: Table, counts: torch.Tensor, on: tuple, odf: int, *,
    stage: str, counts_fn=None, config: Optional[JoinConfig] = None,
) -> None:
    """The measured destination skew of one query's probe side
    (``obs.skew``; dj_tpu/parallel/dist_join.py:776-823): armed by
    ``DJT_OBS_SKEW=1`` with obs on, sampled a signature by
    ``DJT_OBS_SKEW_EVERY``; one partition-count pass
    (``_partition_probe_counts``, or ``counts_fn``: the unprepared join
    shares one lazy pass with its plan decision) and one ``skew`` event a
    batch. A two-level topology is skipped: its main stage partitions
    pre-shuffled rows this probe does not see, and so is the autotuner's
    probe (``obs.recorder.suppressed``). A failed probe mirrors a warning
    and never fails the query."""
    if not obs_skew.probe_enabled() or topology.is_hierarchical or obs_recorder.suppressed():
        return
    if not obs_skew.probe_due((stage, id(topology), tuple(on), odf,
                               obs_recorder.table_sig(table))):
        return
    try:
        n = topology.world_group().size
        mat = (counts_fn() if counts_fn is not None
               else _partition_probe_counts(topology, table, counts, on, odf, config))
        obs_skew.record_partition_skew(mat, n, odf, stage=stage)
    except Exception as e:  # noqa: BLE001 - observation must not fail a query
        obs.mirror_warning("skew_probe_failed",
                           f"partition-skew probe failed ({type(e).__name__}: {e}); skew events "
                           f"disabled for this process's failing shapes")


def _resolve_plan_decision(
    topology: Topology, left: Table, left_counts: torch.Tensor, right: Table,
    right_counts: torch.Tensor, left_on: tuple, right_on: tuple, config: JoinConfig,
    counts_fn=None,
) -> "plan_adapt.PlanDecision":
    """The plan of one unprepared join (dj_tpu/parallel/dist_join.py:
    1207-1287): the signature's decision (``plan_adapt.decide``,
    replayed from the ledger or decided now from the global right
    side's bytes and the probe side's gathered partition counts),
    revalidated: a broadcast whose side no longer fits the budget, or a
    salt set the current n and odf cannot hold, is demoted to shuffle.
    A two-level topology and the planner off give the shuffle plan. A
    failure to decide warns (once a process also into the flight
    recorder) and gives the shuffle plan, as dj_tpu's. ``counts_fn``
    stands in for the partition-count probe: the unprepared join passes
    the one it shares with the skew observation."""
    if not plan_adapt.enabled() or topology.is_hierarchical:
        return plan_adapt.SHUFFLE
    sig = dj_ledger.plan_signature(topology, left, right, left_on, right_on, config)
    n = topology.world_group().size
    odf = config.over_decom_factor
    try:
        decision = plan_adapt.decide(
            sig, n=n, odf=odf,
            right_bytes_fn=lambda: _global_table_bytes(topology, right),
            counts_fn=counts_fn or (lambda: _partition_probe_counts(
                topology, left, left_counts, left_on, odf, config)),
        )
    except Exception as e:  # noqa: BLE001 - planning must not fail a query
        obs.mirror_warning("plan_adapt_failed", f"plan decision failed ({type(e).__name__}: "
                                                f"{e}); serving this shape on the shuffle plan")
        warnings.warn(f"plan decision failed ({type(e).__name__}: {e}); this join runs the "
                      f"shuffle plan", RuntimeWarning, stacklevel=3)
        return plan_adapt.SHUFFLE
    if decision.tier == plan_adapt.TIER_BROADCAST:
        budget = plan_adapt.available_broadcast_bytes()
        rb = _global_table_bytes(topology, right)
        if budget <= 0 or rb > budget:
            decision = plan_adapt.demote(
                sig, f"broadcast misfit: replicated side {rb:.3g} B > budget {budget:.3g} B")
    elif decision.tier == plan_adapt.TIER_SALTED:
        if decision.replicas > n or any(not 0 <= p < n * odf for p in decision.salt):
            decision = plan_adapt.demote(
                sig, f"salt set {decision.salt} / replicas {decision.replicas} incompatible "
                     f"with n={n}, odf={odf}")
    return decision


def _masked_minmax(data: torch.Tensor, counts: torch.Tensor, w: int):
    """(min, max) over the valid rows of a [w * cap] sharded int column,
    as python ints; an empty column gives the inverted sentinel (dtype
    max, dtype min). Unsigned 16/32-bit columns reduce widened to int64
    and uint64 ones as int64 with the top bit flipped: PyTorch has no
    min, max or where for them."""
    info = torch.iinfo(data.dtype)
    cap = data.shape[0] // w
    if cap == 0:
        return info.max, info.min
    bias = 0
    if data.dtype == torch.uint64:
        data, bias = data.view(torch.int64) ^ (-(2**63)), 2**63
    elif data.dtype in (torch.uint16, torch.uint32):
        data = data.to(torch.int64)
    lo, hi = torch.iinfo(data.dtype).max, torch.iinfo(data.dtype).min
    valid = torch.arange(cap, device=data.device)[None, :] < counts[:, None]
    d2 = data.reshape(w, cap)
    mn = int(torch.where(valid, d2, lo).min())
    mx = int(torch.where(valid, d2, hi).max())
    if mx < mn:
        return info.max, info.min
    return mn + bias, mx + bias


def _world_minmax(topology: Optional[Topology], ranges: list) -> list:
    """Per-column (min, max) over the world from this process's: in a
    process world, a reduction over the processes (Python ints, so any
    64-bit value survives); else ``ranges`` itself."""
    if topology is None or not topology.is_process_world:
        return ranges
    every: list = [None] * topology.world_size
    dist.all_gather_object(every, ranges)
    return [(min(p[j][0] for p in every), max(p[j][1] for p in every))
            for j in range(len(ranges))]


# The range probe's memo (dj_tpu's ``_memo_minmax``, dist_join.py:594-625):
# (min, max) of a column's valid rows by the (id, version) of the column
# and of its counts. A version is bumped by every in-place write, so a
# written column is probed again; an entry is evicted when either tensor
# dies, so a recycled id never serves another column's range. Bounded:
# past the cap a probe is not kept. In a process world the value kept is
# the world's, and every process probes the same columns in the same
# order, so the misses, each one gather of Python ints over the
# processes, line up on every process.
_MINMAX_CACHE: dict = {}
_MINMAX_CACHE_MAX = 4096


def _memo_minmax(data: torch.Tensor, counts: torch.Tensor, w: int,
                 topology: Optional[Topology] = None) -> tuple[int, int]:
    """``_masked_minmax`` of ``data`` over the world, memoized (above).
    A shape-bucket pad resolves to its source column first
    (``shape_bucket.alias_base``): the pad appends masked rows only.
    Counts ``dj_range_probe_total{result}``: "memo_hit", or "probe" for
    a miss, which reads the column on the host."""
    base = shape_bucket.alias_base(data)
    if base is not None:
        data = base
    key = (id(data), data._version, id(counts), counts._version, w)
    hit = _MINMAX_CACHE.get(key)
    if hit is not None:
        obs.inc("dj_range_probe_total", result="memo_hit")
        return hit
    obs.inc("dj_range_probe_total", result="probe")
    val = _world_minmax(topology, [_masked_minmax(data, counts, w)])[0]
    if len(_MINMAX_CACHE) < _MINMAX_CACHE_MAX:
        _MINMAX_CACHE[key] = val
        for obj in (data, counts):
            weakref.finalize(obj, _MINMAX_CACHE.pop, key, None)
    return val


def _resolve_key_range(
    config: JoinConfig, left: Table, left_counts: torch.Tensor,
    right: Table, right_counts: torch.Tensor,
    left_on: Sequence[int], right_on: Sequence[int], w: int,
    topology: Optional[Topology] = None,
) -> Optional[tuple]:
    """The static key range the join plans with
    (``_resolve_key_range``, dj_tpu/parallel/dist_join.py:628-683): the
    declared one, else the probed global range of a single 64-bit int
    key, or of a multi-column int key, canonicalized to width form (0,
    2^w - 1) per key. None for a single key of at most 32 bits (it packs
    statically), string and float keys, key pairs of two dtypes, two
    empty sides, ``DJT_JOIN_RANGE_PROBE=0`` (dj_tpu's
    ``DJ_JOIN_RANGE_PROBE``: a 64-bit key's fit is then checked on the
    host in the join) and ``DJT_JOIN_PACK=0``. ``w`` is the number of shards the tables
    here hold; in a process world (``topology``) the ranges of every
    process's shards are reduced. Each column's range comes from the
    memo (``_memo_minmax``)."""
    if config.key_range is not None:
        return normalize_key_range(config.key_range, len(left_on))
    if knobs.read("DJT_JOIN_RANGE_PROBE") != "1":
        return None
    if knobs.read("DJT_JOIN_PACK") != "1":
        return None
    cols = []
    for lc, rc in zip(left_on, right_on):
        a, b = left.columns[lc], right.columns[rc]
        if isinstance(a, StringColumn) or isinstance(b, StringColumn):
            return None
        a, b = a.data, b.data
        if a.dtype != b.dtype or a.is_floating_point() or a.dtype == torch.bool:
            return None
        cols.append((a, b))
    if len(cols) == 1 and cols[0][0].element_size() * 8 <= 32:
        return None
    ranges = []
    for a, b in cols:
        amn, amx = _memo_minmax(a, left_counts, w, topology)
        bmn, bmx = _memo_minmax(b, right_counts, w, topology)
        ranges.append((min(amn, bmn), max(amx, bmx)))
    if any(mx < mn for mn, mx in ranges):
        return None
    return canonical_key_range(tuple(ranges), [dt.numpy_dtype(a.dtype) for a, _ in cols])


class _UnpreparedJob(NamedTuple):
    """One unprepared join's set-up: both tables padded to their shape
    bucket, the key columns, the resolved key range and the plan
    decision."""

    left: Table
    right: Table
    left_on: tuple
    right_on: tuple
    key_range: Optional[tuple]
    decision: "plan_adapt.PlanDecision"


def _unprepared_job(topology: Topology, left: Table, left_counts: torch.Tensor, right: Table,
                    right_counts: torch.Tensor, left_on: Sequence[int],
                    right_on: Sequence[int], config: JoinConfig, what: str) -> _UnpreparedJob:
    """The set-up of one unprepared join, for ``distributed_inner_join``
    and the autotuner's ``price_plan_candidate`` alike, so a candidate is
    priced and probed on the plan the real call runs: the structural
    checks, shape bucketing (``DJT_SHAPE_BUCKET=1``: both tables pad to
    their bucket before the sizing, the signatures and the range probe),
    the key range, then the skew observation and the plan decision,
    which share one lazy partition-count pass (with both armed, a query
    runs it once)."""
    _check_table_right(left, right, right_counts, left_on, right_on, what)
    w = topology.local_ranks
    if left.capacity < w or right.capacity < w:
        raise ValueError(
            f"{what}: table capacity "
            f"{min(left.capacity, right.capacity)} < {w} shards here "
            f"leaves at least one shard with zero capacity; pad the "
            f"table to >= 1 row per shard"
        )
    left = shape_bucket.bucket_table(topology, left)
    right = shape_bucket.bucket_table(topology, right)
    with obs_roofline.phase("probe", stage="join"), span("dj_range_probe"):
        key_range = _resolve_key_range(
            config, left, left_counts, right, right_counts, left_on, right_on, w, topology
        )
    left_on, right_on = tuple(left_on), tuple(right_on)
    memo: dict = {}

    def shared_counts():
        if "counts" not in memo:
            memo["counts"] = _partition_probe_counts(topology, left, left_counts, left_on,
                                                     config.over_decom_factor, config)
        return memo["counts"]

    _observe_partition_skew(topology, left, left_counts, left_on, config.over_decom_factor,
                            stage="join", counts_fn=shared_counts)
    decision = _resolve_plan_decision(topology, left, left_counts, right, right_counts, left_on,
                                      right_on, config, counts_fn=shared_counts)
    return _UnpreparedJob(left, right, left_on, right_on, key_range, decision)


def distributed_inner_join(
    topology: Topology,
    left: Table,
    left_counts: torch.Tensor,
    right,
    right_counts: Optional[torch.Tensor] = None,
    left_on: Sequence[int] = (),
    right_on: Optional[Sequence[int]] = None,
    config: Optional[JoinConfig] = None,
) -> tuple[Table, torch.Tensor, dict]:
    """Join two sharded tables; result columns = left + (right - right_on).

    ``left``/``right`` are sharded tables ([world * cap] columns) with
    int32 [world] valid-row counts. Returns (result, result_counts[world],
    info): the result is sharded ([world * over_decom_factor * out_cap]
    columns, shard r the rows rank r joined), and ``info`` maps each of
    pre_shuffle_overflow /
    shuffle_overflow / join_overflow / char_overflow /
    surrogate_collision / pack_range_overflow to a bool[world]; any True
    means that shard's output is unspecified. In a process world the
    tables, counts and result are this rank's block ([cap] columns, [1]
    counts), and ``info`` holds every rank's flags (bool[world]) on every
    process.

    Under ``DJT_PLAN_ADAPT=1`` the join runs the plan its signature
    decided (``parallel.plan_adapt``): broadcast (each rank's output
    capacity is then ``join_out_factor * max(left cap, world * right
    cap)``), salted or shuffle; every plan gives the same rows and info
    keys.

    ``right`` may instead be a :class:`PreparedSide` (pass
    ``right_counts=None, right_on=None``): the query then does the probe
    side's work only, and ``info`` holds the prepared flag keys
    (prepared_plan_mismatch in place of surrogate_collision and
    pack_range_overflow). A probe side structurally incompatible with the
    prepared plan raises PreparedPlanMismatch.
    """
    if isinstance(right, PreparedSide):
        if right_counts is not None or right_on is not None:
            raise ValueError(
                "a PreparedSide carries its own counts and key columns; "
                "pass right_counts=None, right_on=None"
            )
        return _distributed_inner_join_prepared(
            topology, left, left_counts, right, left_on, config
        )
    if config is None:
        config = JoinConfig()
    with call_span("dj_call", topology.device):
        job = _unprepared_job(topology, left, left_counts, right, right_counts, left_on,
                              right_on, config, "distributed_inner_join")
        decision = job.decision

        def attempt():
            # The ladder's pins are read again inside the attempt: the wire
            # tier through the stripped config, the adapt tier through
            # DJT_PLAN_ADAPT (its pin writes 0 there), so the retry after a
            # pin runs the baseline plan, a decided broadcast or salted plan
            # included.
            cfg = resil.strip_pinned_wire(config)
            d = decision if plan_adapt.enabled() else plan_adapt.SHUFFLE
            faults.check("module_build")
            if d.tier == plan_adapt.TIER_BROADCAST:
                faults.check("broadcast")
            elif d.tier == plan_adapt.TIER_SALTED:
                faults.check("salted")
            if plan_adapt.enabled():
                obs.inc("dj_plan_dispatch_total", tier=d.tier)
            return _run_join(topology, d.tier, job.left, left_counts, job.right, right_counts,
                             job.left_on, job.right_on, cfg, job.key_range, d.salt, d.replicas,
                             path="unprepared")

        out, counts, info = resil.degrade_guard("distributed_inner_join", attempt,
                                                tiers=("adapt", "wire"), config=config,
                                                topology=topology)
        # Fault flag sites join.<flag>: forced on the host after the ranks ran.
        with span("dj_flags"):
            return out, counts, faults.force_flags("join", info)


TIER_LOCAL = "local"  # the pipeline's co-partitioned join (parallel.pipeline)


def _run_join(
    topology: Topology, tier: str, left: Table, left_counts: torch.Tensor, right: Table,
    right_counts: torch.Tensor, left_on: tuple, right_on: tuple, config: JoinConfig,
    key_range: Optional[tuple], salt: tuple = (), replicas: int = 1, *, stage: str = "join",
    path: Optional[str] = None, queries: int = 1, ladder: bool = True,
) -> tuple[Table, torch.Tensor, dict]:
    """One unprepared join's ranks on ``tier``: the shuffle plan
    (``_local_join_pipeline``; salted with a ``salt`` set), the broadcast
    plan (``_broadcast_join_pipeline``) or the co-partitioned local join
    (``TIER_LOCAL``, ``_copartitioned_join``), as one ``_dispatch``
    under ``stage``, ``path`` and ``queries``. Its callers have checked
    the key widths (``_check_key_widths``) and run it inside their
    degradation guard; a shuffle or salted plan whose pre-shuffle
    compresses consults the fault site ``codec`` first, but for the
    autotuner's probe (``ladder=False``: see ``_prepared_attempt``).
    Returns (result, counts, info by ``_flag_keys``)."""
    w = topology.local_ranks
    l_cap, r_cap = left.capacity // w, right.capacity // w
    keys = _flag_keys(config)

    def run(comm, lt, lc, rt, rc):
        args = (comm, lt.with_count(lc[0]), rt.with_count(rc[0]), left_on, right_on, config,
                l_cap, r_cap, key_range)
        if tier == plan_adapt.TIER_BROADCAST:
            out, flags = _broadcast_join_pipeline(*args)
        elif tier == TIER_LOCAL:
            out, flags = _copartitioned_join(*args)
        else:
            out, flags = _local_join_pipeline(*args, salt, replicas)
        return out.with_count(None), out.count().reshape(1), _flag_row(flags, keys)

    kind = {plan_adapt.TIER_BROADCAST: "join_broadcast", TIER_LOCAL: "join_local"}.get(
        tier, "join_salted" if salt else "join")
    if ladder and tier not in (plan_adapt.TIER_BROADCAST, TIER_LOCAL):
        _pre_shuffle_codec(topology, config.left_compression, config.right_compression)
    out, counts, flag_mat = _dispatch(
        topology, stage, kind,
        lambda: run_spmd(topology, run, left, left_counts, right, right_counts,
                         **_backend(config)),
        path=path, queries=queries)
    return out, counts, _flag_info(flag_mat, keys)


def _copartitioned_join(
    comm: Communicator, left: Table, right: Table, left_on: Sequence[int],
    right_on: Sequence[int], config: JoinConfig, l_cap: int, r_cap: int,
    key_range: Optional[tuple] = None,
):
    """One rank's co-partitioned ("local") join (dj_tpu's
    ``_build_local_join_fn``, dist_join.py:972-1040): both shards are
    already hash-partitioned by the join key under the main seed, so equal
    keys lie on one rank and the global join is the ranks' own joins. One
    ``inner_join`` of the two shards at ``join_out_factor * max(l_cap,
    r_cap)`` rows; no partition and no collective of any kind. The
    shuffle flags are constant False."""
    out_cap = max(1, int(config.join_out_factor * max(l_cap, r_cap)))
    comm.phase("dj_join")
    result, total, jflags = inner_join(
        left, right, left_on, right_on,
        out_capacity=out_cap,
        char_out_factor=config.char_out_factor,
        return_flags=True,
        key_range=key_range,
    )
    no = torch.tensor(False, device=left.device)
    return result, {
        "pre_shuffle_overflow": no,
        "shuffle_overflow": no,
        "join_overflow": total > out_cap,
        "char_overflow": _char_overflow(result, no),
        "surrogate_collision": jflags["surrogate_collision"],
        "pack_range_overflow": jflags["pack_range_overflow"],
    }


def _backend(config: JoinConfig, flags_at: int = 2) -> dict:
    """run_spmd's communicator arguments from a config, with the body's
    flag row (output ``flags_at``) gathered into the [w, k] matrix."""
    return {"communicator_cls": config.communicator_cls, "fuse_columns": config.fuse_columns,
            "gathered": (flags_at,)}


_STAT_PREFIX = "pre_shuffle_comp"


def _flag_keys(config: JoinConfig) -> tuple:
    """The unprepared join's info keys: the flags, plus the pre-shuffle's
    compression counters when either side compresses."""
    if config.left_compression or config.right_compression:
        return _FLAG_KEYS + tuple(f"pre_shuffle_{k}" for k in STAT_KEYS)
    return _FLAG_KEYS


def _flag_row(flags: dict, keys) -> torch.Tensor:
    """One rank's flags and counters as a float32 [1, len(keys)] row (a
    bool flag as 0 or 1; a counter absent on this rank as 0)."""
    dev = next(iter(flags.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.stack([flags[k].to(torch.float32) if k in flags else zero
                        for k in keys]).reshape(1, len(keys))


def _flag_info(flag_mat: torch.Tensor, keys) -> dict:
    """{key: bool[world]} for each flag and {key: float32[world]} for each
    compression counter, from the ranks' stacked rows."""
    with span("dj_flags"):
        return {k: flag_mat[:, i] if k.startswith(_STAT_PREFIX) else flag_mat[:, i] != 0
                for i, k in enumerate(keys)}


# Which JoinConfig factor heals which overflow flag: the heal loop grows
# exactly the offending capacity. pre_shuffle_overflow folds the
# pre-shuffle's bucket and output overflows into one flag, so both of its
# sizing factors grow.
_HEAL_FACTORS = {
    "pre_shuffle_overflow": ("pre_shuffle_out_factor", "bucket_factor"),
    "shuffle_overflow": ("bucket_factor",),
    "join_overflow": ("join_out_factor",),
    "char_overflow": ("char_out_factor",),
}

_CONFIG_FACTOR_FIELDS = (
    "pre_shuffle_out_factor",
    "bucket_factor",
    "join_out_factor",
    "char_out_factor",
)


def _config_factors(config: JoinConfig) -> dict:
    return {f: getattr(config, f) for f in _CONFIG_FACTOR_FIELDS}


def _raise_surrogate_collision(_info):
    # Not a capacity problem: two distinct string keys share a 64-bit
    # surrogate, which no factor heals. The heal engine reads this flag
    # only on an attempt without a capacity overflow: under join
    # overflow the expansion is garbage and the verifier compares
    # unrelated rows, so the capacity heals first.
    raise RuntimeError(
        "surrogate_collision: distinct string join keys share a 64-bit "
        "hash surrogate; re-join via a dictionary encoding of the key column"
    )


def distributed_inner_join_auto(
    topology: Topology,
    left: Table,
    left_counts: torch.Tensor,
    right,
    right_counts: Optional[torch.Tensor] = None,
    left_on: Sequence[int] = (),
    right_on: Optional[Sequence[int]] = None,
    config: Optional[JoinConfig] = None,
    *,
    max_attempts: int = 8,
    growth: float = 2.0,
    max_total_growth: float = 4096.0,
):
    """distributed_inner_join that heals its own overflows
    (``distributed_inner_join_auto``, dj_tpu/parallel/dist_join.py:
    1283-1440).

    Static capacities make a wrong sizing factor raise overflow flags
    and leave the rows unspecified. This wrapper runs the join, reads
    the flags on the host, multiplies exactly the offending factor
    (``_HEAL_FACTORS``) by ``growth`` and runs again; a declared
    key_range that the data violates (pack_range_overflow) is dropped
    and the range probed instead. The capacity ledger keeps the healed
    factors per workload signature, so a later call of the same shape
    succeeds on its first attempt. Exhausting ``max_attempts``, or one
    factor growing past ``max_total_growth``, raises CapacityExhausted
    with the last attempt count, flags and factors.

    Returns (result, counts, info, config_used): ``config_used`` is the
    final, possibly grown, config. With a :class:`PreparedSide` as
    ``right`` it returns (result, counts, info, config_used,
    prepared_used): capacity flags grow the query's factors and reuse
    the prepared batches; prepared_plan_mismatch, as a flag or as the
    structural exception, re-prepares under a range widened to the
    probe side, and ``prepared_used`` is that side.
    """
    if isinstance(right, PreparedSide):
        return _distributed_inner_join_prepared_auto(
            topology, left, left_counts, right, left_on, config,
            max_attempts=max_attempts, growth=growth, max_total_growth=max_total_growth,
        )
    if config is None:
        config = JoinConfig()
    # Before the first attempt: keys of two widths are no capacity problem.
    _check_table_right(left, right, right_counts, left_on, right_on,
                       "distributed_inner_join_auto")
    state = {"config": config, "dropped_range": False}

    def run_attempt(attempt):
        out, counts, info = distributed_inner_join(
            topology, left, left_counts, right, right_counts, left_on, right_on,
            state["config"],
        )
        return (out, counts), info

    def _heal_pack_range(info, attempt):
        # Data outside the declared key_range: the packed tags are
        # corrupt and no other flag of this attempt is trusted. A probed
        # range covers the data by construction and never fires this.
        cfg = state["config"]
        if cfg.key_range is None:
            raise RuntimeError(
                "pack_range_overflow with no declared key_range: the probed "
                "range covers the data by construction; this is a bug, not a "
                "capacity problem"
            )
        obs.inc("dj_heal_total", flag="pack_range_overflow")
        obs.record("heal", stage="join", attempt=attempt, flags=["pack_range_overflow"],
                   action="drop_declared_range", dropped_key_range=cfg.key_range)
        state.update(config=dataclasses.replace(cfg, key_range=None), dropped_range=True)

    def _apply_ledger(entry):
        # A learned "declared range was wrong" repair: drop it before the
        # first attempt.
        if entry.get("drop_declared_range") and state["config"].key_range is not None:
            state.update(config=dataclasses.replace(state["config"], key_range=None),
                         dropped_range=True)

    (out, counts), info, _ = heal_engine.run_healed(
        name="distributed_inner_join_auto",
        stage="join",
        budget=HealBudget(max_attempts, growth, max_total_growth),
        run_attempt=run_attempt,
        heal_map=_HEAL_FACTORS,
        read_factors=lambda: _config_factors(state["config"]),
        apply_factors=lambda grew: state.update(
            config=dataclasses.replace(state["config"], **grew)
        ),
        poison={"pack_range_overflow": _heal_pack_range},
        terminal={"surrogate_collision": _raise_surrogate_collision},
        ledger_key=dj_ledger.plan_signature(topology, left, right, left_on, right_on, config),
        ledger_extra=lambda: {"drop_declared_range": True} if state["dropped_range"] else {},
        apply_ledger_entry=_apply_ledger,
    )
    return out, counts, info, state["config"]


# --- prepared build side --------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class PreparedSide:
    """A build side shuffled, packed and sorted once, ready to serve
    repeated joins (``prepare_join_side``).

    ``batches`` holds, per odf batch, (sorted packed words [world * R],
    sorted payload table, valid counts [world]). ``key_range``/``plan``
    pin the anchored pack every probe side must satisfy; ``sizing``/``n``
    pin the batch geometry the words' tag field was built for.
    ``right``/``right_counts`` keep the source (with every appended row,
    ``append_to_prepared``), so a caller can re-prepare.

    ``tier`` is the build tier (``DJT_PREPARED_TIER``, or decided and
    kept in the ledger under the prepare signature): ``"shuffle"``, the
    batches above; ``"broadcast"``, one batch a rank holding the whole
    build side (gathered at prepare time), so a query runs no partition
    and no collective; ``"salted"``, the shuffle batches with the heavy
    partitions ``salt`` (global ids) copied to ``salt_replicas`` cyclic
    peers, and each query's probe rows salted to match."""

    topology: Topology
    config: JoinConfig
    right_on: tuple
    key_range: tuple
    plan: PreparedPackPlan
    n: int
    sizing: BatchSizing
    l_cap: int
    r_cap: int
    batches: tuple
    right: Table
    right_counts: torch.Tensor
    tier: str = plan_adapt.TIER_SHUFFLE
    salt: tuple = ()
    salt_replicas: int = 1


def _main_group_sizing(
    topology: Topology, config: JoinConfig, l_cap: int, r_cap: int
) -> tuple[int, int, int]:
    """(n, l_cap, r_cap) of the main join stage, shared by the prepare
    and the query so their sizings cannot drift: on a two-level topology
    the 'intra' group and the pre-shuffle's output capacities, on a flat
    one the world and the capacities as they are."""
    if topology.is_hierarchical:
        return (
            topology.main_group().size,
            max(1, int(l_cap * config.pre_shuffle_out_factor)),
            max(1, int(r_cap * config.pre_shuffle_out_factor)),
        )
    return topology.world_group().size, l_cap, r_cap


_PREP_FLAG_KEYS = (
    "pre_shuffle_overflow",
    "shuffle_overflow",
    "prep_range_violation",
)
_PREPARED_FLAG_KEYS = (
    "pre_shuffle_overflow",
    "shuffle_overflow",
    "join_overflow",
    "char_overflow",
    "prepared_plan_mismatch",
)


def _prep_flag_keys(config: JoinConfig) -> tuple:
    """The prepare's info keys: its flags, plus the build side's
    pre-shuffle counters when it compresses."""
    if config.right_compression:
        return _PREP_FLAG_KEYS + tuple(f"pre_shuffle_{k}" for k in STAT_KEYS)
    return _PREP_FLAG_KEYS


def _prepared_flag_keys(config: JoinConfig) -> tuple:
    """A prepared query's info keys: its flags, plus the probe side's
    pre-shuffle counters when it compresses."""
    if config.left_compression:
        return _PREPARED_FLAG_KEYS + tuple(f"pre_shuffle_{k}" for k in STAT_KEYS)
    return _PREPARED_FLAG_KEYS


def _pre_shuffle_one(comm: Communicator, config: JoinConfig, table: Table, on: tuple,
                     cap: int, out_cap: int, compression=None) -> tuple[Table, torch.Tensor,
                                                                        dict]:
    """The hierarchical pre-shuffle of one side over 'inter' (the
    prepare's build side or the prepared query's probe side), through
    the codec under ``compression``: (table, overflow, its
    ``pre_shuffle_comp_*`` counters); a flat topology's rank keeps its
    table."""
    if INTER not in comm.axes:
        return table, torch.tensor(False, device=table.device), {}
    inter = comm.sub(INTER)
    with comm.phase_scope("dj_pre_shuffle"):
        out, _, ovf, stats = _local_shuffle(
            table, inter, on, hashing.HASH_MURMUR3, INTER_DOMAIN_SEED,
            max(1, int(cap * config.bucket_factor / inter.size)), out_cap, compression,
        )
    return out, ovf, _pre_shuffle_stats(stats)


def _prepare_batches(
    comm: Communicator, config: JoinConfig, right: Table, right_on: tuple,
    sizing: BatchSizing, plan: PreparedPackPlan, r_cap: int, r_cap_m: int,
    salt: tuple = (), replicas: int = 1,
) -> tuple[tuple, dict]:
    """One rank's preparation (the body of dj_tpu's _build_prepare_fn):
    on a two-level topology the build side's pre-shuffle into
    ``r_cap_m`` rows, then partition, then per batch a single-table
    shuffle and the anchored pack + sort + re-tag. With a ``salt`` set
    (the salted tier, dj_tpu's ``_build_salted_prepare_fn``) each
    batch's exchange also carries the rotated windows of
    ``_salt_windows``, concatenated into the batch before the pack.
    Returns (batches, flags by _PREP_FLAG_KEYS)."""
    right, pre_ovf, pre_stats = _pre_shuffle_one(comm, config, right, right_on, r_cap, r_cap_m,
                                                 config.right_compression)
    n = comm.size
    comm.phase("dj_partition")
    r_part, r_offsets = hash_partition(right, right_on, sizing.m, seed=MAIN_JOIN_SEED)
    no = torch.tensor(False, device=right.device)
    shuffle_ovf = range_bad = no
    outs = []
    for b in range(config.over_decom_factor):
        starts = r_offsets[b * n : (b + 1) * n]
        counts = r_offsets[b * n + 1 : (b + 1) * n + 1] - starts
        windows = [(starts, counts)]
        if salt:
            windows += _salt_windows(b, n, starts, counts, salt, replicas)
        comm.phase("dj_exchange")
        parts = shuffle_tables_start(
            comm, [r_part] * len(windows), [st for st, _ in windows], [ct for _, ct in windows],
            [sizing.br] * len(windows), [n * sizing.br] * len(windows)).wait()
        for _, _, ovf, _ in parts:
            shuffle_ovf = shuffle_ovf | ovf
        if len(parts) == 1:
            r_batch = parts[0][0]
        else:
            comm.phase("dj_salt_concat")
            r_batch = concatenate([t for t, _, _, _ in parts])
        del parts
        comm.phase("dj_prepare")
        words, payload, ok = prepare_packed_batch(r_batch, right_on, plan)
        del r_batch
        range_bad = range_bad | ~ok
        outs.append((words, payload.with_count(None), payload.count().reshape(1)))
    flags = {
        "pre_shuffle_overflow": pre_ovf,
        "shuffle_overflow": shuffle_ovf,
        "prep_range_violation": range_bad,
        **pre_stats,
    }
    return tuple(outs), flags


def _prepare_broadcast(
    comm: Communicator, right: Table, right_on: tuple, plan: PreparedPackPlan, r_cap: int,
) -> tuple[tuple, dict]:
    """One rank's broadcast-tier preparation (dj_tpu's
    ``_build_bc_prepare_fn``, dist_join.py:1879-1933): the whole build
    side gathered into n * r_cap rows (``broadcast_table``) and packed
    and sorted into one resident batch, whatever the odf. Returns
    (batches, flags by _PREP_FLAG_KEYS); the gather's sizing is exact,
    so its shuffle_overflow cannot fire."""
    with comm.phase_scope("dj_broadcast"):
        right_g, _, b_ovf, _ = broadcast_table(comm, right, comm.size * r_cap)
    comm.phase("dj_prepare")
    words, payload, ok = prepare_packed_batch(right_g, right_on, plan)
    del right_g
    flags = {
        "pre_shuffle_overflow": torch.tensor(False, device=right.device),
        "shuffle_overflow": b_ovf,
        "prep_range_violation": ~ok,
    }
    return ((words, payload.with_count(None), payload.count().reshape(1)),), flags


# The ledger record of a prepare signature's build tier. The prepare
# signature does not fold the tier: the decision is read before the
# tier's prepare runs.
_PREPARED_TIER_KEY = "prepared_tier"
_PREPARED_TIERS = (plan_adapt.TIER_SHUFFLE, plan_adapt.TIER_BROADCAST, plan_adapt.TIER_SALTED)
_SHUFFLE_TIER = (plan_adapt.TIER_SHUFFLE, (), 1)


def _prepared_salt_ratio() -> float:
    """The heavy-partition threshold of the salted-prepared tier:
    ``DJT_PREPARED_SALT_RATIO``, else (unset or <= 0) the planner's
    ``DJT_SALT_RATIO``."""
    r = knobs.read_float("DJT_PREPARED_SALT_RATIO")
    return r if r > 0 else plan_adapt.salt_ratio()


def _record_prepared_tier(sig: str, tier: str, salt: tuple, replicas: int, source: str,
                          ratio: Optional[float] = None, **extra) -> None:
    obs.inc("dj_prepared_tier_total", tier=tier, source=source)
    obs.record("prepared_tier", tier=tier, source=source, salt=[int(p) for p in salt],
               replicas=int(replicas), ratio=ratio, signature=sig[:200], **extra)


def _persist_prepared_tier(sig: str, tier: str, salt: tuple, replicas: int,
                           ratio: Optional[float] = None) -> None:
    dj_ledger.update(sig, **{_PREPARED_TIER_KEY: {
        "tier": tier, "salt": [int(p) for p in salt], "replicas": int(replicas), "ratio": ratio,
    }})


def _demote_prepared_tier(sig: str, reason: str) -> tuple:
    """Persist the shuffle tier for prepare signature ``sig``: a
    requested or replayed replication tier that does not fit (broadcast
    budget, salt geometry, a merged size that does not pack) falls
    back to shuffle-prepared. ``reason`` says which, in one
    ``prepared_tier`` event with ``action="demote"``."""
    _persist_prepared_tier(sig, plan_adapt.TIER_SHUFFLE, (), 1)
    _record_prepared_tier(sig, plan_adapt.TIER_SHUFFLE, (), 1, "demote", action="demote",
                          reason=str(reason)[:300])
    return _SHUFFLE_TIER


def _resolve_prepared_tier(
    topology: Topology, right: Table, right_counts: torch.Tensor, right_on: tuple,
    config: JoinConfig, sig: str, forced: Optional[str] = None,
) -> tuple[str, tuple, int]:
    """(tier, salt, replicas) of one prepare (dj_tpu/parallel/
    dist_join.py:1759-1876). A two-level topology stays on shuffle.
    ``forced`` (a re-prepare keeping its side's tier) and a ledger
    record are revalidated: a broadcast against the current budget, a
    salt set against the current n and odf; a misfit demotes. Otherwise
    ``DJT_PREPARED_TIER`` decides (default shuffle): broadcast when the
    side's replicated footprint (the global side's bytes times the
    world, every rank holding it) fits the budget; salted when the build
    side's gathered partition counts have a destination at
    ``_prepared_salt_ratio()`` times its batch's mean; auto tries both
    in that order and else stays on shuffle. A fresh decision persists
    at once; each decision records one ``prepared_tier`` event and
    ``dj_prepared_tier_total{tier,source}``, as dj_tpu's. A pinned
    ``prepared_tier`` (the degradation ladder) also stays on shuffle."""
    if topology.is_hierarchical or resil.tier_pinned(_PREPARED_TIER_KEY):
        return _SHUFFLE_TIER
    n = topology.world_group().size
    odf = config.over_decom_factor
    w = topology.world_size
    salt, replicas = (), 0
    if forced is not None:
        requested, source = forced, "forced"
        if forced == plan_adapt.TIER_SALTED:
            rec = (dj_ledger.consult(sig) or {}).get(_PREPARED_TIER_KEY)
            if isinstance(rec, dict):
                salt = tuple(int(p) for p in rec.get("salt") or ())
                replicas = int(rec.get("replicas") or 0)
    else:
        rec = (dj_ledger.consult(sig) or {}).get(_PREPARED_TIER_KEY)
        if isinstance(rec, dict) and rec.get("tier") in _PREPARED_TIERS:
            requested, source = rec["tier"], "ledger"
            salt = tuple(int(p) for p in rec.get("salt") or ())
            replicas = int(rec.get("replicas") or 0)
        else:
            requested = (knobs.read("DJT_PREPARED_TIER") or "shuffle").strip().lower() or "shuffle"
            source = "env"
    if requested == plan_adapt.TIER_SHUFFLE:
        if source == "ledger":
            _record_prepared_tier(sig, plan_adapt.TIER_SHUFFLE, (), 1, source)
        return _SHUFFLE_TIER
    if requested not in _PREPARED_TIERS + ("auto",):
        raise ValueError(f"DJT_PREPARED_TIER={requested!r}: expected shuffle | broadcast | "
                         f"salted | auto")
    if requested in (plan_adapt.TIER_BROADCAST, "auto"):
        budget = plan_adapt.available_broadcast_bytes()
        rb = float(_global_table_bytes(topology, right)) * w
        if budget > 0 and rb <= budget:
            if source != "ledger":
                _persist_prepared_tier(sig, plan_adapt.TIER_BROADCAST, (), 1)
            _record_prepared_tier(sig, plan_adapt.TIER_BROADCAST, (), 1,
                                  source if source != "env" else "fit")
            return plan_adapt.TIER_BROADCAST, (), 1
        if requested == plan_adapt.TIER_BROADCAST:
            return _demote_prepared_tier(
                sig, f"broadcast-prepared misfit: replicated side {rb:.3g} B ({w} shards) > "
                     f"budget {budget:.3g} B")
    if source in ("ledger", "forced") and salt and replicas >= 2:
        if replicas <= n and all(0 <= p < n * odf for p in salt):
            _record_prepared_tier(sig, plan_adapt.TIER_SALTED, salt, replicas, source)
            return plan_adapt.TIER_SALTED, salt, replicas
        return _demote_prepared_tier(
            sig, f"replayed salt set {salt} / replicas {replicas} incompatible with n={n}, "
                 f"odf={odf}")
    if n <= 1:
        if requested == plan_adapt.TIER_SALTED:
            return _demote_prepared_tier(sig, "salted-prepared needs a multi-shard group")
        return _SHUFFLE_TIER
    obs.inc("dj_plan_probe_total")
    counts = _partition_probe_counts(topology, right, right_counts, right_on, odf, config)
    batches = obs_skew.batch_skew(counts, n, odf, topk=plan_adapt.salt_topk())
    threshold = _prepared_salt_ratio()
    worst = max((b["ratio"] for b in batches), default=1.0)
    heavy = plan_adapt.heavy_destinations(batches, threshold, n)
    if worst >= threshold and heavy:
        salt = tuple(sorted(set(heavy)))
        replicas = plan_adapt.salt_replicas(n, worst)
        _persist_prepared_tier(sig, plan_adapt.TIER_SALTED, salt, replicas, float(worst))
        _record_prepared_tier(sig, plan_adapt.TIER_SALTED, salt, replicas,
                              source if source == "forced" else "probe", ratio=float(worst))
        return plan_adapt.TIER_SALTED, salt, replicas
    if requested == plan_adapt.TIER_SALTED:
        return _demote_prepared_tier(
            sig, f"no heavy resident partition at ratio >= {threshold:.3g} (worst {worst:.3g})")
    _persist_prepared_tier(sig, plan_adapt.TIER_SHUFFLE, (), 1, float(worst))
    _record_prepared_tier(sig, plan_adapt.TIER_SHUFFLE, (), 1, "probe", ratio=float(worst))
    return _SHUFFLE_TIER


def _probe_side_range(table: Table, counts: torch.Tensor, on, topology: Topology):
    """Per-key (min, max) physical bounds of one side's valid rows over
    the world (memoized), or None when the side is empty."""
    ranges = [_memo_minmax(table.columns[c].data, counts, topology.local_ranks, topology)
              for c in on]
    if any(mx < mn for mn, mx in ranges):
        return None
    return tuple(ranges)


def prepare_join_side(
    topology: Topology,
    right: Table,
    right_counts: torch.Tensor,
    right_on: Sequence[int],
    config: Optional[JoinConfig] = None,
    *,
    left_capacity: Optional[int] = None,
    key_range=None,
    max_attempts: int = 8,
    growth: float = 2.0,
    max_total_growth: float = 4096.0,
    tier: Optional[str] = None,
) -> PreparedSide:
    """Shuffle, pack and sort the build side once for repeated joins.

    ``distributed_inner_join(topo, left, lc, prepared, None, left_on,
    None, config)`` then serves each query with probe-side work only.
    ``key_range`` (or config.key_range) declares the join keys' bounds;
    undeclared keys are probed from the build side, so a probe key below
    the build side's minimum raises the query's prepared_plan_mismatch
    flag (``distributed_inner_join_auto`` re-prepares for it).
    ``left_capacity`` (global rows, default the build side's) sizes the
    probe batches the tag field must hold; a later probe table whose
    sizing needs another tag width raises PreparedPlanMismatch.

    The build stage heals as dj_tpu's does (``prepare_join_side``,
    dj_tpu/parallel/dist_join.py:2190-2360), under the heal engine: a
    fired shuffle_overflow grows bucket_factor by ``growth``, build keys
    outside a declared key_range re-probe the range, and budget
    exhaustion raises CapacityExhausted. The capacity ledger remembers
    both per build signature. The returned side's ``config`` holds the
    factors it settled on.

    ``tier`` forces the build tier (a re-prepare keeping its side's);
    None resolves it (``_resolve_prepared_tier``: ``DJT_PREPARED_TIER``,
    a ledger record, or auto). The tiers size the tag field for their
    merged batch: shuffle ``S = n (bl + br)``, broadcast ``l_cap + n
    r_cap`` (the rank's whole left shard against the whole build side),
    salted ``n bl + replicas n br``. A replication tier that does not
    fit (the budget, the salt geometry, an S that does not pack) is
    demoted to shuffle for this signature instead of failing the
    prepare. Under ``DJT_SHAPE_BUCKET=1`` the build side is padded to its
    shape bucket (``parallel.shape_bucket``) and ``left_capacity``
    rounded up to its own.
    """
    if config is None:
        config = JoinConfig()
    w = topology.local_ranks
    if right.capacity < w:
        raise ValueError(
            f"prepare_join_side: build-side capacity {right.capacity} < {w} "
            f"shards here leaves a shard with zero capacity; pad the table to "
            f">= 1 row per shard"
        )
    # Shape bucketing: the build side pads to its bucket, and the left
    # capacity the tag field is sized for rounds up to its own, so every
    # bucketed probe table of that bucket fits the prepared geometry.
    right = shape_bucket.bucket_table(topology, right)
    r_cap = right.capacity // w
    l_cap = (max(1, left_capacity // topology.world_size) if left_capacity is not None
             else r_cap)
    if shape_bucket.enabled():
        l_cap = shape_bucket.bucket_capacity(l_cap)
    right_on = tuple(right_on)
    dtypes = []
    for c_idx in right_on:
        col = right.columns[c_idx]
        if not (isinstance(col, Column) and dt.is_integer(col.dtype)):
            raise ValueError(
                "prepare_join_side requires fixed-width int join keys: "
                "string keys join through full-range 64-bit surrogates "
                "and cannot ride the anchored packed plan — use the "
                "unprepared distributed_inner_join for those"
            )
        dtypes.append(col.data.dtype)
    declared = key_range if key_range is not None else config.key_range
    probed = declared is None
    if probed:
        kr = _probe_side_range(right, right_counts, right_on, topology)
        if kr is None:
            raise ValueError(
                "prepare_join_side: cannot probe an empty build side's key "
                "range; declare JoinConfig.key_range"
            )
    else:
        kr = normalize_key_range(declared, len(right_on))
    prep_sig = dj_ledger.plan_signature(topology, None, right, None, right_on, config)
    tier_r, salt, replicas = _resolve_prepared_tier(topology, right, right_counts, right_on,
                                                    config, prep_sig, forced=tier)
    state = {"config": config, "kr": kr, "probed": probed, "reprobed": False, "tier": tier_r,
             "salt": salt, "replicas": replicas}

    def plan_and_sizing(cfg):
        n, l_cap_m, r_cap_m = _main_group_sizing(topology, cfg, l_cap, r_cap)
        sizing = batch_sizing(cfg, n, l_cap_m, r_cap_m)
        if state["tier"] == plan_adapt.TIER_BROADCAST:
            S = l_cap_m + n * r_cap_m
        elif state["tier"] == plan_adapt.TIER_SALTED:
            S = n * sizing.bl + state["replicas"] * n * sizing.br
        else:
            S = n * (sizing.bl + sizing.br)
        return plan_prepared_pack(state["kr"], dtypes, S), n, sizing, S, r_cap_m

    def packed_plan():
        """(plan, n, sizing, r_cap_m) of the resolved tier. A broadcast
        or salted merged size that does not pack demotes this signature
        to shuffle-prepared; a range that does not pack there either
        raises ValueError."""
        plan, n, sizing, S, r_cap_m = plan_and_sizing(state["config"])
        if plan is None and state["tier"] != plan_adapt.TIER_SHUFFLE:
            _demote_prepared_tier(prep_sig, f"merged size S={S} for tier {state['tier']} does "
                                            f"not pack into the 64-bit word")
            state.update(tier=plan_adapt.TIER_SHUFFLE, salt=(), replicas=1)
            plan, n, sizing, S, r_cap_m = plan_and_sizing(state["config"])
        if plan is None:
            raise ValueError(
                f"prepare_join_side: key range {state['kr']} does not pack into "
                f"the 64-bit word at batch size S={S}; use the unprepared join"
            )
        return plan, n, sizing, r_cap_m

    def run_attempt(attempt):
        # Sized before the guard, so a range that does not pack raises
        # its ValueError and pins no tier.
        sized = packed_plan()

        def build_and_run():
            nonlocal sized
            cfg = resil.strip_pinned_wire(state["config"])
            if state["tier"] != plan_adapt.TIER_SHUFFLE and resil.tier_pinned(_PREPARED_TIER_KEY):
                # A pin landed after the tier was resolved (a retry of
                # this guard, or another call of the process): build the
                # shuffle-prepared baseline instead.
                state.update(tier=plan_adapt.TIER_SHUFFLE, salt=(), replicas=1)
                sized = packed_plan()
            b_plan, b_n, b_sizing, b_r_cap_m = sized
            tier_now, salt_now, replicas_now = state["tier"], state["salt"], state["replicas"]
            if tier_now == plan_adapt.TIER_BROADCAST:
                faults.check("prepare_broadcast")
            elif tier_now == plan_adapt.TIER_SALTED:
                faults.check("prepare_salted")
            faults.check("module_build")
            _pre_shuffle_codec(topology, cfg.right_compression)
            keys = _prep_flag_keys(cfg)

            def run(comm, rt, rc):
                rt = rt.with_count(rc[0])
                if tier_now == plan_adapt.TIER_BROADCAST:
                    batches, flags = _prepare_broadcast(comm, rt, right_on, b_plan, r_cap)
                else:
                    batches, flags = _prepare_batches(comm, cfg, rt, right_on, b_sizing, b_plan,
                                                      r_cap, b_r_cap_m, salt_now, replicas_now)
                return batches, _flag_row(flags, keys)

            batches, flag_mat = _dispatch(
                topology, "prepare", "prepare",
                lambda: run_spmd(topology, run, right, right_counts, **_backend(cfg, flags_at=1)),
                phase="prep")
            return (batches, b_plan, b_n, b_sizing), _flag_info(flag_mat, keys)

        payload, info = resil.degrade_guard("prepare_join_side", build_and_run,
                                            tiers=("wire", _PREPARED_TIER_KEY),
                                            config=state["config"], topology=topology)
        # Fault flag sites prepare.<flag>: forced on the host after the ranks ran.
        return payload, faults.force_flags("prepare", info)

    def _heal_range_violation(info, attempt):
        # Build keys outside the declared range: the anchored words are
        # corrupt, so no other flag of this attempt is trusted.
        if state["probed"]:
            raise RuntimeError(
                "prep_range_violation with a probed key range: the probe "
                "covers the build side by construction; this is a bug"
            )
        new_kr = _probe_side_range(right, right_counts, right_on, topology)
        if new_kr is None:
            raise ValueError(
                "prepare_join_side: declared key_range violated and the "
                "build side probes empty"
            )
        obs.inc("dj_heal_total", flag="prep_range_violation")
        obs.record("heal", stage="prepare", attempt=attempt, flags=["prep_range_violation"],
                   action="reprobe_declared_range", old_key_range=state["kr"],
                   new_key_range=new_kr)
        state.update(kr=new_kr, probed=True, reprobed=True)

    def _apply_ledger(entry):
        # A learned "declared range was violated" repair: probe up front.
        if entry.get("reprobe_declared_range") and not state["probed"]:
            new_kr = _probe_side_range(right, right_counts, right_on, topology)
            if new_kr is not None:
                state.update(kr=new_kr, probed=True, reprobed=True)

    (batches, plan, n, sizing), _, _ = heal_engine.run_healed(
        name="prepare_join_side",
        stage="prepare",
        budget=HealBudget(max_attempts, growth, max_total_growth),
        run_attempt=run_attempt,
        heal_map=_HEAL_FACTORS,
        read_factors=lambda: _config_factors(state["config"]),
        apply_factors=lambda grew: state.update(
            config=dataclasses.replace(state["config"], **grew)
        ),
        poison={"prep_range_violation": _heal_range_violation},
        ledger_key=prep_sig,
        ledger_extra=lambda: {"reprobe_declared_range": True} if state["reprobed"] else {},
        apply_ledger_entry=_apply_ledger,
    )
    return PreparedSide(
        topology=topology, config=state["config"], right_on=right_on, key_range=state["kr"],
        plan=plan, n=n, sizing=sizing, l_cap=l_cap, r_cap=r_cap,
        batches=batches, right=right, right_counts=right_counts,
        tier=state["tier"], salt=state["salt"], salt_replicas=state["replicas"],
    )


def _prepared_query_sizing(
    topology: Topology, config: JoinConfig, l_cap: int, prepared: PreparedSide
) -> tuple[int, int, int, int]:
    """(n, l_cap_main, bl, out_cap) of a query against ``prepared``. The
    left sizing follows the query's config; the right sizing is pinned
    by the prepare. Raises PreparedPlanMismatch when the merged size
    needs another tag width than the prepared words carry.

    Tier-aware (dj_tpu/parallel/dist_join.py:2363-2417): the resident
    rows a rank R are read from the prepared words (shuffle n br,
    broadcast the whole gathered side, salted the rotated windows too).
    A broadcast-prepared query probes the rank's whole left shard (bl =
    l_cap_main, S = bl + R, out_cap = join_out_factor * max(bl, R)); the
    others keep the shuffle tier's left batch."""
    n, l_cap_m, _ = _main_group_sizing(topology, config, l_cap, l_cap)
    if n != prepared.n:
        raise PreparedPlanMismatch(f"main-stage group size {n} != prepared {prepared.n}")
    R = prepared.batches[0][0].shape[0] // topology.local_ranks
    if prepared.tier == plan_adapt.TIER_BROADCAST:
        bl = l_cap_m
        S = bl + R
        out_cap = max(1, int(config.join_out_factor * max(bl, R)))
    else:
        m = n * config.over_decom_factor
        sl = max(1, int(l_cap_m * config.bucket_factor / m))
        bl = l_cap_m if m == 1 else sl
        S = n * bl + R
        out_cap = max(1, int(config.join_out_factor * n * max(sl, prepared.sizing.sr)))
    need = max(1, int(S).bit_length())
    if need != prepared.plan.tag_bits:
        raise PreparedPlanMismatch(
            f"merged size S={S} needs tag_bits={need}, prepared words carry "
            f"{prepared.plan.tag_bits}; re-prepare for the new batch sizing"
        )
    return n, l_cap_m, bl, out_cap


def _check_prepared_query(topology: Topology, left: Table, prepared: PreparedSide,
                          left_on: Sequence[int], config: JoinConfig, what: str) -> tuple:
    """A probe side's structural fit to ``prepared`` (the topology, the
    odf, the key count and dtypes, a capacity of a row a shard): raises
    PreparedPlanMismatch or ValueError; returns ``left_on`` as a tuple."""
    if topology != prepared.topology:
        raise PreparedPlanMismatch("query topology differs from the prepared side's")
    odf = config.over_decom_factor
    if odf != prepared.config.over_decom_factor:
        raise PreparedPlanMismatch(
            f"query over_decom_factor {odf} != prepared "
            f"{prepared.config.over_decom_factor} (the batch count is baked "
            f"into the prepared runs)"
        )
    left_on = tuple(left_on)
    if len(left_on) != len(prepared.right_on):
        raise ValueError(
            f"left_on has {len(left_on)} keys, prepared side was built on "
            f"{len(prepared.right_on)}"
        )
    for k, c_idx in enumerate(left_on):
        col = left.columns[c_idx]
        if not (isinstance(col, Column)
                and str(dt.numpy_dtype(col.data.dtype)) == prepared.plan.key_dtypes[k]):
            raise PreparedPlanMismatch(
                f"left key column {c_idx} dtype differs from the prepared "
                f"plan's {prepared.plan.key_dtypes[k]}"
            )
    w = topology.local_ranks
    if left.capacity < w:
        raise ValueError(
            f"{what}: left capacity {left.capacity} "
            f"< {w} shards here leaves a shard with zero capacity; pad the "
            f"table to >= 1 row per shard"
        )
    return left_on


def _distributed_inner_join_prepared(
    topology: Topology,
    left: Table,
    left_counts: torch.Tensor,
    prepared: PreparedSide,
    left_on: Sequence[int],
    config: Optional[JoinConfig] = None,
) -> tuple[Table, torch.Tensor, dict]:
    """The per-query half of the prepared join: partition the probe
    side, then per batch a single-table shuffle and
    ``inner_join_prepared`` against the resident run; on a salted side
    the probe rows are salted as the side's heavy partitions were
    copied; on a broadcast side one local ``inner_join_prepared`` of
    the rank's whole left shard, with no partition and no collective.
    No range probe: the plan is pinned, and probe keys outside it raise
    the prepared_plan_mismatch flag. Under ``DJT_SHAPE_BUCKET=1`` the
    probe side is padded to its shape bucket first."""
    if config is None:
        config = prepared.config
    with call_span("dj_call", topology.device):
        left, left_on = _prepared_query_job(topology, left, prepared, left_on, config,
                                            "distributed_inner_join(prepared)")
        return _run_prepared_queries(topology, [left], [left_counts], prepared, left_on, config,
                                     stage="prepared_query", path="prepared",
                                     where="distributed_inner_join(prepared)")[0]


def _prepared_query_job(topology: Topology, left: Table, prepared: PreparedSide,
                        left_on: Sequence[int], config: JoinConfig, what: str) -> tuple:
    """The set-up of one query against ``prepared``, for the entry and
    the autotuner's ``price_plan_candidate`` alike: the structural fit
    (``_check_prepared_query``), then the probe side padded to its shape
    bucket. Returns ``(left, left_on)``."""
    left_on = _check_prepared_query(topology, left, prepared, left_on, config, what)
    return shape_bucket.bucket_table(topology, left), left_on


def _run_prepared_queries(
    topology: Topology, lefts: Sequence[Table], left_counts: Sequence[torch.Tensor],
    prepared: PreparedSide, left_on: tuple, config: JoinConfig, *, stage: str, path: str,
    where: str,
) -> list:
    """K same-shaped queries against ``prepared`` in one run
    (``_prepared_attempt``), guarded by the degradation ladder as
    ``where`` (the merge, wire, expand and prepared_tier tiers). Each
    member's probe side is observed for skew under ``path`` as its stage
    (``_observe_partition_skew``), but on a broadcast side. Returns one
    (result, counts, info) a member, each member's flags through the
    ``prepared.<flag>`` fault sites."""
    sizing = _prepared_query_sizing(topology, config, lefts[0].capacity // topology.local_ranks,
                                    prepared)
    if prepared.tier != plan_adapt.TIER_BROADCAST:
        # A broadcast-prepared query partitions nothing: no skew to see.
        for lt, lc in zip(lefts, left_counts):
            _observe_partition_skew(topology, lt, lc, left_on, config.over_decom_factor,
                                    stage=path, config=config)
    outs, counts, flag_mat, keys = resil.degrade_guard(
        where, lambda: _prepared_attempt(topology, lefts, left_counts, prepared, left_on, config,
                                         sizing, stage=stage, path=path),
        tiers=("merge", "wire", "expand", _PREPARED_TIER_KEY), config=config,
        topology=topology)
    return _members(outs, counts, flag_mat, keys, "prepared")


def _prepared_attempt(
    topology: Topology, lefts: Sequence[Table], left_counts: Sequence[torch.Tensor],
    prepared: PreparedSide, left_on: tuple, config: JoinConfig, sizing: tuple, *, stage: str,
    path: str, ladder: bool = True,
):
    """One attempt of K queries against ``prepared`` at ``sizing``
    (``_prepared_query_sizing``): per rank, each member's pre-shuffle
    (two-level topologies), then ``_prepared_query`` (every member's
    batch window in one epoch), or on a broadcast side K local probes
    with no collective; one ``_dispatch`` under ``stage`` and ``path``.
    Returns ``(outs, counts, flag matrix, flag keys)``.

    With ``ladder`` (a real query) it first reads the ladder: a
    broadcast or salted side whose tier the ladder pinned raises
    PreparedPlanMismatch, so the auto wrapper re-prepares it on shuffle,
    and the fault sites of the prepared tiers, ``module_build``,
    ``codec`` and the merge tier's are consulted. The autotuner's probe
    passes ``ladder=False``: it times the dispatch alone, consults no
    site a real query does and so takes no pin inside its candidate's
    env (its one site is ``autotune_probe``), as dj_tpu's probe runs a
    compiled executable."""
    _, l_cap_m, bl, out_cap = sizing
    odf = config.over_decom_factor
    l_cap = lefts[0].capacity // topology.local_ranks
    plan = prepared.plan
    cfg = resil.strip_pinned_wire(config)
    if ladder:
        if prepared.tier != plan_adapt.TIER_SHUFFLE and resil.tier_pinned(_PREPARED_TIER_KEY):
            # The ladder pinned shuffle-prepared (a replication tier's
            # fault, here or in another call): this side's replicated
            # runs must not serve.
            raise PreparedPlanMismatch(
                f"prepared tier {prepared.tier!r} is pinned to the shuffle-prepared baseline; "
                f"re-prepare"
            )
        if prepared.tier == plan_adapt.TIER_BROADCAST:
            faults.check("bc_prepared_query")
        elif prepared.tier == plan_adapt.TIER_SALTED:
            faults.check("salted_prepared_query")
        faults.check("module_build")
        if prepared.tier != plan_adapt.TIER_BROADCAST:
            _pre_shuffle_codec(topology, cfg.left_compression)
        _merge_tier_sites()
    keys = _prepared_flag_keys(cfg)

    def run(comm, lts, lcs, batches):
        lts = [lt.with_count(lc[0]) for lt, lc in zip(lts, lcs)]
        if prepared.tier == plan_adapt.TIER_BROADCAST:
            members = [_bc_prepared_query(comm, lt, left_on, batches[0], plan, out_cap,
                                          cfg.char_out_factor) for lt in lts]
        else:
            pre = [_pre_shuffle_one(comm, cfg, lt, left_on, l_cap, l_cap_m,
                                    cfg.left_compression) for lt in lts]
            members = _prepared_query(comm, [lt for lt, _, _ in pre], left_on, batches, plan,
                                      odf, bl, out_cap, cfg.char_out_factor, prepared.salt,
                                      prepared.salt_replicas)
            for (_, flags), (_, pre_ovf, pre_stats) in zip(members, pre):
                flags.update(pre_shuffle_overflow=pre_ovf, **pre_stats)
        return (tuple(out.with_count(None) for out, _ in members),
                tuple(out.count().reshape(1) for out, _ in members),
                torch.stack([_flag_row(flags, keys)[0] for _, flags in members])[None])

    outs, counts, flag_mat = _dispatch(
        topology, stage, stage,
        lambda: run_spmd(topology, run, tuple(lefts), tuple(left_counts), prepared.batches,
                         **_backend(cfg)),
        path=path, queries=len(lefts))
    return outs, counts, flag_mat, keys


def _bc_prepared_query(
    comm: Communicator, left: Table, left_on: tuple, batch: tuple, plan: PreparedPackPlan,
    out_cap: int, char_out_factor: float,
) -> tuple[Table, dict]:
    """One rank's broadcast-prepared query (dj_tpu's
    ``_build_bc_prepared_query_fn``, dist_join.py:2542-2604): the rank's
    whole left shard against its replicated resident run, one
    ``inner_join_prepared``; no partition and no collective, so
    shuffle_overflow cannot fire."""
    words, ptab, pcnt = batch
    comm.phase("dj_join")
    result, total, jflags = inner_join_prepared(
        left, left_on, words, ptab.with_count(pcnt[0]), plan,
        out_capacity=out_cap, char_out_factor=char_out_factor,
    )
    no = torch.tensor(False, device=left.device)
    return result, {
        "pre_shuffle_overflow": no,
        "shuffle_overflow": no,
        "join_overflow": total > out_cap,
        "char_overflow": _char_overflow(result, no),
        "prepared_plan_mismatch": jflags["prepared_plan_mismatch"],
    }


def _prepared_query(
    comm: Communicator, lefts: Sequence[Table], left_on: tuple, batches: tuple,
    plan: PreparedPackPlan, odf: int, bl: int, out_cap: int, char_out_factor: float,
    salt: tuple = (), replicas: int = 1,
) -> list[tuple[Table, dict]]:
    """One rank's queries (the body of dj_tpu's _build_prepared_query_fn
    after its pre-shuffle, and of _build_coalesced_query_fn for K
    members): partition each probe side, then per batch ONE exchange
    epoch of every member's window (batch b+1's issued before batch b's
    joins) and each member's ``inner_join_prepared`` against the rank's
    resident run; each output string column's char_overflow raises the
    flag. With a ``salt`` set (a salted side, dj_tpu's
    ``_build_salted_prepared_query_fn``) the partition ids are salted
    over ``replicas`` peers first. Returns (result, flags) per member."""
    n = comm.size
    m = n * odf
    parts = []
    for left in lefts:
        comm.phase("dj_partition")
        if salt:
            pid = salted_partition_ids(partition_ids(left, left_on, m, seed=MAIN_JOIN_SEED), m, n,
                                       salt, replicas)
            parts.append(partition_by_ids(left, pid, m))
        else:
            parts.append(hash_partition(left, left_on, m, seed=MAIN_JOIN_SEED))
    k = len(parts)

    def issue(b: int):
        starts = [offsets[b * n : (b + 1) * n] for _, offsets in parts]
        counts = [offsets[b * n + 1 : (b + 1) * n + 1] - st
                  for (_, offsets), st in zip(parts, starts)]
        comm.phase("dj_exchange")
        return shuffle_tables_start(comm, [p for p, _ in parts], starts, counts, [bl] * k,
                                    [n * bl] * k)

    no = torch.tensor(False, device=lefts[0].device)
    flags = [{"pre_shuffle_overflow": no, "shuffle_overflow": no, "join_overflow": no,
              "char_overflow": no, "prepared_plan_mismatch": no} for _ in range(k)]
    batch_results: list = [[] for _ in range(k)]
    inflight = issue(0)
    for b in range(odf):
        # Batch b+1's exchange is issued before batch b's joins
        # (dj_tpu/parallel/dist_join.py:1165-1183).
        prefetch = issue(b + 1) if b + 1 < odf else None
        received = inflight.wait()
        inflight = prefetch
        words_b, ptab_b, pcnt_b = batches[b]
        for q in range(k):
            l_batch, _, ovf, _ = received[q]
            received[q] = None  # free the batch after its join
            f = flags[q]
            f["shuffle_overflow"] = f["shuffle_overflow"] | ovf
            comm.phase("dj_join")
            result, total, jflags = inner_join_prepared(
                l_batch, left_on, words_b, ptab_b.with_count(pcnt_b[0]), plan,
                out_capacity=out_cap, char_out_factor=char_out_factor,
            )
            del l_batch
            f["join_overflow"] = f["join_overflow"] | (total > out_cap)
            f["prepared_plan_mismatch"] = f["prepared_plan_mismatch"] | jflags[
                "prepared_plan_mismatch"]
            f["char_overflow"] = _char_overflow(result, f["char_overflow"])
            batch_results[q].append(result)
    out = []
    for q in range(k):
        comm.phase("dj_concat")
        res = batch_results[q]
        out.append((res[0] if odf == 1 else concatenate(res), flags[q]))
    return out


def _reprepare(
    topology: Topology, left: Table, left_counts: torch.Tensor, prepared: PreparedSide,
    left_on, config: JoinConfig,
) -> PreparedSide:
    """Re-prepare under a range widened to cover the probe side (the
    prepared_plan_mismatch heal, dj_tpu/parallel/dist_join.py:2853-2888):
    the union of the prepared range and the left side's probed bounds,
    the current (possibly grown) factors, a tag field sized for the
    actual left capacity, and the side's own tier (revalidated: a
    misfit lands on shuffle)."""
    left_range = _probe_side_range(left, left_counts, tuple(left_on), topology)
    kr = prepared.key_range
    if left_range is not None:
        kr = tuple((min(a_lo, b_lo), max(a_hi, b_hi))
                   for (a_lo, a_hi), (b_lo, b_hi) in zip(kr, left_range))
    left_capacity = left.capacity * topology.world_size // topology.local_ranks
    return prepare_join_side(
        topology, prepared.right, prepared.right_counts, prepared.right_on, config,
        left_capacity=left_capacity, key_range=kr, tier=prepared.tier,
    )


def _distributed_inner_join_prepared_auto(
    topology: Topology,
    left: Table,
    left_counts: torch.Tensor,
    prepared: PreparedSide,
    left_on: Sequence[int],
    config: Optional[JoinConfig],
    *,
    max_attempts: int = 8,
    growth: float = 2.0,
    max_total_growth: float = 4096.0,
):
    """The prepared half of distributed_inner_join_auto
    (dj_tpu/parallel/dist_join.py:2893-3040): capacity flags grow the
    offending factor and reuse the prepared batches; a mismatch (the
    flag, or PreparedPlanMismatch raised by the query) re-prepares under
    the widened range. The query's config starts at least as wide as the
    prepared side's settled factors, and stays so after a re-prepare, or
    the tag width would mismatch again on every attempt."""
    if config is None:
        config = prepared.config
    else:
        wider = dj_ledger.wider_factors(_config_factors(prepared.config),
                                        _config_factors(config))
        if wider:
            config = dataclasses.replace(config, **wider)
    state = {"config": config, "prepared": prepared}

    def _adopt_settled(new_prepared):
        wider = dj_ledger.wider_factors(_config_factors(new_prepared.config),
                                        _config_factors(state["config"]))
        if wider:
            state["config"] = dataclasses.replace(state["config"], **wider)

    def run_attempt(attempt):
        out, counts, info = _distributed_inner_join_prepared(
            topology, left, left_counts, state["prepared"], left_on, state["config"],
        )
        return (out, counts), info

    def _reprepare_heal(cause, attempt):
        # Left keys outside the prepared anchors (the flag), or a probe
        # side the plan cannot take (the exception): the packed words do
        # not compare, so no other flag of this attempt is trusted.
        new_prepared = _reprepare(topology, left, left_counts, state["prepared"], left_on,
                                  state["config"])
        structural = isinstance(cause, Exception)
        reason = "structural" if structural else "plan_mismatch"
        obs.inc("dj_reprepare_total", reason=reason)
        fields = dict(stage="join", attempt=attempt, reason=reason,
                      old_key_range=state["prepared"].key_range,
                      new_key_range=new_prepared.key_range)
        if structural:
            fields["detail"] = str(cause)[:300]
        obs.record("reprepare", **fields)
        state["prepared"] = new_prepared
        state["config"] = dataclasses.replace(
            state["config"], over_decom_factor=new_prepared.config.over_decom_factor)
        _adopt_settled(new_prepared)

    (out, counts), info, _ = heal_engine.run_healed(
        name="distributed_inner_join_auto (prepared)",
        stage="join",
        budget=HealBudget(max_attempts, growth, max_total_growth),
        run_attempt=run_attempt,
        # The query's flags heal the same factors, which size the left
        # side only: the prepared batches stay as they are (a growth that
        # shifts the merged tag width raises PreparedPlanMismatch, and
        # that re-prepares).
        heal_map=_HEAL_FACTORS,
        read_factors=lambda: _config_factors(state["config"]),
        apply_factors=lambda grew: state.update(
            config=dataclasses.replace(state["config"], **grew)
        ),
        poison={"prepared_plan_mismatch": _reprepare_heal},
        mismatch_excs=(PreparedPlanMismatch,),
        on_mismatch=_reprepare_heal,
        ledger_key=dj_ledger.plan_signature(topology, left, prepared, left_on, None, config),
    )
    return out, counts, info, state["config"], state["prepared"]


# --- coalesced dispatches ------------------------------------------------
#
# K same-shaped queries served in one run (dj_tpu/parallel/dist_join.py:
# 3043-3830): per odf batch, the K members' exchange windows ride ONE
# epoch (batch b+1's issued before batch b's joins), so a server answers
# K queries with odf epochs instead of K odf. Each member is sized as the
# same query alone would be, so its rows and flags are that query's, and
# a member whose flags fire can be served again alone by
# distributed_inner_join_auto. Shape bucketing makes near-miss shapes
# one group: every member is padded to its bucket before the check that
# all share one capacity and schema.


def _same_shape(tables: Sequence[Table], what: str) -> None:
    sig0 = dj_ledger.table_sig(tables[0])
    for t in tables[1:]:
        if t.capacity != tables[0].capacity or dj_ledger.table_sig(t) != sig0:
            raise ValueError(
                f"{what}: every left (and every right) table must share one capacity and "
                f"column schema (coalesce groups are same-signature by construction)"
            )


def _ledger_widened(config: JoinConfig, sig: str) -> JoinConfig:
    """``config`` with the factors the ledger learned for ``sig`` where
    they are wider: a signature that healed must run coalesced at its
    healed factors, or every member would overflow again."""
    entry = dj_ledger.consult(sig)
    if entry is not None:
        widened = dj_ledger.wider_factors(entry.get("factors", {}), _config_factors(config))
        if widened:
            config = dataclasses.replace(config, **widened)
    return config


def _members(outs, counts, flag_mat: torch.Tensor, keys, stage: str) -> list:
    """One (result, counts, info) a member of a run; each member's flags
    go through the fault flag sites ``<stage>.<flag>`` (one consultation
    a member, as dj_tpu's)."""
    with span("dj_flags"):
        return [(outs[q], counts[q], faults.force_flags(stage, _flag_info(flag_mat[:, q], keys)))
                for q in range(len(outs))]


def distributed_inner_join_coalesced(
    topology: Topology,
    lefts: Sequence[Table],
    left_counts: Sequence[torch.Tensor],
    prepared: PreparedSide,
    left_on: Sequence[int],
    config: Optional[JoinConfig] = None,
) -> tuple[list[tuple[Table, torch.Tensor, dict]], JoinConfig]:
    """K same-shaped queries against one PreparedSide in one run
    (dj_tpu's ``distributed_inner_join_coalesced``, dist_join.py:
    3277-3485; section comment above).

    Every left table must share the first's capacity and column schema
    after shape bucketing (ValueError otherwise). The checks and the
    sizing are the singleton prepared query's (PreparedPlanMismatch
    where it raises), at the config's factors widened by the ledger's
    for this signature. On a shuffle-prepared side each odf batch's K
    windows ride one exchange epoch; on a salted side each member's
    partition ids are salted as a singleton query's; on a
    broadcast-prepared side the members are K local probes with no
    collective at all.

    Returns ``(per_query, config_used)``: one (result, counts, info) per
    member, in the order of ``lefts``, each equal to the same query
    served alone, and the config the members ran with."""
    if config is None:
        config = prepared.config
    if not lefts or len(left_counts) != len(lefts):
        raise ValueError("distributed_inner_join_coalesced: one count vector per left table, "
                         "and at least one left table")
    with call_span("dj_call", topology.device):
        lefts = [shape_bucket.bucket_table(topology, t) for t in lefts]
        _same_shape(lefts, "distributed_inner_join_coalesced")
        left_on = _check_prepared_query(topology, lefts[0], prepared, left_on, config,
                                        "distributed_inner_join_coalesced")
        config = _ledger_widened(config, dj_ledger.plan_signature(topology, lefts[0], prepared,
                                                                  left_on, None, config))
        return _run_prepared_queries(topology, lefts, left_counts, prepared, left_on, config,
                                     stage="coalesced_query", path="coalesced",
                                     where="distributed_inner_join_coalesced"), config


def _union_key_ranges(ranges):
    """The key range a coalesced unprepared group plans with: per key the
    union of the members' resolved ranges (canonical width forms, so the
    widest member's); any member None (string or float keys, the probe
    off) gives None, the dynamic plan."""
    if not ranges or any(r is None for r in ranges):
        return None
    return tuple((min(lo for lo, _ in per_key), max(hi for _, hi in per_key))
                 for per_key in zip(*ranges))


def distributed_inner_join_coalesced_unprepared(
    topology: Topology,
    lefts: Sequence[Table],
    left_counts: Sequence[torch.Tensor],
    rights: Sequence[Table],
    right_counts: Sequence[torch.Tensor],
    left_on: Sequence[int],
    right_on: Sequence[int],
    config: Optional[JoinConfig] = None,
) -> tuple[list[tuple[Table, torch.Tensor, dict]], JoinConfig]:
    """K same-shaped unprepared joins in one run (dj_tpu's
    ``distributed_inner_join_coalesced_unprepared``, dist_join.py:
    3646-3830; section comment above): each member's two tables
    partitioned, each odf batch's 2K windows in one exchange epoch, each
    member joined at the singleton ``batch_sizing``, all under the union
    of the members' resolved key ranges (``_union_key_ranges``).

    Every left (and every right) table must share one capacity and
    column schema after shape bucketing. Flat topologies only, and only
    with the planner off: ValueError on a two-level topology or under
    ``DJT_PLAN_ADAPT`` (its broadcast and salted plans are per-query
    decisions one shuffle dispatch cannot honor), as in dj_tpu. Returns
    ``(per_query, config_used)`` as ``distributed_inner_join_coalesced``."""
    if config is None:
        config = JoinConfig()
    with call_span("dj_call", topology.device):
        what = "distributed_inner_join_coalesced_unprepared"
        for q, (lt, rt) in enumerate(zip(lefts, rights)):
            _check_key_widths(lt.columns, rt.columns, left_on, right_on, f"{what} (member {q})")
        if topology.is_hierarchical:
            raise ValueError(f"{what} supports flat topologies only; dispatch two-level queries "
                             f"one at a time")
        if plan_adapt.enabled():
            raise ValueError(f"{what} requires the adaptive planner off (DJT_PLAN_ADAPT): its "
                             f"broadcast and salted tiers are per-query plan decisions that one "
                             f"shuffle dispatch cannot honor; dispatch one at a time")
        k = len(lefts)
        if not k or len(rights) != k or len(left_counts) != k or len(right_counts) != k:
            raise ValueError(f"{what}: as many right tables and count vectors as left tables, and "
                             f"at least one")
        lefts = [shape_bucket.bucket_table(topology, t) for t in lefts]
        rights = [shape_bucket.bucket_table(topology, t) for t in rights]
        _same_shape(lefts, what)
        _same_shape(rights, what)
        left_on, right_on = tuple(left_on), tuple(right_on)
        w = topology.local_ranks
        if lefts[0].capacity < w or rights[0].capacity < w:
            raise ValueError(f"{what}: table capacity {min(lefts[0].capacity, rights[0].capacity)} "
                             f"< {w} shards here leaves a shard with zero capacity; pad the tables "
                             f"to >= 1 row per shard")
        config = _ledger_widened(config, dj_ledger.plan_signature(topology, lefts[0], rights[0],
                                                                  left_on, right_on, config))
        with obs_roofline.phase("probe", stage="join"), span("dj_range_probe"):
            key_range = _union_key_ranges([
                _resolve_key_range(config, lefts[q], left_counts[q], rights[q], right_counts[q],
                                   left_on, right_on, w, topology)
                for q in range(k)
            ])
        for q in range(k):
            _observe_partition_skew(topology, lefts[q], left_counts[q], left_on,
                                    config.over_decom_factor, stage="coalesced", config=config)
        l_cap, r_cap = lefts[0].capacity // w, rights[0].capacity // w

        def attempt():
            cfg = resil.strip_pinned_wire(config)
            faults.check("module_build")
            keys = _flag_keys(cfg)

            def run(comm, lts, lcs, rts, rcs):
                members = _shuffle_join_members(
                    comm, [(lt.with_count(lc[0]), rt.with_count(rc[0]))
                           for lt, lc, rt, rc in zip(lts, lcs, rts, rcs)],
                    left_on, right_on, cfg, l_cap, r_cap, key_range)
                return (tuple(out.with_count(None) for out, _ in members),
                        tuple(out.count().reshape(1) for out, _ in members),
                        torch.stack([_flag_row(flags, keys)[0] for _, flags in members])[None])

            outs, counts, flag_mat = _dispatch(
                topology, "coalesced_join", "coalesced_join",
                lambda: run_spmd(topology, run, tuple(lefts), tuple(left_counts), tuple(rights),
                                 tuple(right_counts), **_backend(cfg)),
                path="coalesced_unprepared", queries=k)
            return outs, counts, flag_mat, keys

        outs, counts, flag_mat, keys = resil.degrade_guard(
            "distributed_inner_join_coalesced_unprepared", attempt, tiers=("wire",), config=config,
            topology=topology)
        return _members(outs, counts, flag_mat, keys, "join"), config


# --- appends to a prepared side -------------------------------------------
#
# The incremental alternative to a fresh prepare (dj_tpu/parallel/
# dist_join.py:3810-4144): the appended rows are hash-partitioned with the
# prepare's seed, so they land in the odf batches of the resident rows
# they join; only the batches that receive rows are shuffled, packed
# under the same anchored plan with tags past the resident ranks and
# merged into the resident run, keeping its capacity and tag width, so a
# query's sizing does not change. Untouched batches keep their tensors.
# A broadcast or salted side holds copies of its rows on other ranks, so
# it re-prepares on its tier instead.

_APPEND_FLAG_KEYS = (
    "append_shuffle_overflow",
    "append_overflow",
    "prepared_plan_mismatch",
)


def combine_prepared_source(
    topology: Topology, prepared: PreparedSide, rows: Table, rows_counts: torch.Tensor,
) -> tuple[Table, torch.Tensor]:
    """The prepared side's source table with ``rows`` appended: per
    shard, the row-compacting ``concatenate`` of the source and the
    appended block (capacity grows by the appended capacity). Returns
    (table, counts) sharded like the source."""

    def run(comm, rt, rc, at, ac):
        out = concatenate([rt.with_count(rc[0]), at.with_count(ac[0])])
        return out.with_count(None), out.count().reshape(1)

    return run_spmd(topology, run, prepared.right, prepared.right_counts, rows, rows_counts)


def append_to_prepared(
    topology: Topology, prepared: PreparedSide, rows: Table, rows_counts: torch.Tensor,
) -> tuple[PreparedSide, dict]:
    """Merge appended build rows into the resident runs, re-sorting only
    the odf batches that receive rows (``append_to_prepared``,
    dj_tpu/parallel/dist_join.py:3978-4144).

    ``rows`` carries the prepared source's column schema, sharded like it
    (at least one row of capacity a shard). First each rank partitions
    its appended rows with the prepare's seed and counts each batch's
    rows; the counts are gathered over the world, so every rank (every
    process of a process world) merges the same batches. Then each
    touched batch: a single-table shuffle at the appended capacity a
    peer (it cannot overflow, whatever the skew; the flag is kept), the
    anchored pack with tags offset past the resident run, and
    ``merge_packed_batch``.

    Returns (new_prepared, info): the new side shares every untouched
    batch (the same tensors), holds the combined source
    (``combine_prepared_source``) and an ``r_cap`` grown by the appended
    capacity a shard. ``info`` maps append_shuffle_overflow,
    append_overflow (resident and appended rows exceed a batch's
    capacity) and prepared_plan_mismatch (appended keys outside the
    anchored plan) to bool[world], and ``touched`` to the merged batch
    ids (a host tuple). Any fired flag leaves the touched runs
    unspecified: discard the side and re-prepare from its source.

    A broadcast- or salted-prepared side holds copies of its rows on
    other ranks (the whole gathered side, or the rotated heavy windows):
    merging into one rank's run would leave the copies stale. Such a
    side re-prepares on its own tier from the combined source, under its
    key range widened to the appended rows (dj_tpu/parallel/
    dist_join.py:4041-4080); ``info`` then marks every batch touched
    and no flag fired (the re-prepare heals its own overflows).

    Raises PreparedPlanMismatch for a hierarchical topology (the rows
    would need the pre-shuffle re-run), a schema other than the source's
    and an appended capacity the tag field cannot hold; ValueError for a
    shard with zero appended capacity. Counts
    ``dj_prepared_append_total{batches}`` (the merged batches), and a
    re-prepare records its ``reprepare`` event with
    ``dj_reprepare_total{reason="append"}``, as dj_tpu does. The fault
    site ``module_build`` is consulted before the merge's first dispatch,
    and the flags go through the ``append.<flag>`` flag sites."""
    if topology.is_hierarchical:
        raise PreparedPlanMismatch(
            "append_to_prepared does not support hierarchical topologies (the "
            "appended rows would need the inter-domain pre-shuffle re-run); "
            "re-prepare instead"
        )
    if dj_ledger.table_sig(rows) != dj_ledger.table_sig(prepared.right):
        raise PreparedPlanMismatch(
            "appended rows' column schema differs from the prepared source table's"
        )
    w = topology.local_ranks
    if rows.capacity < w:
        raise ValueError(
            f"append_to_prepared: appended capacity {rows.capacity} < {w} shards "
            f"here leaves a shard with zero capacity; pad to >= 1 row per shard"
        )
    if prepared.tier != plan_adapt.TIER_SHUFFLE:
        new_right, new_rc = combine_prepared_source(topology, prepared, rows, rows_counts)
        kr = prepared.key_range
        src_range = _probe_side_range(new_right, new_rc, prepared.right_on, topology)
        if src_range is not None:
            kr = tuple((min(a_lo, b_lo), max(a_hi, b_hi))
                       for (a_lo, a_hi), (b_lo, b_hi) in zip(kr, src_range))
        new_prepared = prepare_join_side(
            topology, new_right, new_rc, prepared.right_on, prepared.config,
            left_capacity=prepared.l_cap * topology.world_size, key_range=kr,
            tier=prepared.tier,
        )
        obs.inc("dj_reprepare_total", reason="append")
        obs.record("reprepare", stage="append", attempt=1, reason="append",
                   old_key_range=prepared.key_range, new_key_range=new_prepared.key_range,
                   detail=f"tier={prepared.tier}")
        obs.inc("dj_prepared_append_total", batches=str(len(new_prepared.batches)))
        none = torch.zeros(topology.world_size, dtype=torch.bool, device=topology.device)
        info = dict.fromkeys(_APPEND_FLAG_KEYS, none)
        info["touched"] = tuple(range(len(new_prepared.batches)))
        return new_prepared, faults.force_flags("append", info)
    config = resil.strip_pinned_wire(prepared.config)
    right_on, plan, n = prepared.right_on, prepared.plan, prepared.n
    odf = config.over_decom_factor
    m = n * odf
    a_cap = rows.capacity // w
    R = n * prepared.sizing.br
    if R + n * a_cap > (1 << plan.tag_bits) - 1:
        raise PreparedPlanMismatch(
            f"append batch capacity {n * a_cap} does not fit the prepared tag "
            f"field (tag_bits={plan.tag_bits}, resident R={R}); re-prepare, or "
            f"append in smaller slices"
        )

    faults.check("module_build")

    def probe(comm, at, ac):
        comm.phase("dj_partition")
        _, offsets = hash_partition(at.with_count(ac[0]), right_on, m, seed=MAIN_JOIN_SEED)
        return (torch.stack([offsets[(b + 1) * n] - offsets[b * n] for b in range(odf)])
                .reshape(1, odf),)

    (per_rank,) = run_spmd(topology, probe, rows, rows_counts, **_backend(config, flags_at=0))
    per_batch = per_rank.sum(dim=0).tolist()
    touched = tuple(b for b in range(odf) if per_batch[b] > 0)
    new_batches = list(prepared.batches)
    if touched:
        def merge(comm, at, ac, batches):
            comm.phase("dj_partition")
            part, offsets = hash_partition(at.with_count(ac[0]), right_on, m,
                                           seed=MAIN_JOIN_SEED)
            no = torch.tensor(False, device=at.device)
            flags = dict.fromkeys(_APPEND_FLAG_KEYS, no)
            outs = []
            for b, (words_b, ptab_b, pcnt_b) in zip(touched, batches):
                starts = offsets[b * n : (b + 1) * n]
                counts = offsets[b * n + 1 : (b + 1) * n + 1] - starts
                comm.phase("dj_exchange")
                a_batch, _, a_ovf, _ = shuffle_table(comm, part, starts, counts, a_cap, n * a_cap)
                comm.phase("dj_append_merge")
                a_words, ok = _anchored_pack_word(a_batch, right_on, plan, words_b.shape[0])
                words, payload, count, over = merge_packed_batch(
                    words_b, ptab_b.with_count(pcnt_b[0]), a_batch, a_words, right_on, plan)
                del a_batch, a_words
                flags["append_shuffle_overflow"] = flags["append_shuffle_overflow"] | a_ovf
                flags["append_overflow"] = flags["append_overflow"] | over
                flags["prepared_plan_mismatch"] = flags["prepared_plan_mismatch"] | ~ok
                outs.append((words, payload.with_count(None), count.reshape(1)))
            return tuple(outs), _flag_row(flags, _APPEND_FLAG_KEYS)

        merged, flag_mat = run_spmd(topology, merge, rows, rows_counts,
                                    tuple(prepared.batches[b] for b in touched),
                                    **_backend(config, flags_at=1))
        for b, batch in zip(touched, merged):
            new_batches[b] = batch
        info = _flag_info(flag_mat, _APPEND_FLAG_KEYS)
    else:
        none = torch.zeros(topology.world_size, dtype=torch.bool, device=topology.device)
        info = dict.fromkeys(_APPEND_FLAG_KEYS, none)
    new_right, new_rc = combine_prepared_source(topology, prepared, rows, rows_counts)
    obs.inc("dj_prepared_append_total", batches=str(len(touched)))
    info["touched"] = touched
    # Fault flag sites append.<flag>: forced on the host after the merge.
    info = faults.force_flags("append", info)
    return dataclasses.replace(
        prepared, batches=tuple(new_batches), right=new_right, right_counts=new_rc,
        r_cap=prepared.r_cap + a_cap,
    ), info


# --- candidate pricing (parallel.autotune) ---------------------------------


def _candidate_plan(left: Table, right: Table, left_on: tuple, right_on: tuple, key_range):
    """The ``ops.join.JoinPlan`` an unprepared candidate prices: the
    join's own (``join_plan``) on fixed-width keys; with a string key
    pair, the plan of its int64 surrogate beside string payloads (the
    surrogates are not computed for a price)."""
    if any(isinstance(left.columns[c], StringColumn) for c in left_on):
        return effective_plan(1, single_int_key=len(left_on) == 1, has_strings=True)
    return join_plan(left, right, left_on, right_on, key_range)


def price_plan_candidate(
    topology: Topology,
    left: Table,
    left_counts: torch.Tensor,
    right,
    right_counts: Optional[torch.Tensor] = None,
    left_on: Sequence[int] = (),
    right_on: Optional[Sequence[int]] = None,
    config: Optional[JoinConfig] = None,
    *,
    salt_replicas: Optional[int] = None,
):
    """Price ONE candidate plan for the autotuner (dj_tpu's
    ``price_plan_candidate``, dist_join.py:4147-4261). dj_tpu compiles
    the candidate's module and reads XLA's cost and memory analyses; the
    port compiles no module, so the price is the byte model of the
    candidate's plan: ``bytes_accessed`` is ``obs.bytemodel.
    hbm_model_bytes`` of its ``JoinPlan``, plan tier (the signature's
    ``_resolve_plan_decision``, or the prepared side's tier), odf and the
    shard's row capacities, with the batch sizing's ``out_cap`` as its
    matches and the main group's size as its world; ``flops``,
    ``peak_hbm_bytes`` and the argument, output and temp fields are None,
    so the tuner ranks by bytes.

    The set-up is the real call's (``_unprepared_job``, or
    ``_prepared_query_job`` and ``_prepared_query_sizing``), so the price
    and the probe are of the plan the real call runs. Returns ``(price,
    probe)``: ``probe()`` runs the candidate's dispatch once (``_run_join``
    on the decided tier, or ``_prepared_attempt`` against a PreparedSide,
    under the caller's env overrides) without the degradation ladder
    (``ladder=False``: no pin can be taken inside the candidate's env, and
    a failure propagates to the tuner's caller, whose guard pins tier
    ``autotune``), synchronizes the card, frees the output and returns its
    host-clock seconds. The pricing and
    the probe run under ``obs.recorder.suppress_epochs``: tuning counts
    no collective, wire-matrix byte, tenant byte, dispatch or query, and
    observes no skew, as dj_tpu's probe of an AOT executable counts none.

    ``salt_replicas`` overrides a salted decision's fan-out (the tuner's
    salt axis); other plans ignore it."""
    from ..obs.bytemodel import hbm_model_bytes

    if config is None:
        config = JoinConfig()
    cfg = resil.strip_pinned_wire(config)
    w = topology.local_ranks
    odf = cfg.over_decom_factor
    with obs_recorder.suppress_epochs():
        if isinstance(right, PreparedSide):
            prepared = right
            left_b, left_on = _prepared_query_job(topology, left, prepared, left_on, cfg,
                                                  "price_plan_candidate")
            sizing = _prepared_query_sizing(topology, cfg, left_b.capacity // w, prepared)
            n, l_cap_m, _, out_cap = sizing
            model = hbm_model_bytes(
                l_cap_m, odf, cfg, out_cap, JoinPlan("vmeta", True, False), prepared=True,
                merge_impl=resolve_merge_impl(), plan_tier=prepared.tier,
                right_rows=prepared.r_cap, world=n, salt_replicas=prepared.salt_replicas)
            tier = "prepared"

            def dispatch():
                return _prepared_attempt(topology, [left_b], [left_counts], prepared, left_on,
                                         cfg, sizing, stage="prepared_query", path="prepared",
                                         ladder=False)
        else:
            job = _unprepared_job(topology, left, left_counts, right, right_counts, left_on,
                                  right_on, cfg, "price_plan_candidate")
            decision = job.decision
            replicas = decision.replicas
            if decision.tier == plan_adapt.TIER_SALTED and salt_replicas is not None:
                replicas = max(2, min(topology.world_group().size, int(salt_replicas)))
            n, l_cap_m, r_cap_m = _main_group_sizing(topology, cfg, job.left.capacity // w,
                                                     job.right.capacity // w)
            if decision.tier in (plan_adapt.TIER_BROADCAST, TIER_LOCAL):
                # One join of the shard against the gathered (or the
                # co-partitioned) build side, at the output capacity its
                # run gives it, which no over-decomposition splits: the
                # candidates' odf leaves the plan, and its price, as is.
                other = r_cap_m * (n if decision.tier == plan_adapt.TIER_BROADCAST else 1)
                out_cap = max(1, int(cfg.join_out_factor * max(l_cap_m, other)))
            else:
                out_cap = batch_sizing(cfg, n, l_cap_m, r_cap_m).out_cap
            model = hbm_model_bytes(
                l_cap_m, odf, cfg, out_cap,
                _candidate_plan(job.left, job.right, job.left_on, job.right_on, job.key_range),
                plan_tier=decision.tier, right_rows=r_cap_m, world=n, salt_replicas=replicas)
            tier = decision.tier

            def dispatch():
                return _run_join(topology, decision.tier, job.left, left_counts, job.right,
                                 right_counts, job.left_on, job.right_on, cfg, job.key_range,
                                 decision.salt, replicas, ladder=False)
    price = {"tier": tier, "flops": None, "bytes_accessed": int(model), "argument_bytes": None,
             "output_bytes": None, "temp_bytes": None, "peak_hbm_bytes": None}

    def probe() -> float:
        with obs_recorder.suppress_epochs():
            t0 = time.perf_counter()
            out = dispatch()
            if topology.device.type == "cuda":
                torch.cuda.synchronize(topology.device)
            seconds = time.perf_counter() - t0
        del out  # free the probe's output before the next probe
        return seconds

    return price, probe

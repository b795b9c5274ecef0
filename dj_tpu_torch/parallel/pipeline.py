"""Device-resident join pipelines: co-partitioned intermediates and the
collectives they let a stage skip.

Counterpart of ``dj_tpu/parallel/pipeline.py``. Chaining joins by
calling ``distributed_inner_join`` twice pays again, for the second
join, what the first already did: a host probe of the intermediate's
key range, a partition of the intermediate and its exchange, even when
the second join's key is the key the first shuffle already partitioned
it by. ``distributed_join_pipeline`` chains joins with each intermediate
staying on the device, sharded, and plans each stage's dispatch up
front:

========== ============================================== ===============
stage mode when                                           collectives
========== ============================================== ===============
local      the left side is already hash-partitioned by   none of any
           this stage's ``left_on`` (a previous shuffle   kind
           or local stage on the same columns, or the
           caller's ``left_partitioned_by``) and the right
           side is declared ``right_partitioned``: equal
           keys lie on one rank
broadcast  the right side, replicated, fits the broadcast no all-to-all
           budget (``DJT_BROADCAST_BYTES``; flat          (the gathers)
           topologies)
prepared   ``right`` is a PreparedSide (its tier decides) the side's
shuffle    everything else                                a full epoch
========== ============================================== ===============

``JoinStage.mode`` pins a stage ("local" with its conditions unmet is a
ValueError: a local join of sides that are not co-partitioned would
drop rows). ``DJT_PIPELINE_COPART=0`` and ``DJT_PIPELINE_BROADCAST=0``
turn the two elisions off (dj_tpu's ``DJ_PIPELINE_*``).

A right side is co-partitioned when it was hash-partitioned by its
``right_on`` with the main join seed (``dist_join.MAIN_JOIN_SEED``) into
the main group's ranks: ``shuffle_on(topology, table, counts, on,
seed=12345678)`` over a flat world makes one. A shuffle stage at over-
decomposition odf puts a row on peer ``(h % (n odf)) % n = h % n``, so
its output is co-partitioned with such a side at any odf.

Key ranges are derived, not probed (``DJT_PIPELINE_RANGE_DERIVE``, on
by default): an inner join's output keys exist on both sides, so an
intermediate's key bounds are the intersection of its inputs' bounds
(``ops.join.intersect_key_ranges``), and every other column keeps the
bounds of the input table it came from. Only the pipeline's input
tables are probed, through the memo of ``dist_join._memo_minmax``
(which every process of a process world resolves alike), never an
intermediate. A stage plans with the union of its two sides' bounds in
canonical width form, as ``_resolve_key_range`` would; a declared
``JoinStage.key_range`` wins and probes nothing. So no stage reads an
intermediate back to the host: the only host syncs are the entry
probes (memoized) and, in the auto wrapper, the stages' flag matrices.

``distributed_join_pipeline_auto`` heals each stage on its own: an
overflow of stage i grows stage i's factor under stage i's ledger key
and runs stage i again on the intermediate it already has, and a
declared stage range that fires ``pack_range_overflow`` drops for that
stage alone.

Observed as dj_tpu's: each stage records one ``pipeline`` event (its
index, the stage count, the mode it ran, whether the exchange was
elided, where its key range came from) and counts
``dj_pipeline_stage_total{mode}``; a Table-right stage's run is the
roofline ``dispatch`` phase with stage ``"pipeline:<i>"``; each chain
counts ``dj_join_queries_total{path="pipeline"}`` once; a dropped
declared stage range records its ``heal`` event. Every process plans
and records alike (the events' fields come from the plan, which every
process makes from the same inputs). Each Table-right stage runs under
the degradation ladder with dj_tpu's fault sites (``_dispatch_stage``);
a prepared stage under the prepared query's.

Under ``DJT_AUTOTUNE=1`` the auto wrapper tunes the chain as one unit
(``parallel.autotune``, as dj_tpu's pipeline.py:715-745): one
``autotune.resolve`` on ``pipeline_signature``, whose tuner prices and
probes stage 0's shape (the fact-side stage), then every stage under
the decision's ``dispatch_scope`` with its config through
``apply_config``. In a process world every process takes one common
decision (``autotune.resolve(..., topology=)``), so the rule above that
every process plans alike holds for the tuned chain too. The tune is
not guarded here: a faulted probe
propagates, and a caller's ``degrade_guard(..., tiers=("autotune",))``
pins the tier. The query scheduler dispatches a chain outside such a
guard, as dj_tpu's does: a faulted tune ends that query with its typed
error.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import knobs, obs
from ..core import dtypes as dt
from ..core.table import Column, Table
from ..ops.join import canonical_key_range, intersect_key_ranges, normalize_key_range
from ..resilience import errors as resil
from ..resilience import faults
from ..resilience import heal as heal_engine
from ..resilience import ledger as dj_ledger
from ..resilience.heal import HealBudget
from . import dist_join as dj
from . import autotune, plan_adapt, shape_bucket
from .dist_join import JoinConfig, PreparedSide
from .topology import Topology

__all__ = [
    "JoinStage",
    "PipelinePlan",
    "StagePlan",
    "distributed_join_pipeline",
    "distributed_join_pipeline_auto",
    "pipeline_signature",
    "plan_pipeline",
]

MODE_SHUFFLE = "shuffle"
MODE_LOCAL = "local"
MODE_BROADCAST = "broadcast"
MODE_PREPARED = "prepared"

_EXPLICIT_MODES = ("auto", MODE_SHUFFLE, MODE_LOCAL, MODE_BROADCAST)


def _copart_enabled() -> bool:
    return knobs.read("DJT_PIPELINE_COPART") == "1"


def _broadcast_enabled() -> bool:
    return knobs.read("DJT_PIPELINE_BROADCAST") == "1"


def _range_derive_enabled() -> bool:
    return knobs.read("DJT_PIPELINE_RANGE_DERIVE") == "1"


@dataclasses.dataclass(frozen=True, eq=False)
class JoinStage:
    """One stage: join the running intermediate (left) with ``right`` on
    ``left_on`` / ``right_on``.

    ``right`` is a sharded Table (with ``right_counts`` and ``right_on``)
    or a PreparedSide (both None: it carries its own). ``key_range``
    declares the stage's per-key bounds, skipping probe and derivation.
    ``right_partitioned`` declares a Table right already hash-partitioned
    by ``right_on`` under the main join seed (module docstring), which
    lets an auto stage go local. ``mode`` pins the plan ("auto" decides).
    ``config`` overrides the pipeline's JoinConfig for this stage."""

    right: object
    right_counts: Optional[torch.Tensor] = None
    left_on: Sequence[int] = ()
    right_on: Optional[Sequence[int]] = None
    key_range: object = None
    right_partitioned: bool = False
    mode: str = "auto"
    config: Optional[JoinConfig] = None


@dataclasses.dataclass(frozen=True, eq=False)
class StagePlan:
    """One stage's plan: ``mode``; ``key_range``, the range it plans
    with (declared, or the derived union in canonical width form; None
    is the join's own dynamic plan); ``range_source`` ("declared",
    "derived" or "dynamic"); ``out_partitioned_by``, the columns its
    output is hash-partitioned by (None: none)."""

    index: int
    mode: str
    left_on: tuple
    right_on: Optional[tuple]
    right: object
    right_counts: Optional[torch.Tensor]
    key_range: Optional[tuple]
    range_source: str
    out_partitioned_by: Optional[tuple]
    config: JoinConfig
    declared_key_range: object = None


@dataclasses.dataclass(frozen=True, eq=False)
class PipelinePlan:
    """The chain's plan: the (bucketed) entry table and one StagePlan a
    stage. Running it reads nothing else: the ranges were resolved from
    the input tables at plan time."""

    left: Table
    left_counts: torch.Tensor
    stage_plans: tuple


# -- range tracking ---------------------------------------------------------
#
# Each column of the running intermediate has a source of its bounds:
#   ("range", ((lo, hi),), dtype)  a derived bound;
#   ("probe", table, counts, idx)  the input column it came from, probed
#                                  (memoized) when a stage joins on it;
#   None                           unknown.
# Only int Columns get sources, and a source is resolved only when a
# stage joins on its column.


def _dtype_name(data: torch.Tensor) -> str:
    return str(dt.numpy_dtype(data.dtype))


def _col_source(table: Table, counts, idx):
    col = table.columns[idx]
    if isinstance(col, Column) and not col.data.is_floating_point() \
            and col.data.dtype != torch.bool:
        return ("probe", table, counts, idx)
    return None


def _source_dtype(src) -> Optional[str]:
    """The source column's dtype name, without resolving it."""
    if src is None:
        return None
    if src[0] == "range":
        return src[2]
    _, table, _, idx = src
    return _dtype_name(table.columns[idx].data)


def _resolve_source(src, topology: Topology):
    """((lo, hi), dtype name), or None (unknown, or an empty side)."""
    if src is None:
        return None
    if src[0] == "range":
        _, rng, name = src
        return rng, name
    _, table, counts, idx = src
    data = table.columns[idx].data
    mn, mx = dj._memo_minmax(data, counts, topology.local_ranks, topology)
    if mx < mn:
        return None
    return (mn, mx), _dtype_name(data)


def _derive_stage_range(sources, stage, topology: Topology):
    """(key_range, range_source, key_side_ranges) of a Table-right stage:
    the declared range; else the union of both sides' resolved bounds in
    canonical width form, with the per-key (left, right, dtype) bounds
    for the output's sources; else the dynamic plan. Eligibility is
    ``_resolve_key_range``'s: every key pair int of one dtype, and not a
    single key of at most 32 bits."""
    left_on, right_on = tuple(stage.left_on), tuple(stage.right_on)
    if stage.key_range is not None:
        return normalize_key_range(stage.key_range, len(left_on)), "declared", None
    if not _range_derive_enabled():
        return None, "dynamic", None
    if knobs.read("DJT_JOIN_RANGE_PROBE") != "1":
        return None, "dynamic", None
    if knobs.read("DJT_JOIN_PACK") != "1":
        return None, "dynamic", None
    pairs = []
    for lc, rc in zip(left_on, right_on):
        lsrc = sources.get(lc)
        rsrc = _col_source(stage.right, stage.right_counts, rc)
        ldt, rdt = _source_dtype(lsrc), _source_dtype(rsrc)
        if ldt is None or rdt is None or ldt != rdt:
            return None, "dynamic", None
        pairs.append((lsrc, rsrc, ldt))
    if len(pairs) == 1 and np.dtype(pairs[0][2]).itemsize * 8 <= 32:
        return None, "dynamic", None
    lranges, rranges, dtypes = [], [], []
    for lsrc, rsrc, name in pairs:
        lres = _resolve_source(lsrc, topology)
        rres = _resolve_source(rsrc, topology)
        if lres is None or rres is None:
            return None, "dynamic", None
        lranges.append(lres[0])
        rranges.append(rres[0])
        dtypes.append(np.dtype(name))
    union = tuple((min(a[0], b[0]), max(a[1], b[1])) for a, b in zip(lranges, rranges))
    return (canonical_key_range(union, dtypes), "derived",
            (tuple(lranges), tuple(rranges), tuple(str(d) for d in dtypes)))


def _advance_sources(sources, stage, n_left: int, key_ranges):
    """The output's column sources after a Table-right stage: left
    columns keep their places (the join keys narrowed to the
    intersection of their sides' bounds when both resolved); the right
    payload columns follow in order, each sourced at its input column."""
    out = dict(sources)
    if key_ranges is not None:
        lranges, rranges, dtypes = key_ranges
        for k, lc in enumerate(tuple(stage.left_on)):
            out[lc] = ("range", intersect_key_ranges((lranges[k],), (rranges[k],))[0],
                       dtypes[k])
    right_on = set(tuple(stage.right_on))
    pos = n_left
    for j in range(len(stage.right.columns)):
        if j in right_on:
            continue
        out[pos] = _col_source(stage.right, stage.right_counts, j)
        pos += 1
    return out


def _advance_sources_prepared(sources, stage, n_left: int):
    """After a prepared stage: the left columns carry over; the side's
    payload columns have no source."""
    out = dict(sources)
    ps = stage.right
    for j in range(len(ps.right.columns) - len(tuple(ps.right_on))):
        out[n_left + j] = None
    return out


# -- planning ---------------------------------------------------------------


def _resolve_mode(stage, part_cols, topology: Topology) -> str:
    """The stage's dispatch (module docstring table). The broadcast fit
    weighs the global right side's bytes, which every process of a
    process world computes alike."""
    if isinstance(stage.right, PreparedSide):
        return MODE_PREPARED
    if stage.mode not in _EXPLICIT_MODES:
        raise ValueError(f"JoinStage.mode {stage.mode!r} is not one of {_EXPLICIT_MODES}")
    co_located = (part_cols is not None and part_cols == tuple(stage.left_on)
                  and stage.right_partitioned)
    if stage.mode == MODE_LOCAL:
        if not co_located:
            raise ValueError(
                "JoinStage(mode='local') requires the left side to be hash-partitioned by "
                "left_on (declare left_partitioned_by / chain from a shuffle stage on the same "
                "columns) AND right_partitioned=True"
            )
        return MODE_LOCAL
    if stage.mode in (MODE_SHUFFLE, MODE_BROADCAST):
        return stage.mode
    if co_located and _copart_enabled():
        return MODE_LOCAL
    if _broadcast_enabled() and not topology.is_hierarchical:
        budget = plan_adapt.available_broadcast_bytes()
        if budget > 0 and dj._global_table_bytes(topology, stage.right) <= budget:
            return MODE_BROADCAST
    return MODE_SHUFFLE


def _out_partitioned_by(mode: str, stage, part_cols):
    """The columns the stage's output is hash-partitioned by: a shuffle
    or local stage's ``left_on`` (the left columns keep their places);
    a broadcast stage moves no row and keeps its input's; a prepared
    stage's side's tier decides."""
    if mode in (MODE_SHUFFLE, MODE_LOCAL):
        return tuple(stage.left_on)
    if mode == MODE_BROADCAST:
        return part_cols
    tier = getattr(stage.right, "tier", MODE_SHUFFLE)
    if tier == MODE_BROADCAST:
        return part_cols
    if tier == plan_adapt.TIER_SALTED:
        return None  # the copies of the heavy partitions break it
    return tuple(stage.left_on)


def plan_pipeline(
    topology: Topology,
    left: Table,
    left_counts: torch.Tensor,
    stages: Sequence[JoinStage],
    config: Optional[JoinConfig] = None,
    *,
    left_partitioned_by: Optional[Sequence[int]] = None,
    resolve_ranges: bool = True,
) -> PipelinePlan:
    """The chain's plan: each stage's mode, key range and output
    partitioning (dj_tpu's ``plan_pipeline``). ``resolve_ranges=False``
    plans the modes only and reads no data on the device. A Table
    stage's key pair of two widths raises ValueError before that stage's
    range probe (``dist_join._check_key_widths``, on the stage's left
    columns as the chain builds them)."""
    if not stages:
        raise ValueError("plan_pipeline: at least one JoinStage required")
    if config is None:
        config = JoinConfig()
    left = shape_bucket.bucket_table(topology, left)
    part_cols = None if left_partitioned_by is None else tuple(left_partitioned_by)
    sources = {i: _col_source(left, left_counts, i) for i in range(len(left.columns))}
    cols = list(left.columns)
    cur_cols = len(cols)
    plans = []
    for i, stage in enumerate(stages):
        cfg = stage.config if stage.config is not None else config
        prepared = isinstance(stage.right, PreparedSide)
        if prepared:
            if stage.right_counts is not None or stage.right_on is not None:
                raise ValueError(
                    f"stage {i}: a PreparedSide carries its own counts and key columns; pass "
                    f"right_counts=None, right_on=None"
                )
        elif stage.right_counts is None or stage.right_on is None:
            raise TypeError(f"stage {i}: right_counts and right_on are required when `right` "
                            f"is a Table")
        if not stage.left_on:
            raise ValueError(f"stage {i}: left_on must be non-empty")
        if max(stage.left_on) >= cur_cols:
            raise ValueError(f"stage {i}: left_on {tuple(stage.left_on)} out of range for the "
                             f"stage's {cur_cols}-column left side")
        if not prepared:
            dj._check_key_widths(cols, stage.right.columns, stage.left_on, stage.right_on,
                                 f"stage {i}")
        mode = _resolve_mode(stage, part_cols, topology)
        right = stage.right
        key_range, range_source, key_ranges = None, "dynamic", None
        stage_b = stage
        if not prepared:
            right = shape_bucket.bucket_table(topology, right)
            if right is not stage.right:
                stage_b = dataclasses.replace(stage, right=right)
            if resolve_ranges:
                key_range, range_source, key_ranges = _derive_stage_range(sources, stage_b,
                                                                          topology)
            elif stage.key_range is not None:
                key_range = normalize_key_range(stage.key_range, len(tuple(stage.left_on)))
                range_source = "declared"
        part_cols = _out_partitioned_by(mode, stage, part_cols)
        plans.append(StagePlan(
            index=i, mode=mode, left_on=tuple(stage.left_on),
            right_on=None if stage.right_on is None else tuple(stage.right_on),
            right=right, right_counts=stage.right_counts, key_range=key_range,
            range_source=range_source, out_partitioned_by=part_cols, config=cfg,
            declared_key_range=stage.key_range,
        ))
        # The intermediate does not exist at plan time: only its column
        # count and sources go on.
        r_table, r_on = ((stage.right.right, stage.right.right_on) if prepared
                         else (right, stage.right_on))
        if prepared:
            sources = _advance_sources_prepared(sources, stage, cur_cols)
        else:
            sources = _advance_sources(sources, stage_b, cur_cols, key_ranges)
        cols += [c for j, c in enumerate(r_table.columns) if j not in set(r_on)]
        cur_cols = len(cols)
    return PipelinePlan(left, left_counts, tuple(plans))


def pipeline_signature(topology: Topology, plan: PipelinePlan) -> str:
    """One signature for the whole chain (dj_tpu's autotuner's unit):
    stage 0's mode and two-table plan signature, then each later stage's
    mode, ``left_on`` and its right side's build signature (the
    intermediate is not known statically and must not split it)."""
    sp0 = plan.stage_plans[0]
    parts = [f"{sp0.mode}~" + dj_ledger.plan_signature(
        topology, plan.left, sp0.right, sp0.left_on, sp0.right_on, sp0.config)]
    for sp in plan.stage_plans[1:]:
        if sp.mode == MODE_PREPARED:
            side = dj_ledger.plan_signature(topology, None, sp.right.right, None,
                                            sp.right.right_on, sp.config)
        else:
            side = dj_ledger.plan_signature(topology, None, sp.right, None, sp.right_on,
                                            sp.config)
        parts.append(f"{sp.mode}~on{sp.left_on}~{side}")
    return "pipe[" + ";".join(parts) + "]"


# -- execution --------------------------------------------------------------


def _dispatch_stage(topology: Topology, sp: StagePlan, cur: Table, cur_counts: torch.Tensor,
                    cfg: JoinConfig, key_range, n_stages: int):
    """One Table-right stage's join on its planned mode, and its
    ``pipeline`` event, under the degradation ladder ("adapt", "wire"),
    as dj_tpu's ``_dispatch_stage`` (pipeline.py:533-622). The knobs that
    turn an elision off and the ladder's pins are read inside each
    attempt, so a retry after a pin runs the baseline: a pinned "adapt"
    runs a broadcast stage on the shuffle plan. Fault sites:
    ``module_build`` each attempt, ``broadcast`` on a broadcast stage,
    and the stage's flags through ``join.<flag>``."""

    def attempt():
        cfg2 = resil.strip_pinned_wire(cfg)
        faults.check("module_build")
        mode = sp.mode
        if mode == MODE_LOCAL and not _copart_enabled():
            mode = MODE_SHUFFLE
        if mode == MODE_BROADCAST and (not _broadcast_enabled() or resil.tier_pinned("adapt")):
            mode = MODE_SHUFFLE
        if mode == MODE_BROADCAST:
            faults.check("broadcast")
        tier = {MODE_LOCAL: dj.TIER_LOCAL, MODE_BROADCAST: plan_adapt.TIER_BROADCAST}.get(
            mode, plan_adapt.TIER_SHUFFLE)
        out = dj._run_join(topology, tier, cur, cur_counts, sp.right, sp.right_counts,
                           sp.left_on, sp.right_on, cfg2, key_range, stage=f"pipeline:{sp.index}",
                           path="pipeline", queries=0)
        obs.inc("dj_pipeline_stage_total", mode=mode)
        obs.record("pipeline", stage=sp.index, stages=n_stages, mode=mode,
                   elided=mode in (MODE_LOCAL, MODE_BROADCAST),
                   range=sp.range_source if key_range is not None else "dynamic")
        return out

    out, out_counts, info = resil.degrade_guard("distributed_join_pipeline", attempt,
                                                tiers=("adapt", "wire"), config=cfg,
                                                topology=topology)
    return out, out_counts, faults.force_flags("join", info)


def _record_prepared_stage(sp: StagePlan, n_stages: int, side) -> None:
    obs.inc("dj_pipeline_stage_total", mode=MODE_PREPARED)
    obs.record("pipeline", stage=sp.index, stages=n_stages, mode=MODE_PREPARED,
               elided=getattr(side, "tier", "") == MODE_BROADCAST, range="declared")


def distributed_join_pipeline(
    topology: Topology,
    left: Table,
    left_counts: torch.Tensor,
    stages: Sequence[JoinStage],
    config: Optional[JoinConfig] = None,
    *,
    left_partitioned_by: Optional[Sequence[int]] = None,
    plan: Optional[PipelinePlan] = None,
) -> tuple[Table, torch.Tensor, list]:
    """Chain inner joins with device-resident sharded intermediates and
    the stage plans of ``plan_pipeline`` (module docstring). The result's
    columns accumulate as composed ``distributed_inner_join`` calls': the
    left's, then each stage's right columns but its ``right_on``.
    Returns ``(out, counts, infos)``, one flag dict a stage, which the
    caller must check as distributed_inner_join's (the auto wrapper
    heals them)."""
    if plan is None:
        plan = plan_pipeline(topology, left, left_counts, stages, config,
                             left_partitioned_by=left_partitioned_by)
    cur, cur_counts = plan.left, plan.left_counts
    infos = []
    n_stages = len(plan.stage_plans)
    for sp in plan.stage_plans:
        if sp.mode == MODE_PREPARED:
            cur, cur_counts, info = dj._distributed_inner_join_prepared(
                topology, cur, cur_counts, sp.right, sp.left_on, sp.config)
            _record_prepared_stage(sp, n_stages, sp.right)
        else:
            cur, cur_counts, info = _dispatch_stage(topology, sp, cur, cur_counts, sp.config,
                                                    sp.key_range, n_stages)
        infos.append(info)
    obs.inc("dj_join_queries_total", path="pipeline")
    return cur, cur_counts, infos


def distributed_join_pipeline_auto(
    topology: Topology,
    left: Table,
    left_counts: torch.Tensor,
    stages: Sequence[JoinStage],
    config: Optional[JoinConfig] = None,
    *,
    left_partitioned_by: Optional[Sequence[int]] = None,
    max_attempts: int = 8,
    growth: float = 2.0,
    max_total_growth: float = 4096.0,
) -> tuple[Table, torch.Tensor, list, list]:
    """``distributed_join_pipeline`` with each stage healed on its own.
    Returns ``(out, counts, infos, configs)``: one final flag dict and
    one (possibly grown) config a stage.

    A stage's overflow grows exactly that stage's factor, under its own
    ledger key, and runs that stage again on the intermediate it already
    has. A declared stage ``key_range`` that fires
    ``pack_range_overflow`` drops to the derived or dynamic plan for that
    stage only. A prepared stage heals through the prepared auto path
    (its re-prepare included).

    Under ``DJT_AUTOTUNE=1`` the chain is one tunable unit (module
    docstring): one resolve on its signature, the decision's odf and
    env axes applied to every stage."""
    if config is None:
        config = JoinConfig()
    plan = plan_pipeline(topology, left, left_counts, stages, config,
                         left_partitioned_by=left_partitioned_by)
    decision = None
    pipe_sig = pipeline_signature(topology, plan)
    if autotune.enabled():
        sp0 = plan.stage_plans[0]
        decision = autotune.resolve(pipe_sig, autotune.make_tuner(
            topology, plan.left, plan.left_counts, sp0.right, sp0.right_counts, sp0.left_on,
            sp0.right_on, sp0.config), topology=topology)
    cur, cur_counts = plan.left, plan.left_counts
    infos, configs = [], []
    budget = dict(max_attempts=max_attempts, growth=growth, max_total_growth=max_total_growth)
    n_stages = len(plan.stage_plans)
    with autotune.dispatch_scope(decision, pipe_sig):
        for sp in plan.stage_plans:
            cfg = autotune.apply_config(decision, sp.config)
            if sp.mode == MODE_PREPARED:
                cur, cur_counts, info, cfg_used, side = dj._distributed_inner_join_prepared_auto(
                    topology, cur, cur_counts, sp.right, sp.left_on, cfg, **budget)
                _record_prepared_stage(sp, n_stages, side)
            else:
                cur, cur_counts, info, cfg_used = _heal_stage(topology, sp, cur, cur_counts, cfg,
                                                              n_stages, **budget)
            infos.append(info)
            configs.append(cfg_used)
    obs.inc("dj_join_queries_total", path="pipeline")
    return cur, cur_counts, infos, configs


def _heal_stage(topology: Topology, sp: StagePlan, cur: Table, cur_counts: torch.Tensor,
                cfg: JoinConfig, n_stages: int, *, max_attempts: int, growth: float,
                max_total_growth: float):
    """One Table-right stage under the heal engine: only this stage's
    factors grow, under this stage's own ledger key."""
    state = {"config": cfg, "key_range": sp.key_range,
             "declared": sp.declared_key_range is not None, "dropped_range": False}

    def run_attempt(attempt):
        out, counts, info = _dispatch_stage(topology, sp, cur, cur_counts, state["config"],
                                            state["key_range"], n_stages)
        return (out, counts), info

    def _heal_pack_range(info, attempt):
        if not state["declared"] or state["dropped_range"]:
            raise RuntimeError(
                "pack_range_overflow with no declared stage key_range: derived ranges union "
                "both input sides and cover the data by construction; this is a bug, not a "
                "capacity problem"
            )
        obs.inc("dj_heal_total", flag="pack_range_overflow")
        obs.record("heal", stage=f"pipeline:{sp.index}", attempt=attempt,
                   flags=["pack_range_overflow"], action="drop_declared_range",
                   dropped_key_range=state["key_range"])
        state.update(key_range=None, dropped_range=True)

    def _apply_ledger(entry):
        if entry.get("drop_declared_range") and state["declared"]:
            state.update(key_range=None, dropped_range=True)

    (out, counts), info, _ = heal_engine.run_healed(
        name="distributed_join_pipeline_auto",
        stage=f"pipeline:{sp.index}",
        budget=HealBudget(max_attempts, growth, max_total_growth),
        run_attempt=run_attempt,
        heal_map=dj._HEAL_FACTORS,
        read_factors=lambda: dj._config_factors(state["config"]),
        apply_factors=lambda grew: state.update(
            config=dataclasses.replace(state["config"], **grew)),
        poison={"pack_range_overflow": _heal_pack_range},
        terminal={"surrogate_collision": dj._raise_surrogate_collision},
        ledger_key=dj_ledger.plan_signature(topology, cur, sp.right, sp.left_on, sp.right_on,
                                            cfg),
        ledger_extra=lambda: {"drop_declared_range": True} if state["dropped_range"] else {},
        apply_ledger_entry=_apply_ledger,
    )
    return out, counts, info, state["config"]

"""Skew-adaptive join planning: the broadcast, salted and shuffle tiers.

Counterpart of ``dj_tpu/parallel/plan_adapt.py``. The measured
partition skew and the build side's size decide, once per plan
signature, which plan a join runs (``PlanDecision.tier``):

- ``"broadcast"``: the build (right) side, replicated, fits a rank's
  budget (``DJT_BROADCAST_BYTES``, else ``DJT_SERVE_HBM_BUDGET``, else
  16e9 bytes): every rank all-gathers the right side
  (``all_to_all.broadcast_table``) and joins its own left shard against
  it. No partition and no all-to-all.
- ``"salted"``: the probe side's partition counts show a destination
  with at least ``DJT_SALT_RATIO`` times its batch's mean rows: the
  probe rows bound for each such heavy destination scatter over
  ``replicas`` cyclic peers (``ops.partition.salted_partition_ids``)
  and the build side's heavy partitions are copied to the same peers by
  rotated windows that ride the batch's one exchange epoch. The hot
  destination no longer makes the heal double ``bucket_factor``, which
  widens every destination's bucket.
- ``"shuffle"``: the all-to-all plan (skew below the ratio, the planner
  off, a two-level topology).

:func:`decide` reads the capacity ledger first: a persisted
``plan_adapt`` record (tier, salt set, replicas, ratio) replays with no
probe, also from a ``DJT_LEDGER`` file after a restart. A fresh decision
prices the broadcast fit, and only when it does not fit runs the
partition-count probe, then persists at once. :func:`demote` turns a
signature's decision back to shuffle (a broadcast that no longer fits, a
salt set the geometry cannot hold).

In a process world every process decides on its own, from inputs that
are global on every process (the gathered counts, the global table's
bytes), so all reach the same decision and issue the same collectives.

Knobs: ``DJT_PLAN_ADAPT=1`` arms the planner (default off);
``DJT_BROADCAST_BYTES`` the broadcast budget (<= 0 disables the tier);
``DJT_SALT_RATIO`` (default 2.0) the max / mean ratio that salts;
``DJT_SALT_REPLICAS`` (default ceil(ratio), clamped to [2, group size])
the fan-out; ``DJT_SALT_TOPK`` (default 3) the heavy destinations
considered a batch.

Observed as dj_tpu's: every decision, replayed or fresh, records one
``plan_adapt`` event and ``dj_plan_adapt_total{tier,source}``, a demote
with ``action="demote"`` and its reason; each partition-count probe
counts ``dj_plan_probe_total``. dj_tpu's degradation ladder pin and its
``broadcast`` / ``salted`` fault sites come with the fault ladder
(ROADMAP item 10b).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from .. import knobs, obs
from ..obs import skew as obs_skew
from ..resilience import ledger as dj_ledger

__all__ = [
    "PlanDecision",
    "SHUFFLE",
    "TIER_BROADCAST",
    "TIER_SALTED",
    "TIER_SHUFFLE",
    "available_broadcast_bytes",
    "broadcast_budget_bytes",
    "decide",
    "decision_from_entry",
    "demote",
    "enabled",
    "salt_ratio",
    "salt_replicas",
    "salt_topk",
]


TIER_SHUFFLE = "shuffle"
TIER_BROADCAST = "broadcast"
TIER_SALTED = "salted"


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """One signature's plan: the tier, the salt set (global partition ids
    of the heavy destinations, batch b's destination d at ``b * n +
    d``), the salt fan-out, the measured max / mean destination ratio it
    was based on, and where it came from (``probe``, ``fit``,
    ``ledger``, ``default`` or ``demote``)."""

    tier: str = TIER_SHUFFLE
    salt: tuple = ()
    replicas: int = 1
    ratio: float = 1.0
    source: str = "default"


SHUFFLE = PlanDecision()


def enabled() -> bool:
    """The planner is armed: ``DJT_PLAN_ADAPT`` is truthy."""
    return knobs.read_bool("DJT_PLAN_ADAPT")


def broadcast_budget_bytes() -> float:
    """The broadcast tier's budget in modeled bytes a rank:
    ``DJT_BROADCAST_BYTES`` when set, else ``DJT_SERVE_HBM_BUDGET``
    (default 16e9). A value that does not parse is skipped. <= 0
    disables the tier."""
    raw = knobs.read("DJT_BROADCAST_BYTES")
    if raw is not None:
        try:
            return float(raw)
        except ValueError:
            pass
    return knobs.read_float("DJT_SERVE_HBM_BUDGET")


def available_broadcast_bytes() -> float:
    """The budget the broadcast fit is judged against. dj_tpu subtracts
    the join-index cache's resident bytes; the port has no such cache
    yet (ROADMAP item 10d), so this is the budget alone."""
    return broadcast_budget_bytes()


def salt_ratio() -> float:
    """The max / mean destination ratio that salts (``DJT_SALT_RATIO``,
    default 2.0, at least 1)."""
    return max(1.0, knobs.read_float("DJT_SALT_RATIO"))


def salt_replicas(n: int, ratio: float) -> int:
    """The salt fan-out for a measured ratio: ceil(ratio) cyclic peers
    bring the hot destination back to about the mean; clamped to [2, n]
    (a row scatters over distinct peers). ``DJT_SALT_REPLICAS`` > 0
    replaces ceil(ratio)."""
    env = knobs.read_int("DJT_SALT_REPLICAS")
    if env > 0:
        return max(2, min(n, env))
    return max(2, min(n, math.ceil(ratio)))


def salt_topk() -> int:
    """The heaviest destinations a batch considered (``DJT_SALT_TOPK``,
    default 3)."""
    return max(1, knobs.read_int("DJT_SALT_TOPK"))


def decision_from_entry(entry: Optional[dict]) -> Optional[PlanDecision]:
    """A ledger entry's ``plan_adapt`` record as a PlanDecision (source
    ``ledger``), or None when it holds none, names another tier, holds
    values that do not parse, or would arm a salting without a salt set
    or with fewer than 2 replicas (a torn or foreign record)."""
    pa = (entry or {}).get("plan_adapt")
    if not isinstance(pa, dict) or "tier" not in pa:
        return None
    tier = str(pa.get("tier"))
    if tier not in (TIER_SHUFFLE, TIER_BROADCAST, TIER_SALTED):
        return None
    try:
        salt = tuple(int(p) for p in pa.get("salt") or ())
        replicas = int(pa.get("replicas", 1))
        ratio = float(pa.get("ratio", 1.0))
    except (TypeError, ValueError):
        return None
    if tier == TIER_SALTED and (not salt or replicas < 2):
        return None
    return PlanDecision(tier, salt, replicas, ratio, "ledger")


def _record(sig: str, decision: PlanDecision, **extra) -> None:
    obs.inc("dj_plan_adapt_total", tier=decision.tier, source=decision.source)
    obs.record("plan_adapt", tier=decision.tier, source=decision.source,
               ratio=round(decision.ratio, 4), salt=list(decision.salt),
               replicas=decision.replicas, sig=sig[:200], **extra)


def _persist(sig: str, decision: PlanDecision) -> None:
    dj_ledger.update(sig, plan_adapt={
        "tier": decision.tier,
        "salt": list(decision.salt),
        "replicas": decision.replicas,
        "ratio": round(decision.ratio, 4),
    })


def heavy_destinations(batches: list, threshold: float, n: int) -> list[int]:
    """The global partition ids of the destinations that alone reach
    ``threshold`` times their batch's mean rows, among each batch's
    ``top`` (``obs.skew.batch_skew``'s dicts)."""
    heavy: list[int] = []
    for b in batches:
        if b["mean_rows"] <= 0:
            continue
        for dest, rows in b["top"]:
            if rows >= threshold * b["mean_rows"]:
                heavy.append(b["batch"] * n + dest)
    return heavy


def decide(
    sig: str,
    *,
    n: int,
    odf: int,
    right_bytes_fn: Callable[[], float],
    counts_fn: Callable[[], object],
) -> PlanDecision:
    """The plan of signature ``sig`` (module docstring). A ledger record
    replays as it is. Else ``right_bytes_fn()`` (the global build side's
    bytes) is priced against the budget: broadcast when it fits. Else,
    with n > 1 ranks, ``counts_fn()`` (the [w, n * odf] partition
    counts) gives each batch's destination skew: salted when the worst
    ratio reaches ``salt_ratio()`` and some destination alone does,
    shuffle otherwise. A fresh decision persists before it returns;
    every decision is recorded (module docstring)."""
    if not enabled():
        return SHUFFLE
    replayed = decision_from_entry(dj_ledger.lookup(sig))
    if replayed is not None:
        _record(sig, replayed)
        return replayed
    budget = available_broadcast_bytes()
    if budget > 0 and float(right_bytes_fn()) <= budget:
        decision = PlanDecision(TIER_BROADCAST, (), 1, 1.0, "fit")
        _persist(sig, decision)
        _record(sig, decision)
        return decision
    decision = SHUFFLE
    if n > 1:
        obs.inc("dj_plan_probe_total")
        batches = obs_skew.batch_skew(np.asarray(counts_fn()), n, odf, topk=salt_topk())
        worst = max((b["ratio"] for b in batches), default=1.0)
        threshold = salt_ratio()
        heavy = heavy_destinations(batches, threshold, n)
        if worst >= threshold and heavy:
            decision = PlanDecision(TIER_SALTED, tuple(sorted(set(heavy))),
                                    salt_replicas(n, worst), float(worst), "probe")
        else:
            decision = PlanDecision(TIER_SHUFFLE, (), 1, float(worst), "probe")
    _persist(sig, decision)
    _record(sig, decision)
    return decision


def demote(sig: str, reason: str) -> PlanDecision:
    """Persist the shuffle plan for ``sig`` (source ``demote``): the path
    of a broadcast decision whose side no longer fits, or a salt set the
    current geometry cannot hold. ``reason`` says which, in the
    ``plan_adapt`` event."""
    decision = PlanDecision(TIER_SHUFFLE, (), 1, 1.0, "demote")
    _persist(sig, decision)
    _record(sig, decision, action="demote", reason=str(reason)[:200])
    return decision

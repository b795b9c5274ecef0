"""Typed errors of the join, and the tier degradation ladder.

Counterpart of ``dj_tpu/resilience/errors.py``. The taxonomy lets a
caller route a failure: retry with wider factors
(:class:`CapacityExhausted`), re-prepare the build side
(:class:`PlanMismatch`), restart the process group
(:class:`BackendError`), shed a query whose deadline passed
(:class:`DeadlineExceeded`), and the serving stack's door errors
(:class:`AdmissionRejected`, :class:`QueueFull`, :class:`Draining`),
test and audit errors (:class:`FaultInjected`,
:class:`ContractViolation`), and a hand-written kernel that failed to
build, load or launch (:class:`KernelError`, the port's own). Each
subclasses ``RuntimeError``.

The degradation ladder (:func:`degrade_guard`): the optional tiers of
the port are the components a new CUDA release or topology can break
while their baseline keeps working. When a guarded call fails with a
tier active, the ladder pins that tier's baseline for the PROCESS (one
``degrade`` event and ``dj_degrade_total{tier}``) and retries, so
serving survives a bad tier instead of dying. The port's tiers:

============= ============================== ===============================
tier          pinned to                      active when
============= ============================== ===============================
merge         ``DJT_JOIN_MERGE=sort``        ``resolve_merge_impl()`` is not
                                             sort (the CUDA merge kernel,
                                             or the probe tier)
wire          uncompressed                   compression options on the
                                             call or in the JoinConfig
adapt         ``DJT_PLAN_ADAPT=0``           ``plan_adapt.enabled()``
autotune      ``DJT_AUTOTUNE=0``             ``autotune.enabled()``
expand        ``DJT_PROBE_EXPAND=hist``      ``resolve_probe_expand()`` is
                                             not hist
prepared_tier ``DJT_PREPARED_TIER=shuffle``  the knob is set, not shuffle
============= ============================== ===============================

A pin writes the baseline into the tier's knob, which the port reads
from the environment on every call (``knobs.read``), so the retry and
every later call run the baseline; the wire tier has no knob, and
callers consult :func:`strip_pinned_wire` / :func:`tier_pinned`
instead. Pins are process-wide: the rank threads of a world share them,
and in a process world each process pins only itself.

Two failures never pin a tier, unlike dj_tpu, whose compiler stands
between a tier and its kernels: a :class:`KernelError` (one of the
port's CUDA kernels did not build, load or launch) and a device fault
that torch raises as ``torch.AcceleratorError`` (sticky on the CUDA
context, so a retry fails as well). Both propagate, so a broken kernel
fails its query instead of being served by another tier under its
name. And in a process world of more than one process (the guard's
``topology``), only :class:`FaultInjected` retries: every process
consults a fault site alike and pins alike, while a real failure on one
process would retry its collectives alone, and they could pair with its
peers' next call's. Every other failure there propagates unchanged.

Left out of dj_tpu's ladder: its ``sort`` tier (``DJ_JOIN_SORT=bucketed``,
which the port measured slower on the card and did not keep), so every
guard that names ``sort`` there names the others without it here; the ``fleet`` tier,
which comes with the fleet coordination (ROADMAP item 10d); and
``_BUILDER_TIER`` with the ``ContractViolation`` branch of
``_culprit_tier``, which read the HLO auditor's verdict on a compiled
module, and the port compiles none.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

from .. import knobs, obs


class DJError(RuntimeError):
    """Base of every typed dj_tpu_torch error."""


class CapacityExhausted(DJError):
    """A heal loop ran out of budget (attempt cap or total-factor-growth
    cap) with overflow flags still firing. Carries ``stage``,
    ``attempts``, ``flags`` (name -> fired bool) and ``factors`` (the
    final, grown sizing factors)."""

    def __init__(
        self,
        message: str,
        *,
        stage: Optional[str] = None,
        attempts: Optional[int] = None,
        flags: Optional[dict] = None,
        factors: Optional[dict] = None,
    ):
        super().__init__(message)
        self.stage = stage
        self.attempts = attempts
        self.flags = dict(flags or {})
        self.factors = dict(factors or {})


class PlanMismatch(DJError):
    """The probe side (or the build data) is structurally incompatible
    with a prepared plan: odf, key dtypes, a batch sizing whose tag
    width differs from the prepared words', or build keys outside a
    declared range. Heal by re-preparing."""


class BackendError(DJError):
    """The distributed backend failed past its retry budget (the
    process group's bootstrap). Not healable by capacity growth or
    re-preparation: restart or fail over."""


class ContractViolation(DJError):
    """A compiled module broke its tier's declared shape contract.
    Carries ``contract``, ``builder`` and the ``violations`` strings."""

    def __init__(self, contract: str, builder: str, violations):
        super().__init__(
            f"HLO contract {contract!r} violated by {builder}: " + "; ".join(violations)
        )
        self.contract = contract
        self.builder = builder
        self.violations = tuple(violations)


class FaultInjected(DJError):
    """Raised by an armed exception-type fault site (faults.check).
    Carries ``site`` and ``call``, so the degradation ladder can map the
    failure to the tier under test."""

    def __init__(self, site: str, call: int):
        super().__init__(f"fault injected: {site}@call={call} (DJT_FAULT / faults.arm)")
        self.site = site
        self.call = call


class KernelError(DJError):
    """One of the port's hand-written CUDA kernels failed to build
    (``nvcc`` missing or refusing a source), to load, or to launch
    (``ops.cuda_build``). Never a tier failure: :func:`degrade_guard`
    lets it propagate."""


class AdmissionRejected(DJError):
    """A scheduler rejected the query at the door: its memory forecast
    plus the bytes reserved for queued and running work exceed the
    budget. Carries ``forecast_bytes``, ``reserved_bytes``,
    ``budget_bytes``, the plan ``signature`` and, for a reject grounded
    in measured device occupancy, ``measured``."""

    def __init__(
        self,
        message: str,
        *,
        forecast_bytes: Optional[float] = None,
        reserved_bytes: Optional[float] = None,
        budget_bytes: Optional[float] = None,
        signature: Optional[str] = None,
        measured: Optional[dict] = None,
    ):
        super().__init__(message)
        self.forecast_bytes = forecast_bytes
        self.reserved_bytes = reserved_bytes
        self.budget_bytes = budget_bytes
        self.signature = signature
        self.measured = measured


class QueueFull(DJError):
    """A scheduler's bounded queue is full: the query is shed at submit.
    Carries ``depth``, the cap that was hit."""

    def __init__(self, message: str, *, depth: Optional[int] = None):
        super().__init__(message)
        self.depth = depth


class Draining(DJError):
    """The scheduler is draining: new work is rejected while queued and
    running queries finish. Carries ``scheduler``."""

    def __init__(self, message: str, *, scheduler: Optional[str] = None):
        super().__init__(message)
        self.scheduler = scheduler


class DeadlineExceeded(DJError):
    """The query's monotonic-clock deadline passed before it produced a
    result. ``where`` says which wait used the budget ("queued",
    "healing": the heal loop's check between attempts, or "coalesced").
    Carries ``deadline_s`` (the submitted budget) and ``elapsed_s``."""

    def __init__(
        self,
        message: str,
        *,
        where: Optional[str] = None,
        deadline_s: Optional[float] = None,
        elapsed_s: Optional[float] = None,
    ):
        super().__init__(message)
        self.where = where
        self.deadline_s = deadline_s
        self.elapsed_s = elapsed_s


# The name the prepared path raises under, as in dj_tpu.parallel.dist_join.
PreparedPlanMismatch = PlanMismatch


# --- the degradation ladder -----------------------------------------------
#
# tier -> (env knob or None, baseline value). Writing the baseline into
# the knob makes every later read of it, the retry's first, run the
# baseline plan.
TIER_BASELINE = {
    "merge": ("DJT_JOIN_MERGE", "sort"),
    "wire": (None, "uncompressed"),
    # The skew-adaptive planner (parallel.plan_adapt): 0 in its arming
    # knob makes every later plan resolution read disabled and run the
    # shuffle plan.
    "adapt": ("DJT_PLAN_ADAPT", "0"),
    # The per-signature autotuner (parallel.autotune): 0 in its arming
    # knob, so every later dispatch serves the hand-tuned defaults.
    "autotune": ("DJT_AUTOTUNE", "0"),
    # The probe tier's expansion (ops.join.resolve_probe_expand): hist
    # ranks with expand_ranks and takes the offsets from the run starts.
    "expand": ("DJT_PROBE_EXPAND", "hist"),
    # The prepared build tiers: every later prepare builds the shuffle
    # side; a broadcast or salted side already built raises
    # PreparedPlanMismatch at its next query, which re-prepares it.
    "prepared_tier": ("DJT_PREPARED_TIER", "shuffle"),
}

# Exception fault sites that name their tier (FaultInjected carries the
# site): the ladder pins the culprit, not the first active tier. Both
# non-baseline merge tiers pin "merge" back to DJT_JOIN_MERGE=sort;
# both adaptive plans pin "adapt" back to the shuffle plan; the prepared
# tiers' prepare-time and query-time sites pin "prepared_tier".
_SITE_TIER = {
    "pallas_merge": "merge",
    "probe_merge": "merge",
    "codec": "wire",
    "broadcast": "adapt",
    "salted": "adapt",
    # Both autotuner sites (the timed probe dispatch, the config's
    # application) pin the one "autotune" tier.
    "autotune_probe": "autotune",
    "autotune_apply": "autotune",
    "probe_expand": "expand",
    "prepare_broadcast": "prepared_tier",
    "prepare_salted": "prepared_tier",
    "bc_prepared_query": "prepared_tier",
    "salted_prepared_query": "prepared_tier",
}

_pin_lock = threading.Lock()
# tier -> {"reason": str, "prev_env": Optional[str]}
_pinned: dict[str, dict] = {}


def tier_pinned(tier: str) -> bool:
    return tier in _pinned


def pinned_tiers() -> dict[str, str]:
    """Snapshot: pinned tier -> reason."""
    with _pin_lock:
        return {t: p["reason"] for t, p in _pinned.items()}


def pin_baseline(tier: str, reason: str) -> None:
    """Pin ``tier``'s baseline for the process (idempotent): write the
    baseline into the tier's env knob, record one ``degrade`` event and
    ``dj_degrade_total{tier}``."""
    knob, baseline = TIER_BASELINE[tier]
    with _pin_lock:
        if tier in _pinned:
            return
        prev = None
        if knob is not None:
            prev = os.environ.get(knob)
            os.environ[knob] = baseline
        _pinned[tier] = {"reason": reason, "prev_env": prev}
    obs.inc("dj_degrade_total", tier=tier)
    obs.record("degrade", tier=tier, baseline=baseline, reason=reason)


def _knob_tier(knob: str) -> Optional[str]:
    for tier, (k, _) in TIER_BASELINE.items():
        if k == knob:
            return tier
    return None


def knob_pinned(knob: str) -> bool:
    """Whether the ladder pinned the tier that owns env knob ``knob``."""
    return _knob_tier(knob) in _pinned


def keep_pin_past_scope(knob: str, outer: Optional[str]) -> bool:
    """A scoped override of ``knob`` ends (the autotuner's candidate and
    dispatch envs). When the ladder pinned the knob's tier inside the
    scope, the pin keeps its baseline in the env and takes ``outer``, the
    value from before the scope, as what :func:`reset_pins` restores:
    returns True, and the scope must restore nothing. Else False."""
    tier = _knob_tier(knob)
    with _pin_lock:
        pin = _pinned.get(tier)
        if pin is None:
            return False
        pin["prev_env"] = outer
        return True


def reset_pins() -> None:
    """Unpin every tier, restoring the env knobs they overwrote (tests;
    a process that wants to re-qualify a tier)."""
    with _pin_lock:
        for tier, pin in _pinned.items():
            knob, _ = TIER_BASELINE[tier]
            if knob is None:
                continue
            if pin["prev_env"] is None:
                os.environ.pop(knob, None)
            else:
                os.environ[knob] = pin["prev_env"]
        _pinned.clear()


def _tier_active(tier: str, config, compression) -> bool:
    if tier in _pinned:
        return False
    if tier == "merge":
        from ..ops.join import resolve_merge_impl  # lazy: keep import order flat

        return resolve_merge_impl() != "sort"
    if tier == "adapt":
        from ..parallel import plan_adapt  # lazy: keep import order flat

        return plan_adapt.enabled()
    if tier == "autotune":
        from ..parallel import autotune  # lazy: keep import order flat

        return autotune.enabled()
    if tier == "wire":
        return compression is not None or (
            getattr(config, "left_compression", None) is not None
            or getattr(config, "right_compression", None) is not None
        )
    if tier == "expand":
        from ..ops.join import resolve_probe_expand  # lazy: keep import order flat

        return resolve_probe_expand() != "hist"
    if tier == "prepared_tier":
        return knobs.read("DJT_PREPARED_TIER") not in (None, "", "shuffle")
    return False


def _culprit_tier(exc, tiers, config, compression) -> Optional[str]:
    """The tier to pin for ``exc``: the fault site's own tier when the
    exception names one, else the first active unpinned tier of the call
    site's ladder (one pin a retry: the loop ends because pins only
    accumulate)."""
    if isinstance(exc, FaultInjected):
        t = _SITE_TIER.get(exc.site)
        if t is not None:
            return t if (t in tiers and _tier_active(t, config, compression)) else None
    for t in tiers:
        if _tier_active(t, config, compression):
            return t
    return None


def strip_pinned_wire(config):
    """The wire tier's pin applied to a JoinConfig: compression options
    dropped when "wire" is pinned (it has no env knob). Callers resolve
    this INSIDE their degrade_guard attempt, so the retry after a codec
    pin runs uncompressed."""
    if config is None or "wire" not in _pinned:
        return config
    if (
        getattr(config, "left_compression", None) is None
        and getattr(config, "right_compression", None) is None
    ):
        return config
    return dataclasses.replace(config, left_compression=None, right_compression=None)


def _kernel_failure(exc) -> bool:
    """A kernel that did not build, load or launch, or a device fault:
    no tier's baseline may hide either."""
    if isinstance(exc, KernelError):
        return True
    import torch  # lazy: the ladder's bookkeeping is stdlib

    accel = getattr(torch, "AcceleratorError", None)
    return accel is not None and isinstance(exc, accel)


def degrade_guard(where: str, attempt, *, tiers=(), config=None, compression=None,
                  topology=None):
    """Run ``attempt()`` under the degradation ladder.

    On an exception with an active, unpinned optional tier from
    ``tiers``: pin that tier's baseline (one ``degrade`` event) and
    retry; ``attempt`` must re-read the pins (the env knobs,
    strip_pinned_wire) so the retry runs the baseline. With no candidate
    tier the exception propagates unchanged. PlanMismatch,
    CapacityExhausted and DeadlineExceeded always propagate: they are
    routing signals for the heal and serving layers above, not tier
    failures. So do a :class:`KernelError` and a device fault
    (``torch.AcceleratorError``): a failing kernel fails the call, and
    is never served by another tier. With ``topology`` a process world
    of more than one process, only :class:`FaultInjected` (consulted
    alike by every process) pins and retries; any other failure
    propagates, as it would with no tier active.
    """
    multi_process = (topology is not None and topology.is_process_world
                     and topology.process_count > 1)
    while True:
        try:
            return attempt()
        except (PlanMismatch, CapacityExhausted, DeadlineExceeded, KernelError):
            raise
        except Exception as e:  # noqa: BLE001 - the ladder filters below
            if _kernel_failure(e) or (multi_process and not isinstance(e, FaultInjected)):
                raise
            tier = _culprit_tier(e, tiers, config, compression)
            if tier is None:
                raise
            pin_baseline(tier, f"{where}: {type(e).__name__}: {str(e)[:200]}")

"""Typed errors of the join, so a caller can route a failure.

Counterpart of the taxonomy in ``dj_tpu/resilience/errors.py:42-200``:
retry with wider factors (:class:`CapacityExhausted`), re-prepare the
build side (:class:`PlanMismatch`), restart the process group
(:class:`BackendError`), shed a query whose deadline passed
(:class:`DeadlineExceeded`), and the serving stack's door errors
(:class:`AdmissionRejected`, :class:`QueueFull`, :class:`Draining`)
and test and audit errors (:class:`FaultInjected`,
:class:`ContractViolation`). Each subclasses ``RuntimeError``. The
degradation ladder of that module (``degrade_guard``, ``pin_baseline``:
swap in a baseline tier when a tier fails) is not ported: the port keeps
such fallbacks off its kernel path, and the ladder waits for the serving
stack.
"""

from __future__ import annotations

from typing import Optional


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
    """Raised by an armed fault site. Carries ``site`` and ``call``."""

    def __init__(self, site: str, call: int):
        super().__init__(f"fault injected: {site}@call={call}")
        self.site = site
        self.call = call


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

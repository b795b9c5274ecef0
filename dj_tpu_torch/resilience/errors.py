"""Typed errors of the join, so a caller can route a failure.

Counterpart of the taxonomy in ``dj_tpu/resilience/errors.py``: retry
with wider factors (:class:`CapacityExhausted`) or re-prepare the build
side (:class:`PlanMismatch`), or restart the process group
(:class:`BackendError`). Each subclasses ``RuntimeError``. The
degradation ladder of that module has no counterpart yet: the port has
no optional tier that could fail to build while a baseline works.
"""

from __future__ import annotations

from typing import Optional


class DJError(RuntimeError):
    """Base of every typed dj_tpu_torch error."""


class CapacityExhausted(DJError):
    """Overflow flags still fired when the attempts ran out. Carries
    ``stage``, ``attempts`` and ``flags`` (name -> fired bool)."""

    def __init__(
        self,
        message: str,
        *,
        stage: Optional[str] = None,
        attempts: Optional[int] = None,
        flags: Optional[dict] = None,
    ):
        super().__init__(message)
        self.stage = stage
        self.attempts = attempts
        self.flags = dict(flags or {})


class PlanMismatch(DJError):
    """The probe side (or the build data) is structurally incompatible
    with a prepared plan: odf, key dtypes, a batch sizing whose tag
    width differs from the prepared words', or build keys outside a
    declared range. Heal by re-preparing."""


class BackendError(DJError):
    """The distributed backend failed past its retry budget (the
    process group's bootstrap). Not healable by capacity growth or
    re-preparation: restart or fail over."""


# The name the prepared path raises under, as in dj_tpu.parallel.dist_join.
PreparedPlanMismatch = PlanMismatch

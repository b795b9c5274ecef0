"""dj_tpu_torch.resilience: how the join fails and heals.

Counterpart of ``dj_tpu/resilience/__init__.py`` without the degradation
ladder and the fault injection:

- errors.py: the :class:`DJError` taxonomy (CapacityExhausted,
  PlanMismatch, DeadlineExceeded, ...);
- heal.py: the budgeted heal engine (:func:`run_healed`,
  :class:`HealBudget`, :func:`deadline_scope`) behind
  ``distributed_inner_join_auto`` and ``prepare_join_side``;
- ledger.py: the capacity ledger, learned factors and plan repairs per
  workload signature, kept in ``DJT_LEDGER=<path>`` if set.
"""

from . import ledger
from .errors import (
    AdmissionRejected,
    BackendError,
    CapacityExhausted,
    ContractViolation,
    DeadlineExceeded,
    DJError,
    Draining,
    FaultInjected,
    PlanMismatch,
    PreparedPlanMismatch,
    QueueFull,
)
from .heal import (
    HealBudget,
    check_deadline,
    deadline_scope,
    flag_fired,
    run_healed,
    summarize_flags,
)
from .ledger import plan_signature

__all__ = [
    "AdmissionRejected",
    "BackendError",
    "CapacityExhausted",
    "ContractViolation",
    "DJError",
    "DeadlineExceeded",
    "Draining",
    "FaultInjected",
    "HealBudget",
    "PlanMismatch",
    "PreparedPlanMismatch",
    "QueueFull",
    "check_deadline",
    "deadline_scope",
    "flag_fired",
    "ledger",
    "plan_signature",
    "run_healed",
    "summarize_flags",
]

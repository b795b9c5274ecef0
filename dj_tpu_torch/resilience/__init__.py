"""dj_tpu_torch.resilience: how the join fails, heals and degrades.

Counterpart of ``dj_tpu/resilience/__init__.py``, with the same
``__all__``:

- errors.py: the :class:`DJError` taxonomy (CapacityExhausted,
  PlanMismatch, DeadlineExceeded, FaultInjected, ...) and the tier
  degradation ladder (:func:`degrade_guard`): a failing optional tier
  (the CUDA merge kernel, the probe tier's expansion, the compressed
  wire, the adaptive plans, the prepared build tiers, the autotuner,
  fleet coordination) is pinned to its baseline for the process and the
  call retried;
- heal.py: the budgeted heal engine (:func:`run_healed`,
  :class:`HealBudget`, :func:`deadline_scope`) behind
  ``distributed_inner_join_auto``, ``prepare_join_side`` and
  ``shuffle_on_auto``;
- ledger.py: the capacity ledger, learned factors and plan repairs per
  workload signature, kept in ``DJT_LEDGER=<path>`` if set (re-read on a
  miss under ``DJT_FLEET_DIR``);
- faults.py: deterministic fault injection (``DJT_FAULT=site@call=N``),
  named host-side sites firing on exact call counts; a strict no-op
  when unset.
"""

from . import faults, ledger
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
    degrade_guard,
    pin_baseline,
    pinned_tiers,
    reset_pins,
    strip_pinned_wire,
    tier_pinned,
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

# dj_tpu's list. Draining, PreparedPlanMismatch and summarize_flags are
# importable from here too, outside it.
__all__ = [
    "AdmissionRejected",
    "BackendError",
    "CapacityExhausted",
    "ContractViolation",
    "DJError",
    "DeadlineExceeded",
    "FaultInjected",
    "HealBudget",
    "PlanMismatch",
    "QueueFull",
    "check_deadline",
    "deadline_scope",
    "degrade_guard",
    "faults",
    "flag_fired",
    "ledger",
    "pin_baseline",
    "pinned_tiers",
    "plan_signature",
    "reset_pins",
    "run_healed",
    "strip_pinned_wire",
    "tier_pinned",
]

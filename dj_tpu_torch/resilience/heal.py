"""The budgeted heal engine: the one retry loop behind the auto wrappers.

Counterpart of ``dj_tpu/resilience/heal.py:69-299``. Static capacities
make a wrong sizing factor produce overflow flags and unspecified rows,
never silent garbage (inner_join's overflow contract). The auto wrappers
(``distributed_inner_join_auto``, its prepared half and
``prepare_join_side``) run an attempt, read the flags on the host,
multiply exactly the offending factor and run again.

Per attempt, in this order:

1. **Poison flags** (``pack_range_overflow``, ``prep_range_violation``,
   ``prepared_plan_mismatch``): the whole result is unspecified, so no
   other flag of the attempt is trusted. The caller's handler repairs
   the plan (drops a declared range, re-probes, re-prepares) and the
   attempt runs again without growth.
2. **Capacity flags**: each fired flag's factors (``heal_map``) grow by
   ``budget.growth``; the ledger learns the new factors; again.
3. **Terminal flags** (``surrogate_collision``): trusted only on an
   attempt without capacity overflow, where the handler raises.

The budget is an attempt cap and a cap on any one factor's total growth
(:class:`HealBudget`); either exhausted raises
:class:`~.errors.CapacityExhausted` with the last stage, attempt count,
flags and factors. With a plan signature the engine consults the
capacity ledger (:mod:`.ledger`) before the first attempt and updates it
after each heal. Between attempts it checks the caller's deadline
(:func:`deadline_scope`). dj_tpu's flight-recorder events, counters and
its roofline ``sync`` phase have no counterpart here yet.

In a process world every process reads the same all-gathered flag
matrix, so each takes the same heal. The ledger is per process: a world
whose processes start from different ledger entries sizes its exchanges
differently on each and fails, at the first exchange whose sizes differ
(gloo aborts on the mismatch) or at the collective timeout
(``DJT_COLLECTIVE_TIMEOUT_S``), instead of joining; give every process
the same ``DJT_LEDGER`` file, or none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from . import ledger as _ledger
from .errors import CapacityExhausted, DeadlineExceeded


@dataclasses.dataclass(frozen=True)
class HealBudget:
    """Retry budget: ``max_attempts`` bounds the loop, ``growth`` is the
    multiplier of one heal, ``max_total_growth`` bounds any one factor's
    total growth over its first value (at growth 2 the default 4096
    allows 12 doublings of one factor)."""

    max_attempts: int = 8
    growth: float = 2.0
    max_total_growth: float = 4096.0

    def validate(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if not self.growth > 1.0:
            raise ValueError(f"growth must be > 1.0, got {self.growth}")
        if not self.max_total_growth >= 1.0:
            raise ValueError(f"max_total_growth must be >= 1.0, got {self.max_total_growth}")


# The deadline of the heal loops on this thread: (monotonic deadline,
# submitted budget, start), or None.
_deadline_tls = threading.local()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[float], deadline_s: Optional[float] = None):
    """Make ``deadline`` (absolute ``time.monotonic()`` seconds; None:
    none) visible to every ``run_healed`` loop on this thread for the
    body. Between heal attempts the engine raises
    :class:`~.errors.DeadlineExceeded` (``where="healing"``) once the
    clock passes it. Scopes nest; the previous one returns on exit."""
    prev = getattr(_deadline_tls, "scope", None)
    _deadline_tls.scope = None if deadline is None else (deadline, deadline_s, time.monotonic())
    try:
        yield
    finally:
        _deadline_tls.scope = prev


def check_deadline(where: str) -> None:
    """Raise DeadlineExceeded if this thread's deadline_scope has
    expired; a no-op outside a scope."""
    scope = getattr(_deadline_tls, "scope", None)
    if scope is None:
        return
    deadline, deadline_s, start = scope
    now = time.monotonic()
    if now > deadline:
        raise DeadlineExceeded(
            f"deadline expired {where} (budget "
            f"{deadline_s if deadline_s is not None else deadline - start:g}s,"
            f" elapsed {now - start:.3f}s)",
            where=where,
            deadline_s=deadline_s,
            elapsed_s=round(now - start, 6),
        )


def flag_fired(value) -> bool:
    """Host truthiness of one flag entry: python bools pass through,
    tensors and arrays reduce with any()."""
    if value is None:
        return False
    if isinstance(value, (bool, int)):
        return bool(value)
    if isinstance(value, torch.Tensor):
        return bool(value.any())
    return bool(np.asarray(value).any())


def summarize_flags(info: Mapping) -> dict:
    return {k: flag_fired(v) for k, v in info.items()}


def run_healed(
    *,
    name: str,
    stage: str,
    budget: HealBudget,
    run_attempt: Callable[[int], tuple],
    heal_map: Mapping[str, Sequence[str]],
    read_factors: Callable[[], dict],
    apply_factors: Callable[[dict], None],
    poison: Optional[Mapping[str, Callable]] = None,
    terminal: Optional[Mapping[str, Callable]] = None,
    mismatch_excs: tuple = (),
    on_mismatch: Optional[Callable] = None,
    ledger_key: Optional[str] = None,
    ledger_extra: Optional[Callable[[], dict]] = None,
    apply_ledger_entry: Optional[Callable[[dict], None]] = None,
):
    """Run ``run_attempt`` under the heal contract (module docstring).

    ``run_attempt(attempt) -> (payload, info)`` runs one attempt with
    the caller's current factors; ``read_factors`` / ``apply_factors``
    read and grow them. ``poison[flag](info, attempt)`` repairs the plan
    and returns (the engine runs again); ``terminal[flag](info)``
    raises. ``mismatch_excs`` and ``on_mismatch(exc, attempt)`` bring a
    structural mismatch raised as an exception into the same loop.

    Returns ``(payload, info, attempt)`` of the first clean attempt.
    Raises CapacityExhausted when the attempt cap or the total-growth
    cap runs out with capacity flags still firing.
    """
    budget.validate()
    poison = dict(poison or {})
    terminal = dict(terminal or {})
    initial = dict(read_factors())

    def _ledger_update():
        if ledger_key is None:
            return
        extra = ledger_extra() if ledger_extra is not None else {}
        _ledger.update(ledger_key, factors=read_factors(), **extra)

    if ledger_key is not None:
        entry = _ledger.lookup(ledger_key)
        if entry is not None:
            widened = _ledger.wider_factors(entry.get("factors", {}), read_factors())
            if widened:
                apply_factors(widened)
            if apply_ledger_entry is not None:
                apply_ledger_entry(entry)

    info: dict = {}
    for attempt in range(1, budget.max_attempts + 1):
        if attempt > 1:
            check_deadline("healing")
        try:
            payload, info = run_attempt(attempt)
        except mismatch_excs as e:
            if on_mismatch is None:
                raise
            on_mismatch(e, attempt)
            _ledger_update()
            continue
        fired_map = summarize_flags(info)
        # 1) poison flags: nothing else of this attempt is trusted.
        handled = False
        for flag, handler in poison.items():
            if fired_map.get(flag):
                handler(info, attempt)
                handled = True
                break
        if handled:
            _ledger_update()
            continue
        # 2) capacity flags: grow exactly the offending factors.
        grew: dict[str, float] = {}
        factors_now = read_factors()
        for flag, fnames in heal_map.items():
            if fired_map.get(flag):
                for f in fnames:
                    grew[f] = factors_now[f] * budget.growth
        if not grew:
            # 3) terminal flags, trusted only without capacity overflow.
            for flag, handler in terminal.items():
                if fired_map.get(flag):
                    handler(info)
            return payload, info, attempt
        for f, v in grew.items():
            base = initial.get(f, v)
            if base > 0 and v / base > budget.max_total_growth * (1 + 1e-9):
                raise CapacityExhausted(
                    f"{name}: factor growth budget exhausted at attempt "
                    f"{attempt} ({f}: {base:g} -> {v:g} exceeds "
                    f"max_total_growth={budget.max_total_growth:g}; "
                    f"last flags: {summarize_flags(info)}; final "
                    f"factors: {factors_now})",
                    stage=stage, attempts=attempt,
                    flags=summarize_flags(info), factors=factors_now,
                )
        apply_factors(grew)
        _ledger_update()
    raise CapacityExhausted(
        f"{name}: capacity overflow persists after {budget.max_attempts} "
        f"attempts (last flags: {summarize_flags(info)}; final factors: "
        f"{read_factors()})",
        stage=stage, attempts=budget.max_attempts,
        flags=summarize_flags(info), factors=read_factors(),
    )

"""dj_tpu_torch.serve: the admission-controlled query scheduler.

Counterpart of ``dj_tpu/serve/__init__.py``, with its ``__all__``. The
serving loop in front of ``distributed_inner_join_auto``
(``scheduler.py``'s docstring has the design): admission against a byte
model forecast (``DJT_SERVE_HBM_BUDGET``), a bounded FIFO with
per-query monotonic deadlines (``DJT_SERVE_QUEUE_DEPTH``), a pressure
ladder over the degradation tiers, and coalescing of same-signature
queries into one dispatch. Every submitted query ends in exactly one
typed state: a result, or a :class:`~..resilience.errors.DJError`.
"""

from __future__ import annotations

from ..obs import metrics as _metrics
from .admission import Forecast, forecast, query_signature
from .scheduler import _SCHEDULERS, MAX_PRESSURE_LEVEL, QueryScheduler, ServeConfig, Ticket

__all__ = [
    "Forecast",
    "MAX_PRESSURE_LEVEL",
    "QueryScheduler",
    "ServeConfig",
    "Ticket",
    "forecast",
    "query_signature",
    "reset",
    "schedulers_snapshot",
]


def schedulers_snapshot() -> list:
    """``QueryScheduler.snapshot()`` of every live scheduler of the
    process; one tearing down is skipped, not raised."""
    out = []
    for s in list(_SCHEDULERS):
        try:
            out.append(s.snapshot())
        except Exception:  # noqa: BLE001 - health must always answer
            pass
    return out


def reset() -> None:
    """Reset all serving state of the process (tests, maintenance): every
    live scheduler sheds its queue and forgets its pressure and SLO
    history, and the ``dj_serve`` / ``dj_slo`` / ``dj_forecast`` /
    ``dj_tenant`` / ``dj_fleet`` series clear. Tier pins are
    ``resilience.reset_pins``'s."""
    for s in list(_SCHEDULERS):
        try:
            s.reset()
        except Exception:  # noqa: BLE001 - reset must reset the rest
            pass
    for prefix in ("dj_serve", "dj_slo", "dj_forecast", "dj_tenant", "dj_fleet"):
        _metrics.clear_prefix(prefix)

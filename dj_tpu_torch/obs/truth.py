"""Measured truth, the device half: what the card's allocator holds now.

Counterpart of ``dj_tpu/obs/truth.py`` less its compiled-module half.
Everything the serving stack prices (admission forecasts, the index
budget, the autotuner's candidates) trusts modeled bytes
(``obs.bytemodel``). This module asks the device:

- **Live HBM** (:func:`sample_device_hbm`): the allocator of each CUDA
  device this process uses (its current device, or one it has held
  memory on), ``torch.cuda.memory_stats(d)`` (``allocated_bytes.all
  .current`` in use, ``allocated_bytes.all.peak`` the peak) and
  ``torch.cuda.get_device_properties(d).total_memory`` (the card's
  total; no read opens a context on a device), sampled into the
  ``dj_device_hbm_{in_use,peak}_bytes{device}`` gauges. With
  ``DJT_SERVE_MEASURED_HBM=1``, :func:`measured_admission` turns the
  sample into an admission input: the headroom left under a budget
  (budget - bytes_in_use - ``DJT_SERVE_MEASURED_HBM_HEADROOM``). With no
  CUDA device the seam (:func:`_device_list`) yields nothing and both
  return None, dj_tpu's documented no-op on a CPU backend.
- **The forecast scope** (:func:`forecast_scope`): the admission
  forecast of the dispatch running on this thread: the query scheduler
  opens it around each dispatch (``serve.scheduler``).
- **Per-tenant accounting** (:func:`tenant_summary`): the tenant-labeled
  families (``dj_tenant_wire_bytes_total``, device seconds, prepares,
  index bytes, the per-tenant latency histogram) in one view.

Left out: dj_tpu's ``armed``, ``extract``, ``wrap_extraction``,
``_cost_dict`` and ``_memory_fields``, the ``dj_xla_*`` gauges, the
``xla_cost`` event and ``dj_model_xla_ratio``. Each reads
``cost_analysis()`` / ``memory_analysis()`` of a compiled XLA module;
the port compiles none, and torch has no counterpart (ROADMAP item 10c).
:func:`truth_summary` keeps dj_tpu's keys, those fields None, 0 or
empty.

Stdlib and torch only; torch.cuda is read inside the sampling helpers.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from .. import knobs
from . import metrics as _metrics

__all__ = [
    "current_forecast",
    "forecast_scope",
    "measured_admission",
    "sample_device_hbm",
    "tenant_summary",
    "truth_summary",
]

_tls = threading.local()


@contextlib.contextmanager
def forecast_scope(model_bytes: Optional[float]):
    """Make ``model_bytes`` (a dispatch's admission forecast) this
    thread's ambient forecast for the body; nesting keeps the innermost."""
    prev = getattr(_tls, "forecast", None)
    _tls.forecast = float(model_bytes) if model_bytes and model_bytes > 0 else None
    try:
        yield
    finally:
        _tls.forecast = prev


def current_forecast() -> Optional[float]:
    return getattr(_tls, "forecast", None)


# --- live device HBM -------------------------------------------------------


class _CudaDevice:
    """One CUDA device's allocator, in the shape of dj_tpu's
    ``device.memory_stats()``. Neither read opens a context on the
    device: the allocator's counters are host state, and the limit is
    the device's total memory from its properties."""

    def __init__(self, index: int):
        self.id = index

    def used(self) -> bool:
        """Whether this process uses the device: its current device, or
        one its allocator has held memory on."""
        import torch

        return (self.id == torch.cuda.current_device()
                or torch.cuda.memory_stats(self.id).get("allocated_bytes.all.peak", 0) > 0)

    def memory_stats(self) -> dict:
        import torch

        st = torch.cuda.memory_stats(self.id)
        return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(torch.cuda.get_device_properties(self.id).total_memory)}


def _device_list():
    """The devices to sample, one object a CUDA device with ``id`` and
    ``memory_stats()``; none without CUDA, or before this process has
    initialized it. A seam the tests replace with fake devices."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return [_CudaDevice(i) for i in range(torch.cuda.device_count())]


def _used_here(device) -> bool:
    """Only the devices this process uses are sampled: in a process world
    with every card visible, another process's card would report this
    process's allocator (near 0) under its label. A device object with
    no ``used()`` (dj_tpu's) counts as used."""
    used = getattr(device, "used", None)
    return used is None or bool(used())


def sample_device_hbm(force: bool = False) -> Optional[dict]:
    """``{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}}`` of
    the devices this process uses that report stats, published as the
    ``dj_device_hbm_{in_use,peak}_bytes{device}`` gauges; None when none
    does (no CUDA device). A no-op while obs is disabled unless
    ``force`` (the admission input needs the sample regardless)."""
    if not force and not _metrics.enabled():
        return None
    try:
        devices = _device_list()
    except Exception:  # noqa: BLE001 - sampling must never fail a caller
        return None
    out: dict = {}
    for d in devices:
        try:
            st = d.memory_stats() if _used_here(d) else None
        except Exception:  # noqa: BLE001
            st = None
        if not st:
            continue
        in_use = st.get("bytes_in_use")
        if in_use is None:
            continue
        label = str(getattr(d, "id", len(out)))
        out[label] = {
            "bytes_in_use": int(in_use),
            "peak_bytes_in_use": int(st.get("peak_bytes_in_use", in_use) or in_use),
            "bytes_limit": (int(st["bytes_limit"]) if st.get("bytes_limit") is not None
                            else None),
        }
        if _metrics.enabled():
            _metrics.set_gauge("dj_device_hbm_in_use_bytes", float(in_use), device=label)
            _metrics.set_gauge("dj_device_hbm_peak_bytes",
                               float(out[label]["peak_bytes_in_use"]), device=label)
    return out or None


def measured_admission(budget: float) -> Optional[dict]:
    """The ``DJT_SERVE_MEASURED_HBM=1`` admission input: the most loaded
    device's occupancy and the headroom left under ``budget`` after the
    ``DJT_SERVE_MEASURED_HBM_HEADROOM`` margin. None when the knob is
    off or no device reports stats. Works with obs off: it is an
    admission input, not telemetry."""
    if budget <= 0 or not knobs.read_bool("DJT_SERVE_MEASURED_HBM"):
        return None
    sample = sample_device_hbm(force=True)
    if not sample:
        return None
    device, st = max(sample.items(), key=lambda kv: kv[1]["bytes_in_use"])
    margin = max(0.0, knobs.read_float("DJT_SERVE_MEASURED_HBM_HEADROOM"))
    return {"device": device, "bytes_in_use": st["bytes_in_use"],
            "peak_bytes_in_use": st["peak_bytes_in_use"], "margin_bytes": margin,
            "headroom_bytes": float(budget) - st["bytes_in_use"] - margin}


# --- per-tenant accounting -------------------------------------------------


def _by_tenant(series: dict) -> dict:
    out: dict = {}
    for labels, v in series.items():
        t = dict(labels).get("tenant")
        if t is not None:
            out[t] = out.get(t, 0.0) + v
    return out


def tenant_summary() -> dict:
    """Per tenant: wire bytes, device seconds, prepares, resident index
    bytes and the result-latency count, p50 and p95. A tenant appears
    once any of its families holds a value. Pending device phases are
    resolved first (a served run's device seconds arrive with them), as
    the latency quantiles below would."""
    _metrics._resolve_pending()
    wire = _by_tenant(_metrics.counter_series("dj_tenant_wire_bytes_total"))
    secs = _by_tenant(_metrics.counter_series("dj_tenant_device_seconds_total"))
    preps = _by_tenant(_metrics.counter_series("dj_tenant_prepares_total"))
    index = _by_tenant(_metrics.gauge_series("dj_tenant_index_bytes"))
    tenants: dict = {}
    for t in sorted(set(wire) | set(secs) | set(preps) | set(index)):
        raw = _metrics.histogram_raw("dj_serve_latency_seconds", tenant=t, outcome="result")
        tenants[t] = {
            "wire_bytes": wire.get(t, 0.0),
            "device_seconds": round(secs.get(t, 0.0), 6),
            "prepares": int(preps.get(t, 0)),
            "index_bytes": index.get(t, 0.0),
            "queries_ok": 0 if raw is None else raw[3],
            "latency_p50_s": _metrics.histogram_quantile(
                "dj_serve_latency_seconds", 0.5, tenant=t, outcome="result"),
            "latency_p95_s": _metrics.histogram_quantile(
                "dj_serve_latency_seconds", 0.95, tenant=t, outcome="result"),
        }
    return {"tenants": tenants}


def truth_summary() -> dict:
    """dj_tpu's measured-truth block: the live device sample and its
    peak, the tenant totals, and the compiled-module fields it cannot
    have (module docstring) as None, 0 or empty."""
    sample = sample_device_hbm(force=True)
    return {
        "model_xla_ratio_p50": None,
        "model_xla_ratio_p95": None,
        "xla_cost_events": 0,
        "xla_peak_hbm_bytes": {},
        "measured_hbm": sample,
        "measured_peak_hbm_bytes": (max(s["peak_bytes_in_use"] for s in sample.values())
                                    if sample else None),
        "tenants": {t: {k: s[k] for k in ("wire_bytes", "device_seconds", "prepares",
                                          "index_bytes")}
                    for t, s in tenant_summary()["tenants"].items()},
    }

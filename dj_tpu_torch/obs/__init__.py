"""dj_tpu_torch.obs: the flight recorder, the metrics registry, query
traces and roofline phases, and the planner's host-side models.

Counterpart of ``dj_tpu/obs/``:

- metrics.py: in-process counters, gauges and histograms, with
  ``metrics_text()`` (Prometheus text) and ``metrics_summary()``; a
  strict no-op while disabled.
- recorder.py: the bounded ring of structured events, flushed as JSONL
  through ``DJT_OBS_LOG=<path>`` or read with ``events()`` / ``drain()``;
  and the per-query collective counters that the communicators feed.
- trace.py: ``query_ctx(query_id, tenant)`` stamps every event recorded
  inside it and feeds a bounded per-query timeline store;
  ``query_trace`` and ``export_trace`` read one query back.
- roofline.py: the host-visible phases of every query (probe, dispatch,
  sync, prep), timed with CUDA events on the card and priced against the
  ``DJT_PEAK_HBM_GBPS`` / ``DJT_PEAK_WIRE_GBPS`` roofline.
- bytemodel.py: the byte model (``hbm_model_bytes``,
  ``pipeline_model_bytes``, ``prepared_side_bytes``) in dj_tpu's terms,
  and the buffer bytes the collective counters and the broadcast fit
  count.
- skew.py: the per-link wire matrix ``dj_wire_bytes_total{src,dst,width}``
  (fed by the collective counters), the ``DJT_OBS_SKEW=1`` partition-skew
  probe's ``skew`` events and gauges, and ``fleet_snapshot`` (one
  gather of every process's phase totals and wire rows, the stragglers).
- truth.py: the device half of dj_tpu's measured truth: the card's
  allocator sampled into ``dj_device_hbm_*`` gauges, the
  ``DJT_SERVE_MEASURED_HBM`` admission input, the forecast scope and the
  per-tenant view.
- history.py: the snapshot ring (``sample_now``, a sampler thread) and
  the multi-window burn-rate alerts (``slo_alert``).
- fleet.py: the rank anomaly detector over the fleet snapshots, fed by
  ``skew``'s hook, and ``fleet_health``.
- http.py: the ``DJT_OBS_HTTP`` endpoint (``/metrics``, ``/healthz``,
  ``/trendz``, ``/fleetz``, ``/profilez`` and the rest).
- forensics.py: the ``DJT_OBS_BLACKBOX`` crash black box.

Enable with ``DJT_OBS=1`` or ``DJT_OBS_LOG=<path>`` (or ``enable()``).
Everything is host-side Python; with obs disabled the join path takes
no lock of it and makes no call more than without it.

dj_tpu's trace-time compile accounting (``cached_build``,
``capture_epochs``, ``record_epoch``, ``run_accounted``,
``epoch_total_bytes``, the ``retrace`` and ``collective_epoch`` events,
the build-cache counters) has no jit to hook here and is left out;
``recorder.suppress_epochs`` is a scope of the port's own collective
counting. The compiled-module half of truth (``DJ_OBS_TRUTH``: XLA's
cost and memory analyses, ``dj_xla_*``, ``dj_model_xla_ratio``) has no
torch counterpart and is left out too (ROADMAP item 10c); so are the
fields of the endpoint's payloads that read them.
"""

from . import bytemodel, skew
from .bytemodel import buffer_bytes, hbm_model_bytes, prepared_side_bytes
from .metrics import (
    clear_prefix,
    counter_series,
    counter_value,
    disable,
    enable,
    enabled,
    gauge_series,
    gauge_value,
    histogram_quantile,
    histogram_raw,
    inc,
    metrics_summary,
    metrics_text,
    observe,
    set_gauge,
)
from .recorder import (
    count_collectives,
    drain,
    events,
    mirror_warning,
    record,
    reset,
    ring_capacity,
    set_log_path,
    table_sig,
    write_snapshot,
)
from . import roofline  # noqa: E402  (per-query phase attribution)
from . import truth  # noqa: E402  (the device half of measured truth)
from . import history  # noqa: E402  (snapshot ring and burn-rate alerts)
from . import fleet  # noqa: E402  (rank anomaly detection)
from . import http  # noqa: E402  (the DJT_OBS_HTTP endpoint)
from . import forensics  # noqa: E402  (the crash black box)
from .skew import fleet_snapshot
from .trace import (
    blackbox_traces,
    current_query,
    export_trace,
    query_ctx,
    query_trace,
    recent_traces,
    span,
    span_begin,
    span_end,
)

__all__ = [
    "blackbox_traces",
    "buffer_bytes",
    "bytemodel",
    "clear_prefix",
    "count_collectives",
    "counter_series",
    "counter_value",
    "current_query",
    "disable",
    "drain",
    "enable",
    "enabled",
    "events",
    "export_trace",
    "fleet",
    "fleet_snapshot",
    "forensics",
    "gauge_series",
    "hbm_model_bytes",
    "gauge_value",
    "histogram_quantile",
    "histogram_raw",
    "history",
    "http",
    "inc",
    "metrics_summary",
    "metrics_text",
    "mirror_warning",
    "observe",
    "prepared_side_bytes",
    "query_ctx",
    "query_trace",
    "recent_traces",
    "record",
    "reset",
    "ring_capacity",
    "roofline",
    "set_gauge",
    "set_log_path",
    "skew",
    "span",
    "span_begin",
    "span_end",
    "table_sig",
    "truth",
    "write_snapshot",
]

"""The ``DJT_*`` knob registry: every environment variable the port reads.

Counterpart of ``dj_tpu/knobs.py``. Each knob is one :class:`Knob`
record (name, default, kind, one-line doc, cleanup class); the package
reads them through :func:`read` and its typed siblings, so a knob's
default has one owner. ``tests/test_torch_knobs.py`` holds the registry
to the code both ways: every ``DJT_*`` literal in ``dj_tpu_torch/`` and
``chip_smoke.py`` is registered, every registered name is read
somewhere, and README's port section documents each one.

Stdlib only, like dj_tpu's: importing it imports no torch.

Cleanup classes answer one question for a test fixture: must it clear
the variable around each test? :func:`reset_names` lists the names of
the reset classes ("serve", "plan", "resilience"): process-global
planning and serving state that one test must not leak into the next.
"trace" knobs pick kernels and plans (tests set them per case with
monkeypatch); "ambient" knobs are process infrastructure (bootstrap
coordinates, the obs sinks, the roofline peaks).

dj_tpu's ``trace_env_names`` (the builders' cache key) and its
deprecated aliases have no counterpart: the port builds no module per
knob setting, and no ``DJT_*`` name was ever renamed.

Left out of dj_tpu's measurement family: ``DJ_OBS_TRUTH``, which arms
the compiled-module half of ``obs.truth`` (``cost_analysis()`` /
``memory_analysis()`` of each fresh XLA module). The port compiles no
module, and torch has no counterpart of either analysis. The drift
threshold ``DJT_SERVE_DRIFT_THRESHOLD`` is kept: the scheduler's drift
audit is ``serve.admission.reprice`` over the byte model (the forecast
against the config the query ran with), which needs no XLA analysis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

__all__ = [
    "KNOBS",
    "Knob",
    "REGISTRY",
    "RESET_CLASSES",
    "read",
    "read_bool",
    "read_float",
    "read_int",
    "registry_snapshot",
    "reset_names",
    "scoped",
]

RESET_CLASSES = ("serve", "index", "plan", "resilience")
_CLASSES = RESET_CLASSES + ("trace", "ambient")
_TRUTHY = ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Knob:
    """One registered environment knob: its ``DJT_*`` name, the value an
    unset variable reads as (None: unset means something of its own),
    its kind ("bool", "int", "float", "str", "enum" or "path"), a
    one-line description, its cleanup class and, for an enum, the legal
    values."""

    name: str
    default: object
    kind: str
    doc: str
    cleanup: str
    choices: tuple = ()


KNOBS: tuple[Knob, ...] = (
    # --- kernel and plan selection of one join --------------------------
    Knob("DJT_JOIN_EXPAND", "vmeta", "enum",
         "expansion mode of the unprepared join", "trace",
         choices=("vmeta", "ranks", "hist", "fused", "join", "vcarry", "vfull")),
    Knob("DJT_JOIN_CARRY", "0", "bool",
         "carry the payloads through the expansion (1)", "trace"),
    Knob("DJT_JOIN_PACK", "1", "bool",
         "packed single-word merged sort (0 restores the split plan)", "trace"),
    Knob("DJT_JOIN_MERGE", "sort", "enum",
         "prepared join's merge tier", "trace", choices=("sort", "merge", "probe")),
    Knob("DJT_PROBE_EXPAND", "segment", "enum",
         "probe tier's expansion", "trace", choices=("segment", "hist", "pallas")),
    Knob("DJT_STRING_VERIFY", "1", "bool",
         "verify string keys that share a 64-bit surrogate", "trace"),
    Knob("DJT_JOIN_RANGE_PROBE", "1", "bool",
         "host min/max probe of 64-bit and multi-column keys (0: no probe)", "ambient"),
    # --- the skew-adaptive planner and the prepared tiers ---------------
    Knob("DJT_PLAN_ADAPT", None, "bool",
         "arm the skew-adaptive plan of the unprepared join", "plan"),
    Knob("DJT_BROADCAST_BYTES", None, "float",
         "broadcast tier's budget in modeled bytes a rank (<= 0 disables it)", "plan"),
    Knob("DJT_SALT_RATIO", 2.0, "float",
         "max / mean destination ratio at which a plan salts", "plan"),
    Knob("DJT_SALT_REPLICAS", 0, "int",
         "salt fan-out (0: ceil of the measured ratio)", "plan"),
    Knob("DJT_SALT_TOPK", 3, "int", "heavy destinations considered a batch", "plan"),
    Knob("DJT_PREPARED_TIER", None, "enum",
         "prepared build tier (unset: shuffle)", "plan",
         choices=("shuffle", "broadcast", "salted", "auto")),
    Knob("DJT_PREPARED_SALT_RATIO", None, "float",
         "salted-prepared threshold (unset or <= 0: DJT_SALT_RATIO)", "plan"),
    Knob("DJT_OBS_SKEW", None, "bool",
         "arm the partition-skew probe (obs on; one skew event a query batch)", "plan"),
    Knob("DJT_OBS_SKEW_EVERY", 1, "int",
         "probe a signature's skew every N queries", "plan"),
    # --- the per-signature autotuner -------------------------------------
    Knob("DJT_AUTOTUNE", None, "bool",
         "arm the autotuner (price every candidate, probe the top 2, keep the winner)",
         "plan"),
    Knob("DJT_AUTOTUNE_RETUNE_MAX", 1, "int",
         "re-tunes a signature may take before its record demotes to defaults", "plan"),
    Knob("DJT_AUTOTUNE_WINDOW", 16, "int",
         "latency window the regression check reads, in results", "plan"),
    Knob("DJT_AUTOTUNE_REGRESS", 1.5, "float",
         "latest / trailing-median latency past which a tuned signature re-tunes", "plan"),
    Knob("DJT_AUTOTUNE_ODF", "1,2,4", "str",
         "odf candidates of an unprepared plan (comma-separated)", "plan"),
    Knob("DJT_AUTOTUNE_MERGE", "sort,probe,merge", "str",
         "merge-tier candidates of a prepared plan (comma-separated)", "plan"),
    Knob("DJT_AUTOTUNE_EXPAND", "segment,hist", "str",
         "probe-expansion candidates on the probe tier (comma-separated)", "plan"),
    # --- the composition layers ----------------------------------------
    Knob("DJT_PIPELINE_COPART", "1", "bool",
         "run a co-partitioned pipeline stage as a local join", "plan"),
    Knob("DJT_PIPELINE_BROADCAST", "1", "bool",
         "let an auto pipeline stage plan broadcast", "plan"),
    Knob("DJT_PIPELINE_RANGE_DERIVE", "1", "bool",
         "derive a pipeline stage's key range from its inputs'", "plan"),
    Knob("DJT_SHAPE_BUCKET", None, "bool",
         "pad tables to the geometric shape grid", "plan"),
    Knob("DJT_SHAPE_BUCKET_RATIO", 1.25, "float", "shape grid's ratio (> 1)", "plan"),
    Knob("DJT_SHAPE_BUCKET_MIN", 1024, "int", "shape grid's floor in rows a shard", "plan"),
    # --- serving ----------------------------------------------------------
    Knob("DJT_SERVE_HBM_BUDGET", 16e9, "float",
         "admission budget in modeled bytes (also the broadcast budget when "
         "DJT_BROADCAST_BYTES is unset)", "serve"),
    Knob("DJT_SERVE_QUEUE_DEPTH", 64, "int", "bounded FIFO depth (past it: QueueFull)",
         "serve"),
    Knob("DJT_SERVE_DEADLINE_S", None, "float", "default per-query deadline in seconds",
         "serve"),
    Knob("DJT_SERVE_COALESCE", "1", "bool", "coalesce queued same-signature queries",
         "serve"),
    Knob("DJT_SERVE_COALESCE_MAX", 8, "int", "most queries a coalesced dispatch", "serve"),
    Knob("DJT_SERVE_PRESSURE_WINDOW", 32, "int", "submissions a pressure-ladder window",
         "serve"),
    Knob("DJT_SERVE_PRESSURE_REJECT_RATE", 0.5, "float",
         "rejected and shed share that steps the pressure ladder down", "serve"),
    Knob("DJT_SERVE_MATCH_FACTOR", 1.0, "float",
         "admission's estimate of matches a probe row", "serve"),
    Knob("DJT_SERVE_SLO_WINDOW", 128, "int", "terminal queries the dj_slo_* gauges cover",
         "serve"),
    Knob("DJT_SERVE_DRIFT_THRESHOLD", 2.0, "float",
         "forecast-drift bound: a repriced/forecast ratio outside [1/t, t] is drift",
         "serve"),
    Knob("DJT_SERVE_MEASURED_HBM", None, "bool",
         "measured_admission reads the card's allocator (obs.truth)", "serve"),
    Knob("DJT_SERVE_MEASURED_HBM_HEADROOM", 0.0, "float",
         "bytes held back from the measured headroom", "serve"),
    Knob("DJT_FLEET_TENANT_WEIGHTS", None, "str",
         "tenant fair-share weights 'tenantA:2,tenantB:1'", "serve"),
    Knob("DJT_FLEET_DRAIN_GRACE_S", 30.0, "float",
         "SIGTERM drain grace: bounded wait for queued and running queries", "serve"),
    # --- the join-index cache ---------------------------------------------
    Knob("DJT_INDEX_HBM_BUDGET", 0.0, "float",
         "resident-index budget in exact bytes (<= 0: unbudgeted)", "index"),
    Knob("DJT_INDEX_MANIFEST", None, "path", "the cache's warm-restart JSONL manifest",
         "index"),
    # --- resilience -------------------------------------------------------
    Knob("DJT_LEDGER", None, "path", "capacity ledger's JSONL file", "resilience"),
    Knob("DJT_LEDGER_FSYNC", "0", "bool",
         "fsync each ledger and manifest JSONL append", "resilience"),
    Knob("DJT_FAULT", None, "str",
         "deterministic fault sites, site@call=N[,...] (resilience.faults)", "resilience"),
    # --- fleet coordination (fleet/) ----------------------------------------
    Knob("DJT_FLEET_DIR", None, "path",
         "shared coordination directory; arms fleet mode (leases, budget rows, drain)",
         "resilience"),
    Knob("DJT_FLEET_LEASE_TTL_S", 30.0, "float",
         "lease heartbeat staleness horizon: past it a dead owner's lease is reclaimed",
         "resilience"),
    Knob("DJT_FLEET_LEASE_WAIT_S", 5.0, "float",
         "bounded wait for a peer-held lease before proceeding process-locally",
         "resilience"),
    Knob("DJT_FLEET_LEASE_POLL_S", 0.05, "float", "poll interval while waiting on a lease",
         "resilience"),
    # --- process worlds ---------------------------------------------------
    Knob("DJT_COORDINATOR_ADDRESS", None, "str",
         "host:port of the process world's rendezvous", "ambient"),
    Knob("DJT_NUM_PROCESSES", None, "int", "process world's size", "ambient"),
    Knob("DJT_PROCESS_ID", None, "int", "this process's rank", "ambient"),
    Knob("DJT_INIT_RETRIES", 5, "int", "attempts of the process group's set-up", "ambient"),
    Knob("DJT_INIT_BACKOFF_S", 1.0, "float", "first retry delay in seconds (doubles)",
         "ambient"),
    Knob("DJT_COLLECTIVE_TIMEOUT_S", 600.0, "float",
         "the longest one collective of a process world waits", "ambient"),
    # --- observability ------------------------------------------------------
    Knob("DJT_OBS", None, "bool", "enable the metrics registry and flight recorder",
         "ambient"),
    Knob("DJT_OBS_LOG", None, "path", "JSONL event sink (also enables obs)", "ambient"),
    Knob("DJT_OBS_RING", 1024, "int", "flight recorder's ring capacity in events", "ambient"),
    Knob("DJT_OBS_TRACES", 256, "int", "query timelines kept", "ambient"),
    Knob("DJT_OBS_HISTORY", 512, "int",
         "retained registry and SLO snapshot ring capacity (obs.history)", "ambient"),
    Knob("DJT_OBS_HISTORY_S", 10.0, "float",
         "snapshot sampler interval in seconds (the thread starts with the DJT_OBS_HTTP "
         "server)", "ambient"),
    Knob("DJT_SLO_BURN_FAST_S", 60.0, "float",
         "fast burn-rate alert window in seconds (obs.history)", "ambient"),
    Knob("DJT_SLO_BURN_SLOW_S", 600.0, "float",
         "slow burn-rate alert window in seconds (obs.history)", "ambient"),
    Knob("DJT_SLO_BURN_RATE", 0.1, "float",
         "burn-rate alert threshold: the deadline-miss or shed share of a window at which "
         "slo_alert fires", "ambient"),
    Knob("DJT_OBS_ANOMALY_WINDOW", 16, "int",
         "fleet-snapshot window the rank anomaly detector scores over (obs.fleet; min 2)",
         "ambient"),
    Knob("DJT_OBS_ANOMALY_RATIO", 2.0, "float",
         "a rank's windowed work over the fleet median at which a (rank, phase) anomaly "
         "fires (<= 0 disables)", "ambient"),
    Knob("DJT_OBS_ANOMALY_Z", 2.0, "float",
         "fleet z-score an anomaly must also reach on fleets of 4 or more ranks", "ambient"),
    Knob("DJT_OBS_HTTP", None, "int",
         "live telemetry endpoint port (also enables obs; 0 binds an ephemeral port, "
         "published as the dj_obs_http_port gauge and the obs_http event)", "ambient"),
    Knob("DJT_OBS_HTTP_HOST", "127.0.0.1", "str", "telemetry endpoint bind host",
         "ambient"),
    Knob("DJT_OBS_PROFILE_DIR", None, "path",
         "torch.profiler capture directory of the /profilez route (unset: /profilez "
         "answers 400)", "ambient"),
    Knob("DJT_OBS_BLACKBOX", None, "path",
         "crash black-box directory: arms excepthook, SIGTERM and atexit handlers that dump "
         "a per-rank JSONL bundle (also enables obs; read with python -m "
         "dj_tpu_torch.scripts.blackbox_read)", "ambient"),
    Knob("DJT_OBS_BLACKBOX_TRACES", 8, "int",
         "closed query timelines kept in a black-box bundle (open ones always dump)",
         "ambient"),
    Knob("DJT_PEAK_HBM_GBPS", 3350.0, "float",
         "HBM peak of the roofline in GB/s (H100 80GB HBM3)", "ambient"),
    Knob("DJT_PEAK_WIRE_GBPS", 450.0, "float",
         "wire peak of the roofline in GB/s (NVLink, each way)", "ambient"),
)

REGISTRY: dict[str, Knob] = {k.name: k for k in KNOBS}
assert len(REGISTRY) == len(KNOBS), "duplicate knob registration"
assert all(k.cleanup in _CLASSES for k in KNOBS), "unknown cleanup class"


def reset_names() -> tuple[str, ...]:
    """The knobs of the reset classes (module docstring), in
    registration order: the names a test fixture clears."""
    return tuple(k.name for k in KNOBS if k.cleanup in RESET_CLASSES)


@contextlib.contextmanager
def scoped(values: dict, keep=None):
    """Each variable of ``values`` set for the body (None unsets it), and
    restored after, except a name for which ``keep(name, previous)``
    says the body's value stays."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if keep is not None and keep(k, v):
                continue
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def read(name: str, default: object = "__registry__") -> object:
    """The raw string of registered knob ``name`` when it is set, else
    ``default`` (the registry's default when omitted). An unregistered
    name raises KeyError: reads go through the registry."""
    knob = REGISTRY[name]
    v = os.environ.get(knob.name)
    if v is not None:
        return v
    return knob.default if default == "__registry__" else default


def read_float(name: str) -> float:
    """:func:`read` as a float; unset or malformed gives the default."""
    knob = REGISTRY[name]
    try:
        return float(read(name))  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return float(knob.default if knob.default is not None else 0.0)


def read_int(name: str) -> int:
    """:func:`read` as an int; unset or malformed gives the default."""
    knob = REGISTRY[name]
    try:
        return int(read(name))  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return int(knob.default if knob.default is not None else 0)


def read_bool(name: str) -> bool:
    """:func:`read` as a bool: 1, true, yes or on, in any case."""
    v = read(name)
    return v is not None and str(v).strip().lower() in _TRUTHY


def registry_snapshot() -> list:
    """Every knob with its effective value, JSON-able: ``set`` says
    whether the variable is set, ``raw`` what it holds, ``effective``
    what the process runs on (a malformed number falls back to the
    default and sets ``malformed``)."""
    out = []
    for k in KNOBS:
        raw = os.environ.get(k.name)
        effective: object = k.default
        malformed = False
        if raw is not None:
            effective = raw
            try:
                if k.kind == "float":
                    effective = float(raw)
                elif k.kind == "int":
                    effective = int(raw)
                elif k.kind == "bool":
                    effective = raw.strip().lower() in _TRUTHY
            except ValueError:
                effective, malformed = k.default, True
        out.append({
            "name": k.name, "kind": k.kind, "doc": k.doc, "cleanup": k.cleanup,
            "choices": list(k.choices), "default": k.default, "set": raw is not None,
            "raw": raw, "effective": effective, "malformed": malformed,
        })
    return out

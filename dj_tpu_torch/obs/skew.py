"""The wire matrix, measured partition skew and the fleet view.

Counterpart of ``dj_tpu/obs/skew.py``. Three signals live here:

**The per-link wire matrix** (``dj_wire_bytes_total{src,dst,width}``).
The bucketed shuffle sends each peer exactly a bucket's capacity,
however many of its rows are valid, so an epoch's bytes divide evenly
over the n destinations. Every epoch ``recorder.count_collectives``
counts also reaches :func:`_wire_sink`, so each row of the matrix sums
to the per-shard ``dj_collective_bytes_total`` by construction. The
skew is therefore not in the wire bytes (padding hides it) but in the
valid rows, which the probe below measures.

**Measured partition skew** (``skew`` events, ``dj_skew_*`` gauges).
``DJT_OBS_SKEW=1`` (with obs on) arms a probe a query
(``dist_join._observe_partition_skew``): the probe side's per-source
partition counts, hashed as the join will hash them; per odf batch this
module derives each destination's rows and records one ``skew`` event
(the vector, max and mean rows, their ratio, the top-k heavy
destinations) on the query's timeline. The probe costs a small dispatch
and a host read a query, so it is a knob of its own;
``DJT_OBS_SKEW_EVERY=N`` samples it every N queries of a signature.

**The fleet view** (:func:`fleet_snapshot`). Every counter above is the
process's own. ``fleet_snapshot`` gathers each process's phase totals,
wire-matrix row sums and heal counters (one fixed-size all-gather of a
uint8 tensor over the default process group: on the rank's card under
NCCL, on the CPU under gloo; one process returns its own row), derives
the stragglers (``dj_rank_phase_seconds{rank,phase}`` and the per-phase
max / median ``dj_rank_skew_ratio{phase}``) and keeps the merged view
for :func:`fleet_view` and :func:`rank_skew_summary`, which never enter
a collective (the endpoint's ``/skewz``, ``/rooflinez`` and ``/fleetz``
read them). Every merged view also reaches ``_fleet_sink``, which
``obs.fleet`` sets to its anomaly window's ``note_snapshot``.
"""

from __future__ import annotations

import json
import statistics
import threading
from typing import Optional

import numpy as np

from .. import knobs
from . import metrics as _metrics
from . import recorder as _recorder
from . import roofline as _roofline

__all__ = [
    "batch_skew",
    "fleet_snapshot",
    "fleet_view",
    "probe_due",
    "probe_enabled",
    "rank_skew_summary",
    "record_partition_skew",
    "summary",
    "wire_matrix",
]

# Aggregates over every skew observation of the process (the ring
# evicts, a gauge keeps its last value). Guarded by _lock.
_lock = threading.Lock()
_agg = {"batches": 0, "max_ratio": 0.0, "max_rows": 0, "top": None}

# The last fleet_snapshot's straggler block and merged view.
_last_stragglers: Optional[dict] = None
_last_fleet: Optional[dict] = None

# The fixed size of a process's row in the fleet all-gather: a row that
# does not fit drops fields (never bytes) until it does.
_FLEET_MSG_BYTES = 8192

# The fleet-snapshot consumer: obs.fleet's note_snapshot (set when
# obs.fleet is imported), called with every merged view.
_fleet_sink = None


def probe_enabled() -> bool:
    """The skew probe's arming: obs on and ``DJT_OBS_SKEW`` truthy."""
    return _metrics.enabled() and knobs.read_bool("DJT_OBS_SKEW")


# Per-signature probe sampling (DJT_OBS_SKEW_EVERY): consultations a
# key, a bounded FIFO so a loop of new signatures cannot grow it.
_probe_seen: dict = {}
_PROBE_SEEN_MAX = 4096


def probe_due(key: tuple) -> bool:
    """Consult and advance ``key``'s sampling counter: True on the 1st,
    (N+1)th, (2N+1)th, ... consultation under ``DJT_OBS_SKEW_EVERY=N``
    (default 1: every query probes)."""
    every = max(1, knobs.read_int("DJT_OBS_SKEW_EVERY"))
    with _lock:
        seen = _probe_seen.get(key, 0)
        if key not in _probe_seen and len(_probe_seen) >= _PROBE_SEEN_MAX:
            _probe_seen.pop(next(iter(_probe_seen)))
        _probe_seen[key] = seen + 1
    return seen % every == 0


# --- the per-link wire matrix ------------------------------------------


def _wire_sink(acct: dict, queries: int = 1) -> None:
    """count_collectives' hook: one epoch's accounting into the per-link
    counters, bytes / n to each (src, dst) cell a width, in one batched
    registry update."""
    n = int(acct.get("n", 0))
    if n <= 0:
        return
    items = []
    for w, b in acct["bytes_by_width"].items():
        per_link = b * queries / n
        for s in range(n):
            for d in range(n):
                items.append(("dj_wire_bytes_total",
                              {"src": str(s), "dst": str(d), "width": str(w)}, per_link))
    _metrics.inc_items(items)


def wire_matrix() -> dict:
    """The accumulated per-link matrix from the ``dj_wire_bytes_total``
    series: ``{"n", "bytes"`` ([src][dst], widths summed),
    ``"row_totals"``, ``"by_width"``, ``"total_bytes"}``; n = 0 before
    any counted exchange."""
    n = 0
    cells: dict = {}
    by_width: dict = {}
    for labels, v in _metrics.counter_series("dj_wire_bytes_total").items():
        la = dict(labels)
        s, d, w = int(la["src"]), int(la["dst"]), la["width"]
        n = max(n, s + 1, d + 1)
        cells[(s, d)] = cells.get((s, d), 0.0) + v
        by_width[w] = by_width.get(w, 0.0) + v
    matrix = [[cells.get((s, d), 0.0) for d in range(n)] for s in range(n)]
    row_totals = [sum(row) for row in matrix]
    return {"n": n, "bytes": matrix, "row_totals": row_totals, "by_width": by_width,
            "total_bytes": sum(row_totals)}


# --- measured partition skew ---------------------------------------------


def batch_skew(counts, n: int, odf: int, *, topk: int = 3) -> list[dict]:
    """Per odf batch, the destination skew of a per-source partition-count
    matrix ``counts`` ([w, m] with m = n * odf, as
    ``dist_join._partition_probe_counts`` returns it): one signal for the
    events below and the skew-adaptive planner. Batch b's destinations
    are the n group peers of partitions [b n, (b + 1) n); a
    destination's rows are the column sum over the source shards.
    Returns one dict a batch: ``batch``, ``rows`` (the vector),
    ``max_rows``, ``mean_rows``, ``ratio`` (max / mean, 1.0 when empty)
    and ``top`` ([(dest, rows)] heaviest first, ``topk`` entries)."""
    counts = np.asarray(counts)
    out = []
    for b in range(odf):
        rows = counts[:, b * n:(b + 1) * n].sum(axis=0)
        mx = int(rows.max()) if rows.size else 0
        mean = float(rows.mean()) if rows.size else 0.0
        ratio = (mx / mean) if mean > 0 else 1.0
        k = min(topk, len(rows))
        heavy = sorted(((int(d), int(rows[d])) for d in range(len(rows))),
                       key=lambda t: -t[1])[:k]
        out.append({"batch": b, "rows": [int(r) for r in rows], "max_rows": mx,
                    "mean_rows": mean, "ratio": ratio, "top": heavy})
    return out


def record_partition_skew(counts, n: int, odf: int, *, stage: str, topk: int = 3) -> None:
    """One ``skew`` event a batch of :func:`batch_skew` (on the query's
    timeline), the ``dj_skew_{max_rows,mean_rows,ratio}{stage}`` gauges
    of the call's heaviest batch, and the process aggregates."""
    if not _metrics.enabled():
        return
    worst = None
    for b in batch_skew(counts, n, odf, topk=topk):
        ratio, mx, mean, heavy = b["ratio"], b["max_rows"], b["mean_rows"], b["top"]
        _recorder.record("skew", stage=stage, batch=b["batch"], rows=b["rows"], max_rows=mx,
                         mean_rows=round(mean, 3), ratio=round(ratio, 4), top=heavy)
        if worst is None or ratio > worst[0]:
            worst = (ratio, mx, mean)
        with _lock:
            _agg["batches"] += 1
            if ratio > _agg["max_ratio"]:
                _agg["max_ratio"] = ratio
                _agg["top"] = heavy
            _agg["max_rows"] = max(_agg["max_rows"], mx)
    if worst is not None:
        ratio, mx, mean = worst
        _metrics.set_gauge("dj_skew_max_rows", mx, stage=stage)
        _metrics.set_gauge("dj_skew_mean_rows", round(mean, 3), stage=stage)
        _metrics.set_gauge("dj_skew_ratio", round(ratio, 4), stage=stage)


def summary() -> dict:
    """The process's skew aggregates: batches observed, the worst max /
    mean ratio, the heaviest destination's rows and the top heavy
    destinations of the worst batch."""
    with _lock:
        out = dict(_agg)
    out["max_ratio"] = round(out["max_ratio"], 4)
    return out


# --- the fleet view --------------------------------------------------------


def _process_world() -> tuple[int, int]:
    """(rank, size) of the default process group, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_rank_snapshot() -> dict:
    wm = wire_matrix()
    return {
        "rank": _process_world()[0],
        "phase_seconds": {k: round(v, 6) for k, v in _roofline.phase_totals().items()},
        "wire_row_totals": wm["row_totals"],
        "wire_total_bytes": wm["total_bytes"],
        "heal_total": _metrics.counter_value("dj_heal_total"),
        "serve_admitted_total": _metrics.counter_value("dj_serve_admitted_total"),
        "serve_shed_total": _metrics.counter_value("dj_serve_shed_total"),
        "serve_rejected_total": _metrics.counter_value("dj_serve_rejected_total"),
        "skew": summary(),
    }


def _fit_payload(local: dict) -> bytes:
    """The JSON of ``local`` in at most ``_FLEET_MSG_BYTES - 4`` bytes:
    fields are dropped (never bytes cut, which would tear the JSON)
    until it fits, and the dropped ones named under ``truncated``."""
    payload = json.dumps(local).encode()
    if len(payload) <= _FLEET_MSG_BYTES - 4:
        return payload
    for dropped in (("skew",), ("skew", "wire_row_totals"),
                    ("skew", "wire_row_totals", "phase_seconds")):
        slim = {k: v for k, v in local.items() if k not in dropped}
        slim["truncated"] = list(dropped)
        payload = json.dumps(slim).encode()
        if len(payload) <= _FLEET_MSG_BYTES - 4:
            return payload
    return json.dumps({"rank": local.get("rank", 0), "truncated": ["all"]}).encode()


def _gather_ranks(local: dict) -> list[dict]:
    """Every process's snapshot: one all-gather of a fixed-size uint8
    row (a 4-byte length, then the JSON) over the default group. One
    process returns its own row; a failed gather degrades to it (a
    diagnostic must not fail its caller); a torn row is skipped."""
    import torch
    import torch.distributed as dist

    _, nproc = _process_world()
    if nproc <= 1:
        return [local]
    try:
        payload = _fit_payload(local)
        row = np.zeros(_FLEET_MSG_BYTES, np.uint8)
        row[:4] = np.frombuffer(len(payload).to_bytes(4, "little"), np.uint8)
        row[4:4 + len(payload)] = np.frombuffer(payload, np.uint8)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        send = torch.from_numpy(row).to(dev)
        recv = torch.empty(nproc * _FLEET_MSG_BYTES, dtype=torch.uint8, device=dev)
        dist.all_gather_into_tensor(recv, send)
        rows = recv.cpu().numpy().reshape(nproc, _FLEET_MSG_BYTES)
        out = []
        for r in rows:
            ln = int.from_bytes(r[:4].tobytes(), "little")
            try:
                out.append(json.loads(r[4:4 + ln].tobytes()))
            except Exception:  # noqa: BLE001 - a torn row skips
                continue
        return out or [local]
    except Exception:  # noqa: BLE001 - diagnostics must degrade
        return [local]


def _derive_stragglers(ranks: list[dict]) -> dict:
    """Per phase across the gathered ranks: the max, median, max /
    median ratio and slowest rank; publishes
    ``dj_rank_phase_seconds{rank,phase}`` and ``dj_rank_skew_ratio{phase}``."""
    phases: set = set()
    for r in ranks:
        phases |= set(r.get("phase_seconds", {}))
    out: dict = {}
    for p in sorted(phases):
        vals = [float(r.get("phase_seconds", {}).get(p, 0.0)) for r in ranks]
        med = statistics.median(vals)
        mx = max(vals)
        out[p] = {"max_s": round(mx, 6), "median_s": round(med, 6),
                  "ratio": round(mx / med, 4) if med > 0 else 1.0,
                  "slowest_rank": ranks[vals.index(mx)].get("rank", 0)}
        for r, v in zip(ranks, vals):
            _metrics.set_gauge("dj_rank_phase_seconds", v, rank=str(r.get("rank", 0)), phase=p)
        _metrics.set_gauge("dj_rank_skew_ratio", out[p]["ratio"], phase=p)
    return out


def fleet_snapshot(topo=None) -> dict:
    """Gather every process's snapshot (module docstring) and derive the
    stragglers: ``{"ranks", "stragglers", "wire"}``. In a process world
    every process must call it, as any collective. ``topo`` is accepted
    for symmetry with the other entry points and unused: the view is by
    process, not by rank of a topology."""
    del topo
    global _last_stragglers, _last_fleet
    ranks = _gather_ranks(_local_rank_snapshot())
    stragglers = _derive_stragglers(ranks)
    _last_stragglers = {"ranks": len(ranks), "gathered": len(ranks) > 1, "phases": stragglers}
    _last_fleet = {"ranks": ranks, "stragglers": stragglers, "wire": wire_matrix()}
    if _fleet_sink is not None:
        try:
            _fleet_sink(_last_fleet)
        except Exception:  # noqa: BLE001 - a consumer must never fail a gather
            pass
    return _last_fleet


def fleet_view() -> dict:
    """The merged view without a collective: one process computes it
    afresh; a process world serves the last :func:`fleet_snapshot`, or
    its own row marked ``gathered: false`` before any."""
    if _process_world()[1] <= 1:
        return fleet_snapshot()
    if _last_fleet is not None:
        return _last_fleet
    local = _local_rank_snapshot()
    return {"ranks": [local], "stragglers": _derive_stragglers([local]), "wire": wire_matrix(),
            "gathered": False}


def rank_skew_summary() -> dict:
    """The last fleet_snapshot's straggler block, or a local one (one
    rank, every ratio 1.0) before any gather."""
    if _last_stragglers is not None:
        return _last_stragglers
    return {"ranks": 1, "gathered": False,
            "phases": {p: {"ratio": 1.0} for p in _roofline.phase_totals()}}


def _clear() -> None:
    global _last_stragglers, _last_fleet
    with _lock:
        _agg.update({"batches": 0, "max_ratio": 0.0, "max_rows": 0, "top": None})
        _probe_seen.clear()
    _last_stragglers = None
    _last_fleet = None


# Hooks, not imports (the recorder imports none of its siblings): the
# wire matrix is fed by count_collectives, and obs.reset() clears the
# aggregates.
_recorder._wire_sink = _wire_sink
_recorder._aux_resets.append(_clear)

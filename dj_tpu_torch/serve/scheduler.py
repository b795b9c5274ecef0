"""The query scheduler: admission, a bounded queue, deadlines, pressure.

Counterpart of ``dj_tpu/serve/scheduler.py``. The serving loop in front
of ``distributed_inner_join_auto``: without it a burst of concurrent
queries races the heal engine and a caller meets ``CapacityExhausted``
mid-flight instead of a reject at the door. :class:`QueryScheduler`
coordinates four mechanisms:

1. **Admission** (:mod:`.admission`): each submit is priced by the byte
   model under the ledger-warmed factors of its plan signature and
   admitted against ``DJT_SERVE_HBM_BUDGET`` less the bytes reserved for
   queued and running work, the join-index cache's resident bytes and
   live fleet peers' published bytes; resident index entries are shed
   before a reject (``cache.shed_bytes``). Over budget raises the typed
   :class:`AdmissionRejected` at submit. With ``DJT_SERVE_MEASURED_HBM=1``
   the card's allocator (``obs.truth.measured_admission``) rejects too.
2. **A bounded queue and deadlines**: a FIFO capped at
   ``DJT_SERVE_QUEUE_DEPTH`` (past it :class:`QueueFull` at submit); a
   query's ``deadline_s`` is checked on a monotonic clock at dispatch
   (``DeadlineExceeded``, ``where="queued"``) and between heal attempts
   (``heal.deadline_scope``, ``where="healing"``).
3. **The pressure ladder**: a rejected and shed share of the last
   ``DJT_SERVE_PRESSURE_WINDOW`` submissions at
   ``DJT_SERVE_PRESSURE_REJECT_RATE`` steps one level: 1 pins the
   ``wire`` tier (uncompressed), 2 pins ``merge`` (the sort tier; the
   port has no bucketed-sort tier to pin beside it), 3 halves the odf
   of unprepared queries at dispatch. One ``pressure`` event a step.
4. **Coalescing**: queued queries against one PreparedSide (or, the
   shape-bucket extension, one Table shape) with one signature dispatch
   together (``distributed_inner_join_coalesced`` /
   ``_coalesced_unprepared``); a member whose flags fire demotes to the
   singleton heal path, so rows and heals are those of each query alone.

Every submitted query ends in exactly one terminal state, a result or a
typed :class:`~..resilience.errors.DJError`. A ``KernelError`` or a
device fault (``torch.AcceleratorError``) ends its tickets typed and pins
no tier; no query is served on the CPU when the card was asked for.

5. **Query traces** (:mod:`..obs.trace`): submit mints a fleet-unique
   ``query_id`` and each stage of the query runs inside
   ``query_ctx(query_id, tenant)``; its ``query``, ``queued`` and ``run``
   spans close exactly once.
6. **SLO and drift**: a sliding window over terminal queries publishes
   ``dj_slo_deadline_hit_rate`` / ``_heal_rate`` / ``_shed_rate`` /
   ``_window_terminals{scheduler}``; each terminal observes
   ``dj_serve_latency_seconds{tenant,outcome}``; each result's forecast
   is repriced under the config it ran with into
   ``dj_forecast_error_ratio`` (one ``drift`` event and
   ``dj_forecast_drift_total`` past ``DJT_SERVE_DRIFT_THRESHOLD``; a
   tuned signature is flagged for one re-tune).

Counters ``dj_serve_admitted_total``, ``dj_serve_rejected_total{reason}``
(``measured_hbm`` for the measured gate, ``draining``),
``dj_serve_shed_total{reason}``, ``dj_serve_coalesced_total``,
``dj_forecast_drift_total``, ``dj_tenant_device_seconds_total{tenant}``,
``dj_fleet_tenant_shed_total{tenant}``; gauges ``dj_serve_queue_depth``,
``dj_serve_reserved_bytes``, ``dj_serve_pressure_level``, the
``dj_slo_*`` family and ``dj_device_hbm_*`` (sampled at dispatch and
terminal); histograms ``dj_serve_latency_seconds`` and
``dj_forecast_error_ratio``, and ``dj_roofline_frac{phase="run"}``. A
dispatch is the span ``serve_run`` (``parallel.spmd.call_span``); on the
card the ``run`` phase and ``dj_tenant_device_seconds_total`` take its
device time, from two CUDA events resolved without a synchronize
(``obs.roofline.observe_events``), and on the CPU dispatch to terminal.
Events ``admission`` (rejects; a measured one carries
``source="measured_hbm"`` and the allocator's evidence), ``shed``,
``pressure``, ``coalesce``, ``drift``, ``drain``, ``span`` and one
``serve`` a terminal with its queued, run and total seconds. These are
dj_tpu's names and labels.

**The worker thread.** ``worker=True`` (the default) dispatches on a
daemon thread, which makes the topology's CUDA device its current one
(``torch.cuda.set_device`` is per thread). A result's tensors were
written on that thread's stream: :meth:`Ticket.result` makes the caller's
current stream wait on an event recorded at the terminal, and adds no
synchronize.

**A process world.** dj_tpu has one controller; a process world of the
port runs one scheduler a process, each with its own clock, allocator,
fleet view and queue. Every process submits the same queries in the same
order, and the decisions that depend on time or local state are taken
once for the world (``parallel.agree``): the door (one gather of every
process's inputs; the query is admitted only when every process admits
it, and a reject carries the rejecting process's evidence), the index
shed (the largest need over the processes), the deadline shed at
dispatch and between heal attempts (process 0's clock), and which queued
tickets form a dispatch group (process 0's queue). Two threads issuing
object collectives on one group could pair them wrongly, so in such a
world dispatch runs on the caller's thread (:meth:`QueryScheduler.pump`,
or :meth:`Ticket.result`, which pumps), and ``worker=True`` raises
ValueError. Worlds whose ranks are threads of this process keep the
worker.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
import traceback
import weakref
from collections import deque
from typing import Optional, Sequence

from .. import fleet as _fleet
from .. import knobs
from ..obs import metrics as _metrics
from ..obs import recorder as obs
from ..obs import roofline as _roofline
from ..obs import skew as _skew
from ..obs import trace
from ..obs import truth as _truth
from ..parallel import agree
from ..parallel.spmd import call_span
from ..resilience import errors as resil
from ..resilience import heal as heal_engine
from ..resilience.errors import (
    AdmissionRejected,
    BackendError,
    DeadlineExceeded,
    DJError,
    Draining,
    QueueFull,
)
from . import admission

__all__ = ["MAX_PRESSURE_LEVEL", "QueryScheduler", "ServeConfig", "Ticket"]

# Live schedulers, so serve.reset() and the health snapshot reach them
# without a handle threaded everywhere. Weak: a dropped one is collected.
_SCHEDULERS: "weakref.WeakSet[QueryScheduler]" = weakref.WeakSet()

# Query ids are fleet-unique, "rank:q<pid>-<seq>": the rank tells the
# processes of a world apart, the pid the uncoordinated workers of a host
# (all rank 0), and the counter is shared by the schedulers of a process.
_QUERY_IDS = itertools.count(1)
_QUERY_RANK: Optional[int] = None
# Scheduler names label the per-scheduler dj_slo_* series.
_SCHED_IDS = itertools.count(1)


def _query_rank() -> int:
    """This process's rank for query ids: ``DJT_PROCESS_ID`` when set,
    else the default group's rank when one is initialized (the scheduler
    never initializes one), else 0. A rank found is kept; 0 is asked
    again next time, in case a group comes up later."""
    global _QUERY_RANK
    if _QUERY_RANK is not None:
        return _QUERY_RANK
    rank = None
    v = knobs.read("DJT_PROCESS_ID")
    if v not in (None, ""):
        try:
            rank = int(v)
        except ValueError:
            rank = None
    if rank is None:
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                rank = int(dist.get_rank())
        except Exception:  # noqa: BLE001 - stay at 0
            rank = None
    if rank is None:
        return 0
    _QUERY_RANK = rank
    return rank


def _mint_query_id() -> str:
    return f"{_query_rank()}:q{os.getpid()}-{next(_QUERY_IDS)}"


def _slo_rates(win: list) -> dict:
    """The SLO window's rates (entries: (had_deadline, deadline_hit,
    healed, shed)), one owner for the gauges and the snapshot. The hit
    rate counts deadline-carrying queries only (1.0 with none)."""
    n = len(win)
    with_deadline = [e for e in win if e[0]]
    return {
        "window_terminals": n,
        "deadline_hit_rate": (round(sum(1 for e in with_deadline if e[1]) / len(with_deadline), 4)
                              if with_deadline else 1.0),
        "heal_rate": round(sum(1 for e in win if e[2]) / n, 4) if n else 0.0,
        "shed_rate": round(sum(1 for e in win if e[3]) / n, 4) if n else 0.0,
    }


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The scheduler's knobs (``from_env`` reads the ``DJT_SERVE_HBM_BUDGET``
    family).

    hbm_budget_bytes: the admission budget in modeled bytes (the byte
      model's units); <= 0 disables admission. dj_tpu's 16e9: a
      full-width query on the card models far more (see README), so a
      server sizes it from its forecasts.
    queue_depth: the FIFO cap; a submit past it raises QueueFull.
    default_deadline_s: the deadline of a submit that gives none (None:
      no deadline).
    coalesce / coalesce_max: group same-signature queries, at most
      coalesce_max a dispatch.
    pressure_window / pressure_reject_rate: the ladder steps one level
      each time the rejected and shed share of the last pressure_window
      submissions reaches pressure_reject_rate (the window restarts at
      each step).
    match_factor: admission's matches a probe row.
    max_attempts / growth / max_total_growth: the HealBudget of the auto
      wrappers.
    slo_window: terminal queries the dj_slo_* rates cover.
    drift_threshold: a repriced/forecast ratio outside [1/t, t] records
      one ``drift`` event.
    """

    hbm_budget_bytes: float = 16e9
    queue_depth: int = 64
    default_deadline_s: Optional[float] = None
    coalesce: bool = True
    coalesce_max: int = 8
    pressure_window: int = 32
    pressure_reject_rate: float = 0.5
    match_factor: float = 1.0
    max_attempts: int = 8
    growth: float = 2.0
    max_total_growth: float = 4096.0
    slo_window: int = 128
    drift_threshold: float = 2.0

    @classmethod
    def from_env(cls) -> "ServeConfig":
        dl = knobs.read("DJT_SERVE_DEADLINE_S")
        try:
            # A typo falls back to the default (no deadline), as every
            # sibling knob does, instead of refusing to start.
            deadline = float(dl) if dl else None
        except ValueError:
            deadline = None
        return cls(
            hbm_budget_bytes=knobs.read_float("DJT_SERVE_HBM_BUDGET"),
            queue_depth=knobs.read_int("DJT_SERVE_QUEUE_DEPTH"),
            default_deadline_s=deadline,
            coalesce=knobs.read("DJT_SERVE_COALESCE") == "1",
            coalesce_max=knobs.read_int("DJT_SERVE_COALESCE_MAX"),
            pressure_window=knobs.read_int("DJT_SERVE_PRESSURE_WINDOW"),
            pressure_reject_rate=knobs.read_float("DJT_SERVE_PRESSURE_REJECT_RATE"),
            match_factor=knobs.read_float("DJT_SERVE_MATCH_FACTOR"),
            slo_window=knobs.read_int("DJT_SERVE_SLO_WINDOW"),
            drift_threshold=knobs.read_float("DJT_SERVE_DRIFT_THRESHOLD"),
        )


# The pressure ladder: (level, action). Levels are cumulative and
# monotone per scheduler (reset_pressure); the pins are process-wide.
_PRESSURE_LEVELS = (
    (1, "drop_compressed_wire"),
    (2, "drop_optional_tiers"),
    (3, "halve_odf"),
)
MAX_PRESSURE_LEVEL = 3


def _release_frames(error: Optional[BaseException]) -> None:
    """Drop the locals of the frames in ``error``'s tracebacks (its cause
    and context too), keeping their lines. A ticket keeps its error for
    as long as the caller keeps the ticket, and a failed dispatch's frames
    hold its device buffers."""
    seen = set()
    while error is not None and id(error) not in seen:
        seen.add(id(error))
        traceback.clear_frames(error.__traceback__)
        error = error.__cause__ or error.__context__


def _cuda_device(topology):
    """The topology's CUDA device, or None for CPU ranks."""
    dev = topology.device
    return dev if dev.type == "cuda" else None


class Ticket:
    """One submitted query's handle. Exactly one terminal transition:
    :meth:`result` waits for it, then returns the auto wrapper's tuple
    (``(out, counts, info, config_used)`` unprepared, ``(out, counts,
    info, config_used, prepared_used)`` prepared, ``(out, counts, infos,
    configs)`` for a pipeline) or raises the typed terminal error."""

    __slots__ = (
        "args", "config", "deadline", "deadline_s", "forecast", "coalesced", "submit_t",
        "start_t", "_event", "_payload", "_error", "_done", "_scheduler", "seq", "tenant",
        "lease", "query_id", "_queued_open", "_run_open", "stages", "_ready", "_run_events",
    )

    def __init__(self, scheduler, seq, args, config, deadline, deadline_s, forecast,
                 tenant="default", lease=None, query_id="", stages=None):
        self._scheduler = scheduler
        self.seq = seq
        self.query_id = query_id
        # Which lifecycle spans are open: a demoted coalesced member
        # enters dispatch again, and its spans must pair exactly once.
        self._queued_open = False
        self._run_open = False
        self.args = args  # (topology, left, lc, right, rc, l_on, r_on)
        # A pipeline query's JoinStage chain; args then holds (topology,
        # left, lc, None, None, (), None).
        self.stages = stages
        self.config = config
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.deadline_s = deadline_s
        self.forecast = forecast
        self.tenant = tenant
        # The join-index Lease pinning this query's resident side,
        # released at the terminal, so no eviction can take it mid-query.
        self.lease = lease
        self.coalesced = False
        self.submit_t = time.monotonic()
        self.start_t: Optional[float] = None
        self._event = threading.Event()
        self._payload = None
        self._error: Optional[BaseException] = None
        self._done = False
        # A CUDA event recorded on the dispatching thread's stream at the
        # terminal; result() orders the caller's stream after it.
        self._ready = None
        # (start, end) CUDA events of the dispatch's serve_run span, with
        # obs enabled on the card: the run's device time (_finish).
        self._run_events = None

    @property
    def done(self) -> bool:
        return self._done

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def outcome(self) -> Optional[str]:
        """None while pending; "result" or the terminal error's class name."""
        if not self._done:
            return None
        return "result" if self._error is None else type(self._error).__name__

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and (
            (time.monotonic() if now is None else now) > self.deadline)

    def result(self, timeout: Optional[float] = None):
        """Wait for the terminal state. With no worker thread it pumps
        the scheduler from this thread (in a process world every process
        calls it, in the same order). Raises TimeoutError when still
        pending after ``timeout`` seconds."""
        t_end = None if timeout is None else time.monotonic() + timeout
        if self._scheduler is not None and not self._scheduler.has_worker:
            while not self._event.is_set():
                if self._scheduler.pump() == 0 and not self._event.is_set():
                    if t_end is not None and time.monotonic() > t_end:
                        break
                    time.sleep(0.001)
        remaining = None if t_end is None else max(0.0, t_end - time.monotonic())
        if not self._event.wait(remaining):
            raise TimeoutError(f"query #{self.seq} still pending after {timeout}s")
        if self._error is not None:
            try:
                raise self._error
            finally:
                # The raise puts this frame in the error's traceback: drop
                # its reference to the ticket, which holds the error (the
                # cycle concurrent.futures.Future.result breaks too).
                self = None  # noqa: PLW0642
        if self._ready is not None:
            import torch

            torch.cuda.current_stream(self._ready[0]).wait_event(self._ready[1])
        return self._payload


class QueryScheduler:
    """The admission-controlled scheduler in front of
    ``distributed_inner_join_auto`` (module docstring).

    ``worker=True`` starts a daemon dispatch thread (a ValueError in a
    process world of more than one process); ``worker=False`` leaves
    dispatch to :meth:`pump`, or to :meth:`Ticket.result`, which pumps.
    ``index`` is an optional :class:`~..cache.JoinIndexCache` that Table
    rights resolve through. A context manager (``close()`` on exit)."""

    def __init__(self, config: Optional[ServeConfig] = None, *, worker: bool = True,
                 index=None):
        if worker and agree.dist_world():
            raise ValueError(
                "QueryScheduler(worker=True) in a process world of more than one process: "
                "its decisions are object collectives that must be issued from one thread "
                "a process; pass worker=False and dispatch with pump() or Ticket.result()")
        self.config = config if config is not None else ServeConfig.from_env()
        self.index = index
        self._cv = threading.Condition()
        self._queue: deque[Ticket] = deque()
        self._reserved_bytes = 0.0
        self._pressure_level = 0
        self._outcomes: deque[bool] = deque(maxlen=max(1, self.config.pressure_window))
        self._slo: deque = deque(maxlen=max(1, self.config.slo_window))
        self.name = f"s{next(_SCHED_IDS)}"
        self._seq = itertools.count(1)
        self._closed = False
        # Drain mode (fleet.drain, SIGTERM): the door rejects with
        # Draining while the queue keeps dispatching (close() sheds it).
        self._draining = _fleet.drain.draining()
        self._worker: Optional[threading.Thread] = None
        _SCHEDULERS.add(self)
        _fleet.drain.register(self)
        if _fleet.enabled():
            _fleet.drain.install()  # main thread only; chains to the handler before it
        if worker:
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="dj_tpu_torch-serve-worker", daemon=True)
            self._worker.start()

    # -- lifecycle ----------------------------------------------------------

    @property
    def has_worker(self) -> bool:
        return self._worker is not None

    def __enter__(self) -> "QueryScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop accepting work, shed what is queued (typed BackendError)
        and join the worker thread."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        w = self._worker
        if w is not None and w is not threading.current_thread():
            w.join(timeout=30)
        self._shed_all("scheduler closed")

    def reset(self) -> None:
        """Shed the queue, zero the reservation, forget the pressure and
        SLO history (the process-wide tier pins are
        ``resilience.reset_pins``: they may outlive a scheduler)."""
        self._shed_all("scheduler reset")
        with self._cv:
            self._reserved_bytes = 0.0
            self._pressure_level = 0
            self._draining = False
            self._outcomes.clear()
            self._slo.clear()
        self._set_gauges()

    def drain(self) -> None:
        """Enter drain mode (``fleet.drain.begin``, SIGTERM): the door
        rejects new work with ``Draining`` while queued and running
        queries go on to their terminals. Idempotent; one ``drain`` event
        marks the flip."""
        with self._cv:
            first = not self._draining
            self._draining = True
            self._cv.notify_all()
        if first:
            obs.record("drain", phase="scheduler", scheduler=self.name,
                       queue_depth=len(self._queue))

    def drained(self) -> bool:
        """Draining with nothing queued or running."""
        with self._cv:
            return self._draining and not self._queue and self._reserved_bytes <= 0.0

    def _shed_all(self, why: str) -> None:
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
        for t in pending:
            self._finish(t, error=BackendError(f"{why} with query queued"))

    # -- introspection --------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def reserved_bytes(self) -> float:
        return self._reserved_bytes

    @property
    def pressure_level(self) -> int:
        return self._pressure_level

    def snapshot(self) -> dict:
        """One JSON-able view: queue depth and cap, reserved and budget
        bytes, the resident index bytes, the pressure level, the worker's
        liveness, the SLO rates and the rank-skew summary."""
        with self._cv:
            depth, reserved, level = len(self._queue), self._reserved_bytes, self._pressure_level
            closed, draining, win = self._closed, self._draining, list(self._slo)
        w = self._worker
        return {
            "name": self.name, "closed": closed, "draining": draining, "queue_depth": depth,
            "queue_cap": self.config.queue_depth, "reserved_bytes": reserved,
            "budget_bytes": self.config.hbm_budget_bytes,
            "index_bytes": admission.reserved_index_bytes(), "pressure_level": level,
            "worker_alive": bool(w is not None and w.is_alive()), "slo": _slo_rates(win),
            "rank_skew": _skew.rank_skew_summary(),
        }

    def reset_pressure(self) -> None:
        """Back to level 0 (the tier pins stay: ``reset_pins``)."""
        with self._cv:
            self._pressure_level = 0
            self._outcomes.clear()
        obs.set_gauge("dj_serve_pressure_level", 0)

    # -- the world's one decision ----------------------------------------------

    def _check_world(self, topology) -> None:
        if agree.multi_process(topology) and self.has_worker:
            raise ValueError("QueryScheduler: a process-world query on a scheduler with a "
                             "worker thread (construct it with worker=False)")

    def _views(self, topology, view) -> list:
        """Every process's ``view`` in a process world, else [view]."""
        return agree.gather(view) if agree.multi_process(topology) else [view]

    def _world_max(self, topology, value: float) -> float:
        return max(self._views(topology, value))

    def _rank0(self, topology, value):
        """Process 0's ``value`` in a process world, else ``value``."""
        return agree.from_rank0(value) if agree.multi_process(topology) else value

    def _expired(self, ticket: Ticket, now: Optional[float] = None) -> bool:
        return self._rank0(ticket.args[0], ticket.expired(now))

    # -- submit: admission and backpressure ---------------------------------

    def submit(self, topology, left, left_counts, right, right_counts=None,
               left_on: Sequence[int] = (), right_on: Optional[Sequence[int]] = None,
               config=None, *, deadline_s: Optional[float] = None,
               tenant: str = "default") -> Ticket:
        """Admit and enqueue one query (``distributed_inner_join_auto``'s
        arguments). Raises the typed :class:`AdmissionRejected`,
        :class:`QueueFull` or :class:`Draining` at once. Returns a
        :class:`Ticket`.

        With ``index=`` at construction, a Table right with fixed-width
        keys resolves through ``index.get_or_prepare(..., tenant=)`` here:
        the first submit of a signature pays the prepare, later ones pin
        the resident side and dispatch a prepared query (and coalesce as
        such). A shape the cache cannot take, or a full index, serves
        unprepared. Runs under ``query_ctx``: a door reject closes the
        query's trace and carries ``.query_id``."""
        query_id = _mint_query_id()
        with trace.query_ctx(query_id, tenant):
            trace.span_begin("query")
            try:
                ticket = self._admit(topology, left, left_counts, right, right_counts, left_on,
                                     right_on, config, deadline_s=deadline_s, tenant=tenant,
                                     query_id=query_id)
            except BaseException as e:
                trace.span_end("query", outcome=type(e).__name__)
                try:
                    e.query_id = query_id
                except Exception:  # noqa: BLE001 - best-effort tag
                    pass
                raise
        self._set_gauges()
        return ticket

    def _admit(self, topology, left, left_counts, right, right_counts, left_on, right_on,
               config, *, deadline_s, tenant, query_id) -> Ticket:
        """submit's body: index routing, the forecast, the door, enqueue."""
        from ..core.table import Column
        from ..parallel import shape_bucket
        from ..parallel.dist_join import JoinConfig, PreparedSide

        self._check_world(topology)
        if not isinstance(right, PreparedSide) and (right_counts is None or right_on is None):
            raise TypeError("submit: right_counts and right_on are required when `right` is a "
                            "Table (they default to None only so a PreparedSide can omit them)")
        if config is None:
            config = JoinConfig()
        # Shape bucketing at the door (DJT_SHAPE_BUCKET=1): the forecast
        # prices the padded shape, the signature folds into the bucket and
        # near-miss shapes share a coalescing key. The pad is memoized by
        # buffer identity, so the index cache sees a stable dataset.
        left = shape_bucket.bucket_table(topology, left)
        if not isinstance(right, PreparedSide):
            right = shape_bucket.bucket_table(topology, right)
        lease = None
        orig_right = (right, right_counts, right_on)
        try:
            if (self.index is not None and not isinstance(right, PreparedSide)
                    and all(isinstance(right.columns[c], Column) for c in right_on)):
                try:
                    lease = self.index.get_or_prepare(topology, right, right_counts, right_on,
                                                      config, tenant=tenant,
                                                      left_capacity=left.capacity)
                except (AdmissionRejected, ValueError):
                    # A full index (the cache recorded its reject) or a
                    # shape off the anchored plan: serve unprepared.
                    lease = None
                if lease is not None:
                    right, right_counts, right_on = lease.prepared, None, None
            if deadline_s is None:
                deadline_s = self.config.default_deadline_s
            fc = admission.forecast(topology, left, right, left_on, right_on, config,
                                    match_factor=self.config.match_factor)
            budget = self.config.hbm_budget_bytes
            # Resident index bytes and live fleet peers' bytes spend the
            # same pool as the reservations (read outside the lock).
            index_bytes = admission.reserved_index_bytes()
            fleet_bytes = _fleet.peer_bytes_guarded()
            if budget > 0:
                from ..cache import shed_bytes

                def _over() -> float:
                    # The admission arithmetic: the shed steps below and
                    # the door's check must agree on it.
                    return fc.bytes + self._reserved_bytes + index_bytes + fleet_bytes - budget

                # Live queries outrank cached residency: shed unpinned
                # index entries before rejecting (outside the lock: an
                # eviction may write a manifest line). A process world
                # sheds the largest need of its processes on each, so
                # their caches stay equal.
                need = self._world_max(topology, _over())
                if need > 0 and index_bytes > 0:
                    shed_bytes(need)
                    index_bytes = admission.reserved_index_bytes()
                if lease is not None and self._world_max(topology, _over()) > 0:
                    # This query's own pinned side may be what does not
                    # fit (shed_bytes spares pinned entries): unpin, serve
                    # unprepared, and shed the now evictable entry.
                    lease.release()
                    lease = None
                    right, right_counts, right_on = orig_right
                    fc = admission.forecast(topology, left, right, left_on, right_on, config,
                                            match_factor=self.config.match_factor)
                    need = self._world_max(topology, _over())
                    if need > 0 and index_bytes > 0:
                        shed_bytes(need)
                        index_bytes = admission.reserved_index_bytes()
            # The measured gate (DJT_SERVE_MEASURED_HBM=1): the card's
            # allocator outranks the model; None when unarmed or CPU.
            measured = _truth.measured_admission(budget)
            if measured is not None and not fc.bytes > measured["headroom_bytes"]:
                measured = None
            # Tenant fair share: under pressure a door shed goes to the
            # most over-share tenant's queued work.
            heavy = self._overshare_tenant() if self._pressure_level >= 1 else None
            with self._cv:
                view = self._door_view_locked(fc, index_bytes, fleet_bytes, measured, heavy)
            views = self._views(topology, view)
            with self._cv:
                shed, victims, pressure = self._door_locked(views, fc, tenant)
                if shed is None:
                    ticket = Ticket(
                        self, next(self._seq),
                        (topology, left, left_counts, right, right_counts, tuple(left_on),
                         None if right_on is None else tuple(right_on)),
                        config, None if deadline_s is None else time.monotonic() + deadline_s,
                        deadline_s, fc, tenant, lease, query_id)
                    lease = None  # the ticket owns it now
                    self._enqueue_locked(ticket)
            self._apply_pressure(pressure)
            for v in victims:
                self._finish_fair_share_victim(v, heavy)
            if shed is not None:
                self._raise_shed(shed, fc, budget)
        finally:
            if lease is not None:  # rejected at the door: unpin
                lease.release()
        trace.span_begin("queued")
        return ticket

    def _door_view_locked(self, fc, index_bytes, fleet_bytes, measured, heavy) -> dict:
        """This process's inputs to the door (caller holds the lock)."""
        return {"closed": self._closed, "draining": self._draining, "fc": fc.bytes,
                "reserved": self._reserved_bytes, "index": index_bytes, "fleet": fleet_bytes,
                "measured": measured, "full": len(self._queue) >= self.config.queue_depth,
                "heavy": heavy}

    def _door_locked(self, views: list, fc, tenant: str):
        """The door's one decision over every process's view (one view
        outside a process world): ``(shed, victims, pressure)``, where
        ``shed`` is None (admit) or (kind, the deciding view). Caller
        holds the lock; raising and recording happen after it."""
        if any(v["closed"] for v in views):
            raise BackendError("QueryScheduler is closed")
        budget = self.config.hbm_budget_bytes

        def over(v, freed=0.0):
            return budget > 0 and v["fc"] + v["reserved"] - freed + v["index"] + v["fleet"] > budget

        measured = next((v for v in views if v["measured"] is not None), None)
        draining = any(v["draining"] for v in views)
        is_over = any(over(v) for v in views)
        full = any(v["full"] for v in views)
        heavy = views[0]["heavy"]  # process 0's usage ranking
        victims: list = []
        freed = 0.0
        if not draining and measured is None and (is_over or full) and heavy is not None \
                and heavy != tenant:
            need = max(v["fc"] + v["reserved"] + v["index"] + v["fleet"] - budget
                       for v in views) if is_over else 0.0
            victims = self._fair_share_victims_locked(heavy, need_bytes=need)
            # The victims' reservations release in their _finish; the door
            # credits them now so the redirect admits this query.
            freed = sum(t.forecast.bytes for t in victims)
            is_over = any(over(v, freed) for v in views)
            full = len(self._queue) >= self.config.queue_depth
        shed, pressure = None, None
        if draining:
            shed = ("draining", views[0])
        elif measured is not None:
            shed = ("measured_hbm", measured)
        elif is_over:
            shed = ("admission", next(v for v in views if over(v, freed)))
        elif full:
            shed = ("queue_full", views[0])
        if shed is None or shed[0] != "draining":
            pressure = self._note_outcome(rejected=shed is not None)
        return shed, victims, pressure

    def _enqueue_locked(self, ticket: Ticket) -> None:
        self._queue.append(ticket)
        self._reserved_bytes += ticket.forecast.bytes
        obs.inc("dj_serve_admitted_total")
        # The flag now, the begin event after the lock: the dispatch may
        # even finish the ticket first; the flag keeps the span paired.
        ticket._queued_open = True
        self._cv.notify()

    def _raise_shed(self, shed: tuple, fc, budget: float, what: str = "") -> None:
        """Record a door shed and raise its typed error (outside the lock)."""
        kind, v = shed
        if kind == "draining":
            obs.inc("dj_serve_rejected_total", reason="draining")
            obs.record("drain", phase="reject", scheduler=self.name, sig=fc.signature[:200])
            raise Draining(f"scheduler {self.name} is draining (SIGTERM/rolling restart): new "
                           f"work rejected, in-flight work finishing; retry on another worker",
                           scheduler=self.name)
        if kind == "measured_hbm":
            m = v["measured"]
            obs.inc("dj_serve_rejected_total", reason="measured_hbm")
            obs.record("admission", decision="reject", source="measured_hbm",
                       forecast_bytes=fc.bytes, budget_bytes=budget, device=m["device"],
                       bytes_in_use=m["bytes_in_use"], margin_bytes=m["margin_bytes"],
                       headroom_bytes=m["headroom_bytes"], sig=fc.signature[:200])
            raise AdmissionRejected(
                f"{what}admission rejected on MEASURED occupancy: forecast {fc.bytes:.3g} B "
                f"exceeds measured headroom {m['headroom_bytes']:.3g} B (device {m['device']} "
                f"holds {m['bytes_in_use']:.3g} B of DJT_SERVE_HBM_BUDGET {budget:.3g} B, "
                f"margin {m['margin_bytes']:.3g} B)",
                forecast_bytes=fc.bytes, reserved_bytes=float(m["bytes_in_use"]),
                budget_bytes=budget, signature=fc.signature, measured=m)
        if kind == "admission":
            reserved, index_bytes, fleet_bytes = v["reserved"], v["index"], v["fleet"]
            obs.inc("dj_serve_rejected_total", reason="admission")
            fields = dict(forecast_bytes=fc.bytes, reserved_bytes=reserved,
                          index_bytes=index_bytes)
            if not what:
                fields["fleet_bytes"] = fleet_bytes
            obs.record("admission", decision="reject", **fields, budget_bytes=budget,
                       ledger_warmed=fc.ledger_warmed, sig=fc.signature[:200])
            raise AdmissionRejected(
                f"{what}admission rejected: {'chain ' if what else ''}forecast "
                f"{fc.bytes:.3g} B + reserved {reserved:.3g} B + resident index "
                f"{index_bytes:.3g} B + fleet peers {fleet_bytes:.3g} B exceeds "
                f"DJT_SERVE_HBM_BUDGET {budget:.3g} B (ledger_warmed={fc.ledger_warmed})",
                forecast_bytes=fc.bytes, reserved_bytes=reserved + index_bytes + fleet_bytes,
                budget_bytes=budget, signature=fc.signature)
        obs.inc("dj_serve_shed_total", reason="queue_full")
        obs.record("shed", reason="queue_full", depth=self.config.queue_depth)
        raise QueueFull(f"serve queue at capacity (DJT_SERVE_QUEUE_DEPTH="
                        f"{self.config.queue_depth})", depth=self.config.queue_depth)

    def submit_pipeline(self, topology, left, left_counts, stages, config=None, *,
                        left_partitioned_by=None, deadline_s: Optional[float] = None,
                        tenant: str = "default") -> Ticket:
        """Admit and enqueue a multi-join chain as one query
        (``distributed_join_pipeline_auto``'s arguments): one query id,
        one forecast for the chain (:func:`~.admission.forecast_pipeline`:
        the budget reserves the chain once, up front), one Ticket whose
        ``result()`` gives ``(out, counts, infos, configs)``. A pipeline
        never coalesces and never routes through the index: a stage's
        resident right is passed as a PreparedSide in its JoinStage."""
        query_id = _mint_query_id()
        with trace.query_ctx(query_id, tenant):
            trace.span_begin("query")
            try:
                ticket = self._admit_pipeline(topology, left, left_counts, stages, config,
                                              left_partitioned_by=left_partitioned_by,
                                              deadline_s=deadline_s, tenant=tenant,
                                              query_id=query_id)
            except BaseException as e:
                trace.span_end("query", outcome=type(e).__name__)
                try:
                    e.query_id = query_id
                except Exception:  # noqa: BLE001 - best-effort tag
                    pass
                raise
        self._set_gauges()
        return ticket

    def _admit_pipeline(self, topology, left, left_counts, stages, config, *,
                        left_partitioned_by, deadline_s, tenant, query_id) -> Ticket:
        """submit_pipeline's body: plan without range probes (the door
        reads no device data), forecast the chain, the door, enqueue."""
        from ..parallel.dist_join import JoinConfig
        from ..parallel.pipeline import plan_pipeline

        self._check_world(topology)
        if config is None:
            config = JoinConfig()
        # The dispatch plans again with ranges; the bucketing is memoized
        # by identity, so both plans see the same padded tables.
        plan = plan_pipeline(topology, left, left_counts, stages, config,
                             left_partitioned_by=left_partitioned_by, resolve_ranges=False)
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        fc = admission.forecast_pipeline(topology, plan, config,
                                         match_factor=self.config.match_factor)
        budget = self.config.hbm_budget_bytes
        index_bytes = admission.reserved_index_bytes()
        fleet_bytes = _fleet.peer_bytes_guarded()
        if budget > 0:
            need = self._world_max(topology, fc.bytes + self._reserved_bytes + index_bytes
                                   + fleet_bytes - budget)
            if need > 0 and index_bytes > 0:
                from ..cache import shed_bytes

                shed_bytes(need)
                index_bytes = admission.reserved_index_bytes()
        measured = _truth.measured_admission(budget)
        if measured is not None and not fc.bytes > measured["headroom_bytes"]:
            measured = None
        with self._cv:
            view = self._door_view_locked(fc, index_bytes, fleet_bytes, measured, None)
        views = self._views(topology, view)
        with self._cv:
            shed, _, pressure = self._door_locked(views, fc, tenant)
            if shed is None:
                ticket = Ticket(self, next(self._seq),
                                (topology, plan.left, plan.left_counts, None, None, (), None),
                                config,
                                None if deadline_s is None else time.monotonic() + deadline_s,
                                deadline_s, fc, tenant, None, query_id, stages=list(stages))
                self._enqueue_locked(ticket)
        self._apply_pressure(pressure)
        if shed is not None:
            self._raise_shed(shed, fc, budget, what="pipeline ")
        trace.span_begin("queued")
        return ticket

    # -- tenant fair share (DJT_FLEET_TENANT_WEIGHTS) --------------------------

    def _overshare_tenant(self) -> Optional[str]:
        """The tenant furthest over its ``DJT_FLEET_TENANT_WEIGHTS``
        share, or None (no weights, balanced, no accounting yet). Usage
        is ``obs.truth.tenant_summary``: the tenant's share of device
        seconds and of resident index bytes, against its weight's share.
        Deterministic. Called outside the lock."""
        weights = _fleet.tenant_weights()
        if not weights:
            return None
        try:
            tenants = _truth.tenant_summary().get("tenants") or {}
        except Exception:  # noqa: BLE001 - fair share is best-effort
            return None
        if not tenants:
            return None
        ds_tot = sum(float(t.get("device_seconds", 0.0)) for t in tenants.values())
        ib_tot = sum(float(t.get("index_bytes", 0.0)) for t in tenants.values())
        if ds_tot <= 0 and ib_tot <= 0:
            return None
        w_tot = sum(weights.get(name, 1.0) for name in tenants)
        if w_tot <= 0:
            return None
        best, best_ratio = None, 1.0
        for name in sorted(tenants):
            t = tenants[name]
            usage, terms = 0.0, 0
            if ds_tot > 0:
                usage += float(t.get("device_seconds", 0.0)) / ds_tot
                terms += 1
            if ib_tot > 0:
                usage += float(t.get("index_bytes", 0.0)) / ib_tot
                terms += 1
            usage /= max(terms, 1)
            fair = weights.get(name, 1.0) / w_tot
            ratio = usage / fair if fair > 0 else 0.0
            if ratio > best_ratio:
                best, best_ratio = name, ratio
        return best

    def _fair_share_victims_locked(self, heavy: str, *, need_bytes: float) -> list:
        """Pop the over-share tenant's queued tickets, newest first, until
        ``need_bytes`` are freed (a full queue: the first pop). Their
        terminals land outside the lock."""
        victims, freed = [], 0.0
        for t in list(reversed(self._queue)):
            if t.tenant != heavy:
                continue
            self._queue.remove(t)
            victims.append(t)
            freed += t.forecast.bytes
            if freed >= need_bytes:
                break
        return victims

    def _finish_fair_share_victim(self, v: Ticket, heavy: str) -> None:
        obs.inc("dj_serve_shed_total", reason="tenant_fair_share")
        obs.inc("dj_fleet_tenant_shed_total", tenant=v.tenant)
        with trace.query_ctx(v.query_id, v.tenant):
            obs.record("shed", reason="tenant_fair_share", tenant=v.tenant, over_tenant=heavy,
                       depth=self.config.queue_depth)
        self._finish(v, error=QueueFull(
            f"shed by tenant fair-share: tenant {v.tenant!r} is over its "
            f"DJT_FLEET_TENANT_WEIGHTS share under pressure", depth=self.config.queue_depth))

    # -- the pressure ladder ----------------------------------------------------

    def _note_outcome(self, *, rejected: bool):
        """One submission outcome into the window; a sustained rejected
        share steps the level. Caller holds the lock, so only the state
        moves here: the transition (level, action, rate) is returned for
        :meth:`_apply_pressure` after the lock. None: no transition."""
        self._outcomes.append(rejected)
        win = self._outcomes
        if len(win) < win.maxlen or self._pressure_level >= MAX_PRESSURE_LEVEL:
            return None
        rate = sum(win) / len(win)
        if rate < self.config.pressure_reject_rate:
            return None
        self._pressure_level += 1
        level = self._pressure_level
        win.clear()  # each step needs fresh sustained pressure
        return (level, _PRESSURE_LEVELS[level - 1][1], rate)

    def _apply_pressure(self, transition) -> None:
        """A transition's pins, gauge and ``pressure`` event, outside the
        lock. Level 2 pins ``merge`` alone: dj_tpu pins its bucketed
        ``sort`` tier too, which the port does not have."""
        if transition is None:
            return
        level, action, rate = transition
        if action == "drop_compressed_wire":
            resil.pin_baseline("wire", "serve pressure: sustained rejection")
        elif action == "drop_optional_tiers":
            resil.pin_baseline("merge", "serve pressure: sustained rejection")
        # halve_odf applies at dispatch (_dispatch_config). The gauge reads
        # the current level: transitions may apply out of order.
        obs.set_gauge("dj_serve_pressure_level", self._pressure_level)
        obs.record("pressure", level=level, action=action, reject_rate=round(rate, 4))

    def _dispatch_config(self, ticket: Ticket):
        """The JoinConfig a query runs with at the current level: level 3
        halves the odf of unprepared queries (a PreparedSide's odf is its
        resident batches')."""
        from ..parallel.dist_join import PreparedSide

        cfg = ticket.config
        if (self._pressure_level >= 3 and not isinstance(ticket.args[3], PreparedSide)
                and cfg.over_decom_factor > 1):
            cfg = dataclasses.replace(cfg, over_decom_factor=max(1, cfg.over_decom_factor // 2))
        return cfg

    # -- dispatch -------------------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            try:
                did = self.pump(block=True, timeout=0.25)
            except Exception:  # noqa: BLE001 - the loop must survive
                did = 0
            if not did and self._closed:
                return

    def pump(self, *, block: bool = False, timeout: Optional[float] = None) -> int:
        """Dispatch one group (coalesced or single). Returns how many
        queries reached a terminal (queue-expired sheds included). Every
        failure of a query lands in its ticket, typed. In a process world
        every process pumps together: process 0 picks the group and its
        clock the expired members."""
        popped = self._pop_group(block, timeout)
        if not popped:
            return 0
        group, expired = popped
        shed, live = 0, []
        for t, gone in zip(group, expired):
            if gone:
                self._shed_deadline(t, "queued")
                shed += 1
            else:
                live.append(t)
        if live:
            self._execute(live)
        self._set_gauges()
        return shed + len(live)

    def _pop_group(self, block: bool, timeout: Optional[float]) -> Optional[tuple]:
        """(the group taken off the queue, which members expired), or None.
        In a process world both are process 0's: its queue and its clock
        at this pop (one object broadcast)."""
        with self._cv:
            if block and not self._queue and not self._closed:
                self._cv.wait(timeout)
            # A closed scheduler dispatches nothing more: close() sheds.
            if not self._queue or self._closed:
                return None
            group = self._group_locked()
            topology = group[0].args[0]
            if not agree.multi_process(topology):
                self._take_locked(group)
                now = time.monotonic()
                return group, [t.expired(now) for t in group]
            now = time.monotonic()
            mine = ([t.seq for t in group], [t.expired(now) for t in group])
        seqs, expired = agree.from_rank0(mine)
        with self._cv:
            by_seq = {t.seq: t for t in self._queue}
            if any(s not in by_seq for s in seqs):
                raise RuntimeError(f"QueryScheduler {self.name}: process 0 dispatches queries "
                                   f"{seqs}, which this process has not queued: the processes "
                                   f"submitted different queries")
            group = [by_seq[s] for s in seqs]
            self._take_locked(group)
            return group, expired

    def _group_locked(self) -> list:
        """The head ticket and the queued tickets that coalesce with it,
        at most ``coalesce_max`` (not yet taken off the queue)."""
        head = self._queue[0]
        group = [head]
        key = self._coalesce_key(head)
        if key is not None:
            limit = max(1, self.config.coalesce_max)
            for t in list(self._queue)[1:]:
                if len(group) >= limit:
                    break
                if self._coalesce_key(t) == key:
                    group.append(t)
        return group

    def _take_locked(self, group: list) -> None:
        taken = {id(t) for t in group}
        keep = [t for t in self._queue if id(t) not in taken]
        self._queue.clear()
        self._queue.extend(keep)

    def _coalesce_key(self, ticket: Ticket):
        """The group key, or None when the query cannot coalesce: the same
        PreparedSide, left schema and capacity, key columns and config;
        or, for Table rights (the shape-bucket extension), the same left
        and right schema and capacity, keys and config on a flat world
        with the adaptive planner unarmed (its tiers are per-query plan
        decisions a fused dispatch cannot honor). Never for a pipeline or
        under the autotuner (tuned knobs are per signature)."""
        from ..parallel import autotune, plan_adapt
        from ..parallel.dist_join import PreparedSide

        if ticket.stages is not None:
            return None
        if not self.config.coalesce or self.config.coalesce_max < 2:
            return None
        if autotune.enabled():
            return None
        topology, left, _, right, _, left_on, right_on = ticket.args
        if isinstance(right, PreparedSide):
            return (id(topology), id(right), obs.table_sig(left, force=True), left.capacity,
                    left_on, ticket.config)
        if right_on is None or topology.is_hierarchical or plan_adapt.enabled():
            return None
        return ("unprep", id(topology), obs.table_sig(left, force=True), left.capacity,
                obs.table_sig(right, force=True), right.capacity, left_on, right_on,
                ticket.config)

    def _execute(self, group: list) -> None:
        """Run one group to terminal states; nothing escapes."""
        try:
            if threading.current_thread() is self._worker:
                dev = _cuda_device(group[0].args[0])
                if dev is not None:
                    import torch

                    torch.cuda.set_device(dev)
            if len(group) > 1:
                self._execute_coalesced(group)
            else:
                # pump() just read the deadline (process 0's clock in a
                # process world): no second read before the dispatch.
                self._execute_single(group[0], recheck=False)
        except Exception as e:  # noqa: BLE001 - the terminal-state guarantee
            err = self._typed(e)
            for t in group:
                if not t.done:
                    self._finish(t, error=err)
        finally:
            for t in group:
                if not t.done:
                    self._finish(t, error=BackendError(
                        "scheduler bug: dispatched query reached no terminal state"))

    @staticmethod
    def _typed(e: BaseException) -> DJError:
        """DJErrors pass through; any other exception (a device fault
        included) wraps in BackendError, the original as ``__cause__``."""
        if isinstance(e, DJError):
            return e
        wrapped = BackendError(f"unhandled {type(e).__name__} on the serve path: {e}")
        wrapped.__cause__ = e
        return wrapped

    def _scopes(self, ticket: Ticket, model_bytes: float, deadline=None, deadline_s=None):
        """A dispatch's forecast and deadline scopes (``deadline``: the
        ticket's unless given; shared by the processes of a world)."""
        if deadline is None:
            deadline, deadline_s = ticket.deadline, ticket.deadline_s
        stack = contextlib.ExitStack()
        stack.enter_context(_truth.forecast_scope(model_bytes))
        stack.enter_context(heal_engine.deadline_scope(
            deadline, deadline_s, shared=agree.multi_process(ticket.args[0])))
        return stack

    def _run_auto(self, ticket: Ticket, config):
        from ..parallel.dist_join import distributed_inner_join_auto

        topology, left, lc, right, rc, left_on, right_on = ticket.args
        sc = self.config
        with self._scopes(ticket, ticket.forecast.bytes):
            return distributed_inner_join_auto(
                topology, left, lc, right, rc, left_on, right_on, config,
                max_attempts=sc.max_attempts, growth=sc.growth,
                max_total_growth=sc.max_total_growth)

    def _run_pipeline(self, ticket: Ticket, config):
        """One chain under the forecast and deadline scopes (each stage
        heals, and the chain tunes as one unit, inside the auto wrapper)."""
        from ..parallel.pipeline import distributed_join_pipeline_auto

        topology, left, lc = ticket.args[:3]
        sc = self.config
        with self._scopes(ticket, ticket.forecast.bytes):
            return distributed_join_pipeline_auto(
                topology, left, lc, ticket.stages, config, max_attempts=sc.max_attempts,
                growth=sc.growth, max_total_growth=sc.max_total_growth)

    def _run_autotuned(self, ticket: Ticket, config):
        """One dispatch under the autotuner: the signature's decision (its
        first sighting tunes once; a record replays with no probe), the
        tuned odf in the config, the env axes under ``dispatch_scope``."""
        from ..parallel import autotune

        sig = ticket.forecast.signature
        decision = autotune.resolve(sig, autotune.make_tuner(*ticket.args, ticket.config),
                                    topology=ticket.args[0])
        cfg = autotune.apply_config(decision, config)
        with autotune.dispatch_scope(decision, sig):
            return self._run_auto(ticket, cfg)

    @contextlib.contextmanager
    def _serve_run(self, tickets: list):
        """The dispatch's span ``serve_run`` (``spmd.call_span``): under
        ``record_phases`` the root of one record entry, from dispatch to
        the end of its work on the stream. With obs enabled on the card
        two CUDA events bracket it too, which ``_finish`` hands to
        ``obs.roofline`` as the ``run`` phase and the tenant's device
        seconds (each coalesced member gets the group's)."""
        topology = tickets[0].args[0]
        dev = _cuda_device(topology) if _metrics.enabled() else None
        start = None
        for t in tickets:
            t._run_events = None
        if dev is not None:
            import torch

            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
        with call_span("serve_run", topology.device):
            yield
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(dev))
            for t in tickets:
                t._run_events = (start, end)

    def _mark_dispatched(self, ticket: Ticket, *, coalesced: bool = False) -> None:
        """Close ``queued`` and open ``run``, each once a query (caller
        holds the ticket's query_ctx)."""
        if ticket._queued_open:
            ticket._queued_open = False
            trace.span_end("queued")
        if not ticket._run_open:
            ticket._run_open = True
            trace.span_begin("run", coalesced=coalesced)

    def _execute_single(self, ticket: Ticket, expired_where: str = "queued",
                        recheck: bool = True) -> None:
        # A demoted coalesced member comes here too: its deadline may have
        # passed while the group ran, and it sheds as "coalesced".
        if recheck and self._expired(ticket):
            self._shed_deadline(ticket, expired_where)
            return
        with trace.query_ctx(ticket.query_id, ticket.tenant):
            self._execute_single_traced(ticket)

    def _execute_single_traced(self, ticket: Ticket) -> None:
        from ..parallel import autotune

        self._mark_dispatched(ticket)
        _truth.sample_device_hbm()
        ticket.start_t = time.monotonic()
        # The side this dispatch starts from: replace() below commits only
        # if the entry still holds it (a concurrent append or heal wins).
        base = ticket.args[3] if ticket.lease is not None else None
        try:
            cfg = self._dispatch_config(ticket)
            with self._serve_run([ticket]):
                if ticket.stages is not None:
                    payload = self._run_pipeline(ticket, cfg)
                elif autotune.enabled():
                    # A faulted probe or apply pins the autotune tier, and the
                    # retry serves the hand-tuned defaults.
                    payload = resil.degrade_guard(
                        "serve_autotune", lambda: self._run_autotuned(ticket, cfg),
                        tiers=("autotune",), topology=ticket.args[0])
                else:
                    payload = self._run_auto(ticket, cfg)
        except DeadlineExceeded as e:
            self._shed_deadline(ticket, e.where or "healing", err=e)
            return
        except Exception as e:  # noqa: BLE001 - the typed-terminal guarantee
            self._finish(ticket, error=self._typed(e))
            return
        if ticket.lease is not None and isinstance(payload, tuple) and len(payload) == 5:
            # The auto loop may have re-prepared: publish the healed side,
            # so the signature heals once, not once a query. Best effort.
            try:
                if payload[4] is not base:
                    self.index.replace(ticket.lease.key, payload[4], expect=base)
            except Exception:  # noqa: BLE001
                pass
        self._finish(ticket, payload=payload)

    def _begin_coalesced(self, group: list) -> None:
        _truth.sample_device_hbm()
        now = time.monotonic()
        for t in group:
            t.start_t = now
            t.coalesced = True
            with trace.query_ctx(t.query_id, t.tenant):
                self._mark_dispatched(t, coalesced=True)

    def _group_scopes(self, group: list):
        """The group's scopes: the members' summed forecast, the earliest
        deadline."""
        deadlines = [t.deadline for t in group if t.deadline is not None]
        deadline = min(deadlines) if deadlines else None
        head = group[0]
        return self._scopes(head, sum(t.forecast.bytes for t in group), deadline,
                            head.deadline_s if deadline is not None else None)

    def _demote_all(self, group: list) -> None:
        """After a group-level failure each member runs alone (the
        singleton path re-prepares, heals and types errors as if never
        grouped). Called after the except block: the failure's traceback
        holds the group's device buffers until then, and a member run
        beside them could exhaust the card."""
        for t in group:
            t.coalesced = False
            self._execute_single(t, expired_where="coalesced")

    def _finish_members(self, group: list, per_query, fired_keys, payload_of) -> None:
        """Each member's terminal: a member whose flags fire demotes to the
        singleton heal path, the others keep the group's result."""
        from ..resilience.heal import flag_fired

        for t, (out, counts, info) in zip(group, per_query):
            if any(flag_fired(v) for k, v in info.items()
                   if k.endswith("overflow") or k in fired_keys):
                t.coalesced = False
                self._execute_single(t, expired_where="coalesced")
            else:
                self._finish(t, payload=payload_of(out, counts, info))

    def _execute_coalesced(self, group: list) -> None:
        from ..parallel.dist_join import PreparedSide, distributed_inner_join_coalesced

        if not isinstance(group[0].args[3], PreparedSide):
            self._execute_coalesced_unprepared(group)
            return
        self._begin_coalesced(group)
        head = group[0]
        topology, _, _, prepared, _, left_on, _ = head.args
        config = self._dispatch_config(head)
        try:
            # One run for the group: its heal and collective events go to
            # the head's timeline (the coalesce event names the members).
            with trace.query_ctx(head.query_id, head.tenant), self._group_scopes(group), \
                    self._serve_run(group):
                per_query, config_used = distributed_inner_join_coalesced(
                    topology, [t.args[1] for t in group], [t.args[2] for t in group], prepared,
                    left_on, config)
        except Exception as e:  # noqa: BLE001 - demote, don't die
            # A kernel or device failure does not demote: the singleton
            # would launch the same kernel. It ends the group's tickets.
            if resil._kernel_failure(e):
                raise
            per_query = None
        if per_query is None:
            self._demote_all(group)
            return
        obs.inc("dj_serve_coalesced_total", len(group))
        with trace.query_ctx(head.query_id, head.tenant):
            obs.record("coalesce", size=len(group), sig=head.forecast.signature[:200],
                       members=[t.query_id for t in group])
        # config_used: the group may have run at ledger-widened factors.
        self._finish_members(group, per_query, ("prepared_plan_mismatch",),
                             lambda out, counts, info: (out, counts, info, config_used,
                                                        prepared))

    def _execute_coalesced_unprepared(self, group: list) -> None:
        """K same-signature Table-right queries in one dispatch, with the
        prepared path's contract: a group failure demotes every member, a
        member whose flags fire (an overflow, a surrogate collision)
        demotes alone."""
        from ..parallel.dist_join import distributed_inner_join_coalesced_unprepared

        self._begin_coalesced(group)
        head = group[0]
        topology, _, _, _, _, left_on, right_on = head.args
        config = self._dispatch_config(head)
        try:
            with trace.query_ctx(head.query_id, head.tenant), self._group_scopes(group), \
                    self._serve_run(group):
                per_query, config_used = distributed_inner_join_coalesced_unprepared(
                    topology, [t.args[1] for t in group], [t.args[2] for t in group],
                    [t.args[3] for t in group], [t.args[4] for t in group], left_on, right_on,
                    config)
        except Exception as e:  # noqa: BLE001 - demote, don't die
            if resil._kernel_failure(e):
                raise
            per_query = None
        if per_query is None:
            self._demote_all(group)
            return
        obs.inc("dj_serve_coalesced_total", len(group))
        with trace.query_ctx(head.query_id, head.tenant):
            obs.record("coalesce", size=len(group), sig=head.forecast.signature[:200],
                       members=[t.query_id for t in group], path="unprepared")
        self._finish_members(group, per_query, ("surrogate_collision",),
                             lambda out, counts, info: (out, counts, info, config_used))

    # -- terminal transitions ------------------------------------------------------

    def _shed_deadline(self, ticket: Ticket, where: str,
                       err: Optional[DeadlineExceeded] = None) -> None:
        # Deadline sheds feed the pressure window too: expiring queries
        # are overload as much as rejects are.
        with self._cv:
            pressure = self._note_outcome(rejected=True)
        self._apply_pressure(pressure)
        obs.inc("dj_serve_shed_total", reason=f"deadline_{where}")
        with trace.query_ctx(ticket.query_id, ticket.tenant):
            obs.record("shed", reason=f"deadline_{where}", deadline_s=ticket.deadline_s,
                       queued_s=round(time.monotonic() - ticket.submit_t, 6))
        if err is None:
            err = DeadlineExceeded(
                f"deadline expired {where} (budget {ticket.deadline_s:g}s)", where=where,
                deadline_s=ticket.deadline_s,
                elapsed_s=round(time.monotonic() - ticket.submit_t, 6))
        self._finish(ticket, error=err)

    def _finish(self, ticket: Ticket, payload=None,
                error: Optional[BaseException] = None) -> None:
        """The one terminal transition, exactly once a ticket; also where
        every per-terminal observation happens: the ``serve`` event, the
        closing spans, the latency histogram, the drift audit and the SLO
        window."""
        _release_frames(error)
        with self._cv:
            if ticket._done:
                raise AssertionError(
                    f"ticket #{ticket.seq} finished twice ({ticket.outcome} then "
                    f"{'result' if error is None else type(error).__name__})")
            ticket._payload = payload
            ticket._error = error
            ticket._done = True
            self._reserved_bytes = max(0.0, self._reserved_bytes - ticket.forecast.bytes)
        if ticket.lease is not None:
            # Only now can the index evict the side.
            ticket.lease.release()
            ticket.lease = None
        end = time.monotonic()
        start = ticket.start_t
        total_s = end - ticket.submit_t
        with trace.query_ctx(ticket.query_id, ticket.tenant):
            self._audit_forecast(ticket, payload, error)
            if start is not None:
                # The run against the forecast's modeled bytes (results
                # only): one phase event, dj_roofline_frac{run}. Its
                # device time where serve_run's events bracket it (obs
                # enabled on the card), else dispatch to terminal.
                run_kw = dict(model_bytes=ticket.forecast.bytes if error is None else None,
                              kind="hbm", stage="serve")
                if ticket._run_events is not None:
                    tenant = ticket.tenant
                    _roofline.observe_events(
                        "run", *ticket._run_events, **run_kw,
                        then=lambda s: obs.inc("dj_tenant_device_seconds_total", s,
                                               tenant=tenant))
                else:
                    _roofline.observe_phase("run", end - start, **run_kw)
            obs.record(
                "serve", outcome=ticket.outcome, tenant=ticket.tenant,
                queued_s=round((start if start is not None else end) - ticket.submit_t, 6),
                run_s=None if start is None else round(end - start, 6),
                total_s=round(total_s, 6), coalesced=ticket.coalesced,
                plan_tier=ticket.forecast.plan_tier, autotuned=ticket.forecast.autotuned)
            if ticket._queued_open:
                ticket._queued_open = False
                trace.span_end("queued")
            if ticket._run_open:
                ticket._run_open = False
                trace.span_end("run")
            trace.span_end("query", outcome=ticket.outcome)
        obs.observe("dj_serve_latency_seconds", total_s, tenant=ticket.tenant,
                    outcome=ticket.outcome)
        if start is not None and ticket._run_events is None:
            # Coalesced members each count the group's shared wall.
            obs.inc("dj_tenant_device_seconds_total", end - start, tenant=ticket.tenant)
        _truth.sample_device_hbm()
        if error is None and start is not None:
            try:
                from ..parallel import autotune

                autotune.note_latency(ticket.forecast.signature, end - start)
            except Exception:  # noqa: BLE001 - the feed never fails a query
                pass
        self._note_slo(ticket, end)
        if error is None and threading.current_thread() is self._worker:
            dev = _cuda_device(ticket.args[0])
            if dev is not None:
                import torch

                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                ticket._ready = (dev, ev)
        ticket._event.set()

    def _audit_forecast(self, ticket: Ticket, payload, error) -> None:
        """The drift audit: the forecast repriced under the config the
        query ran with (``payload[3]``), into ``dj_forecast_error_ratio``;
        outside [1/t, t] one ``drift`` event, ``dj_forecast_drift_total``
        and a re-tune flag on a tuned signature."""
        if error is not None or not isinstance(payload, tuple):
            return
        if len(payload) < 4 or ticket.forecast.bytes <= 0:
            return
        try:
            actual = admission.reprice(ticket.forecast, payload[3])
        except Exception:  # noqa: BLE001 - an audit never fails a query
            return
        ratio = actual / ticket.forecast.bytes
        obs.observe("dj_forecast_error_ratio", ratio, buckets=_metrics.RATIO_BUCKETS)
        t = max(1.0, self.config.drift_threshold)
        if ratio > t or ratio < 1.0 / t:
            obs.inc("dj_forecast_drift_total")
            obs.record("drift", ratio=round(ratio, 4), forecast_bytes=ticket.forecast.bytes,
                       actual_bytes=actual, threshold=t,
                       ledger_warmed=ticket.forecast.ledger_warmed,
                       sig=ticket.forecast.signature[:200])
            try:
                from ..parallel import autotune

                autotune.note_drift(ratio, sig=ticket.forecast.signature)
            except Exception:  # noqa: BLE001 - an audit never fails a query
                pass

    def _note_slo(self, ticket: Ticket, end: float) -> None:
        """The SLO window over terminal queries and its ``dj_slo_*``
        gauges, labeled with this scheduler's name. Door rejects live in
        the pressure window, not here."""
        healed = trace.event_count(ticket.query_id, "heal") > 0
        entry = (ticket.deadline is not None,
                 ticket.outcome == "result" and (ticket.deadline is None or end <= ticket.deadline),
                 healed, ticket.outcome == "DeadlineExceeded")
        with self._cv:
            self._slo.append(entry)
            win = list(self._slo)
        rates = _slo_rates(win)
        obs.set_gauge("dj_slo_deadline_hit_rate", rates["deadline_hit_rate"], scheduler=self.name)
        obs.set_gauge("dj_slo_heal_rate", rates["heal_rate"], scheduler=self.name)
        obs.set_gauge("dj_slo_shed_rate", rates["shed_rate"], scheduler=self.name)
        obs.set_gauge("dj_slo_window_terminals", rates["window_terminals"], scheduler=self.name)

    def _set_gauges(self) -> None:
        obs.set_gauge("dj_serve_queue_depth", len(self._queue))
        obs.set_gauge("dj_serve_reserved_bytes", self._reserved_bytes)
        # The fleet budget row rides the gauge cadence (throttled inside).
        _fleet.publish_guarded(self._reserved_bytes, admission.reserved_index_bytes())

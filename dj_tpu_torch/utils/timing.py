"""Phase timers, trace annotations and profiler brackets.

Counterpart of ``dj_tpu/utils/timing.py``, the reference's three tracing
mechanisms on PyTorch:

1. NVTX ranges -> :func:`annotate`: an NVTX range when the device is
   CUDA, plus a ``torch.profiler.record_function`` range while a
   ``torch.profiler`` profile is active (its trace shows the range, with
   the kernels launched inside it); with no profiler running that op is
   not opened, since it costs microseconds a range. The join pipeline's
   phases, which ``Communicator.phase`` names (dj_partition, dj_exchange,
   dj_join, dj_concat, a2a_*, bc_*, ...), each open one, and so does
   each :class:`span`, a named stage inside the open phase (the local
   join's pack, sort, expand, take, strings, ...), which the phase
   clock of ``parallel.spmd.record_phases`` also times.
2. cudaProfilerStart/Stop brackets -> :func:`profile`: a
   ``torch.profiler.profile`` bracket (CPU and, with a card, CUDA
   activities) that writes a chrome trace into a directory.
3. The reference's per-rank ``report_timing`` prints -> :class:`PhaseTimer`:
   host-side phase timing in the reference's print format.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["PhaseTimer", "annotate", "profile", "span"]

# What a span opened here nests in: the rank's phase ranges inside a
# ``run_spmd`` body, the call's root outside the ranks
# (``parallel.spmd.call_span``), None elsewhere. The object has ``label``
# (the open phase's name, or None), ``device`` and ``clock`` (the phase
# clock that times spans, None while nothing records).
_span_target: contextvars.ContextVar = contextvars.ContextVar(
    "dj_tpu_torch_span_target", default=None)
# Every span name a clock has timed in this process: the keys of a phase
# record that are spans and not mark-to-mark phases (``is_span_key``).
_span_names: set = {"untraced"}


def _nvtx(device) -> bool:
    if device is None:
        return torch.cuda.is_available() and torch.cuda.is_initialized()
    return torch.device(device).type == "cuda"


def _profiling() -> bool:
    """A ``torch.profiler`` profile is active in this process (on any
    thread). A PyTorch without the flag is taken to be profiling."""
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", True)


class annotate:
    """A named range, as a context manager: ``torch.cuda.nvtx`` push and
    pop when ``device`` is a CUDA device (None: when CUDA is initialized
    in this process), and ``torch.profiler.record_function(name)`` while
    a profiler is active."""

    __slots__ = ("name", "device", "_rf", "_nv")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self._rf = None
        self._nv = False

    def __enter__(self) -> None:
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._nv = _nvtx(self.device)
        if self._nv:
            torch.cuda.nvtx.range_push(self.name)

    def __exit__(self, *exc) -> bool:
        if self._nv:
            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(*exc)
        return False


class span:
    """A named stage of the work, as a context manager: an
    :class:`annotate` range keyed ``"<open phase>/<name>"`` (``name``
    where no phase is open: outside the ranks, under the call's root),
    timed on the phase clock of the rank or root it runs in while
    ``parallel.spmd.record_phases`` records. With nothing recording it
    is the range alone: no CUDA event, no synchronize, no device work.
    A span inside an open span of the same key counts once."""

    __slots__ = ("name", "_range", "_clock", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        target = _span_target.get()
        if target is None:
            key, device, self._clock = self.name, None, None
        else:
            key = self.name if target.label is None else f"{target.label}/{self.name}"
            device, self._clock = target.device, target.clock
        self._range = annotate(key, device)
        self._range.__enter__()
        self._rec = None
        if self._clock is not None:
            _span_names.add(self.name)
            self._rec = self._clock.open(key)

    def __exit__(self, *exc) -> bool:
        if self._rec is not None:
            self._clock.close(self._rec)
        self._range.__exit__(*exc)
        return False


@contextlib.contextmanager
def span_target(target) -> Iterator[None]:
    """Spans opened in the body nest in ``target`` (``_span_target``)."""
    token = _span_target.set(target)
    try:
        yield
    finally:
        _span_target.reset(token)


def is_span_key(key: str) -> bool:
    """Whether a phase record's ``key`` is a span's (or ``untraced``),
    which nests in a phase, and not a mark-to-mark phase, which tiles
    the rank's time with the others."""
    return key.rsplit("/", 1)[-1] in _span_names


@contextlib.contextmanager
def profile(trace_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the body with ``torch.profiler`` (CPU activities, and CUDA
    ones when a card is present) and write its chrome trace to
    ``trace_dir/trace.json`` at exit; yields the profiler, whose
    ``events()`` and ``key_averages()`` the caller may read after the
    body. A falsy ``trace_dir`` makes it a no-op that yields None.

    The profiler records every thread's ranges (``profile_all_threads``):
    the ranks of a world of threads annotate their phases on their own
    threads, which a profiler of the calling thread alone would miss."""
    if not trace_dir:
        yield None
        return
    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, experimental_config=_all_threads()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _all_threads():
    """The profiler config that records every thread, or None where this
    PyTorch has no such option (only the calling thread is recorded)."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def _sync(x) -> None:
    """Wait for the device work that produced the tensors in ``x`` (a
    tensor, or a nested tuple, list or dict of them): one synchronize
    of each CUDA device they lie on. CPU tensors are computed when they
    exist."""
    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, dict):
            for e in v.values():
                walk(e)
        elif isinstance(v, (tuple, list)):
            for e in v:
                walk(e)

    walk(x)
    for d in devices:
        torch.cuda.synchronize(d)


class PhaseTimer:
    """Host-side phase timing behind a report flag.

    >>> timer = PhaseTimer(report=True, rank=0)
    >>> with timer.phase("hash partition"):
    ...     out = step(...)           # doctest: +SKIP
    >>> timer.elapsed_ms("hash partition")  # doctest: +SKIP

    ``block``, when given to :meth:`phase`, is a zero-argument callable
    that returns the tensors to wait for (or those tensors): they are
    synchronized before the clock stops, so work the device runs after
    the body returns is the phase's and not whoever synchronizes next.

    ``on_phase(name, ms)``, when set, fires at every phase exit
    (``obs.roofline.query_timer`` feeds the observatory through it).
    """

    def __init__(self, report: bool = False, rank: int = 0, on_phase=None):
        self.report = report
        self.rank = rank
        self.on_phase = on_phase
        self.phases: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def note(self, name: str, ms: float) -> None:
        """Add one externally timed entry of phase ``name``."""
        self.phases[name] = self.phases.get(name, 0.0) + ms
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def phase(self, name: str, block=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                _sync(block() if callable(block) else block)
            ms = (time.perf_counter() - t0) * 1e3
            self.note(name, ms)
            if self.report:
                # The reference's format: "Rank 0: Hash partition takes 12ms"
                # (distributed_join.cpp:237-239).
                print(f"Rank {self.rank}: {name} takes {ms:.1f}ms")
            if self.on_phase is not None:
                self.on_phase(name, ms)

    def elapsed_ms(self, name: str) -> float:
        """The total of every entry of ``name``."""
        return self.phases.get(name, 0.0)

    def call_count(self, name: str) -> int:
        return self.counts.get(name, 0)

    def summary(self) -> dict[str, dict]:
        """{phase: {"total_ms", "count", "mean_ms"}}."""
        return {
            name: {
                "total_ms": total,
                "count": self.counts.get(name, 0),
                "mean_ms": total / max(1, self.counts.get(name, 0)),
            }
            for name, total in self.phases.items()
        }

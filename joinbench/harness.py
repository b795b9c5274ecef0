"""One run of a cell in this process: set-up, the measured window, the
check against the reference, the result.

Two loops. ``closed_loop`` joins back to back, each call on fresh
device copies of the set-up's tables (a user's tables are new to the
program every time, so no memo keyed on a tensor's identity may hit),
each call ending in a synchronize; the window's rate is all its input
bytes over all its seconds. ``open_loop`` submits probe tables to a
served build side on a Poisson schedule fixed by the cell (the same set
of sizes and gaps for every seed, in the seed's order), times each
query from when it was due to when its answer was on the device, and
waits up to ``wait_after_close_s`` past the window for the last.

The window keeps, from the seed, a sample of its answers (the valid
rows, copied), every answer's row count and flags. Once the window has
closed and the program's state is freed, the reference joins the
sample's inputs again and the answers are compared row for row (the
configuration's kind, ``kinds/<kind>.py``), every count is held to the
exact match count, and no flag may have fired. Each compared number
and its limit go into the result line's last key, ``checks``.
"""

from __future__ import annotations

import contextlib
import gc
import queue
import random
import statistics
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import datagen, profiling
from .readers import percentile

WARMUP_CALLS = 2


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fresh(cols: list) -> list:
    """Device copies of a table's columns (a string column's two tensors
    each)."""
    return [tuple(t.clone() for t in c) if isinstance(c, tuple) else c.clone() for c in cols]


def nbytes(cols: list) -> int:
    return sum(sum(t.numel() * t.element_size() for t in (c if isinstance(c, tuple) else (c,)))
               for c in cols)


def device_info(device: torch.device, count: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}
    return {"platform": "cpu", "kind": "cpu", "count": count}


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free_memory(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# -- the closed loop ----------------------------------------------------------------------


def closed_loop(system, left: list, right: list, join_config, device: torch.device,
                seconds: float, trace: bool, sample_seed: int,
                keep_going: Optional[Callable[[bool], bool]] = None,
                stretch_calls: int = 3, on: tuple = ((0,), (0,))) -> dict:
    """Join ``left`` and ``right`` on the key columns ``on`` (left's,
    right's) back to back for ``seconds``. Returns
    the window's joins and seconds, each join's count and flag (device
    tensors), the valid rows of one join drawn from ``sample_seed``
    (a reservoir of one over the window), the peak, and with ``trace``
    the program's phases of every call and a profiled stretch of
    ``stretch_calls`` joins (calls 2 to 2 + stretch_calls of the window).
    ``keep_going(want)`` turns this rank's wish to go on into the
    world's decision (every rank must make the same number of calls)."""
    from .system import valid_rows

    def call():
        ans = system.join_cols(fresh(left), fresh(right), join_config, *on)
        sync(device)
        return ans

    for _ in range(WARMUP_CALLS):
        call()
    free_memory(device)
    reset_peak(device)
    rng = random.Random(sample_seed)
    counts, flags, sample = [], [], None
    phase_ctx = system.phases() if trace else contextlib.nullcontext([])
    first = 2
    last = first + stretch_calls
    stretch = None
    wall0 = time.time()
    t0 = time.perf_counter()
    n = 0
    with phase_ctx as phases:
        while True:
            if trace and n == first:
                stretch = profiling.Stretch(device).__enter__()
            ans = call()
            n += 1
            if stretch is not None and n == last:
                stretch.__exit__(None, None, None)
            counts.append(ans.count)
            flags.append(ans.flagged)
            if rng.random() * n < 1.0:
                sample = None
                sample = valid_rows(ans)
            del ans
            want = time.perf_counter() - t0 < seconds or (trace and n < last)
            if not (keep_going(want) if keep_going else want):
                break
    window = time.perf_counter() - t0
    if stretch is not None:
        stretch.finish()
    return {"joins": n, "window_s": window, "wall0": wall0, "t_window": t0, "counts": counts,
            "flags": flags, "sample": sample, "peak": peak_bytes(device),
            "phases": list(phases), "profile": stretch.summary if stretch is not None else None,
            "stretch_calls": stretch_calls if stretch is not None else 0}


# -- the open loop ------------------------------------------------------------------------


class _Dispatch:
    """The serving side of the open loop: a dispatcher thread pumps the
    scheduler (its worker loop: one group a pump) and records a CUDA
    event after each pump; a collector thread waits for each finished
    query's event in turn and stamps the moment its answer was on the
    device. Between ``phases_on`` and ``phases_off`` the dispatcher's
    calls run under the program's phase clock (``phases_cm``), kept in
    ``phases``; it sets ``phases_closed`` once the clock is off."""

    def __init__(self, server, device, sampled: set, phases_cm=None):
        self.server = server
        self.device = device
        self.sampled = sampled
        self.phases_cm = phases_cm
        self.phases: list = []
        self.lock = threading.Lock()
        self.pending: list = []  # (index, due, ticket), in submit order
        self.done_q: queue.Queue = queue.Queue()
        self.stop = threading.Event()  # every query is submitted
        self.halt = threading.Event()  # stop pumping, whatever is left
        self.phases_on = threading.Event()
        self.phases_off = threading.Event()
        self.phases_closed = threading.Event()
        self.records: dict = {}  # index -> record
        self.samples: dict = {}  # index -> valid rows
        self.error: Optional[BaseException] = None

    def add(self, index: int, due: float, ticket) -> None:
        with self.lock:
            self.pending.append((index, due, ticket))

    def outstanding(self) -> int:
        with self.lock:
            return len(self.pending)

    def dispatcher(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        cm = runs = None
        try:
            while not self.halt.is_set() and not (self.stop.is_set() and not self.outstanding()):
                if cm is None and self.phases_on.is_set() and not self.phases_off.is_set() \
                        and self.phases_cm is not None:
                    cm = self.phases_cm()
                    runs = cm.__enter__()
                if self.phases_off.is_set() and not self.phases_closed.is_set():
                    self._close_phases(cm, runs)
                if not self.server.pump(0.02):
                    continue
                ev = None
                if self.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                with self.lock:
                    finished = [p for p in self.pending if p[2].done]
                    self.pending = [p for p in self.pending if not p[2].done]
                for p in finished:
                    self.done_q.put((p, ev))
        except BaseException as e:  # noqa: BLE001 - reported by the loop
            self.error = e
        finally:
            if not self.phases_closed.is_set():
                self._close_phases(cm, runs)
            self.done_q.put(None)

    def _close_phases(self, cm, runs) -> None:
        if cm is not None:
            cm.__exit__(None, None, None)
            self.phases = list(runs)
        self.phases_closed.set()

    def collector(self) -> None:
        from .system import valid_rows

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            while True:
                item = self.done_q.get()
                if item is None:
                    return
                (index, due, ticket), ev = item
                if ev is not None:
                    ev.synchronize()
                end = time.monotonic()
                ans = self.server.answer(ticket)
                rec = {"due": due, "end": end, "start": ticket.start_t,
                       "queued_s": self.server.queued_s(ticket), "error": None}
                if ans is None:
                    rec["error"] = type(ticket.error).__name__
                else:
                    rec["count"], rec["flagged"] = ans.count, ans.flagged
                    if index in self.sampled:
                        self.samples[index] = valid_rows(ans)
                del ans, ticket, item
                self.records[index] = rec
        except BaseException as e:  # noqa: BLE001 - reported by the loop
            self.error = e


def serve_schedule(traffic: dict, seconds: float) -> tuple:
    """(due offsets in seconds, probe sizes) of the window's queries: the
    cell's fixed set of sizes and gaps at its rate, in the order its
    ``schedule_seed`` draws (one trace for every seed: the seed draws the
    keys)."""
    n = max(1, int(traffic["rate_per_s"] * seconds))
    rng = np.random.default_rng(traffic["schedule_seed"])
    sizes = rng.permutation(datagen.log_uniform_sizes(n, traffic["probe_rows_min"],
                                                      traffic["probe_rows_max"]))
    gaps = rng.permutation(datagen.poisson_gaps(n, traffic["rate_per_s"]))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due, sizes


def sample_indices(seed: int, sizes: np.ndarray, k: int) -> set:
    """``k`` queries drawn from ``seed``, and the largest."""
    rng = random.Random(datagen.sub_seed(seed, 4))
    picked = set(rng.sample(range(len(sizes)), min(k, len(sizes))))
    picked.add(int(np.argmax(sizes)))
    return picked


def probe_query(kind, inputs: dict, device, seed: int, stream: tuple, rows: int,
                selectivity: float) -> dict:
    """The inputs of a query (``kind.probe``): a probe table of ``rows``
    rows drawn from its own ``stream`` of ``seed`` ((2, i) for the
    window's query i) against the resident build side of ``inputs``."""
    return kind.probe(inputs, datagen.generator(device, seed, *stream), rows, selectivity)


def open_loop(server, kind, inputs: dict, traffic: dict, device: torch.device, seed: int,
              seconds: float, trace: bool, phases_cm=None) -> dict:
    """Serve the window's schedule (``serve_schedule``) of queries drawn
    by ``kind`` against the build side of ``inputs``, and wait for every
    answer, at most ``wait_after_close_s`` past the window. With
    ``trace`` the window ends in two stretches of ``trace_stretch_s``:
    the program's phase clock (``phases_cm``, which synchronizes each
    query to read its events), then the profiler alone, until the last
    answer (its stop holds the interpreter; at the end of the window no
    submit can find the queue full then). ``trace_from`` is the offset
    at which the first began: queries due before it ran untraced."""
    due, sizes = serve_schedule(traffic, seconds)
    sampled = sample_indices(seed, sizes, traffic["sample_answers"])
    sel = traffic["selectivity"]
    d = _Dispatch(server, device, sampled, phases_cm if trace else None)
    matches: dict = {}
    rejected: dict = {}
    threads = [threading.Thread(target=d.dispatcher, daemon=True),
               threading.Thread(target=d.collector, daemon=True)]
    for t in threads:
        t.start()
    stretch = None
    t_profile = seconds - traffic["trace_stretch_s"]
    t_phases = t_profile - traffic["trace_stretch_s"]
    reset_peak(device)
    wall0 = time.time()
    t_window = time.perf_counter()
    t0 = time.monotonic()
    for i, (off, rows) in enumerate(zip(due, sizes)):
        if trace and not d.phases_on.is_set() and off >= t_phases:
            d.phases_on.set()
        if trace and stretch is None and off >= t_profile:
            d.phases_off.set()
            d.phases_closed.wait(timeout=5)
            stretch = profiling.Stretch(device).__enter__()
        wait = t0 + off - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        query = probe_query(kind, inputs, device, seed, (2, i), int(rows), sel)
        cols, matches[i] = kind.sides(query)[0], kind.expected_count(query)
        del query
        try:
            ticket = server.submit(server.port.table(cols))
        except Exception as e:  # noqa: BLE001 - a refused query is a failed one
            rejected[i] = type(e).__name__
            continue
        d.add(i, t0 + off, ticket)
        del ticket, cols
    t_close = t0 + seconds
    d.stop.set()
    limit = max(time.monotonic(), t_close) + traffic["wait_after_close_s"]
    while d.outstanding() and time.monotonic() < limit and d.error is None:
        time.sleep(0.002)
    window_end = max(time.monotonic(), t_close)
    peak = peak_bytes(device)
    if stretch is not None:
        stretch.__exit__(None, None, None)
    d.halt.set()
    for t in threads:
        t.join(timeout=60)
    if d.error is not None:
        raise d.error
    if stretch is not None:
        stretch.finish()
    return {"n": len(due), "due": due, "sizes": sizes, "t0": t0, "wall0": wall0,
            "t_window": t_window, "window_s": window_end - t0, "records": d.records,
            "rejected": rejected, "matches": matches, "samples": d.samples, "peak": peak,
            "phases": d.phases,
            "profile": stretch.summary if stretch is not None else None,
            "stretch": stretch, "trace_from": t_phases if trace else None}


def latency_stats(loop: dict, limit_s: float) -> dict:
    """p50 and p95 of every query's ms from due to answer; a query with
    no answer counts at ``limit_s`` (it missed any latency limit)."""
    lat = []
    for i in range(loop["n"]):
        rec = loop["records"].get(i)
        if rec is None or rec["error"] is not None:
            lat.append(limit_s)
        else:
            lat.append(rec["end"] - rec["due"])
    return {"query_p50_ms": 1e3 * statistics.median(lat),
            "query_p95_ms": 1e3 * percentile(lat, 0.95)}


def query_cover(loop: dict) -> Optional[tuple]:
    """(device-busy seconds, seconds) of the intervals in which a query
    ran, inside the traced stretch."""
    st = loop["stretch"]
    if st is None or not st.summary:
        return None
    prof = st.summary
    spans = []
    for rec in loop["records"].values():
        if rec["error"] is None and rec["start"] is not None:
            a = (rec["start"] - st.mono0) * 1e6 + st.mark_us0
            b = (rec["end"] - st.mono0) * 1e6 + st.mark_us0
            a, b = max(a, prof["mark_us"][0]), min(b, prof["mark_us"][1])
            if b > a:
                spans.append([a, b])
    if not spans:
        return None
    return profiling.covered_s(prof["busy_us"], spans)

"""Communicator abstraction: swappable collective backends over a transport.

Counterpart of ``dj_tpu/parallel/communicator.py``. A communicator
moves equal-size buckets between the ranks of one communication group.
Every tensor argument has the group size as its leading axis:
``all_to_all`` sends ``buckets[p]`` to peer p and returns what each peer
sent here.

Two layers. A *transport* is how this rank reaches its peers:

- ``SingleRankTransport``: the world of one rank; every collective is
  the identity (a copy);
- ``InProcessTransport``: ranks that run as threads of this process
  (``parallel.spmd``); each collective is a rendezvous of the group;
- ``DistTransport``: one rank per process over ``torch.distributed``
  (NCCL on the card, gloo on the CPU): ``all_to_all_single``,
  ``all_gather_into_tensor``, ``all_reduce`` and ``batch_isend_irecv``,
  over the default process group or a subgroup's.

On a two-level topology a rank has one communicator per axis ('inter'
and 'intra', each over its own group's transport); ``Communicator.sub``
reaches the other axis's, and both share the rank's ``PhaseClock``.

A *backend* is how an all-to-all is cut into transport calls, dj_tpu's
three: ``XlaCommunicator`` (one call, the default), ``BufferedCommunicator``
(the bucket axis in ``chunk_rows`` pieces) and ``RingCommunicator`` (n - 1
rotation rounds of ``shift``). Any backend runs over any transport.
``exchange_start`` issues an exchange and returns a handle whose
``wait()`` gives the received buffers, so a caller can issue batch b+1's
exchange before it joins batch b; over torch.distributed the transfer
then runs on the backend's stream meanwhile.

Observability. ``Communicator.phase`` marks a rank's phases: each one
is also a ``utils.timing.annotate`` range (an NVTX range on the card,
and a ``torch.profiler`` range while a profiler runs) from its mark to
the next mark, so a profiler trace shows dj_partition, dj_exchange,
dj_join, a2a_* and bc_* with the kernels launched inside them. A
``span`` (``utils.timing.span``) names a stage inside the
open phase (``dj_join/sort``, ...); both are timed on the rank's
``PhaseClock`` while ``spmd.record_phases`` records. ``exchange_start`` counts
each epoch it issues into ``dj_collective_launches_total`` and
``dj_collective_bytes_total{width}`` (``obs.recorder.count_collectives``)
on the communicators whose ``counts_collectives`` is set: one rank a
process, so a world of threads counts each epoch once.
"""


from __future__ import annotations

import abc
import contextlib
import functools
import threading
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..obs import metrics as _obs_metrics
from ..obs.recorder import count_collectives
from ..utils.timing import annotate
from .topology import INTER, INTRA, CommunicationGroup


class PhaseClock:
    """Device time of one rank's phases, for ranks that share one stream.

    ``mark(label)`` starts phase ``label``; ``pause()`` ends the rank's
    run of work (it is about to wait while other ranks issue theirs) and
    ``resume()`` starts the same phase again. A phase's time is the sum
    of the gaps from each of its marks to the next mark: CUDA events on
    the device's current stream, or the host clock on the CPU, where
    every op has finished when it returns.

    Spans (``utils.timing.span``) nest in the phases: ``open(key)``
    stamps a span's start and ``close`` its end, and a span's time is
    the sum of its start-to-end gaps, on the same stamps. A call's root
    clock (``spmd.call_span``) holds spans alone, its first the call's
    own, which ``uncovered_ms`` measures the rest against."""

    def __init__(self, device: torch.device):
        self.device = device
        self.label: Optional[str] = None
        self.scope: Optional[str] = None  # set: marks are named "<scope>/<label>"
        self._marks: list = []
        self._spans: list = []  # [key, start stamp, end stamp], in opening order
        self._open: set = set()  # keys of the spans open now

    def _stamp(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _gap(self, a, b) -> float:
        return a.elapsed_time(b) if self.device.type == "cuda" else (b - a) * 1e3

    def mark(self, label: str) -> None:
        if self.scope is not None:
            label = f"{self.scope}/{label}"
        self.label = label
        self._marks.append((label, self._stamp()))

    def pause(self) -> None:
        self._marks.append((None, self._stamp()))

    def resume(self) -> None:
        if self.label is not None:
            self._marks.append((self.label, self._stamp()))

    def open(self, key: str) -> Optional[list]:
        """Start span ``key``; None (nothing timed) while a span of that
        key is open already."""
        if key in self._open:
            return None
        self._open.add(key)
        rec = [key, self._stamp(), None]
        self._spans.append(rec)
        return rec

    def close(self, rec: list) -> None:
        rec[2] = self._stamp()
        self._open.discard(rec[0])

    def _intervals(self) -> list:
        """(key, start stamp, end stamp) of every phase run (mark to the
        next mark) and every closed span."""
        out = [(label, a, b) for (label, a), (_, b) in zip(self._marks, self._marks[1:])
               if label is not None]
        return out + [tuple(rec) for rec in self._spans if rec[2] is not None]

    def ms(self) -> dict:
        """{phase or span key: ms}; waits for the device to run the
        marked work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out: dict = {}
        for label, a, b in self._intervals():
            out[label] = out.get(label, 0.0) + self._gap(a, b)
        return out

    def uncovered_ms(self, others: Sequence["PhaseClock"]) -> float:
        """The ms of this clock's first span that no other span of it
        and no phase or span of ``others`` covers (an interval union on
        the shared stream's stamps); call after ``ms``."""
        (_, origin, end), *rest = self._spans
        total = self._gap(origin, end)
        inner = [tuple(rec) for rec in rest if rec[2] is not None]
        inner += [iv for c in others for iv in c._intervals()]
        ivs = sorted((max(0.0, self._gap(origin, a)), min(total, self._gap(origin, b)))
                     for _, a, b in inner)
        covered, reach = 0.0, 0.0
        for a, b in ivs:
            a = max(a, reach)
            if b > a:
                covered += b - a
                reach = b
        return max(0.0, total - covered)


class Pending:
    """An issued collective: ``wait()`` returns its result, once. Until
    then it holds the tensors the transfer reads and writes, so none is
    freed or reused while a backend's stream still moves it."""

    def __init__(self, finish: Callable[[], object], *keep: torch.Tensor):
        self._finish: Optional[Callable[[], object]] = finish
        self._keep = keep
        self._value = None

    def wait(self):
        if self._finish is not None:
            self._value = self._finish()
            self._finish, self._keep = None, ()
        return self._value


def done(value) -> Pending:
    """A handle whose collective has completed."""
    return Pending(lambda: value)


class Transport(abc.ABC):
    """How one rank reaches the other ranks of its world."""

    name: str
    clock: Optional[PhaseClock] = None  # set to time this rank's phases

    def __init__(self, size: int):
        self.size = size

    @abc.abstractmethod
    def rank(self) -> int:
        ...

    @abc.abstractmethod
    def all_to_all_start(self, buckets: torch.Tensor) -> Pending:
        """Issue ``out[p] = what peer p sent to this rank``."""

    @abc.abstractmethod
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """The elementwise ``op`` ("max" or "sum") over the ranks."""

    @abc.abstractmethod
    def shift_start(self, x: torch.Tensor, s: int) -> Pending:
        """Issue the send of ``x`` to rank (rank + s) % n; the handle
        gives what rank (rank - s) % n sent."""


class SingleRankTransport(Transport):
    """The world of one rank: every collective returns a copy of its
    input, so no caller sees its send buffer aliased by the receive side."""

    name = "single"

    def __init__(self):
        super().__init__(1)

    def rank(self) -> int:
        return 0

    def all_to_all_start(self, buckets: torch.Tensor) -> Pending:
        return done(buckets.clone())

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x.unsqueeze(0).clone()

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        return x.clone()

    def shift_start(self, x: torch.Tensor, s: int) -> Pending:
        return done(x.clone())


# The dtype whose elements carry each element width across a process
# boundary: gloo and NCCL reject 16-bit integers, unsigned 16/32/64-bit
# ones and (gloo) bool, so every tensor travels as the bits of one of
# these and is viewed back on receipt (a 2-byte element as two bytes).
_WIRE = {8: torch.int64, 4: torch.int32, 2: torch.uint8, 1: torch.uint8}
# all_reduce needs values, not bits: the types each is reduced in.
_REDUCE_AS = {torch.bool: torch.uint8, torch.int16: torch.int32, torch.uint16: torch.int32,
              torch.uint32: torch.int64}
_INT64_MIN = -(2**63)


def _wire(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x``'s bits as a contiguous [rows, k] tensor of a wire dtype."""
    return x.contiguous().reshape(rows, -1).view(_WIRE[x.element_size()])


def _unwire(w: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    return w.view(like.dtype).reshape(shape)


class DistTransport(Transport):
    """This process's rank of a process world, over ``torch.distributed``:
    the default process group, or ``group`` (a subgroup's ProcessGroup,
    ``topology.process_subgroups``), where the rank and the peers are
    the group's own. Under NCCL every call
    takes the card's tensors as they are, and so do gloo's collectives.
    gloo's point-to-point send on a CUDA tensor aborts the process (its
    TCP pair writes from the device pointer: ``gloo::IoException ...
    writev: Bad address``, torch 2.11), so a gloo transport on the card
    moves ``shift`` through host copies; ``host_staged`` names the calls
    it stages."""

    def __init__(self, device: torch.device, group=None):
        super().__init__(dist.get_world_size(group))
        self.device = device
        self.pg = group
        self._rank = dist.get_rank(group)
        self.name = str(dist.get_backend(group))
        cuda_gloo = self.name == "gloo" and device.type == "cuda"
        self.host_staged = ("shift",) if cuda_gloo else ()

    def rank(self) -> int:
        return self._rank

    def all_to_all_start(self, buckets: torch.Tensor) -> Pending:
        send = _wire(buckets, buckets.shape[0])
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=self.pg, async_op=True)

        def finish():
            work.wait()
            return _unwire(recv, buckets, buckets.shape)

        return Pending(finish, send, recv)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        send = _wire(x, 1).reshape(-1)
        recv = send.new_empty((self.size * send.numel(),))
        dist.all_gather_into_tensor(recv, send, group=self.pg)
        return _unwire(recv, x, (self.size,) + tuple(x.shape))

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        rop = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
        if x.dtype == torch.uint64:
            # Order-preserving as int64 with the top bit flipped; a sum
            # wraps the same in either view.
            v = x.view(torch.int64)
            y = v ^ _INT64_MIN if op == "max" else v.clone()
            dist.all_reduce(y, rop, group=self.pg)
            return (y ^ _INT64_MIN if op == "max" else y).view(torch.uint64)
        y = x.to(_REDUCE_AS.get(x.dtype, x.dtype), copy=True)
        dist.all_reduce(y, rop, group=self.pg)
        return y.to(x.dtype)

    def _global(self, peer: int) -> int:
        """A peer's rank in the default group, which P2POp takes."""
        return peer if self.pg is None else dist.get_global_rank(self.pg, peer)

    def shift_start(self, x: torch.Tensor, s: int) -> Pending:
        if s % self.size == 0 and self.name == "gloo":
            return done(x.clone())  # gloo connects no rank to itself; NCCL does
        staged = "shift" in self.host_staged
        send = _wire(x, 1).cpu() if staged else _wire(x, 1)
        recv = torch.empty_like(send)
        r, n = self._rank, self.size
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self._global((r + s) % n), self.pg),
            dist.P2POp(dist.irecv, recv, self._global((r - s) % n), self.pg),
        ])

        def finish():
            for w in works:
                w.wait()
            return _unwire(recv.to(self.device) if staged else recv, x, x.shape)

        return Pending(finish, send, recv)


class PhaseRanges:
    """The open ``annotate`` range of one rank's phase marks, shared by
    the rank's communicators on every axis (like its PhaseClock): a mark
    ends the open range and opens the next; ``scope`` names the marks
    inside a ``phase_scope``. It is also what a ``span`` opened in the
    rank nests in: ``label`` names the open phase and ``clock`` is the
    rank's PhaseClock (None while nothing records)."""

    def __init__(self, device=None, clock: Optional[PhaseClock] = None):
        self.device = device
        self.clock = clock
        self.scope: Optional[str] = None
        self.label: Optional[str] = None
        self._open = None

    def mark(self, label: str) -> None:
        self.end()
        if self.scope is not None:
            label = f"{self.scope}/{label}"
        cm = annotate(label, self.device)
        cm.__enter__()
        self._open = cm
        self.label = label

    def end(self) -> None:
        if self._open is not None:
            cm, self._open = self._open, None
            cm.__exit__(None, None, None)
        self.label = None


class Communicator(abc.ABC):
    """Collective backend over one communication group, on a transport."""

    def __init__(self, group: CommunicationGroup, transport: Transport,
                 fuse_columns: bool = True):
        if transport.size != group.size:
            raise ValueError(f"a transport of {transport.size} ranks for a group of {group.size}")
        self.group = group
        self.transport = transport
        self.fuse_columns = fuse_columns
        # {axis name: this rank's communicator on that axis}, set by
        # run_spmd on a two-level topology; empty on a flat one.
        self.axes: dict = {}
        # This rank's phase ranges (run_spmd shares one among its axes)
        # and whether its exchanges feed the collective counters.
        self.ranges = PhaseRanges()
        self.counts_collectives = True

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def clock(self) -> Optional[PhaseClock]:
        return self.transport.clock

    @clock.setter
    def clock(self, clock: Optional[PhaseClock]) -> None:
        self.transport.clock = clock

    def phase(self, label: str) -> None:
        """Start phase ``label`` of this rank's work: an ``annotate``
        range until the next mark (module docstring), timed when a
        ``clock`` is set."""
        if self.clock is not None:
            self.clock.mark(label)
        self.ranges.mark(label)

    def end_phases(self) -> None:
        """End the rank's last phase range."""
        self.ranges.end()

    @contextlib.contextmanager
    def phase_scope(self, label: str):
        """Phase ``label`` for the body: the phases marked inside it, on
        any axis's communicator of this rank, are named
        ``"<label>/<phase>"``."""
        self.phase(label)
        clock = self.clock
        if clock is not None:
            clock.scope = label
        self.ranges.scope = label
        try:
            yield
        finally:
            if clock is not None:
                clock.scope = None
            self.ranges.scope = None

    def count_epoch(self, launches: int, buffers: Sequence[torch.Tensor]) -> None:
        """Count one exchange epoch of ``launches`` collectives moving
        ``buffers`` (their per-shard send bytes by element width), when
        this communicator counts and obs is enabled."""
        if not (self.counts_collectives and _obs_metrics.enabled()):
            return
        by_width: dict = {}
        for b in buffers:
            k = str(b.element_size())
            by_width[k] = by_width.get(k, 0) + b.numel() * b.element_size()
        count_collectives([{"n": self.size, "launches": launches, "bytes_by_width": by_width}])

    def rank(self) -> int:
        """This rank's index in the group."""
        return self.transport.rank()

    def sub(self, axis_name: str) -> "Communicator":
        """This rank's communicator on ``axis_name``: its own axis, or on
        a two-level topology the other one."""
        if axis_name == self.group.axis_name:
            return self
        if axis_name not in self.axes:
            raise ValueError(f"no {axis_name!r} group on this rank's topology")
        return self.axes[axis_name]

    def world_rank(self) -> int:
        """This rank's index in the world: inter index * intra size +
        intra index on a two-level topology, the group rank on a flat
        one."""
        if INTER in self.axes:
            intra = self.axes[INTRA]
            return self.axes[INTER].rank() * intra.size + intra.rank()
        return self.rank()

    def _check(self, buckets: torch.Tensor) -> None:
        if buckets.dim() == 0 or buckets.shape[0] != self.size:
            raise ValueError(f"leading axis of {tuple(buckets.shape)} != group size {self.size}")

    @abc.abstractmethod
    def all_to_all_start(self, buckets: torch.Tensor) -> Pending:
        """Issue the exchange of equal-size buckets: in[p] -> peer p;
        ``wait()`` gives out[p] <- peer p."""

    def all_to_all(self, buckets: torch.Tensor) -> torch.Tensor:
        """Exchange equal-size buckets: in[p] -> peer p; out[p] <- peer p."""
        return self.all_to_all_start(buckets).wait()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Gather x from every peer along a new leading axis."""
        return self.transport.all_gather(x)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return self.transport.all_reduce(x, "max")

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.transport.all_reduce(x, "sum")

    def communicate_sizes(self, send_counts: torch.Tensor) -> torch.Tensor:
        """Exchange per-peer element counts ([size] or [size, k] int32);
        returns the receive counts."""
        return self.all_to_all(send_counts.to(torch.int32))

    def exchange(self, buffers: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Exchange several [size, ...] bucket buffers in one epoch.
        Fuse-capable backends move each dtype class with one collective;
        the others issue one per buffer. Either way the result matches
        ``buffers`` in order, shape and dtype."""
        return self.exchange_start(buffers).wait()

    def exchange_start(self, buffers: Sequence[torch.Tensor]) -> Pending:
        """Issue ``exchange(buffers)``; ``wait()`` on the handle returns
        its result. Every rank issues its exchanges in the same order."""
        bufs = list(buffers)
        n = self.size
        for b in bufs:
            if b.shape[0] != n:
                raise ValueError(f"exchange buffer leading axis {b.shape[0]} != group size {n}")
        if not self.fuse_columns or len(bufs) <= 1:
            self.count_epoch(len(bufs), bufs)
            pend = [self.all_to_all_start(b) for b in bufs]
            return Pending(lambda: [p.wait() for p in pend])
        groups: dict = {}
        for j, b in enumerate(bufs):
            groups.setdefault(b.dtype, []).append(j)
        # One collective a dtype (dj_tpu fuses a width class: two dtypes
        # of one width are two launches here, one there).
        self.count_epoch(len(groups), bufs)
        issued = []
        for idxs in groups.values():
            if len(idxs) == 1:
                issued.append((idxs, None, self.all_to_all_start(bufs[idxs[0]])))
                continue
            flats = [bufs[j].reshape(n, -1) for j in idxs]
            widths = [f.shape[1] for f in flats]
            issued.append((idxs, widths, self.all_to_all_start(torch.cat(flats, dim=1))))
        shapes = [b.shape for b in bufs]
        del bufs

        def finish():
            out: list[Optional[torch.Tensor]] = [None] * len(shapes)
            for idxs, widths, p in issued:
                recv = p.wait()
                if widths is None:
                    out[idxs[0]] = recv
                    continue
                off = 0
                for j, w in zip(idxs, widths):
                    out[j] = recv[:, off : off + w].reshape(shapes[j])
                    off += w
            return out

        return Pending(finish)


def make_communicator(cls, group: CommunicationGroup, transport: Transport, fuse_columns=None):
    """Construct a backend on ``transport``, honoring its own fuse
    default when ``fuse_columns`` is None (dj_tpu's make_communicator:
    the default backend fuses, Ring and Buffered move one buffer per
    collective, like the reference's NCCL and buffered backends); a bool
    overrides."""
    if fuse_columns is None:
        return cls(group, transport)
    return cls(group, transport, fuse_columns=fuse_columns)


class XlaCommunicator(Communicator):
    """The default backend: each all-to-all is one transport call (dj_tpu's
    XlaCommunicator; the name is kept so a config names the same class in
    both packages)."""

    def all_to_all_start(self, buckets: torch.Tensor) -> Pending:
        self._check(buckets)
        return self.transport.all_to_all_start(buckets)


class BufferedCommunicator(XlaCommunicator):
    """All-to-all chunked through fixed-size sub-collectives (dj_tpu's
    BufferedCommunicator, the reference's UCXBufferCommunicator): the
    [n, B, ...] buckets split along B into ceil(B / chunk_rows) transport
    calls, so no one transfer exceeds ``chunk_rows`` rows a peer. One
    collective per buffer by default (fuse_columns=False)."""

    def __init__(self, group: CommunicationGroup, transport: Transport,
                 fuse_columns: bool = False, chunk_rows: int = 1 << 16):
        super().__init__(group, transport, fuse_columns=fuse_columns)
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows {chunk_rows} < 1")
        self.chunk_rows = chunk_rows

    def all_to_all_start(self, buckets: torch.Tensor) -> Pending:
        self._check(buckets)
        b = buckets.shape[1] if buckets.dim() > 1 else 0
        if buckets.dim() < 2 or b <= self.chunk_rows:
            return self.transport.all_to_all_start(buckets)
        pend = [self.transport.all_to_all_start(buckets[:, lo : lo + self.chunk_rows])
                for lo in range(0, b, self.chunk_rows)]
        return Pending(lambda: torch.cat([p.wait() for p in pend], dim=1))


class RingCommunicator(XlaCommunicator):
    """All-to-all as n - 1 rotation rounds (dj_tpu's RingCommunicator,
    the reference's point-to-point backends): in round s rank r sends its
    bucket for peer (r + s) % n there and receives from (r - s) % n, one
    ``shift`` of the transport (one ``batch_isend_irecv`` under
    torch.distributed, so a round's send and receive cannot deadlock).
    The self bucket never leaves the rank. One collective per buffer by
    default (fuse_columns=False)."""

    def __init__(self, group: CommunicationGroup, transport: Transport,
                 fuse_columns: bool = False):
        super().__init__(group, transport, fuse_columns=fuse_columns)

    def all_to_all_start(self, buckets: torch.Tensor) -> Pending:
        self._check(buckets)
        n, r = self.size, self.rank()
        rounds = [(s, self.transport.shift_start(buckets[(r + s) % n], s)) for s in range(1, n)]
        out = torch.empty_like(buckets)
        out[r] = buckets[r]

        def finish():
            for s, p in rounds:
                out[(r - s) % n] = p.wait()
            return out

        return Pending(finish)


class SingleRankCommunicator(XlaCommunicator):
    """The default backend over the one-rank transport."""

    def __init__(self, group: CommunicationGroup, fuse_columns: bool = True):
        if group.size != 1:
            raise ValueError(f"SingleRankCommunicator needs a group of 1, got {group.size}")
        super().__init__(group, SingleRankTransport(), fuse_columns)


class WorldAborted(RuntimeError):
    """A rank of the world failed; this rank's collective cannot complete."""


class InProcessWorld:
    """What the ranks of one world, each a thread of this process, share.

    ``cond`` holds the world lock: a rank holds it while it runs and
    releases it only while it waits at a rendezvous, so one rank's work
    is issued at a time. Each communication group of the world (the
    whole world, or on a two-level topology each 'inter' and 'intra'
    group, ``group(members)``) has its own rendezvous state under that
    one lock. A rank that fails calls ``abort``, which wakes every
    waiting rank of every group with ``WorldAborted``; a wait that
    outlasts ``timeout`` seconds, or that a returned member of its group
    can no longer complete, aborts the world too, so no rank waits
    forever."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.timeout = timeout
        self.cond = threading.Condition(threading.Lock())
        self.error: Optional[BaseException] = None
        self.returned: list[int] = []

    def group(self, members: Sequence[int]) -> "InProcessGroup":
        """A group of the world ranks ``members``; a member's rank in it is
        its index there."""
        return InProcessGroup(self, members)

    def abort(self, error: BaseException) -> None:
        """Fail every rendezvous from now on (caller holds ``cond``)."""
        if self.error is None:
            self.error = error
        self.cond.notify_all()

    def rank_returned(self, rank: int) -> None:
        """World rank ``rank``'s body returned (caller holds ``cond``)."""
        self.returned.append(rank)
        self.cond.notify_all()



class InProcessGroup:
    """The rendezvous state of one communication group of an
    ``InProcessWorld``: at a rendezvous every member deposits a value
    and waits until all ``size`` members have; each then reads the
    deposits of that rendezvous."""

    def __init__(self, world: InProcessWorld, members: Sequence[int]):
        self.world = world
        self.members = tuple(members)
        self.size = len(self.members)
        self._slots: list = [None] * self.size
        self._arrived = 0
        self._gen = 0
        self._done: Optional[list] = None  # the deposits of the last rendezvous
        self._reads = 0

    def _members_returned(self) -> list[int]:
        return [m for m in self.world.returned if m in self.members]

    def rendezvous(self, rank: int, value) -> list:
        """Deposit ``value`` as member ``rank`` and wait for every
        member's; returns the list of deposits by member. The caller
        holds the world's ``cond``, reads what it needs, then calls
        ``read_done``."""
        world = self.world
        me = self.members[rank]
        if world.error is not None:
            raise WorldAborted(f"rank {me}: the world was aborted") from world.error
        gen = self._gen
        self._slots[rank] = value
        self._arrived += 1
        if self._arrived == self.size:
            self._done, self._slots = self._slots, [None] * self.size
            self._arrived = self._reads = 0
            self._gen += 1
            world.cond.notify_all()
        else:
            world.cond.wait_for(
                lambda: (self._gen != gen or world.error is not None
                         or bool(self._members_returned())),
                world.timeout,
            )
            if self._gen == gen:
                if world.error is None:
                    gone = self._members_returned()
                    why = (f"rank(s) {gone} returned" if gone
                           else f"no completion within {world.timeout} s")
                    err = RuntimeError(
                        f"rank {me}: rendezvous {gen} of group {list(self.members)} cannot "
                        f"complete: {self._arrived} of {self.size} ranks arrived and {why}"
                    )
                    world.abort(err)
                    raise err
                raise WorldAborted(f"rank {me}: the world was aborted") from world.error
        return self._done  # type: ignore[return-value]

    def read_done(self) -> None:
        """A member has read the last rendezvous; the last reader drops
        the deposits, so no send buffer outlives its exchange."""
        self._reads += 1
        if self._reads == self.size:
            self._done = None


class InProcessTransport(Transport):
    """One rank of a group whose ranks are threads of this process, all
    on one device (``parallel.spmd.run_spmd``). Each collective is a
    rendezvous of its ``InProcessGroup``: rank r deposits its tensor,
    waits for every peer's, and reads its own part of each (``all_to_all`` gives
    ``out[p] = sent_by_peer_p[r]``), so every call completes when it
    returns. The result is a new tensor, never a view of a peer's
    buffer."""

    name = "in-process"

    def __init__(self, group: InProcessGroup, rank: int):
        if not 0 <= rank < group.size:
            raise ValueError(f"rank {rank} of a group of {group.size}")
        super().__init__(group.size)
        self.group = group
        self._rank = rank

    def rank(self) -> int:
        return self._rank

    def _collective(self, x: torch.Tensor, read):
        if self.clock is not None:
            self.clock.pause()
        deposits = self.group.rendezvous(self._rank, x)
        if self.clock is not None:
            self.clock.resume()
        out = read(deposits)
        self.group.read_done()
        return out

    def all_to_all_start(self, buckets: torch.Tensor) -> Pending:
        r = self._rank
        return done(self._collective(buckets, lambda d: torch.stack([sent[r] for sent in d])))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self._collective(x, torch.stack)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        if op == "max":
            return self._collective(x, lambda d: torch.stack(d).amax(0))
        return self._collective(x, lambda d: functools.reduce(torch.add, d))

    def shift_start(self, x: torch.Tensor, s: int) -> Pending:
        src = (self._rank - s) % self.size
        return done(self._collective(x, lambda d: d[src].clone()))

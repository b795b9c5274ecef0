"""Communicator abstraction: swappable collective backends.

Counterpart of ``dj_tpu/parallel/communicator.py:34-168``. A
communicator moves equal-size buckets between the ranks of one
communication group. Every tensor argument has the group size as its
leading axis: ``all_to_all`` sends ``buckets[p]`` to peer p and returns
what each peer sent here. Two backends run here: the one-rank group,
where every collective is the identity, and a group of ranks that run
as threads of this process (``InProcessCommunicator``, the counterpart
of dj_tpu's ``XlaCommunicator`` over a mesh of one process). A
``torch.distributed`` backend implements the same methods with
``all_to_all_single``, ``all_gather_into_tensor`` and ``all_reduce``.
"""

from __future__ import annotations

import abc
import functools
import threading
import time
from typing import Optional, Sequence

import torch

from .topology import CommunicationGroup


class PhaseClock:
    """Device time of one rank's phases, for ranks that share one stream.

    ``mark(label)`` starts phase ``label``; ``pause()`` ends the rank's
    run of work (it is about to wait while other ranks issue theirs) and
    ``resume()`` starts the same phase again. A phase's time is the sum
    of the gaps from each of its marks to the next mark: CUDA events on
    the device's current stream, or the host clock on the CPU, where
    every op has finished when it returns."""

    def __init__(self, device: torch.device):
        self.device = device
        self.label: Optional[str] = None
        self._marks: list = []

    def _stamp(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def mark(self, label: str) -> None:
        self.label = label
        self._marks.append((label, self._stamp()))

    def pause(self) -> None:
        self._marks.append((None, self._stamp()))

    def resume(self) -> None:
        if self.label is not None:
            self._marks.append((self.label, self._stamp()))

    def ms(self) -> dict:
        """{phase: ms}; waits for the device to run the marked work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out: dict = {}
        for (label, a), (_, b) in zip(self._marks, self._marks[1:]):
            if label is None:
                continue
            gap = a.elapsed_time(b) if self.device.type == "cuda" else (b - a) * 1e3
            out[label] = out.get(label, 0.0) + gap
        return out


class Communicator(abc.ABC):
    """Collective transport over one communication group."""

    clock: Optional[PhaseClock] = None  # set to time this rank's phases

    def __init__(self, group: CommunicationGroup, fuse_columns: bool = True):
        self.group = group
        self.fuse_columns = fuse_columns

    @property
    def size(self) -> int:
        return self.group.size

    def phase(self, label: str) -> None:
        """Start phase ``label`` of this rank's work (timed only when a
        ``clock`` is set)."""
        if self.clock is not None:
            self.clock.mark(label)

    @abc.abstractmethod
    def rank(self) -> int:
        """This rank's index in the group."""

    @abc.abstractmethod
    def all_to_all(self, buckets: torch.Tensor) -> torch.Tensor:
        """Exchange equal-size buckets: in[p] -> peer p; out[p] <- peer p."""

    @abc.abstractmethod
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Gather x from every peer along a new leading axis."""

    @abc.abstractmethod
    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        ...

    def communicate_sizes(self, send_counts: torch.Tensor) -> torch.Tensor:
        """Exchange per-peer element counts ([size] or [size, k] int32);
        returns the receive counts."""
        return self.all_to_all(send_counts.to(torch.int32))

    def exchange(self, buffers: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Exchange several [size, ...] bucket buffers in one epoch.
        Fuse-capable backends move each dtype class with one collective;
        the others issue one per buffer. Either way the result matches
        ``buffers`` in order, shape and dtype."""
        bufs = list(buffers)
        n = self.size
        for b in bufs:
            if b.shape[0] != n:
                raise ValueError(f"exchange buffer leading axis {b.shape[0]} != group size {n}")
        if not self.fuse_columns or len(bufs) <= 1:
            return [self.all_to_all(b) for b in bufs]
        out: list[Optional[torch.Tensor]] = [None] * len(bufs)
        groups: dict = {}
        for j, b in enumerate(bufs):
            groups.setdefault(b.dtype, []).append(j)
        for idxs in groups.values():
            if len(idxs) == 1:
                out[idxs[0]] = self.all_to_all(bufs[idxs[0]])
                continue
            flats = [bufs[j].reshape(n, -1) for j in idxs]
            recv = self.all_to_all(torch.cat(flats, dim=1))
            off = 0
            for j, f in zip(idxs, flats):
                out[j] = recv[:, off : off + f.shape[1]].reshape(bufs[j].shape)
                off += f.shape[1]
        return out  # type: ignore[return-value]


class SingleRankCommunicator(Communicator):
    """The one-rank group: every collective returns its input (a copy,
    so no caller sees its send buffer aliased by the receive side)."""

    def __init__(self, group: CommunicationGroup, fuse_columns: bool = True):
        if group.size != 1:
            raise ValueError(f"SingleRankCommunicator needs a group of 1, got {group.size}")
        super().__init__(group, fuse_columns)

    def rank(self) -> int:
        return 0

    def all_to_all(self, buckets: torch.Tensor) -> torch.Tensor:
        return buckets.clone()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x.unsqueeze(0).clone()

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return x.clone()

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.clone()


class WorldAborted(RuntimeError):
    """A rank of the world failed; this rank's collective cannot complete."""


class InProcessWorld:
    """What the ranks of one world, each a thread of this process, share.

    ``cond`` holds the world lock: a rank holds it while it runs and
    releases it only while it waits at a rendezvous, so one rank's work
    is issued at a time. At a rendezvous every rank deposits a value and
    waits until all ``size`` ranks have; each then reads the deposits of
    that rendezvous. A rank that fails calls ``abort``, which wakes every
    waiting rank with ``WorldAborted``; a wait that outlasts ``timeout``
    seconds, or that a returned rank can no longer complete, aborts the
    world too, so no rank waits forever."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.timeout = timeout
        self.cond = threading.Condition(threading.Lock())
        self._slots: list = [None] * size
        self._arrived = 0
        self._gen = 0
        self._done: Optional[list] = None  # the deposits of the last rendezvous
        self._reads = 0
        self._error: Optional[BaseException] = None
        self._returned: list[int] = []

    def abort(self, error: BaseException) -> None:
        """Fail every rendezvous from now on (caller holds ``cond``)."""
        if self._error is None:
            self._error = error
        self.cond.notify_all()

    def rank_returned(self, rank: int) -> None:
        """Rank ``rank``'s body returned (caller holds ``cond``)."""
        self._returned.append(rank)
        self.cond.notify_all()

    def rendezvous(self, rank: int, value) -> list:
        """Deposit ``value`` and wait for every rank's; returns the list
        of deposits by rank. The caller holds ``cond``, reads what it
        needs, then calls ``read_done``."""
        if self._error is not None:
            raise WorldAborted(f"rank {rank}: the world was aborted") from self._error
        gen = self._gen
        self._slots[rank] = value
        self._arrived += 1
        if self._arrived == self.size:
            self._done, self._slots = self._slots, [None] * self.size
            self._arrived = self._reads = 0
            self._gen += 1
            self.cond.notify_all()
        else:
            self.cond.wait_for(
                lambda: self._gen != gen or self._error is not None or bool(self._returned),
                self.timeout,
            )
            if self._gen == gen:
                if self._error is None:
                    why = (f"rank(s) {self._returned} returned" if self._returned
                           else f"no completion within {self.timeout} s")
                    err = RuntimeError(
                        f"rank {rank}: rendezvous {gen} cannot complete: {self._arrived} of "
                        f"{self.size} ranks arrived and {why}"
                    )
                    self.abort(err)
                    raise err
                raise WorldAborted(f"rank {rank}: the world was aborted") from self._error
        return self._done  # type: ignore[return-value]

    def read_done(self) -> None:
        """A rank has read the last rendezvous; the last reader drops the
        deposits, so no send buffer outlives its exchange."""
        self._reads += 1
        if self._reads == self.size:
            self._done = None


class InProcessCommunicator(Communicator):
    """One rank of a world whose ranks are threads of this process, all
    on one device (``parallel.spmd.run_spmd``). Each collective is a
    rendezvous of the world: rank r deposits its tensor, waits for every
    peer's, and reads its own part of each; ``all_to_all`` gives
    ``out[p] = sent_by_peer_p[r]``. The result is a new tensor, never a
    view of a peer's buffer."""

    def __init__(
        self, group: CommunicationGroup, world: InProcessWorld, rank: int,
        fuse_columns: bool = True,
    ):
        if world.size != group.size or not 0 <= rank < group.size:
            raise ValueError(f"rank {rank} of a group of {group.size} in a world of {world.size}")
        super().__init__(group, fuse_columns)
        self.world = world
        self._rank = rank

    def rank(self) -> int:
        return self._rank

    def _collective(self, x: torch.Tensor, read):
        if self.clock is not None:
            self.clock.pause()
        deposits = self.world.rendezvous(self._rank, x)
        if self.clock is not None:
            self.clock.resume()
        out = read(deposits)
        self.world.read_done()
        return out

    def all_to_all(self, buckets: torch.Tensor) -> torch.Tensor:
        if buckets.shape[0] != self.size:
            raise ValueError(f"leading axis {buckets.shape[0]} != group size {self.size}")
        r = self._rank
        return self._collective(buckets, lambda d: torch.stack([sent[r] for sent in d]))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self._collective(x, torch.stack)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return self._collective(x, lambda d: torch.stack(d).amax(0))

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._collective(x, lambda d: functools.reduce(torch.add, d))

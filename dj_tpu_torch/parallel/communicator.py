"""Communicator abstraction: swappable collective backends.

Counterpart of ``dj_tpu/parallel/communicator.py:34-126``. A
communicator moves equal-size buckets between the ranks of one
communication group. Every tensor argument has the group size as its
leading axis: ``all_to_all`` sends ``buckets[p]`` to peer p and returns
what each peer sent here. This slice implements the one-rank group,
where every collective is the identity; a ``torch.distributed`` NCCL
backend implements the same methods with ``all_to_all_single``,
``all_gather_into_tensor`` and ``all_reduce``.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence

import torch

from .topology import CommunicationGroup


class Communicator(abc.ABC):
    """Collective transport over one communication group."""

    def __init__(self, group: CommunicationGroup, fuse_columns: bool = True):
        self.group = group
        self.fuse_columns = fuse_columns

    @property
    def size(self) -> int:
        return self.group.size

    @abc.abstractmethod
    def rank(self) -> int:
        """This process's index in the group."""

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


def make_communicator(
    cls, group: CommunicationGroup, fuse_columns: Optional[bool]
) -> Communicator:
    """Construct a backend, keeping its own fuse default when the caller
    passes fuse_columns=None."""
    return cls(group) if fuse_columns is None else cls(group, fuse_columns)

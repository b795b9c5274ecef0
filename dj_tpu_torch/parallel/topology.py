"""Device topology: the ranks of a join and their communication groups.

Counterpart of ``dj_tpu/parallel/topology.py`` for a flat world. The JAX
package names a mesh axis; here a topology is the ordered list of
devices, one per rank, and a communication group is the rank axis and
its size. This slice runs a world of one rank (the current CUDA
device); multi-rank worlds and the two-level (inter, intra)
factorization come with the NCCL communicator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class CommunicationGroup:
    """A shuffle scope: one rank axis and its size."""

    axis_name: str
    size: int


@dataclasses.dataclass(frozen=True)
class Topology:
    """Ranks of a flat world, one device each."""

    devices: tuple[torch.device, ...]
    axis_name: str = "ranks"

    @property
    def world_size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's device (rank 0 of a one-rank world)."""
        return self.devices[0]

    def world_group(self) -> CommunicationGroup:
        return CommunicationGroup(self.axis_name, self.world_size)


def make_topology(
    devices: Optional[Sequence] = None,
    intra_size: Optional[int] = None,
    axis_name: str = "ranks",
) -> Topology:
    """A flat topology over ``devices`` (default: the current CUDA
    device). Pass ``devices=["cpu"]`` to run on the CPU."""
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = tuple(torch.device(d) for d in devices)
    if intra_size is not None and intra_size < len(devices):
        raise NotImplementedError(
            "two-level (inter, intra) topologies come with a later slice"
        )
    if len(devices) != 1:
        raise NotImplementedError(
            "multi-rank worlds come with the NCCL communicator slice; "
            "this slice runs one rank"
        )
    return Topology(devices, axis_name)

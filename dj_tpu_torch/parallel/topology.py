"""Device topology: the ranks of a join and their communication groups.

Counterpart of ``dj_tpu/parallel/topology.py`` for a flat world. The JAX
package names a mesh axis; here a topology is the ordered list of
devices, one per rank, and a communication group is the rank axis and
its size. The ranks of a world run in one process (``parallel.spmd``),
so they share one device: a repeated device (``["cuda:0"] * 4``, or
``["cpu"] * 8`` in the tests) makes a world of that many ranks. Ranks
on several devices (one process per GPU, ROADMAP queue 1 item 3) and
the two-level (inter, intra) factorization (item 8) raise.
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
    """Ranks of a flat world, one entry of ``devices`` each."""

    devices: tuple[torch.device, ...]
    axis_name: str = "ranks"

    @property
    def world_size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device every rank of the world runs on."""
        return self.devices[0]

    def world_group(self) -> CommunicationGroup:
        return CommunicationGroup(self.axis_name, self.world_size)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_topology(
    devices: Optional[Sequence] = None,
    intra_size: Optional[int] = None,
    axis_name: str = "ranks",
) -> Topology:
    """A flat topology with one rank per entry of ``devices`` (default:
    one rank on the current CUDA device). Pass ``devices=["cpu"]`` to run
    on the CPU, and repeat a device for a world of several ranks in this
    process: ``make_topology(["cuda:0"] * 4)``."""
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("make_topology: a world needs at least one rank")
    if intra_size is not None and intra_size < len(devices):
        raise NotImplementedError(
            "two-level (inter, intra) topologies come with ROADMAP queue 1 "
            "item 8 (shuffle_on, the codec and the two-level topology)"
        )
    if len(set(devices)) != 1:
        raise NotImplementedError(
            f"ranks on several devices {sorted(set(map(str, devices)))} need "
            f"one process per device, which comes with ROADMAP queue 1 item 3 "
            f"(torch.distributed ranks); a world in one process runs every "
            f"rank on one device"
        )
    return Topology(devices, axis_name)

"""Device topology: the ranks of a join and their communication groups.

Counterpart of ``dj_tpu/parallel/topology.py`` for a flat world. The JAX
package names a mesh axis; here a topology is the ranks' devices and a
communication group is the rank axis and its size. A world takes one of
two forms:

- a world in this process: every rank runs here, on one device, as a
  thread of its own (``parallel.spmd``). A repeated device
  (``["cuda:0"] * 4``, or ``["cpu"] * 8`` in the tests) makes a world of
  that many ranks; one device makes the world of one rank.
- a process world: one rank per process, under ``torch.distributed``
  (``parallel.bootstrap.init_distributed``). When a process group is
  live, ``make_topology()`` gives it: ``process_count()`` ranks, this
  process's ``rank`` and its device (``cuda:LOCAL_RANK``, or the CPU for
  ``devices=["cpu"]``). A sharded table then holds this rank's block
  only.

Ranks on several devices in one process, and the two-level (inter,
intra) factorization (ROADMAP queue 1 item 8), raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from . import bootstrap


@dataclasses.dataclass(frozen=True)
class CommunicationGroup:
    """A shuffle scope: one rank axis and its size."""

    axis_name: str
    size: int


@dataclasses.dataclass(frozen=True)
class Topology:
    """Ranks of a flat world. ``devices`` holds one entry per rank that
    runs in this process: every rank of a world in one process, or this
    process's rank alone in a process world, where ``rank`` is its index
    and ``process_count`` the world's size."""

    devices: tuple[torch.device, ...]
    axis_name: str = "ranks"
    rank: Optional[int] = None
    process_count: int = 1

    @property
    def is_process_world(self) -> bool:
        return self.rank is not None

    @property
    def world_size(self) -> int:
        return self.process_count if self.is_process_world else len(self.devices)

    @property
    def local_ranks(self) -> int:
        """Rank blocks a sharded tensor of this process holds: the whole
        world in one process, one in a process world."""
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device every rank of this process runs on."""
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
    """A flat topology. With a live process group, the process world:
    one rank per process on ``cuda:LOCAL_RANK`` (``devices=["cpu"]`` for
    CPU ranks). Otherwise one rank per entry of ``devices`` (default:
    one rank on the current CUDA device) in this process: pass
    ``devices=["cpu"]`` to run on the CPU, and repeat a device for a
    world of several ranks, ``make_topology(["cuda:0"] * 4)``."""
    if bootstrap.is_distributed_initialized():
        return _process_world(devices, intra_size, axis_name)
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("make_topology: a world needs at least one rank")
    _flat_only(intra_size, len(devices))
    if len(set(devices)) != 1:
        raise NotImplementedError(
            f"ranks on several devices {sorted(set(map(str, devices)))} run one "
            f"process per device: start a process world (init_distributed, then "
            f"make_topology()); a world in one process runs every rank on one device"
        )
    return Topology(devices, axis_name)


def _flat_only(intra_size: Optional[int], world: int) -> None:
    if intra_size is not None and intra_size < world:
        raise NotImplementedError(
            "two-level (inter, intra) topologies come with ROADMAP queue 1 "
            "item 8 (shuffle_on, the codec and the two-level topology)"
        )


def _process_world(devices, intra_size, axis_name) -> Topology:
    w = bootstrap.process_count()
    _flat_only(intra_size, w)
    if devices is None:
        dev = torch.device("cuda", bootstrap.local_device_index())
    else:
        devices = tuple(_device(d) for d in devices)
        if len(devices) != 1:
            raise ValueError(
                f"make_topology: a process world runs one rank per process; got "
                f"{len(devices)} devices"
            )
        dev = devices[0]
    return Topology((dev,), axis_name, rank=bootstrap.process_index(), process_count=w)

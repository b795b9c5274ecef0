"""Device topology: the ranks of a join and their communication groups.

Counterpart of ``dj_tpu/parallel/topology.py``. The JAX package names a
mesh axis; here a topology is the ranks' devices and a communication
group is a rank axis and its size. A world takes one of two forms:

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

Either form may be flat (one axis, ``('ranks',)``) or two-level
(``('inter', 'intra')``, ``make_topology(..., intra_size=i)``, the
reference's ``--nvlink-domain-size``): rank r is ``inter_idx * i +
intra_idx``, so sharding is the same as on the flat world. The 'intra'
group of rank r is the i consecutive ranks of its domain, the 'inter'
group the ranks with the same ``r % i``, at stride i. In a process world
every process creates every subgroup's ``torch.distributed`` group once,
in the same order, when ``make_topology`` runs (``process_subgroups``).
Ranks on several devices in one process raise.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from . import bootstrap

INTER, INTRA = "inter", "intra"


@dataclasses.dataclass(frozen=True)
class CommunicationGroup:
    """A shuffle scope: one rank axis and its size."""

    axis_name: str
    size: int


@dataclasses.dataclass(frozen=True)
class Topology:
    """Ranks of a flat or two-level world. ``devices`` holds one entry
    per rank that runs in this process: every rank of a world in one
    process, or this process's rank alone in a process world, where
    ``rank`` is its index and ``process_count`` the world's size.
    ``intra_size`` is None on a flat world, else the size of the 'intra'
    axis (a divisor of the world below it)."""

    devices: tuple[torch.device, ...]
    axis_name: str = "ranks"
    rank: Optional[int] = None
    process_count: int = 1
    intra_size: Optional[int] = None

    @property
    def is_process_world(self) -> bool:
        return self.rank is not None

    @property
    def world_size(self) -> int:
        return self.process_count if self.is_process_world else len(self.devices)

    @property
    def is_hierarchical(self) -> bool:
        return self.intra_size is not None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (INTER, INTRA) if self.is_hierarchical else (self.axis_name,)

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
        if self.is_hierarchical:
            raise ValueError(
                "a two-level topology has no single-axis world group; shuffle "
                "over the 'inter' then the 'intra' group"
            )
        return CommunicationGroup(self.axis_name, self.world_size)

    def group(self, axis_name: str) -> CommunicationGroup:
        if axis_name not in self.axis_names:
            raise ValueError(f"axis {axis_name!r} is not one of {self.axis_names}")
        if not self.is_hierarchical:
            return self.world_group()
        size = self.intra_size if axis_name == INTRA else self.world_size // self.intra_size
        return CommunicationGroup(axis_name, size)

    def main_group(self) -> CommunicationGroup:
        """The group of the join's main stage: 'intra' on a two-level
        topology, the world on a flat one."""
        return self.group(INTRA) if self.is_hierarchical else self.world_group()

    def group_ranks(self, axis_name: str, rank: int) -> list[int]:
        """The world ranks of ``rank``'s group on ``axis_name``, in the
        group's rank order."""
        if not self.is_hierarchical:
            self.group(axis_name)
            return list(range(self.world_size))
        i = self.intra_size
        if axis_name == INTRA:
            return list(range(rank - rank % i, rank - rank % i + i))
        self.group(axis_name)
        return list(range(rank % i, self.world_size, i))


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _intra(intra_size: Optional[int], world: int) -> Optional[int]:
    """The two-level factor of a world: None (flat) when ``intra_size``
    is None or covers the world (dj_tpu's make_topology)."""
    if intra_size is None or intra_size >= world:
        return None
    if intra_size < 1 or world % intra_size:
        raise ValueError(f"world size {world} not divisible by intra_size {intra_size}")
    return intra_size


def make_topology(
    devices: Optional[Sequence] = None,
    intra_size: Optional[int] = None,
    axis_name: str = "ranks",
) -> Topology:
    """A flat or two-level topology. With a live process group, the
    process world: one rank per process on ``cuda:LOCAL_RANK``
    (``devices=["cpu"]`` for CPU ranks). Otherwise one rank per entry of
    ``devices`` (default: one rank on the current CUDA device) in this
    process: pass ``devices=["cpu"]`` to run on the CPU, and repeat a
    device for a world of several ranks, ``make_topology(["cuda:0"] *
    4)``. ``intra_size`` below the world size factors the ranks into
    ('inter', 'intra') with 'intra' of that size; it must divide the
    world."""
    if bootstrap.is_distributed_initialized():
        return _process_world(devices, intra_size, axis_name)
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("make_topology: a world needs at least one rank")
    intra = _intra(intra_size, len(devices))
    if len(set(devices)) != 1:
        raise NotImplementedError(
            f"ranks on several devices {sorted(set(map(str, devices)))} run one "
            f"process per device: start a process world (init_distributed, then "
            f"make_topology()); a world in one process runs every rank on one device"
        )
    return Topology(devices, axis_name, intra_size=intra)


def _process_world(devices, intra_size, axis_name) -> Topology:
    w = bootstrap.process_count()
    intra = _intra(intra_size, w)
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
    topo = Topology((dev,), axis_name, rank=bootstrap.process_index(), process_count=w,
                    intra_size=intra)
    if intra is not None:
        process_subgroups(topo)
    return topo


# (world, intra) -> (the default group they were made under, {(axis,
# first rank): ProcessGroup}), all as weak references: torch.distributed
# holds the groups until destroy_process_group, and a group that outlives
# that call can abort the process when it is freed at exit.
_SUBGROUPS: dict = {}


def process_subgroups(topology: Topology) -> dict:
    """{axis name: ProcessGroup, or None for a group of one} of this
    process's rank on a two-level process world. The first call under a
    process group creates every subgroup of the (world, intra) pair
    with ``dist.new_group``, which every process must call for every
    group in the same order: ``make_topology`` makes that call on every
    process."""
    w, i, r = topology.world_size, topology.intra_size, topology.rank
    default = dist.group.WORLD
    made = _SUBGROUPS.get((w, i))
    groups = None if made is None or made[0]() is not default else {
        key: ref() for key, ref in made[1].items()}
    if groups is None or any(g is None for g in groups.values()):
        groups = {}
        for axis in (INTER, INTRA):
            if topology.group(axis).size == 1:
                continue
            firsts = range(i) if axis == INTER else range(0, w, i)
            for first in firsts:
                g = dist.new_group(topology.group_ranks(axis, first))
                if r in topology.group_ranks(axis, first):  # others get a placeholder
                    groups[(axis, first)] = g
        _SUBGROUPS[(w, i)] = (weakref.ref(default),
                              {key: weakref.ref(g) for key, g in groups.items()})
    return {axis: groups.get((axis, topology.group_ranks(axis, r)[0]))
            for axis in (INTER, INTRA)}


def largest_intra_size(world: int, max_domain: int) -> int:
    """The reference's intra-domain size (dj_tpu's
    ``largest_intra_size``, after get_nvl_partition_size): the whole
    world when ``max_domain`` covers it, else the largest divisor of
    ``world`` at most ``max_domain``, searched down from
    ceil(sqrt(world)) so the factors stay balanced (world 8, max_domain
    4 gives 2, not 4)."""
    if max_domain >= world:
        return world
    d = math.isqrt(world)
    d += d * d < world  # ceil(sqrt(world))
    while d > 0:
        if world % d == 0 and d <= max_domain:
            return d
        d -= 1
    return 1

"""run_spmd: one body per rank of a world.

Counterpart of the ``shard_map`` that dj_tpu wraps around each rank's
pipeline (``dj_tpu/utils/compat.py:24``; ``run`` in
``dj_tpu/parallel/dist_join.py:862-876``). Every positional argument is
sharded as ``in_specs=spec`` shards it: a [w * cap] column, a [w] count
vector, a Table or a tuple of them splits into w equal row blocks, and
rank r's body gets block r (a string column's offsets in blocks of cap +
1, its chars in w equal blocks). The bodies' results join the same way,
as ``out_specs=spec`` does: their tensors and tables are concatenated in
rank order ([w * cap_out] tables, [w] counts, [w, k] flag matrices).
Each body gets a communicator of the backend the caller names
(``communicator_cls``, default ``XlaCommunicator``) over the main group:
the world on a flat topology, the rank's 'intra' group on a two-level
one, where ``comm.sub("inter")`` is its communicator over the 'inter'
group and ``comm.world_rank()`` its rank in the world. A group of one
rank (intra 1) takes the ``SingleRankTransport``; both communicators
share the rank's ``PhaseClock``.

A world of one rank runs its body on the caller's thread over the
``SingleRankTransport``. A world of w > 1 ranks on one device runs
each rank's body on a thread of its own over an ``InProcessTransport``:

- a rank holds the world lock while it runs and releases it only while
  it waits at a collective, so one rank issues work at a time: the
  module-level launch counters stay exact, and only one rank's working
  set between two collectives is live besides the resident shards;
- every rank launches on the device's current stream (the default
  stream of a new thread), so all ranks' kernels run in issue order on
  one stream, and a peer's send buffer is read after it was written;
- a rank that raises aborts the world: every rank waiting at a
  collective wakes with ``WorldAborted``, and the caller gets the first
  failing rank's exception. A collective that cannot complete (a rank
  returned, or ``RENDEZVOUS_TIMEOUT_S`` passed) raises as well;
- each rank runs in a copy of the caller's ``contextvars`` context, so
  what the caller's context holds (``obs.query_ctx``'s query, an open
  collective account, ``record_phases``) holds inside the rank; rank 0
  alone feeds the collective counters, so a query counts its epochs
  once, as dj_tpu's one controller does.

In a process world (``Topology.is_process_world``) every process calls
run_spmd with its own block of each sharded argument; the body runs once,
on this process's rank, over a ``DistTransport``, and run_spmd returns
this rank's results. The outputs named by ``gathered`` are all-gathered
over the world instead, so every process holds the [w, ...] whole that
one process's world returns (the flag matrix, which every rank must
read alike). A two-level process world's communicators run over the
subgroups' ProcessGroups (``topology.process_subgroups``). A rank that
raises leaves its peers at their next collective until the process
group's timeout fails them.

Each call consults the fault site ``communicator``
(``resilience.faults``) once, before any rank starts.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Callable, Optional, Sequence

import torch

from ..core.table import Column, StringColumn, Table
from ..resilience import faults
from .communicator import (
    Communicator,
    DistTransport,
    InProcessTransport,
    InProcessWorld,
    PhaseClock,
    PhaseRanges,
    SingleRankTransport,
    WorldAborted,
    XlaCommunicator,
    make_communicator,
)
from .topology import INTER, INTRA, Topology, process_subgroups

RENDEZVOUS_TIMEOUT_S = 600.0  # the longest one rank waits at one collective

_phase_runs: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "dj_tpu_torch_phase_runs", default=None
)


@contextlib.contextmanager
def record_phases():
    """Time every rank's phases in the run_spmd calls made inside the
    block: yields a list that gets, per call, one {phase: ms} per rank
    (``Communicator.phase`` names the phases; on the card the times are
    the device's, from CUDA events on the shared stream)."""
    runs: list = []
    token = _phase_runs.set(runs)
    try:
        yield runs
    finally:
        _phase_runs.reset(token)


def _split(x, w: int) -> list:
    """Rank r's block of a sharded argument, for r in range(w)."""
    if isinstance(x, torch.Tensor):
        if x.dim() == 0 or x.shape[0] % w:
            raise ValueError(f"run_spmd: a sharded tensor of shape {tuple(x.shape)} "
                             f"does not split into {w} row blocks")
        blocks = x.reshape(w, x.shape[0] // w, *x.shape[1:])
        return [blocks[r] for r in range(w)]
    if isinstance(x, Table):
        if x.valid_count is not None:
            raise ValueError("run_spmd: shard a table's counts as their own [w] argument")
        cols = [_split_column(c, w) for c in x.columns]
        return [Table(tuple(col[r] for col in cols)) for r in range(w)]
    if isinstance(x, (tuple, list)):
        parts = [_split(e, w) for e in x]
        return [type(x)(p[r] for p in parts) for r in range(w)]
    raise TypeError(f"run_spmd: cannot shard a {type(x).__name__}")


def _split_column(c, w: int) -> list:
    if isinstance(c, StringColumn):
        return [StringColumn(o, ch, c.dtype)
                for o, ch in zip(_split(c.offsets, w), _split(c.chars, w))]
    return [Column(d, c.dtype) for d in _split(c.data, w)]


def _concat_column(cols: list):
    c = cols[0]
    if isinstance(c, StringColumn):
        return StringColumn(torch.cat([p.offsets for p in cols]),
                            torch.cat([p.chars for p in cols]), c.dtype)
    return Column(torch.cat([p.data for p in cols]), c.dtype)


def _concat(parts: list):
    """The rank results of one output joined in rank order."""
    x = parts[0]
    if len(parts) == 1:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat(parts)
    if isinstance(x, Table):
        if any(p.valid_count is not None for p in parts):
            raise ValueError("run_spmd: return a table's counts as their own [1] output")
        return Table(tuple(_concat_column([p.columns[j] for p in parts])
                           for j in range(x.num_columns)))
    if isinstance(x, (tuple, list)):
        return type(x)(_concat([p[i] for p in parts]) for i in range(len(x)))
    raise TypeError(f"run_spmd: cannot join rank results of type {type(x).__name__}")


def _stop(comm: Communicator) -> None:
    """End the rank's last phase."""
    if comm.clock is not None:
        comm.clock.pause()
    comm.end_phases()


def _on_device(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _axis_comms(topology: Topology, transports: dict, cls, fuse_columns,
                clock: Optional[PhaseClock], lead: bool = True) -> Communicator:
    """The rank's communicator over the main group, given a transport per
    axis ({axis name: transport}); on a two-level topology each knows the
    other through ``axes``. Every one shares ``clock`` and one
    ``PhaseRanges``; ``lead`` says whether the rank's exchanges feed the
    collective counters (one rank a process does)."""
    comms = {axis: make_communicator(cls, topology.group(axis), t, fuse_columns)
             for axis, t in transports.items()}
    ranges = PhaseRanges(topology.device)
    for c in comms.values():
        c.clock = clock
        c.ranges = ranges
        c.counts_collectives = lead
        if topology.is_hierarchical:
            c.axes = comms
    return comms[topology.main_group().axis_name]


def run_spmd(topology: Topology, body: Callable, *sharded, communicator_cls=None,
             fuse_columns: Optional[bool] = None, gathered: Sequence[int] = ()):
    """``body(comm, *blocks)`` once per rank of ``topology`` that runs in
    this process, where ``comm`` is the rank's communicator over the
    main group (module docstring) and ``blocks`` the rank's blocks of
    ``sharded``; returns the ranks' results joined in rank order.
    ``communicator_cls`` and ``fuse_columns`` choose the backend and
    whether an exchange moves one collective per dtype class or one per
    buffer (None: the backend's own default). ``gathered`` indexes
    outputs of a tuple result that every process of a process world gets
    whole."""
    # Fault site "communicator" (dj_tpu's make_communicator, consulted
    # there while a module traces): once a call, on the calling thread,
    # before any rank starts, so a thread world counts one consultation.
    faults.check("communicator")
    cls = XlaCommunicator if communicator_cls is None else communicator_cls
    dev = topology.device
    runs = _phase_runs.get()
    if topology.is_process_world:
        clock = PhaseClock(dev) if runs is not None else None
        if topology.is_hierarchical:
            transports = {axis: SingleRankTransport() if pg is None else DistTransport(dev, pg)
                          for axis, pg in process_subgroups(topology).items()}
        else:
            transports = {topology.axis_name: DistTransport(dev)}
        comm = _axis_comms(topology, transports, cls, fuse_columns, clock)
        with _on_device(dev):
            try:
                out = body(comm, *sharded)
            finally:
                _stop(comm)
            if gathered:
                world = DistTransport(dev) if topology.is_hierarchical else comm.transport
                out = tuple(_gather(world, x) if i in gathered else x for i, x in enumerate(out))
        if runs is not None:
            runs.append([clock.ms()])
        return out
    w = topology.world_size
    blocks = [_split(a, w) for a in sharded]
    clocks = [PhaseClock(dev) if runs is not None else None for _ in range(w)]
    if w == 1:
        comm = _axis_comms(topology, {topology.axis_name: SingleRankTransport()}, cls,
                           fuse_columns, clocks[0])
        try:
            out = body(comm, *(b[0] for b in blocks))
        finally:
            _stop(comm)
    else:
        out = _run_threads(topology, body, blocks, clocks, cls, fuse_columns)
    if runs is not None:
        runs.append([c.ms() for c in clocks])
    return out


def _gather(transport, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` joined in rank order, as one process's world
    concatenates them."""
    g = transport.all_gather(x)
    return g.reshape((-1,) + tuple(g.shape[2:]))


def _thread_transports(topology: Topology, world: InProcessWorld) -> list[dict]:
    """Each world rank's {axis name: transport}: one rendezvous group per
    group of each axis, all under the world's one lock."""
    w = topology.world_size
    if not topology.is_hierarchical:
        group = world.group(range(w))
        return [{topology.axis_name: InProcessTransport(group, r)} for r in range(w)]
    out: list[dict] = [{} for _ in range(w)]
    for axis in (INTER, INTRA):
        made: dict = {}
        for r in range(w):
            members = topology.group_ranks(axis, r)
            if len(members) == 1:
                out[r][axis] = SingleRankTransport()
                continue
            group = made.setdefault(members[0], world.group(members))
            out[r][axis] = InProcessTransport(group, members.index(r))
    return out


def _run_threads(topology, body, blocks, clocks, cls, fuse_columns):
    w = topology.world_size
    dev = topology.device
    world = InProcessWorld(w, RENDEZVOUS_TIMEOUT_S)
    transports = _thread_transports(topology, world)
    results: list = [None] * w
    errors: list = []

    def rank_main(r: int) -> None:
        comm = _axis_comms(topology, transports[r], cls, fuse_columns, clocks[r], lead=r == 0)
        with world.cond:
            try:
                with _on_device(dev):
                    try:
                        results[r] = body(comm, *(b[r] for b in blocks))
                    finally:
                        _stop(comm)
            except BaseException as e:  # re-raised in the caller below
                errors.append((r, e))
                world.abort(e)
            else:
                world.rank_returned(r)

    threads = [
        threading.Thread(target=contextvars.copy_context().run, args=(rank_main, r),
                         name=f"dj_tpu_torch-rank-{r}", daemon=True)
        for r in range(w)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # The first failure is the cause; the ranks it woke raise WorldAborted.
        r, e = next(((r, e) for r, e in errors if not isinstance(e, WorldAborted)), errors[0])
        e.add_note(f"raised on rank {r} of {w}")
        raise e
    return _concat(results)

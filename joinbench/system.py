"""The system under test: dj_tpu_torch, through its public entry points.

The one module of the benchmark that imports the program. It turns the
benchmark's plain tensors into the program's tables, calls
``distributed_inner_join`` (and, for a served cell, a
``QueryScheduler`` in front of a ``JoinIndexCache``), and hands back
plain tensors: the answer's columns (a string column as (offsets,
chars)), its row count and whether any overflow flag fired. The phase
clock (``record_phases``) is the program's own; the harness reads it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


def _dj():
    import dj_tpu_torch

    return dj_tpu_torch


@dataclasses.dataclass
class Answer:
    """One join's answer on this rank: the result's columns as the
    program returned them (capacity-sized), the valid row count (0-d
    int64 on the device) and whether any overflow flag fired (0-d bool)."""

    columns: list  # int64 tensors, or (offsets, chars) for a string column
    count: torch.Tensor
    flagged: torch.Tensor


def answer_of(out, counts, info) -> Answer:
    dj = _dj()
    cols = []
    for c in out.columns:
        if isinstance(c, dj.StringColumn):
            cols.append((c.offsets, c.chars))
        else:
            cols.append(c.data)
    flags = [v for v in info.values() if v.dtype == torch.bool]
    flagged = (torch.stack([f.any() for f in flags]).any() if flags
               else torch.zeros((), dtype=torch.bool, device=counts.device))
    return Answer(cols, counts.sum(dtype=torch.int64), flagged)


def valid_rows(answer: Answer) -> list:
    """Copies of the answer's valid rows (a string column as (offsets,
    chars) of those rows), read once its work has finished."""
    n = int(answer.count)
    out = []
    for c in answer.columns:
        if isinstance(c, tuple):
            off, chars = c
            out.append((off[:n + 1].clone(), chars[:int(off[n])].clone()))
        else:
            out.append(c[:n].clone())
    return out


class Port:
    """The program on ``device``: a world of one rank, or this process's
    rank of the process world that ``init_world`` joined."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.topology = _dj().make_topology([self.device])

    def table(self, cols: list) -> tuple:
        """A one-shard table of ``cols`` (tensors, each column of its
        tensor's dtype, or (offsets, chars) pairs) and its [1] count."""
        dj = _dj()
        made = []
        n = None
        for c in cols:
            if isinstance(c, tuple):
                made.append(dj.StringColumn(c[0], c[1]))
                n = c[0].shape[0] - 1 if n is None else n
            else:
                made.append(dj.Column(c, dj.dtypes.from_torch(c.dtype)))
                n = c.shape[0]
        return dj.Table(tuple(made)), torch.full((1,), n, dtype=torch.int32, device=self.device)

    def config(self, settings: dict):
        return _dj().JoinConfig(**settings)

    def join(self, left: tuple, right: tuple, config, left_on=(0,), right_on=(0,)) -> Answer:
        """``distributed_inner_join`` of (table, counts) pairs on the key
        columns ``left_on`` and ``right_on``."""
        out, counts, info = _dj().distributed_inner_join(
            self.topology, left[0], left[1], right[0], right[1], list(left_on), list(right_on),
            config)
        return answer_of(out, counts, info)

    def join_cols(self, left_cols: list, right_cols: list, config, left_on=(0,),
                  right_on=(0,)) -> Answer:
        """The join of two tables given as columns (``table``)."""
        return self.join(self.table(left_cols), self.table(right_cols), config, left_on,
                         right_on)

    @contextlib.contextmanager
    def phases(self):
        """The program's phase clock over the block: yields the list
        that gets, per call, one {phase: device ms} per rank here."""
        from dj_tpu_torch.parallel import spmd

        with spmd.record_phases() as runs:
            yield runs

    def serve(self, build: tuple, config, serve_settings: dict, on: tuple = ((0,), (0,))):
        """A scheduler in front of a join-index cache, dispatched by the
        caller (``worker=False``: the harness's dispatcher thread pumps);
        queries join on the key columns ``on`` (the query's, the build
        side's)."""
        dj = _dj()
        cache = dj.JoinIndexCache(dj.IndexConfig())
        sched = dj.QueryScheduler(dj.ServeConfig(**serve_settings), worker=False, index=cache)
        return Server(self, sched, cache, build, config, on)


class Server:
    """Submits probe tables against one resident build side."""

    def __init__(self, port: Port, sched, cache, build: tuple, config,
                 on: tuple = ((0,), (0,))):
        self.port = port
        self.sched = sched
        self.cache = cache
        self.build = build
        self.config = config
        self.left_on, self.right_on = (list(k) for k in on)

    def submit(self, left: tuple):
        """A ticket for ``left`` JOIN the build side (the index resolves
        the build side to its resident prepared side)."""
        return self.sched.submit(self.port.topology, left[0], left[1], self.build[0],
                                 self.build[1], self.left_on, self.right_on, self.config)

    def warm(self, left: tuple) -> None:
        """One query answered before the window (the first pays the
        prepare); raises if it ended in an error."""
        self.sched.submit(self.port.topology, left[0], left[1], self.build[0], self.build[1],
                          self.left_on, self.right_on, self.config).result()

    def pump(self, timeout: float) -> int:
        return self.sched.pump(block=True, timeout=timeout)

    @staticmethod
    def answer(ticket) -> Optional[Answer]:
        """The ticket's answer, or None when it ended in an error."""
        if ticket.error is not None:
            return None
        out, counts, info = ticket.result()[:3]
        return answer_of(out, counts, info)

    @staticmethod
    def queued_s(ticket) -> Optional[float]:
        if ticket.start_t is None:
            return None
        return ticket.start_t - ticket.submit_t

    def close(self) -> None:
        self.sched.close()
        self.cache.clear(force=True)


def build_kernels() -> float:
    """Build every kernel library the program lacks (nvcc, into the
    program's build directory in the checkout); returns the seconds."""
    import time

    from dj_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    return time.perf_counter() - t0


def init_world(address: str, world: int, rank: int, backend: str, device: str) -> None:
    """Join a process world of ``world`` processes as ``rank``."""
    _dj().init_distributed(address, world, rank, backend, device=device)


def close_world() -> None:
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()

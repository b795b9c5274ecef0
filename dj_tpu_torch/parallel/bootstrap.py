"""Multi-process bootstrap: one rank per process, over torch.distributed.

Counterpart of ``dj_tpu/parallel/bootstrap.py``. The reference's first
act in every benchmark program is MPI_Init and a device per rank; here every
process of a world calls ``init_distributed()``, which joins
``torch.distributed``'s default process group: NCCL when the process's
ranks run on a CUDA device, gloo when the caller asks for CPU ranks
(``device="cpu"``) or names ``backend="gloo"``. ``make_topology()`` then
gives the process world (one rank per process, this process's block
of every sharded table).

The settings come from, in this order: the explicit arguments;
``DJT_COORDINATOR_ADDRESS`` / ``DJT_NUM_PROCESSES`` / ``DJT_PROCESS_ID``;
torchrun's ``MASTER_ADDR``:``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.
With no coordinator in any of them the call is a no-op (a world of one
process). Joining retries transient failures with a doubling back-off
(``DJT_INIT_RETRIES`` tries, first delay ``DJT_INIT_BACKOFF_S``) and
raises ``BackendError`` when the tries run out; every collective of the
group then fails after ``DJT_COLLECTIVE_TIMEOUT_S`` seconds instead of
waiting forever on a rank that died.

Not ported: dj_tpu's ``ensure_async_collectives`` and
``setup_compile_cache`` set XLA flags and XLA's compilation cache, which
PyTorch has no counterpart of (NCCL collectives are asynchronous by
construction); the observability hooks (the HTTP endpoint and the crash
black box) come with the serving stack, ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..resilience.errors import BackendError

_COORD_VARS = ("DJT_COORDINATOR_ADDRESS",)
_NPROC_VARS = ("DJT_NUM_PROCESSES",)
_PID_VARS = ("DJT_PROCESS_ID",)

DEFAULT_TIMEOUT_S = 600.0  # the longest one collective waits


def _env_first(names) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return v
    return None


def _torchrun_address() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def is_distributed_initialized() -> bool:
    """True when this process belongs to a live process group."""
    return dist.is_available() and dist.is_initialized()


def retry_backoff(
    fn: Callable,
    what: str,
    *,
    attempts: Optional[int] = None,
    base_delay_s: Optional[float] = None,
    max_delay_s: float = 30.0,
    sleep: Optional[Callable[[float], None]] = None,
) -> object:
    """Run ``fn`` with bounded exponential-backoff retry.

    Bring-up is where transient failures are the norm (the coordinator
    may not be listening yet when a worker arrives). Up to ``attempts``
    (``DJT_INIT_RETRIES``, default 5) tries, with delays from
    ``base_delay_s`` (``DJT_INIT_BACKOFF_S``, default 1.0) doubling per
    attempt and capped at ``max_delay_s``; no sleep after the last try.
    Exhaustion raises :class:`BackendError` chaining the last failure.
    """
    if attempts is None:
        attempts = max(1, int(os.environ.get("DJT_INIT_RETRIES", "5")))
    if base_delay_s is None:
        base_delay_s = float(os.environ.get("DJT_INIT_BACKOFF_S", "1.0"))
    if sleep is None:
        sleep = time.sleep
    last: Optional[BaseException] = None
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - transient by contract
            last = e
            if attempt == attempts:
                break
            sleep(min(max_delay_s, base_delay_s * 2 ** (attempt - 1)))
    raise BackendError(
        f"{what} failed after {attempts} attempts: {type(last).__name__}: {last}"
    ) from last


def _backend(backend: Optional[str], device: Optional[str]) -> str:
    if backend is not None:
        return backend
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed: no CUDA device; pass device='cpu' (or "
            "backend='gloo') for a world of CPU ranks"
        )
    return "nccl"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    *,
    device: Optional[str] = None,
) -> bool:
    """Join the world of processes if one is configured.

    ``coordinator_address`` is ``host:port`` (or any init_method URL) of
    rank 0's store. Returns True when this process belongs to a process
    group (joined here or before), False when no coordinator is
    configured. A malformed process count or id fails at once, outside
    the retries. On a CUDA rank the current device becomes
    ``cuda:LOCAL_RANK`` before the group starts, so NCCL binds each
    process to its own card."""
    if is_distributed_initialized():
        return True
    address = coordinator_address or _env_first(_COORD_VARS) or _torchrun_address()
    if address is None:
        return False
    nproc = num_processes if num_processes is not None else (
        _env_first(_NPROC_VARS) or os.environ.get("WORLD_SIZE"))
    pid = process_id if process_id is not None else (
        _env_first(_PID_VARS) or os.environ.get("RANK"))
    if nproc is None or pid is None:
        raise ValueError(
            f"init_distributed: coordinator {address} is set, but the process "
            f"count ({nproc}) or this process's id ({pid}) is not"
        )
    nproc, pid = int(nproc), int(pid)
    if not 0 <= pid < nproc:
        raise ValueError(f"init_distributed: process id {pid} outside a world of {nproc}")
    be = _backend(backend, device)
    timeout_s = float(os.environ.get("DJT_COLLECTIVE_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    if be == "nccl":
        torch.cuda.set_device(local_device_index(pid))
    url = address if "://" in address else f"tcp://{address}"
    retry_backoff(
        lambda: dist.init_process_group(
            be, init_method=url, world_size=nproc, rank=pid,
            timeout=datetime.timedelta(seconds=timeout_s),
        ),
        "torch.distributed.init_process_group",
    )
    return True


def local_device_index(rank: Optional[int] = None) -> int:
    """This process's card on its host: ``LOCAL_RANK``, else its rank
    (default: ``process_index()``) modulo the cards."""
    local = os.environ.get("LOCAL_RANK")
    if local not in (None, ""):
        return int(local)
    rank = process_index() if rank is None else rank
    return rank % max(1, torch.cuda.device_count())


def process_index() -> int:
    """This process's rank in the world (0 without a process group)."""
    return dist.get_rank() if is_distributed_initialized() else 0


def process_count() -> int:
    """Processes in the world (1 without a process group)."""
    return dist.get_world_size() if is_distributed_initialized() else 1

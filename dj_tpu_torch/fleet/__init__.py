"""dj_tpu_torch.fleet: shared-nothing coordination between worker processes.

Counterpart of ``dj_tpu/fleet/__init__.py``. N serving workers on one host
each believe they own the whole device budget and each re-prepare the same
tenant's build sides. This package coordinates them with no coordinator
process, through files under one shared directory and the JSONL contracts
the port already has (``DJT_LEDGER``, ``DJT_INDEX_MANIFEST``, appended one
whole line a write by ``resilience.ledger.append_line``):

- :mod:`.leases`: advisory lease files (``O_CREAT|O_EXCL``, an owner
  payload, a heartbeat mtime) give one writer a signature for prepares; a
  lease past ``DJT_FLEET_LEASE_TTL_S`` whose owner is provably dead is
  reclaimed by exactly one racer.
- :mod:`.budget`: each worker publishes its reserved and resident bytes in
  a row under ``DJT_FLEET_DIR/budget``; admission charges live peers' rows.
- :mod:`.drain`: SIGTERM drains every live scheduler, withdraws this
  worker's budget row and chains to the disposition installed before.

One knob arms it all: ``DJT_FLEET_DIR``. Unset, the package is a no-op
(:func:`enabled` is the gate every caller checks), and the degradation
ladder's ``fleet`` tier pins the knob back to empty, so a lost shared
directory or an injected ``fleet.*`` fault degrades to process-local
serving instead of deadlocking. Coordination is host-side file I/O only:
it launches nothing on the device and issues no collective.

**A process world is one worker.** dj_tpu runs one controller process.
In a ``torch.distributed`` world of the port every process serves its own
shard of the same side, and the processes have different pids. Left
alone, process 1 would read process 0's lease or budget row as a live
peer's and defer to its own world. So the owner that leases, manifest
records and budget rows carry is the world's: :func:`identity` gives
process 0's pid and host once :func:`set_world` has bound them (the
join-index cache does, with the one gather its shared decision takes),
and :func:`owner_alive` treats that owner as this process. Process 0 alone
takes the prepare lease and runs the cache's gate; a budget row is named
by the world's owner and the process's rank.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from .. import knobs as _knobs

__all__ = [
    "budget",
    "drain",
    "enabled",
    "fleet_dir",
    "guarded",
    "identity",
    "leases",
    "owner_alive",
    "peer_bytes_guarded",
    "publish_guarded",
    "reset",
    "set_world",
    "snapshot",
    "tenant_weights",
    "world_rank",
]

_world_lock = threading.Lock()
# {"pid", "host", "rank", "size"} of the process world this process
# serves in, bound by set_world; None: a world of one process.
_world: Optional[dict] = None


def fleet_dir() -> Optional[str]:
    """The shared coordination directory, or None when fleet mode is off.
    The degradation ladder's ``fleet`` tier pins ``DJT_FLEET_DIR`` empty,
    which makes this None."""
    return _knobs.read("DJT_FLEET_DIR") or None


def enabled() -> bool:
    """True when fleet coordination is armed (``DJT_FLEET_DIR`` set and
    not pinned away by the ladder)."""
    return fleet_dir() is not None


def guarded(where: str, fn: Callable):
    """Run a coordination step under the ladder's ``fleet`` tier: a
    FaultInjected ``fleet.*`` site or an OSError from the shared directory
    pins ``DJT_FLEET_DIR`` empty and retries, and the retry must check
    :func:`enabled` again so that it runs process-locally. A
    ``KernelError`` or a device fault propagates, as through every guard."""
    from ..resilience import errors as _errors

    return _errors.degrade_guard(where, fn, tiers=("fleet",))


def tenant_weights() -> dict:
    """``DJT_FLEET_TENANT_WEIGHTS`` (``"tenantA:2,tenantB:1"``) as
    {tenant: positive float weight}; {} when unset or unparseable."""
    raw = _knobs.read("DJT_FLEET_TENANT_WEIGHTS")
    if not raw:
        return {}
    out: dict = {}
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            weight = float(w) if w else 1.0
        except ValueError:
            continue
        if name and weight > 0:
            out[name.strip()] = weight
    return out


def set_world(pid: int, host: str, rank: int, size: int) -> None:
    """Bind this process to a process world whose owner (its process 0)
    has ``pid`` on ``host``; ``rank`` and ``size`` are this process's
    index and the world's process count. A world of one process unbinds."""
    global _world
    with _world_lock:
        _world = None if size <= 1 else {"pid": int(pid), "host": str(host),
                                          "rank": int(rank), "size": int(size)}


def identity() -> dict:
    """The owner this process's leases, manifest records and budget rows
    carry: {"pid", "host"} of process 0 of its process world, else its
    own."""
    w = _world
    if w is not None:
        return {"pid": w["pid"], "host": w["host"]}
    return {"pid": os.getpid(), "host": _hostname()}


def world_rank() -> tuple[int, int]:
    """(rank, size) of this process in its bound world; (0, 1) alone."""
    w = _world
    return (w["rank"], w["size"]) if w is not None else (0, 1)


def _own_pid(pid: int) -> bool:
    return pid == os.getpid() or pid == identity()["pid"]


def owner_alive(rec: dict) -> bool:
    """Is the worker that wrote ``rec`` (a manifest, lease or budget row
    carrying ``pid`` and ``host``) a LIVE PEER of this process? False for
    this process's own owner (its pid, or its world's: a row written in
    an earlier life, or by this world, is ours to rebuild, not to defer
    to), for a row of another host (its liveness is unknowable here; the
    TTL decides), and for a same-host pid that no longer exists."""
    try:
        pid = int(rec.get("pid", 0))
    except (TypeError, ValueError):
        return False
    if pid <= 0 or _own_pid(pid):
        return False
    host = rec.get("host")
    if host is not None and host != _hostname():
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _hostname() -> str:
    import socket

    return socket.gethostname()


def publish_guarded(reserved_bytes: float, index_bytes: float) -> None:
    """Publish this worker's footprint into its budget row under the
    ladder (a failure pins the process local and is otherwise invisible
    to the query path)."""
    if not enabled():
        return
    try:
        guarded("fleet_publish",
                lambda: budget.publish(reserved_bytes, index_bytes) if enabled() else None)
    except Exception:  # noqa: BLE001 - publishing must never take a query down
        pass


def peer_bytes_guarded() -> float:
    """Live peers' published reserved + resident bytes, under the ladder;
    0.0 when fleet mode is off or coordination just degraded."""
    if not enabled():
        return 0.0
    try:
        out = guarded("fleet_peer_bytes",
                      lambda: budget.peer_bytes() if enabled() else 0.0)
    except Exception:  # noqa: BLE001 - admission arithmetic must always proceed
        return 0.0
    return float(out or 0.0)


def snapshot() -> dict:
    """One self-describing coordination snapshot: armed, the directory,
    this process's pid, the drain flag, the tenant weights and every
    budget row on disk."""
    return {
        "enabled": enabled(),
        "dir": fleet_dir(),
        "pid": os.getpid(),
        "draining": drain.draining(),
        "tenant_weights": tenant_weights(),
        "budget_rows": budget.rows_snapshot(),
    }


def reset() -> None:
    """Forget the process-local coordination state (tests): the drain
    flag and handler, the publish throttle and the bound world. Files
    under ``DJT_FLEET_DIR`` are the caller's to manage."""
    drain._reset_for_tests()
    budget._reset_for_tests()
    set_world(0, "", 0, 1)


from . import budget, drain, leases  # noqa: E402  (the helpers above are their deps)

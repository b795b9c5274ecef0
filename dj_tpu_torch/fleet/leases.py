"""Advisory file leases: one writer a signature across the fleet.

Counterpart of ``dj_tpu/fleet/leases.py``. The state machine:

    free --O_CREAT|O_EXCL wins--> held --release/unlink--> free
     ^                              |
     |            heartbeat (mtime) older than DJT_FLEET_LEASE_TTL_S
     |                  AND owner pid provably dead (same host)
     |                              v
     +--exactly-one rename wins-- stale

A lease is one file under ``DJT_FLEET_DIR/leases/`` named by the sha1 of
its key, created with ``O_CREAT|O_EXCL`` and holding a ``{pid, host, key,
ts}`` JSON payload (the owner is :func:`..fleet.identity`: a process
world's leases carry its process 0). The holder refreshes the file's
mtime as its heartbeat. Reclaim renames the file to a tombstone: of N
racers that saw the same stale lease exactly one rename succeeds, so the
reclaim is counted once and the rebuild happens once.

Advisory: the worst case of every race (a peer that never calls
:func:`acquire`, an owner restarted between the liveness check and the
rename) is one duplicate prepare, never a corrupted log, because the
JSONL logs are appended a whole line a write and merge last-wins.

Every wait is bounded: :func:`acquire` polls for at most
``DJT_FLEET_LEASE_WAIT_S`` and then returns None, and the caller proceeds
process-locally.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional

from .. import knobs as _knobs
from .. import obs
from ..resilience import faults

__all__ = ["Lease", "acquire", "lease_path"]

_LEASE_SUBDIR = "leases"


def _ttl_s() -> float:
    return max(0.05, _knobs.read_float("DJT_FLEET_LEASE_TTL_S"))


def lease_path(key: str) -> Optional[str]:
    """The lease file of ``key``, or None when fleet mode is off. Keys
    are hashed: signatures run far past any filename limit."""
    from . import fleet_dir

    d = fleet_dir()
    if d is None:
        return None
    h = hashlib.sha1(key.encode("utf-8", "replace")).hexdigest()[:24]
    return os.path.join(d, _LEASE_SUBDIR, f"{h}.lease")


class Lease:
    """A held advisory lease. Release it once (a second release does
    nothing); usable as a context manager. ``reclaimed`` says whether
    winning took evicting a stale owner first."""

    __slots__ = ("key", "path", "reclaimed", "_released")

    def __init__(self, key: str, path: str, reclaimed: bool = False):
        self.key = key
        self.path = path
        self.reclaimed = reclaimed
        self._released = False

    def heartbeat(self) -> None:
        """Refresh the heartbeat mtime, the holder's claim to be alive.
        Call it before (and during a long) protected work, so the TTL
        measures the work, not the wait."""
        faults.check("fleet.lease_heartbeat")
        try:
            os.utime(self.path, None)
        except OSError:
            pass  # reclaimed under us: the work goes on, advisorily

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        try:
            os.unlink(self.path)
        except OSError:
            pass  # already reclaimed or released

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _read_owner(path: str) -> dict:
    try:
        with open(path, "r") as f:
            return json.loads(f.read() or "{}")
    except (OSError, ValueError):
        return {}


def _try_reclaim(path: str, key: str, st, age_s: float) -> bool:
    """Evict a stale lease. The rename arbitrates: one of N concurrent
    reclaimers succeeds and counts the reclaim, then everyone races the
    O_EXCL create again.

    ``st`` is the stat that justified the eviction. A faster reclaimer
    may have finished its reclaim and create between that stat and this
    rename, so the renamed file would be its fresh lease: the
    tombstone's inode and mtime must match ``st``, else the file goes
    back and this racer waits like the others."""
    tomb = f"{path}.r{os.getpid()}"
    try:
        os.rename(path, tomb)
    except OSError:
        return False  # another racer won the rename
    try:
        t_st = os.stat(tomb)
    except OSError:
        t_st = None
    if t_st is not None and (t_st.st_ino != st.st_ino or t_st.st_mtime != st.st_mtime):
        try:
            os.rename(tomb, path)  # put the fresh winner's lease back
        except OSError:
            pass
        return False
    try:
        os.unlink(tomb)
    except OSError:
        pass
    obs.inc("dj_fleet_lease_reclaimed_total")
    obs.record("fleet", action="lease_reclaimed", key=key[:200], age_s=round(age_s, 3),
               pid=os.getpid())
    return True


def acquire(key: str, *, wait_s: Optional[float] = None,
            poll_s: Optional[float] = None) -> Optional[Lease]:
    """Win the lease of ``key`` or give up within a bound.

    Returns a held :class:`Lease` when this process creates the file
    (fresh, or after reclaiming a stale owner's), or None when a live
    peer held it for the whole ``DJT_FLEET_LEASE_WAIT_S`` (the caller
    then consults the shared state again: the peer probably finished)
    or the directory cannot be written."""
    from . import fleet_dir, identity, owner_alive

    faults.check("fleet.lease_acquire")
    if fleet_dir() is None:
        return None
    path = lease_path(key)
    assert path is not None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if wait_s is None:
        wait_s = max(0.0, _knobs.read_float("DJT_FLEET_LEASE_WAIT_S"))
    if poll_s is None:
        poll_s = max(0.005, _knobs.read_float("DJT_FLEET_LEASE_POLL_S"))
    ttl = _ttl_s()
    deadline = time.monotonic() + wait_s
    reclaimed = False
    me = identity()
    while True:
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            pass
        except OSError:
            return None  # unwritable shared directory: the caller degrades
        else:
            payload = {"pid": me["pid"], "host": me["host"], "key": key[:500],
                       "ts": round(time.time(), 3)}
            try:
                os.write(fd, (json.dumps(payload) + "\n").encode())
            finally:
                os.close(fd)
            return Lease(key, path, reclaimed=reclaimed)
        # Held: stale with a dead owner -> reclaim; else wait, bounded.
        try:
            st = os.stat(path)
        except OSError:
            continue  # released between the open and the stat: race again
        age = time.time() - st.st_mtime
        owner = _read_owner(path)
        # owner_alive is False for this process's own owner (a manifest
        # row of an earlier life is ours to rebuild), but a lease with
        # our owner is held by another thread of this live process, or
        # by another process of our world, and is never reclaimed.
        held_by_us = owner.get("pid") in (os.getpid(), me["pid"])
        if age > ttl and not held_by_us and not owner_alive(owner):
            if _try_reclaim(path, key, st, age):
                reclaimed = True
            continue  # winner and losers race the O_EXCL create again
        if time.monotonic() >= deadline:
            obs.record("fleet", action="lease_wait_expired", key=key[:200],
                       waited_s=round(wait_s, 3))
            return None
        time.sleep(min(poll_s, max(0.0, deadline - time.monotonic())))

"""The shared fleet budget: one footprint row a worker under one host.

Counterpart of ``dj_tpu/fleet/budget.py``. Each worker publishes one row,
``DJT_FLEET_DIR/budget/<pid>.json`` holding ``{pid, host, reserved_bytes,
index_bytes, ts}``, through a temporary file and ``os.replace`` (a reader
never sees a torn row). Admission then charges live peers' ``reserved +
index`` bytes against the budget beside this process's own reservations,
so K workers on one host stop each believing they own the card.

In a process world (``fleet.set_world``) the row carries the world's
owner, process 0's pid, and is named ``<owner pid>-r<rank>.json``: each
process publishes its own footprint, and no process of the world charges
another's row as a peer's.

Liveness, not consensus: a row is charged only while its writer is a live
peer (``fleet.owner_alive``) and fresher than the lease TTL, so a killed
worker's bytes stop being charged within ``DJT_FLEET_LEASE_TTL_S``, and
the next reader removes a dead owner's row. Publishing is throttled to
changed values, plus a refresh that keeps the row fresh at steady state.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from .. import knobs as _knobs
from .. import obs
from ..resilience import faults

__all__ = ["peer_bytes", "publish", "rows_snapshot", "withdraw"]

_lock = threading.Lock()
_last_pub: Optional[tuple] = None  # (reserved, index, monotonic ts)

# Re-publish unchanged values after this share of the TTL, so peers'
# freshness horizon keeps seeing a live row at steady state.
_REFRESH_FRACTION = 0.25


def _dir() -> Optional[str]:
    from . import fleet_dir

    d = fleet_dir()
    if d is None:
        return None
    return os.path.join(d, "budget")


def _row_path() -> Optional[str]:
    """This process's row: ``<pid>.json``, or ``<owner pid>-r<rank>.json``
    in a bound process world."""
    from . import identity, world_rank

    d = _dir()
    if d is None:
        return None
    rank, size = world_rank()
    pid = identity()["pid"]
    return os.path.join(d, f"{pid}.json" if size <= 1 else f"{pid}-r{rank}.json")


def _ttl_s() -> float:
    return max(0.05, _knobs.read_float("DJT_FLEET_LEASE_TTL_S"))


def publish(reserved_bytes: float, index_bytes: float) -> None:
    """Publish this worker's footprint row (an atomic replace). A
    publish of unchanged values inside the refresh window is skipped, so
    the serving path does not pay a file write a query."""
    global _last_pub
    from . import identity

    path = _row_path()
    if path is None:
        return
    vals = (round(float(reserved_bytes)), round(float(index_bytes)))
    now = time.monotonic()
    with _lock:
        if _last_pub is not None:
            last_vals, last_t = _last_pub[:2], _last_pub[2]
            if vals == last_vals and now - last_t < _ttl_s() * _REFRESH_FRACTION:
                return
    faults.check("fleet.publish")
    me = identity()
    row = {"pid": me["pid"], "host": me["host"], "reserved_bytes": vals[0],
           "index_bytes": vals[1], "ts": round(time.time(), 3)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(row))
    os.replace(tmp, path)
    with _lock:
        _last_pub = (*vals, now)
    obs.set_gauge("dj_fleet_peer_bytes", peer_bytes())


def _row_files() -> list:
    """(path, row) of every parseable budget row, this process's too;
    torn or foreign files skipped."""
    d = _dir()
    if d is None:
        return []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    out = []
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(d, name)
        try:
            with open(path, "r") as f:
                row = json.loads(f.read() or "{}")
        except (OSError, ValueError):
            continue
        if isinstance(row, dict) and "pid" in row:
            out.append((path, row))
    return out


def peer_bytes(now: Optional[float] = None) -> float:
    """The sum of live PEERS' published ``reserved + index`` bytes. Rows
    of this process's own owner are skipped, and so are rows older than
    the TTL or of a provably dead same-host owner (whose files are
    removed): a killed worker's reservation must not haunt the budget."""
    from . import identity, owner_alive

    if now is None:
        now = time.time()
    ttl = _ttl_s()
    mine = (os.getpid(), identity()["pid"])
    total = 0.0
    for path, row in _row_files():
        if row.get("pid") in mine:
            continue
        fresh = (now - float(row.get("ts", 0.0))) <= max(ttl, 1.0)
        if not fresh or not owner_alive(row):
            if not owner_alive(row):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            continue
        total += float(row.get("reserved_bytes", 0.0)) + float(row.get("index_bytes", 0.0))
    return total


def withdraw() -> None:
    """Remove this worker's row (a graceful drain or a clean shutdown):
    a departing worker returns its share at once instead of after the
    TTL."""
    global _last_pub
    path = _row_path()
    if path is None:
        return
    with _lock:
        _last_pub = None
    try:
        os.unlink(path)
    except OSError:
        pass
    obs.record("fleet", action="budget_withdrawn", pid=os.getpid())


def rows_snapshot() -> list:
    """Every budget row on disk, live or not: diagnostics show what is
    there; liveness filtering is admission's job."""
    return [row for _, row in _row_files()]


def _reset_for_tests() -> None:
    global _last_pub
    with _lock:
        _last_pub = None

"""Capacity ledger: learned sizing factors, remembered per signature.

Counterpart of ``dj_tpu/resilience/ledger.py:47-302``. The heal loops
converge in O(log(need)) attempts; the ledger keeps what they learned.
It maps a **plan signature** (the workload's static shape: stage kind,
world size, odf, both tables' column dtypes, the key columns and the
per-shard capacities) to the factors, and the plan repairs, the engine
settled on. The engine reads it (:func:`lookup`) before the first
attempt and updates it after every heal, so a signature pays each heal
once per process. The skew-adaptive planner keeps its per-signature
decisions here too (``plan_adapt`` and ``prepared_tier`` records, read
through :func:`consult`).

Entries are monotone: a factor update keeps the larger of old and new,
so an entry can only make first attempts more generous. Other fields
(``drop_declared_range``, ``reprobe_declared_range``, ``plan_adapt``,
``prepared_tier``) are last-write-wins.

``DJT_LEDGER=<path>`` makes it persistent: every update appends one JSON
line (one ``os.write`` on an ``O_APPEND`` descriptor, so concurrent
writers interleave whole lines), and the first use replays the file,
skipping a torn last line. A missing or unreadable file is an empty
start; a write that fails is skipped, never raised.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

_lock = threading.Lock()
_entries: dict[str, dict] = {}
# The DJT_LEDGER path whose file has been replayed into _entries (None:
# nothing loaded). Checked at each use, so flipping the variable loads
# the new file.
_loaded_path: Optional[str] = None


def _path() -> Optional[str]:
    return os.environ.get("DJT_LEDGER") or None


def signature(kind: str, **parts) -> str:
    """A stable string key for one workload shape. ``parts`` values are
    rendered with repr (tuples, ints, strs: static shape descriptors,
    never data)."""
    body = ",".join(f"{k}={parts[k]!r}" for k in sorted(parts))
    return f"{kind}|{body}"


def table_sig(table) -> tuple:
    """A table's column schema: each fixed-width column's physical dtype
    name, "str" for a string column (dj_tpu's ``obs.recorder.table_sig``,
    duck-typed on ``.chars`` as it is)."""
    return tuple("str" if hasattr(c, "chars") else str(c.data.dtype).removeprefix("torch.")
                 for c in table.columns)


def table_shape(table, shards: int) -> tuple:
    """The per-shard shape a signature folds: ``(rows, char_cap, ...)``
    of each of the ``shards`` shards ``table`` holds here, one char
    capacity for each string column, rounded to its shape bucket under
    ``DJT_SHAPE_BUCKET=1`` (``parallel.shape_bucket.table_shape``, as in
    dj_tpu), so two raw shapes of one bucket share a signature."""
    from ..parallel.shape_bucket import table_shape as bucketed_shape

    return bucketed_shape(table, shards)


def plan_signature(topology, left, right, left_on, right_on, config) -> str:
    """The plan signature of one workload, in dj_tpu's three kinds:

    - ``left is None``: "prepare" (``right``/``right_on`` describe the
      build table of ``prepare_join_side``);
    - ``right`` a PreparedSide (it has ``.batches``): "prepared";
      ``right_on`` is ignored;
    - otherwise "join".

    Each folds the world size, the odf, the tables' dtypes
    (:func:`table_sig`), the key columns and the per-shard capacities
    (:func:`table_shape`); for tables dj_tpu holds alike the string is
    dj_tpu's."""
    w = topology.world_size
    shards = topology.local_ranks
    odf = config.over_decom_factor
    if left is None:
        return signature("prepare", w=w, odf=odf, table=table_sig(right), on=tuple(right_on),
                         shape=table_shape(right, shards))
    if hasattr(right, "batches"):
        return signature(
            "prepared", w=w, odf=odf, left=table_sig(left), right=table_sig(right.right),
            on=(tuple(left_on), tuple(right.right_on)),
            shape=(table_shape(left, shards), table_shape(right.right, shards)),
        )
    return signature(
        "join", w=w, odf=odf, left=table_sig(left), right=table_sig(right),
        on=(tuple(left_on), tuple(right_on)),
        shape=(table_shape(left, shards), table_shape(right, shards)),
    )


def _merge(entry: dict, factors: Optional[dict], extra: dict) -> dict:
    if factors:
        cur = entry.setdefault("factors", {})
        for f, v in factors.items():
            v = float(v)
            if f not in cur or v > cur[f]:
                cur[f] = v
    for k, v in extra.items():
        entry[k] = v
    return entry


def _ensure_loaded_locked() -> None:
    global _loaded_path
    path = _path()
    if path is None or path == _loaded_path:
        return
    _loaded_path = path
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn line from a writer that died
                sig = rec.pop("sig", None) if isinstance(rec, dict) else None
                if not isinstance(sig, str):
                    continue
                rec.pop("ts", None)
                _merge(_entries.setdefault(sig, {}), rec.pop("factors", None), rec)
    except OSError:
        pass


def append_line(path: str, rec: dict) -> None:
    """Append ``rec`` as one JSON line with one ``os.write`` on an
    ``O_APPEND`` descriptor. A failure is skipped: a broken ledger file
    must never take a join down."""
    data = (json.dumps(rec) + "\n").encode("utf-8")
    try:
        fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
    except (OSError, TypeError):
        pass


def wider_factors(learned, current) -> dict:
    """The learned factors present in ``current`` and strictly wider:
    applying them can only make the sizing more generous."""
    return {
        f: float(v)
        for f, v in (learned or {}).items()
        if f in current and float(v) > float(current[f])
    }


def lookup(sig: str) -> Optional[dict]:
    """A copy of the learned entry of ``sig``, or None."""
    with _lock:
        _ensure_loaded_locked()
        entry = _entries.get(sig)
        return None if entry is None else json.loads(json.dumps(entry))


def consult(sig: str) -> Optional[dict]:
    """A copy of the learned entry of ``sig``, or None: the planner's
    lookup (dj_tpu/resilience/ledger.py:239-259, without its hit and
    miss counters and its ``DJ_FLEET_DIR`` refresh)."""
    return lookup(sig)


def update(sig: str, factors: Optional[dict] = None, **extra) -> None:
    """Merge learned state for ``sig``: factors keep the larger value,
    other fields overwrite; with ``DJT_LEDGER`` set, append one line."""
    with _lock:
        _ensure_loaded_locked()
        _merge(_entries.setdefault(sig, {}), factors, extra)
        path = _path()
        if path is not None:
            rec = {"sig": sig, "ts": round(time.time(), 3)}
            if factors:
                rec["factors"] = {f: float(v) for f, v in factors.items()}
            rec.update(extra)
            append_line(path, rec)


def entries() -> dict[str, dict]:
    """A copy of every learned entry."""
    with _lock:
        _ensure_loaded_locked()
        return json.loads(json.dumps(_entries))


def reset() -> None:
    """Forget everything in this process (the ``DJT_LEDGER`` file stays;
    the next use replays it)."""
    global _loaded_path
    with _lock:
        _entries.clear()
        _loaded_path = None

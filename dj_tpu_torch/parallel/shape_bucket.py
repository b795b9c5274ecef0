"""Shape-bucketed capacities: a few table shapes for many raw shapes.

Counterpart of ``dj_tpu/parallel/shape_bucket.py``. dj_tpu compiles one
module per static shape, so a stream of queries that each hold a few
rows more than the last would compile without end; its fix is to round
each per-shard capacity up to a geometric grid and pad the table to it.
The port compiles nothing per shape, but the same grid makes near-miss
shapes one group: one plan signature (the capacity ledger's learned
factors, the planner's decisions), one coalesced dispatch
(``distributed_inner_join_coalesced_unprepared`` takes members of one
capacity) and one prepared geometry.

Armed by ``DJT_SHAPE_BUCKET=1``. The grid is ``{MIN * RATIO^k}`` with
``DJT_SHAPE_BUCKET_RATIO`` (default 1.25: at most 20% of a padded table
is padding) and ``DJT_SHAPE_BUCKET_MIN`` (default 1024 rows or chars a
shard).

- :func:`bucket_capacity`: the grid arithmetic.
- :func:`table_shape`: the per-shard shape the ledger's plan signatures
  fold, the bucket when bucketing is on, the raw shape otherwise.
- :func:`bucket_table`: the pad. Each shard's fixed columns grow with a
  zero tail; its string offsets pad edge-mode (pad rows are empty) and
  its chars with zeros. Valid counts pass through untouched, so the pad
  rows are masked like every table's capacity padding. Pads are
  memoized by the source buffers' identity and version (``_version``,
  which PyTorch bumps on every in-place write), evicted when a source
  buffer dies, so repeated calls on one table pad once and see one
  padded object; a concurrent first call waits for the one that pads.
  The range probe's memo reads a pad's valid-row min/max from its
  source through :func:`alias_base`.

Observed as dj_tpu's: ``dj_shape_bucket_total{result}`` counts the pads
("pad"), the tables already on the grid ("exact", each distinct source
once) and the memo hits ("memo_hit"), and each pad records one
``shape_bucket`` event (raw and bucket rows, the pad fraction, the raw
and bucket char capacities).
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Optional

import torch

from .. import knobs, obs
from ..core.table import Column, StringColumn, Table

__all__ = [
    "alias_base",
    "bucket_capacity",
    "bucket_table",
    "enabled",
    "grid_points",
    "table_shape",
]


def enabled() -> bool:
    return knobs.read_bool("DJT_SHAPE_BUCKET")


def grid_ratio() -> float:
    """``DJT_SHAPE_BUCKET_RATIO``; unset, malformed or <= 1 (the grid
    walk would not advance) gives the registry's default, 1.25."""
    r = knobs.read_float("DJT_SHAPE_BUCKET_RATIO")
    return r if r > 1.0 else knobs.REGISTRY["DJT_SHAPE_BUCKET_RATIO"].default


def grid_floor() -> int:
    """``DJT_SHAPE_BUCKET_MIN`` (at least 1); unset or malformed gives
    the registry's default, 1024."""
    return max(1, knobs.read_int("DJT_SHAPE_BUCKET_MIN"))


def bucket_capacity(raw: int, *, floor: Optional[int] = None, ratio: Optional[float] = None
                    ) -> int:
    """The smallest grid point >= ``raw`` on ``{floor * ratio^k}``, by an
    integer walk (multiply and ceil), so no float rounding can give a
    bucket below ``raw``; ``bucket_capacity(bucket) == bucket``."""
    if raw <= 0:
        return raw
    b = floor if floor is not None else grid_floor()
    r = ratio if ratio is not None else grid_ratio()
    while b < raw:
        b = max(b + 1, math.ceil(b * r))
    return int(b)


def grid_points(lo: int, hi: int) -> int:
    """How many grid points cover capacities in [lo, hi]: the most
    distinct shapes a stream of such capacities makes once bucketed."""
    r = grid_ratio()
    lo_b, hi_b = bucket_capacity(max(1, lo)), bucket_capacity(max(lo, hi))
    n, b = 0, grid_floor()
    while b < lo_b:
        b = max(b + 1, math.ceil(b * r))
    while b <= hi_b:
        n += 1
        b = max(b + 1, math.ceil(b * r))
    return max(1, n)


def table_shape(table, shards: int) -> tuple:
    """The per-shard shape a plan signature folds: ``(rows, char_cap,
    ...)`` of each of the ``shards`` shards ``table`` holds here, one
    char capacity a string column; each rounded to its bucket under
    ``DJT_SHAPE_BUCKET=1``. Duck-typed on ``.chars``."""
    w = max(1, shards)
    shape = (table.capacity // w,) + tuple(
        c.chars.shape[0] // w for c in table.columns if hasattr(c, "chars"))
    return tuple(bucket_capacity(s) for s in shape) if enabled() else shape


# --- the pad ---------------------------------------------------------------

# Padded tables by their source buffers' (id, version) and the grid
# targets. An entry is evicted when a source buffer dies, so a recycled
# id never serves another table's pad; a write into a source bumps its
# version, so the next call pads the new data. Bounded: past the cap a
# pad is not kept.
_PAD_MEMO: dict = {}
_PAD_MEMO_MAX = 4096
_pad_lock = threading.Lock()
# Pads in progress, keyed like the memo: a concurrent first call on the
# same buffers waits for the owner's pad instead of making a second
# padded object, then re-reads the memo (and pads itself if the owner
# failed).
_PAD_INFLIGHT: dict = {}
# Padded column id -> (weakref to its source column, the source's and
# the pad's versions at pad time).
_ALIAS: dict = {}
# Tables already on the grid, by their buffers' (id, version): "exact"
# counts each distinct source once, however often it re-enters.
_EXACT_SEEN: set = set()


def alias_base(data: torch.Tensor) -> Optional[torch.Tensor]:
    """The column ``data`` was padded from, or None when ``data`` is no
    pad, its source died, or either was written since the pad."""
    rec = _ALIAS.get(id(data))
    if rec is None:
        return None
    ref, base_version, pad_version = rec
    base = ref()
    if base is None or base._version != base_version or data._version != pad_version:
        return None
    return base


def _buffers(table: Table) -> tuple:
    out = []
    for c in table.columns:
        out += [c.offsets, c.chars] if isinstance(c, StringColumn) else [c.data]
    return tuple(out)


def _key_of(bufs: tuple) -> tuple:
    return tuple((id(b), b._version) for b in bufs)


def _pad_rows(data: torch.Tensor, w: int, raw: int, target: int, edge: bool = False
              ) -> torch.Tensor:
    """Each of the w shards of ``data`` ([w * raw]) grown to ``target``:
    a zero tail, or its last element repeated under ``edge``."""
    shards = data.reshape(w, raw)
    out = torch.zeros((w, target), dtype=data.dtype, device=data.device)
    out[:, :raw] = shards
    if edge and target > raw:
        out[:, raw:] = shards[:, raw - 1 :]
    return out.reshape(-1)


def _pad(table: Table, w: int, raw: int, target: int, str_caps: tuple) -> Table:
    cols = []
    si = 0
    for c in table.columns:
        if isinstance(c, StringColumn):
            rcc, bcc = str_caps[si]
            si += 1
            cols.append(StringColumn(_pad_rows(c.offsets, w, raw + 1, target + 1, edge=True),
                                     _pad_rows(c.chars, w, rcc, bcc), c.dtype))
        else:
            cols.append(Column(_pad_rows(c.data, w, raw, target), c.dtype))
    return Table(tuple(cols), table.valid_count)


def _is_pad_product(table: Table) -> bool:
    """``table`` came out of this module's pad: a re-entry, not a source."""
    return any(id(c.data) in _ALIAS for c in table.columns if isinstance(c, Column))


def bucket_table(topology, table: Table) -> Table:
    """``table`` padded to its shape bucket, or ``table`` itself when
    bucketing is off or every shape is on the grid (module docstring).
    ``table`` is sharded over the ``topology.local_ranks`` shards it holds
    here (a process world's block is one shard)."""
    if not enabled():
        return table
    w = topology.local_ranks
    raw = table.capacity // w
    target = bucket_capacity(raw)
    str_raw = tuple(c.chars.shape[0] // w for c in table.columns if isinstance(c, StringColumn))
    str_tgt = tuple(bucket_capacity(c) for c in str_raw)
    bufs = _buffers(table)
    if target == raw and str_tgt == str_raw:
        if _is_pad_product(table):
            return table
        key = (_key_of(bufs), w)
        with _pad_lock:
            seen = key in _EXACT_SEEN
            if not seen and len(_EXACT_SEEN) < _PAD_MEMO_MAX:
                _EXACT_SEEN.add(key)
                for b in bufs:
                    weakref.finalize(b, _EXACT_SEEN.discard, key)
        if not seen:
            obs.inc("dj_shape_bucket_total", result="exact")
        return table
    key = (_key_of(bufs), w, raw, target, str_raw, str_tgt)
    while True:
        with _pad_lock:
            hit = _PAD_MEMO.get(key)
            if hit is not None:
                break
            ev = _PAD_INFLIGHT.get(key)
            if ev is None:
                _PAD_INFLIGHT[key] = threading.Event()
                break  # this thread pads
        ev.wait()
    if hit is not None:
        obs.inc("dj_shape_bucket_total", result="memo_hit")
        return hit
    try:
        padded = _pad(table, w, raw, target, tuple(zip(str_raw, str_tgt)))
        # The aliases go in before the memo publishes the pad.
        for oc, pc in zip(table.columns, padded.columns):
            if isinstance(oc, Column):
                _ALIAS[id(pc.data)] = (weakref.ref(oc.data), oc.data._version, pc.data._version)
                weakref.finalize(pc.data, _ALIAS.pop, id(pc.data), None)
        with _pad_lock:
            if len(_PAD_MEMO) < _PAD_MEMO_MAX:
                _PAD_MEMO[key] = padded
                for b in bufs:
                    weakref.finalize(b, _PAD_MEMO.pop, key, None)
    finally:
        with _pad_lock:
            ev = _PAD_INFLIGHT.pop(key, None)
        if ev is not None:
            ev.set()
    obs.inc("dj_shape_bucket_total", result="pad")
    obs.record("shape_bucket", raw_rows=raw, bucket_rows=target,
               pad_fraction=round(1.0 - raw / target, 4), raw_chars=list(str_raw),
               bucket_chars=list(str_tgt))
    return padded

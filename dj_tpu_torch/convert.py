"""Carry tables, join configs and prepared sides between dj_tpu and
dj_tpu_torch.

The two packages share no code, so the meeting point is plain data: a
table as a list of numpy column arrays (a string column as its
(offsets, chars) pair), their logical dtype names and a valid row count; a config as its field values; a prepared side as its
plan fields and its batches' arrays. This module imports neither JAX nor
dj_tpu; the caller converts dj_tpu arrays with ``np.asarray`` and builds
dj_tpu tables from the arrays it gets back, ``prepared_side_from``
reads a dj_tpu PreparedSide by attribute name, converting each array
with ``np.asarray``, and ``compression_options_from`` reads a
compression options tree by field name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .compress import cascaded as cz
from .core import dtypes as dt
from .core.table import Column, StringColumn, Table
from .ops.join import PreparedPackPlan
from .parallel import communicator
from .parallel.dist_join import BatchSizing, JoinConfig, PreparedSide
from .parallel.topology import Topology


def table_from_numpy(
    arrays: Sequence[np.ndarray],
    dtype_names: Sequence[str],
    valid_count: Optional[int] = None,
    device="cuda",
) -> Table:
    """A dj_tpu_torch Table from column arrays and logical dtype names
    (``Column.dtype.name`` on the dj_tpu side). A "string" column's
    entry is its (offsets, chars) pair (``StringColumn.offsets`` and
    ``.chars`` on the dj_tpu side)."""
    cols = []
    for a, name in zip(arrays, dtype_names, strict=True):
        d = dt.by_name(name)
        if d.kind == "string":
            offsets, chars = (torch.from_numpy(np.array(x, dtype=t)).to(device)
                              for x, t in zip(a, (np.int32, np.uint8), strict=True))
            cols.append(StringColumn(offsets, chars, d))
            continue
        a = np.array(a, dtype=d.physical)  # a writable copy
        cols.append(Column(torch.from_numpy(a).to(device), d))
    vc = None
    if valid_count is not None:
        vc = torch.tensor(int(valid_count), dtype=torch.int32, device=device)
    return Table(tuple(cols), vc)


def table_to_numpy(table: Table) -> tuple[list[np.ndarray], list[str], Optional[int]]:
    """(column arrays, logical dtype names, valid count or None); a
    string column's array is its (offsets, chars) pair."""
    arrays = [(c.offsets.cpu().numpy(), c.chars.cpu().numpy()) if isinstance(c, StringColumn)
              else c.data.cpu().numpy() for c in table.columns]
    names = [c.dtype.name for c in table.columns]
    vc = None if table.valid_count is None else int(table.valid_count)
    return arrays, names, vc


def compression_options_from(tree):
    """The port's options for any compression options tree, read by field
    name (``method``, ``cascaded.num_rles`` / ``num_deltas`` /
    ``use_bp``, ``wire_factor``, ``children``): a table's tuple of
    column options gives a tuple, one column's options a
    ColumnCompressionOptions, None gives None."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return tuple(compression_options_from(o) for o in tree)
    c = tree.cascaded
    return cz.ColumnCompressionOptions(
        method=str(tree.method),
        cascaded=cz.CascadedOptions(int(c.num_rles), int(c.num_deltas), bool(c.use_bp)),
        wire_factor=float(tree.wire_factor),
        children=tuple(compression_options_from(ch) for ch in tree.children),
    )


def join_config_from(config) -> JoinConfig:
    """A JoinConfig with the same values of every field this port has,
    read by name from another config object (dj_tpu's JoinConfig). The
    communicator class maps to the port's class of the same name, the
    compression options through ``compression_options_from``."""
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(JoinConfig)}
    fields["communicator_cls"] = getattr(communicator, fields["communicator_cls"].__name__)
    for side in ("left_compression", "right_compression"):
        fields[side] = compression_options_from(fields[side])
    return JoinConfig(**fields)


def prepared_side_from(prepared, topology: Topology) -> PreparedSide:
    """The port's PreparedSide holding the state of a dj_tpu
    PreparedSide of any tier on ``topology``'s device: the plan fields,
    sizes (``r_cap`` grown by any append), config, tier, salt set and
    salt replicas by name, the sorted words (u64, kept as their int64
    bit patterns), payload tables (string columns as their offsets and
    chars) and counts of every batch (one replicated batch on the
    broadcast tier), and the source table, through ``np.asarray``."""
    dev = topology.device

    def tensor(a, dtype=None):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a if dtype is None else a.view(dtype))).to(dev)

    def table(t) -> Table:
        return table_from_numpy(
            [(np.asarray(c.offsets), np.asarray(c.chars)) if hasattr(c, "chars")
             else np.asarray(c.data) for c in t.columns],
            [c.dtype.name for c in t.columns], device=dev,
        )

    batches = tuple(
        (tensor(words, np.int64), table(payload), tensor(counts))
        for words, payload, counts in prepared.batches
    )
    return PreparedSide(
        topology=topology,
        config=join_config_from(prepared.config),
        right_on=tuple(prepared.right_on),
        key_range=tuple((int(lo), int(hi)) for lo, hi in prepared.key_range),
        plan=PreparedPackPlan(*prepared.plan),
        n=int(prepared.n),
        sizing=BatchSizing(*(int(v) for v in prepared.sizing)),
        l_cap=int(prepared.l_cap),
        r_cap=int(prepared.r_cap),
        batches=batches,
        right=table(prepared.right),
        right_counts=tensor(prepared.right_counts),
        tier=str(prepared.tier),
        salt=tuple(int(p) for p in prepared.salt),
        salt_replicas=int(prepared.salt_replicas),
    )

"""Carry tables and join configs between dj_tpu and dj_tpu_torch.

The two packages share no code, so the meeting point is plain data: a
table as a list of numpy column arrays, their logical dtype names and a
valid row count; a config as its field values. This module imports
neither JAX nor dj_tpu; the caller converts dj_tpu arrays with
``np.asarray`` and builds dj_tpu tables from the arrays it gets back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .core import dtypes as dt
from .core.table import Column, Table
from .parallel.dist_join import JoinConfig


def table_from_numpy(
    arrays: Sequence[np.ndarray],
    dtype_names: Sequence[str],
    valid_count: Optional[int] = None,
    device="cuda",
) -> Table:
    """A dj_tpu_torch Table from column arrays and logical dtype names
    (``Column.dtype.name`` on the dj_tpu side). String columns raise
    NotImplementedError."""
    cols = []
    for a, name in zip(arrays, dtype_names, strict=True):
        d = dt.by_name(name)
        a = np.ascontiguousarray(np.asarray(a, dtype=d.physical))
        cols.append(Column(torch.from_numpy(a).to(device), d))
    vc = None
    if valid_count is not None:
        vc = torch.tensor(int(valid_count), dtype=torch.int32, device=device)
    return Table(tuple(cols), vc)


def table_to_numpy(table: Table) -> tuple[list[np.ndarray], list[str], Optional[int]]:
    """(column arrays, logical dtype names, valid count or None)."""
    arrays = [c.data.cpu().numpy() for c in table.columns]
    names = [c.dtype.name for c in table.columns]
    vc = None if table.valid_count is None else int(table.valid_count)
    return arrays, names, vc


def join_config_from(config) -> JoinConfig:
    """A JoinConfig with the same values of every field this port has,
    read by name from another config object (dj_tpu's JoinConfig)."""
    return JoinConfig(
        **{f.name: getattr(config, f.name) for f in dataclasses.fields(JoinConfig)}
    )

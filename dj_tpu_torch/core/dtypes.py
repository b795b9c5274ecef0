"""Logical dtype model for columnar tables (fixed-width types).

Counterpart of ``dj_tpu/core/dtypes.py``: a column keeps its logical
dtype as metadata beside a torch tensor of the physical dtype. Temporal
types are stored as their int64 tick counts, exactly as in the JAX
package. Strings are not part of this slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DType:
    """A logical column dtype.

    ``physical`` is the numpy dtype of the stored values; ``kind`` is one
    of {"int", "uint", "float", "timestamp", "duration"}.
    """

    name: str
    physical: Any
    kind: str

    @property
    def itemsize(self) -> int:
        return np.dtype(self.physical).itemsize

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_BY_NUMPY[np.dtype(self.physical)]

    def __repr__(self) -> str:
        return f"DType({self.name})"


int8 = DType("int8", np.int8, "int")
int16 = DType("int16", np.int16, "int")
int32 = DType("int32", np.int32, "int")
int64 = DType("int64", np.int64, "int")
uint8 = DType("uint8", np.uint8, "uint")
uint16 = DType("uint16", np.uint16, "uint")
uint32 = DType("uint32", np.uint32, "uint")
uint64 = DType("uint64", np.uint64, "uint")
float32 = DType("float32", np.float32, "float")
float64 = DType("float64", np.float64, "float")

timestamp_s = DType("timestamp_s", np.int64, "timestamp")
timestamp_ms = DType("timestamp_ms", np.int64, "timestamp")
timestamp_us = DType("timestamp_us", np.int64, "timestamp")
timestamp_ns = DType("timestamp_ns", np.int64, "timestamp")
duration_s = DType("duration_s", np.int64, "duration")
duration_ms = DType("duration_ms", np.int64, "duration")
duration_us = DType("duration_us", np.int64, "duration")
duration_ns = DType("duration_ns", np.int64, "duration")

_BY_NAME = {
    d.name: d
    for d in [
        int8, int16, int32, int64,
        uint8, uint16, uint32, uint64,
        float32, float64,
        timestamp_s, timestamp_ms, timestamp_us, timestamp_ns,
        duration_s, duration_ms, duration_us, duration_ns,
    ]
}

TORCH_BY_NUMPY = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def by_name(name: str) -> DType:
    if name == "string":
        raise NotImplementedError(
            "string columns come with a later slice of the port"
        )
    return _BY_NAME[name]


def from_torch(dtype: torch.dtype) -> DType:
    """Logical dtype for a raw torch dtype (its plain numeric name)."""
    return _BY_NAME[str(dtype).removeprefix("torch.")]


def is_integer(d: DType) -> bool:
    return d.kind in ("int", "uint", "timestamp", "duration")


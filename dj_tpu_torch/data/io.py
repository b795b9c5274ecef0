"""Host-side columnar IO: parquet/arrow ingestion into Tables.

Counterpart of ``dj_tpu/data/io.py``, with the same six functions and
behavior. IO stays on the host (pyarrow) and converts to the port's
columnar model at the ingest boundary: a fixed-width arrow column
becomes a ``Column`` of a CPU tensor (temporal types collapse to their
integer tick dtype through ``core.dtypes.by_name``, ``date32`` to
int32), a string or binary column becomes a ``StringColumn`` (int32
offsets, uint8 chars). The tables are host tables: ``shard_table``
places them on the devices of its topology.

Null policy: the device model carries no validity bitmap, so nulls are
resolved at ingest, as the reference drops them right after its read
(cudf::drop_nulls). ``drop_nulls`` filters rows on the host; the nulls
left in a column become zeros, or empty strings.

pyarrow is imported inside the functions only, so this module imports
on a machine without it (the card's has none); a reader called there
raises ``ImportError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.table import Column, StringColumn, Table

_ARROW_FIXED = {
    "int8": dt.int8, "int16": dt.int16, "int32": dt.int32, "int64": dt.int64,
    "uint8": dt.uint8, "uint16": dt.uint16, "uint32": dt.uint32,
    "uint64": dt.uint64, "float": dt.float32, "float32": dt.float32,
    "double": dt.float64, "float64": dt.float64,
}


def _arrow():
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet  # noqa: F401
        return pyarrow
    except ImportError as e:
        raise ImportError(
            "parquet/arrow IO requires pyarrow; install it or use the "
            "synthetic generators in dj_tpu.data.generator"
        ) from e


def _temporal_dtype(arrow_type) -> Optional[dt.DType]:
    import pyarrow.types as pt

    if pt.is_timestamp(arrow_type):
        return dt.by_name(f"timestamp_{arrow_type.unit}")
    if pt.is_duration(arrow_type):
        return dt.by_name(f"duration_{arrow_type.unit}")
    if pt.is_date32(arrow_type):
        # Days since the epoch, stored as int32 (the TPC-H date columns).
        return dt.int32
    return None


def column_from_arrow(arr) -> Column | StringColumn:
    """Convert one arrow ChunkedArray/Array to a column of CPU tensors.

    Nulls must already be resolved (see drop_nulls); the nulls left in a
    fixed-width column become zeros, in a string column empty strings."""
    import pyarrow as pa
    import pyarrow.types as pt

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    if pt.is_string(t) or pt.is_large_string(t) or pt.is_binary(t):
        # Normalise to non-large offsets; nulls -> empty strings.
        arr = arr.cast(pa.binary()).fill_null(b"")
        np_strings = arr.to_numpy(zero_copy_only=False)
        sizes = np.fromiter((len(s) for s in np_strings), np.int32, count=len(np_strings))
        offsets = np.zeros(len(np_strings) + 1, np.int32)
        np.cumsum(sizes, out=offsets[1:])
        chars = (np.frombuffer(b"".join(np_strings), np.uint8).copy() if offsets[-1]
                 else np.zeros((1,), np.uint8))
        return StringColumn(torch.from_numpy(offsets), torch.from_numpy(chars))
    d = _temporal_dtype(t)
    if d is None:
        d = _ARROW_FIXED.get(str(t))
    if d is None:
        raise TypeError(f"unsupported arrow type for device columns: {t}")
    np_vals = arr.fill_null(0).to_numpy(zero_copy_only=False)
    np_vals = np.ascontiguousarray(np_vals).astype(np.dtype(d.physical), copy=False)
    return Column(torch.from_numpy(np_vals.copy()), d)


def from_arrow(table) -> Table:
    """Convert a pyarrow Table to a host Table."""
    return Table(tuple(column_from_arrow(table.column(i)) for i in range(table.num_columns)))


def drop_nulls(table, subset: Sequence[int]):
    """Drop rows with nulls in any of the ``subset`` columns (arrow-level),
    as cudf::drop_nulls(view, keys, keep_threshold=len(keys))."""
    import pyarrow.compute as pc

    mask = None
    for i in subset:
        valid = pc.is_valid(table.column(i))
        mask = valid if mask is None else pc.and_(mask, valid)
    return table.filter(mask) if mask is not None else table


def read_parquet(path: str, columns: Optional[Sequence[str]] = None) -> Table:
    """Read a parquet file into a host Table."""
    pa = _arrow()
    return from_arrow(pa.parquet.read_table(path, columns=list(columns) if columns else None))


def read_parquet_arrow(path: str, columns: Optional[Sequence[str]] = None):
    """Read a parquet file as a pyarrow Table (for filtering before ingest)."""
    pa = _arrow()
    return pa.parquet.read_table(path, columns=list(columns) if columns else None)


def table_data_nbytes(t: Table) -> int:
    """Valid-data byte size for throughput accounting (host tables only),
    the analogue of the reference's calculate_table_size."""
    n = 0
    for c in t.columns:
        if isinstance(c, StringColumn):
            n += int(c.offsets[-1]) + c.offsets.shape[0] * 4
        else:
            n += c.size * c.dtype.itemsize
    return n

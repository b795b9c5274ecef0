"""The byte model of the broadcast tier's fit.

Counterpart of ``dj_tpu/obs/bytemodel.py:31-38`` (``buffer_bytes``) and
``:68-86`` (``replicated_table_bytes``). Duck-typed over the table's
columns (a string column has ``.chars``), so it imports no table code.
"""

from __future__ import annotations


def buffer_bytes(shape, itemsize: int) -> int:
    """Bytes of one buffer of ``shape`` and ``itemsize``-byte elements."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * int(itemsize)


def replicated_table_bytes(table) -> int:
    """The buffer bytes of every column of ``table`` (a string column's
    int32 offsets and uint8 chars): what one rank holds once the
    broadcast tier has gathered the table, when ``table`` is the global
    one. The broadcast fit prices it against ``DJT_BROADCAST_BYTES``."""
    total = 0
    for c in table.columns:
        if hasattr(c, "chars"):
            total += buffer_bytes(c.offsets.shape, 4)
            total += buffer_bytes(c.chars.shape, 1)
        else:
            total += buffer_bytes(c.data.shape, c.data.element_size())
    return total

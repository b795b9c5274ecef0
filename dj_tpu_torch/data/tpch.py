"""TPC-H-shaped tables: orders, lineitem and customer of one split.

Counterpart of ``scripts/make_tpch_sample.py::make_split`` without its
parquet output: the same draws from ``np.random.default_rng(seed +
split)`` in the same order give the same columns, built as port Tables
on the caller's device. A split is one GPU's share of a TPC-H scale, as
the reference's ``tpch.cpp`` gives each GPU one split: unique
``O_ORDERKEY`` in [split * n_orders, (split + 1) * n_orders), shuffled;
``O_CUSTKEY`` drawn from every split's customers; Poisson
``lineitems_per_order`` rows of lineitem per order, shuffled; unique
``C_CUSTKEY`` in the split's own customer range. ``O_ORDERPRIORITY`` and
``C_MKTSEGMENT`` are string columns, built as offsets and chars from the
drawn indices without a loop over rows.

``customer_names`` renders TPC-H's ``C_NAME`` ("Customer#%09d" of a
custkey, 18 bytes) as a string column, so that a join can key on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.table import Column, StringColumn, Table, sizes_to_offsets

PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
NAME_PREFIX = b"Customer#"
NAME_DIGITS = 9


def _pick_strings(words, idx: np.ndarray, device) -> StringColumn:
    """The string column whose row i is ``words[idx[i]]``: the sizes
    gathered and scanned into offsets, each byte read from the words'
    concatenation at its row's word start plus its place in the row."""
    enc = [w.encode() for w in words]
    lens = torch.tensor([len(w) for w in enc], dtype=torch.int32, device=device)
    flat = torch.frombuffer(bytearray(b"".join(enc)), dtype=torch.uint8).to(device)
    word_start = sizes_to_offsets(lens)[:-1]
    code = torch.from_numpy(idx).to(device)
    sizes = lens[code]
    offsets = sizes_to_offsets(sizes)
    nbytes = int(offsets[-1])
    row = torch.repeat_interleave(torch.arange(code.shape[0], device=device), sizes,
                                  output_size=nbytes)
    src = word_start[code][row] + torch.arange(nbytes, dtype=torch.int32, device=device)
    src -= offsets[row]
    chars = flat[src] if nbytes else torch.zeros(1, dtype=torch.uint8, device=device)
    return StringColumn(offsets, chars)


def customer_names(custkey: torch.Tensor) -> StringColumn:
    """``C_NAME`` of each custkey: "Customer#" and the key in 9 digits,
    zero-padded (keys in [0, 10^9))."""
    n = custkey.shape[0]
    dev = custkey.device
    width = len(NAME_PREFIX) + NAME_DIGITS
    mat = torch.empty((n, width), dtype=torch.uint8, device=dev)
    mat[:, : len(NAME_PREFIX)] = torch.frombuffer(bytearray(NAME_PREFIX),
                                                  dtype=torch.uint8).to(dev)
    k = custkey.to(torch.int64)
    for d in range(NAME_DIGITS):
        place = 10 ** (NAME_DIGITS - 1 - d)
        mat[:, len(NAME_PREFIX) + d] = (k // place % 10 + ord("0")).to(torch.uint8)
    offsets = torch.arange(0, width * (n + 1), width, dtype=torch.int32, device=dev)
    chars = mat.reshape(-1) if n else torch.zeros(1, dtype=torch.uint8, device=dev)
    return StringColumn(offsets, chars)


def make_split(
    split: int,
    n_orders: int,
    seed: int,
    lineitems_per_order: float,
    n_customers: int,
    n_customers_total: int,
    device="cuda",
) -> tuple[Table, Table, Table]:
    """(orders, lineitem, customer) of one split, exact tables on
    ``device``: orders (O_ORDERKEY, O_CUSTKEY, O_ORDERPRIORITY),
    lineitem (L_ORDERKEY, L_PARTKEY, L_QUANTITY), customer (C_CUSTKEY,
    C_MKTSEGMENT), with the values ``make_split`` of
    scripts/make_tpch_sample.py draws for the same arguments."""
    rng = np.random.default_rng(seed + split)
    base = split * n_orders
    o_orderkey = np.arange(base, base + n_orders, dtype=np.int64)
    rng.shuffle(o_orderkey)
    priority = rng.integers(0, len(PRIORITIES), n_orders)
    o_custkey = rng.integers(0, n_customers_total, n_orders).astype(np.int64)
    n_items = rng.poisson(lineitems_per_order, n_orders)
    l_orderkey = np.repeat(o_orderkey, n_items)
    rng.shuffle(l_orderkey)
    n_li = l_orderkey.shape[0]
    l_partkey = rng.integers(0, n_orders * 4, n_li).astype(np.int64)
    l_quantity = rng.integers(1, 51, n_li).astype(np.int64)
    c_custkey = np.arange(split * n_customers, (split + 1) * n_customers, dtype=np.int64)
    rng.shuffle(c_custkey)
    segment = rng.integers(0, len(SEGMENTS), n_customers)

    def col(a):
        return Column(torch.from_numpy(a).to(device), dt.int64)

    orders = Table((col(o_orderkey), col(o_custkey), _pick_strings(PRIORITIES, priority, device)))
    lineitem = Table((col(l_orderkey), col(l_partkey), col(l_quantity)))
    customer = Table((col(c_custkey), _pick_strings(SEGMENTS, segment, device)))
    return orders, lineitem, customer

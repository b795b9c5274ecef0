"""TPC-H's orders JOIN lineitem on the orderkey, one split of the scale, as
rapidsai/distributed-join ``benchmark/tpch.cpp`` joins it
(``datagen.tpch_split``): orders(o_orderkey, o_orderpriority, a string)
JOIN lineitem(l_orderkey).

The answer's rows are (orderkey, priority), one a lineitem. The control,
``truncate_strings``, carries each priority in a fixed 8-byte field (a
string packed into one 64-bit word).
"""

from __future__ import annotations

import torch

from joinbench import datagen, reference

ORDERS_A_SCALE = 1_500_000
CONTROLS = ("truncate_strings",)
KEYS = {"kind": None, "scale_factor": None, "splits": None, "split": None,
        "orders_rows": None, "lineitems_min": None, "lineitems_max": None,
        "key_type": ("int64",), "join_config": None, "control": CONTROLS}


def check(cfg: dict, traffic: dict) -> None:
    if cfg["orders_rows"] != ORDERS_A_SCALE * cfg["scale_factor"] // cfg["splits"]:
        raise ValueError("orders_rows is not the scale's orders over its splits")
    if not 0 <= cfg["split"] < cfg["splits"]:
        raise ValueError("split lies outside the splits")


def inputs(cfg: dict, seed: int, device, probe: bool = True) -> dict:
    return datagen.tpch_split(datagen.generator(device, seed, 0), cfg["split"],
                              cfg["orders_rows"], cfg["lineitems_min"], cfg["lineitems_max"])


def sides(inputs: dict) -> tuple:
    return [inputs["o_orderkey"], inputs["o_orderpriority"]], [inputs["l_orderkey"]]


def on(cfg: dict) -> tuple:
    return (0,), (0,)


def expected_count(inputs: dict) -> int:
    """Every lineitem has its order."""
    return int(inputs["l_orderkey"].shape[0])


def expected_rows(inputs: dict) -> tuple:
    """The reference's answer: (the orderkey of each lineitem's order, a
    string view (offsets, chars, rows) of its priority)."""
    li, _ = reference.match_pairs(inputs["o_orderkey"], inputs["l_orderkey"])
    off, chars = inputs["o_orderpriority"]
    return inputs["o_orderkey"][li], (off, chars, li)


def rows_wrong(inputs: dict, got: list) -> int:
    keys, (off, chars) = got
    want_keys, want_view = expected_rows(inputs)
    view = (off, chars, torch.arange(keys.shape[0], device=keys.device))
    return reference.keyed_string_rows_wrong(keys, view, want_keys, want_view)


def control(mode: str, left: list, right: list) -> list:
    if mode != "truncate_strings":
        raise ValueError(f"unknown control {mode!r}")
    li, _ = reference.match_pairs(left[0], right[0])
    off, chars = left[1]
    return [left[0][li], reference.truncate_strings(off, chars, li)]


def tiny(cfg: dict, rows: int) -> dict:
    """A quarter as many orders as ``rows``."""
    return dict(cfg, orders_rows=rows // 4)

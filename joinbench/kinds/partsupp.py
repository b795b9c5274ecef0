"""TPC-H's lineitem JOIN partsupp on (partkey, suppkey), Q9's join of the
two tables (``ps_suppkey = l_suppkey and ps_partkey = l_partkey``),
unfiltered, on Q9's columns: one GPU's share after a hash shuffle on the
pair.

partsupp holds 4 suppliers a part by TPC-H's rule (clause 4.2.3):
``ps_suppkey = (partkey + i * (S / 4 + (partkey - 1) / S)) mod S + 1``
for i in 0..3, S the scale's suppliers. The share keeps the pairs whose
64-bit mix (``reference._mix64`` of ``partkey * (S + 1) + suppkey``) is
``split`` modulo ``splits``, shuffled. Each lineitem is one of the kept
pairs, uniform (TPC-H draws the part and then one of its 4 suppliers
uniformly), with dbgen's sparse orderkey of a uniform order of the
scale, a quantity of 1-50, TPC-H's retail price rule for the extended
price and a discount of 0-10; prices in int64 hundredths. So every
lineitem matches exactly one partsupp row, and the keys span the
scale's whole domains.

The answer's rows are (l_partkey, l_suppkey, l_orderkey, l_quantity,
l_extendedprice, l_discount, ps_supplycost). The control,
``partkey_only``, matches on the partkey alone: a lineitem then also
meets the share's other suppliers of its part.
"""

from __future__ import annotations

import torch

from joinbench import datagen, reference

PARTS_A_SCALE = 200_000
SUPPLIERS_A_SCALE = 10_000
LINEITEMS_A_SCALE = 6_000_000
ORDERS_A_SCALE = 1_500_000
SUPPLIERS_A_PART = 4
CONTROLS = ("partkey_only",)
KEYS = {"kind": None, "scale_factor": None, "splits": None, "split": None, "parts": None,
        "suppliers": None, "lineitems": None, "key_type": ("int64",), "join_config": None,
        "control": CONTROLS}


def check(cfg: dict, traffic: dict) -> None:
    sf = cfg["scale_factor"]
    if cfg["parts"] != PARTS_A_SCALE * sf:
        raise ValueError("parts is not the scale's parts")
    if cfg["suppliers"] != SUPPLIERS_A_SCALE * sf:
        raise ValueError("suppliers is not the scale's suppliers")
    if cfg["lineitems"] != LINEITEMS_A_SCALE * sf // cfg["splits"]:
        raise ValueError("lineitems is not the scale's lineitems over its splits")
    if not 0 <= cfg["split"] < cfg["splits"]:
        raise ValueError("split lies outside the splits")


def _suppkey(part: torch.Tensor, i: torch.Tensor, s: int) -> torch.Tensor:
    return (part + i * (s // 4 + (part - 1) // s)) % s + 1


def inputs(cfg: dict, seed: int, device, probe: bool = True) -> dict:
    """The share's tables, every column int64. ``parts`` of the scale's
    ``PARTS_A_SCALE * scale_factor`` are drawn, evenly spaced over its
    partkeys (all of them at full size)."""
    gen = datagen.generator(device, seed, 0)
    s = cfg["suppliers"]
    stride = PARTS_A_SCALE * cfg["scale_factor"] // cfg["parts"]
    part = (torch.arange(cfg["parts"], dtype=torch.int64, device=device) * stride + 1
            ).repeat_interleave(SUPPLIERS_A_PART)
    supp = _suppkey(part, torch.arange(SUPPLIERS_A_PART, device=device).repeat(cfg["parts"]), s)
    kept = reference._mix64(part * (s + 1) + supp) % cfg["splits"] == cfg["split"]
    part, supp = part[kept], supp[kept]
    del kept
    order = torch.randperm(part.shape[0], generator=gen, device=device)
    ps_partkey, ps_suppkey = part[order], supp[order]
    del part, supp, order
    ps_supplycost = torch.randint(100, 100_001, ps_partkey.shape, generator=gen, device=device)
    n = cfg["lineitems"]
    pick = torch.randint(0, ps_partkey.shape[0], (n,), generator=gen, device=device)
    l_partkey, l_suppkey = ps_partkey[pick], ps_suppkey[pick]
    del pick
    g = torch.randint(0, ORDERS_A_SCALE * cfg["scale_factor"], (n,), generator=gen,
                      device=device)
    l_orderkey = (g // 8) * 32 + g % 8 + 1
    del g
    l_quantity = torch.randint(1, 51, (n,), generator=gen, device=device)
    retail = 90_000 + (l_partkey // 10) % 20_001 + 100 * (l_partkey % 1000)
    l_extendedprice = l_quantity * retail
    del retail
    l_discount = torch.randint(0, 11, (n,), generator=gen, device=device)
    return {"l_partkey": l_partkey, "l_suppkey": l_suppkey, "l_orderkey": l_orderkey,
            "l_quantity": l_quantity, "l_extendedprice": l_extendedprice,
            "l_discount": l_discount, "ps_partkey": ps_partkey, "ps_suppkey": ps_suppkey,
            "ps_supplycost": ps_supplycost}


def sides(inputs: dict) -> tuple:
    """lineitem JOIN partsupp."""
    return ([inputs[k] for k in ("l_partkey", "l_suppkey", "l_orderkey", "l_quantity",
                                 "l_extendedprice", "l_discount")],
            [inputs["ps_partkey"], inputs["ps_suppkey"], inputs["ps_supplycost"]])


def on(cfg: dict) -> tuple:
    return (0, 1), (0, 1)


def expected_count(inputs: dict) -> int:
    """Every lineitem has its partsupp row."""
    return int(inputs["l_partkey"].shape[0])


def _rows(left: list, right: list, li: torch.Tensor, ri: torch.Tensor) -> list:
    return [c[li] for c in left] + [right[2][ri]]


def expected_rows(inputs: dict) -> list:
    """The reference's rows: each lineitem's six columns and its
    partsupp's supplycost."""
    left, right = sides(inputs)
    li, ri = reference.match_pairs(left[:2], right[:2])
    return _rows(left, right, li, ri)


def rows_wrong(inputs: dict, got: list) -> int:
    return reference.rows_wrong_int(got, expected_rows(inputs))


def control(mode: str, left: list, right: list) -> list:
    if mode != "partkey_only":
        raise ValueError(f"unknown control {mode!r}")
    li, ri = reference.match_pairs(left[0], right[0])
    return _rows(left, right, li, ri)


def tiny(cfg: dict, rows: int) -> dict:
    """``rows`` lineitems and about ``rows`` partsupp rows (8 x ``rows``
    pairs of ``2 x rows`` parts spread over the scale's partkeys); the
    key domains stay the scale's."""
    return dict(cfg, parts=2 * rows, lineitems=rows)

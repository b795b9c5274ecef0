"""The reference's int64 join: a probe table JOIN a build table of unique
int64 keys, each with an int64 payload (rapidsai/distributed-join
``benchmark/distributed_join.cu``; ``datagen.build_probe``).

The answer's rows are [key, probe payload, build payload]. The control,
``hash32_keys``, matches rows on 32 bits of a hash of the keys,
unverified: the width below the configuration's int64 keys. A world
gives each rank its share of one draw over the whole world
(``datagen.world_build_probe``); the row of an answer belongs to the
rank that holds its probe row, whose global row id is the probe payload.
"""

from __future__ import annotations

import torch

from joinbench import datagen, reference

CONTROLS = ("hash32_keys",)
KEYS = {"kind": None, "build_rows": None, "probe_rows": None, "selectivity": None,
        "rand_max": None, "join_config": None, "control": CONTROLS,
        "key_type": ("int64",), "payload_type": ("int64",), "unique_build_keys": (True,)}


def check(cfg: dict, traffic: dict) -> None:
    if traffic.get("ranks", 1) > 1 and cfg["rand_max"] != 2 * cfg["build_rows"]:
        raise ValueError("a world draws its keys from [0, 2 x its build rows]: "
                         "rand_max must be 2 x build_rows")


def inputs(cfg: dict, seed: int, device, probe: bool = True) -> dict:
    return datagen.build_probe(datagen.generator(device, seed, 0), cfg["build_rows"],
                               cfg["probe_rows"] if probe else 0, cfg["selectivity"],
                               cfg["rand_max"])


def sides(inputs: dict) -> tuple:
    """probe JOIN build."""
    return ([inputs["probe_keys"], inputs["probe_payload"]],
            [inputs["build_keys"], inputs["build_payload"]])


def on(cfg: dict) -> tuple:
    return (0,), (0,)


def expected_count(inputs: dict) -> torch.Tensor:
    return inputs["matches"]


def expected_rows(inputs: dict) -> list:
    """The reference's rows [key, probe payload, build payload]."""
    return reference.join_rows(inputs["probe_keys"], inputs["probe_payload"],
                               inputs["build_keys"], inputs["build_payload"])


def rows_wrong(inputs: dict, got: list) -> int:
    return reference.rows_wrong_int(got, expected_rows(inputs))


def control(mode: str, left: list, right: list) -> list:
    if mode != "hash32_keys":
        raise ValueError(f"unknown control {mode!r}")
    return reference.join_rows(left[0], left[1], right[0], right[1], reference.hash32)


def tiny(cfg: dict, rows: int) -> dict:
    return dict(cfg, build_rows=rows, probe_rows=rows, rand_max=2 * rows)


# -- an open loop: probe tables drawn query by query against a resident build side --------


def probe(inputs: dict, gen: torch.Generator, rows: int, selectivity: float) -> dict:
    """The inputs of one query: ``rows`` probe rows against the build side."""
    keys, matches = datagen.draw_probe(gen, inputs["build_keys"], inputs["complement"], rows,
                                       selectivity)
    return dict(inputs, probe_keys=keys,
                probe_payload=torch.arange(rows, dtype=torch.int64, device=keys.device),
                matches=matches)


def key_range(cfg: dict) -> tuple:
    return 0, cfg["rand_max"]


# -- a world of ranks ---------------------------------------------------------------------


def world_inputs(cfg: dict, seed: int, rank: int, world: int, device) -> dict:
    return datagen.world_build_probe(device, seed, rank, world, cfg["build_rows"],
                                     cfg["probe_rows"], cfg["selectivity"])


def world_build_side(cfg: dict, seed: int, world: int, device) -> list:
    return list(datagen.world_build_side(device, seed, world, cfg["build_rows"]))


def world_owner(cfg: dict, got: list) -> torch.Tensor:
    return got[1] // cfg["probe_rows"]


def world_rows_wrong(inputs: dict, build: list, got: list) -> int:
    return rows_wrong(dict(inputs, build_keys=build[0], build_payload=build[1]), got)

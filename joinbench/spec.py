"""What a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's
configuration, traffic mix and chips; each configuration is
``configs/<name>.json``, each mix ``traffic/<name>.json`` and each
per-layer metric's reader ``metrics/<name>.py`` beside this file. A
later cell, mix or metric is a new file and a new entry: nothing here
lists them.

``check`` refuses a configuration or mix that sets a key the harness
does not read, or a value it does not implement (``CONFIG_KEYS``,
``TRAFFIC_KEYS``): a file asking for, say, on-off arrivals or repeated
build keys would otherwise run the old traffic under a new name. Such a
cell needs a generator in the harness first.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# Keys that describe a configuration or mix and are read by no code.
TEXT_KEYS = frozenset({"source", "guarantees", "payload", "inputs", "reduced", "assumed"})
# What the harness reads, by a configuration's ``kind`` and a mix's ``loop``: None takes any
# value, a tuple only the values the harness implements.
CONFIG_KEYS = {
    "int64": {"kind": None, "build_rows": None, "probe_rows": None, "selectivity": None,
              "rand_max": None, "join_config": None, "control": ("hash32_keys",),
              "key_type": ("int64",), "payload_type": ("int64",),
              "unique_build_keys": (True,)},
    "tpch": {"kind": None, "scale_factor": None, "splits": None, "split": None,
             "orders_rows": None, "lineitems_min": None, "lineitems_max": None,
             "key_type": ("int64",), "join_config": None, "control": ("truncate_strings",)},
}
TRAFFIC_KEYS = {
    "closed": {"loop": None, "ranks": None, "clients": (1,), "trace_calls": None,
               "join_config": None},
    "open": {"loop": None, "ranks": (1,), "clients": (1,), "arrivals": ("poisson",),
             "sizes": ("log-uniform",), "rate_per_s": None, "schedule_seed": None,
             "probe_rows_min": None, "probe_rows_max": None, "selectivity": None,
             "serve": None, "sample_answers": None, "wait_after_close_s": None,
             "trace_stretch_s": None, "join_config": None},
}
TPCH_ORDERS_A_SCALE = 1_500_000


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple  # the end-to-end metric entries this cell reports
    per_layer: tuple  # the per-layer metric entries this cell reports


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_config(name: str, here: pathlib.Path = HERE) -> dict:
    cfg = json.loads((here / "configs" / f"{name}.json").read_text())
    cfg["name"] = name
    return cfg


def load_traffic(name: str, here: pathlib.Path = HERE) -> dict:
    mix = json.loads((here / "traffic" / f"{name}.json").read_text())
    mix["name"] = name
    return mix


def load_reader(metric: str, here: pathlib.Path = HERE) -> Callable[[dict], Optional[float]]:
    """The ``read(ctx)`` function of ``metrics/<metric>.py``, loaded by
    path (a metric's name may hold dots)."""
    path = here / "metrics" / f"{metric}.py"
    mod_name = "joinbench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {metric} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _check_keys(what: str, data: dict, allowed: dict) -> None:
    for key, value in data.items():
        if key in TEXT_KEYS or key == "name":
            continue
        if key not in allowed:
            raise ValueError(f"{what} sets {key!r}, which the harness does not read")
        if allowed[key] is not None and value not in allowed[key]:
            raise ValueError(f"{what}: {key} = {value!r} is not implemented "
                             f"(only {list(allowed[key])})")


def check(cfg: dict, traffic: dict) -> None:
    """Refuse a configuration or mix the harness would not run as it says."""
    kind, loop = cfg.get("kind"), traffic.get("loop")
    if kind not in CONFIG_KEYS:
        raise ValueError(f"configuration {cfg.get('name')}: unknown kind {kind!r}")
    if loop not in TRAFFIC_KEYS:
        raise ValueError(f"mix {traffic.get('name')}: unknown loop {loop!r}")
    _check_keys(f"configuration {cfg.get('name')}", cfg, CONFIG_KEYS[kind])
    _check_keys(f"mix {traffic.get('name')}", traffic, TRAFFIC_KEYS[loop])
    if kind == "tpch":
        if cfg["orders_rows"] != TPCH_ORDERS_A_SCALE * cfg["scale_factor"] // cfg["splits"]:
            raise ValueError("orders_rows is not the scale's orders over its splits")
        if not 0 <= cfg["split"] < cfg["splits"]:
            raise ValueError("split lies outside the splits")
    if traffic.get("ranks", 1) > 1:
        if kind != "int64":
            raise ValueError("a world of ranks draws int64 tables only")
        if cfg["rand_max"] != 2 * cfg["build_rows"]:
            raise ValueError("a world draws its keys from [0, 2 x its build rows]: "
                             "rand_max must be 2 x build_rows")


def _reported(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its
    ``workloads``, or, without that key, in every cell that reports
    the end-to-end metric it moves (or every cell, for an end-to-end
    metric without the key)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def resolve(workload: str, bench: Optional[dict] = None, here: pathlib.Path = HERE) -> Cell:
    """The cell named ``workload``, with its configuration, mix and
    metrics read from their files."""
    bench = load_benchmark(here.parent) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[workload]
    cfg = load_config(w["config"], here)
    traffic = load_traffic(w["traffic"], here)
    check(cfg, traffic)
    e2e = tuple(m for m in bench["end_to_end"] if _reported(m, workload, set()))
    names = {m["name"] for m in e2e}
    layer = tuple(m for m in bench["per_layer"] if _reported(m, workload, names))
    return Cell(workload, int(w["chips"]), cfg, traffic, e2e, layer)

"""What a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's
configuration, traffic mix and chips; each configuration is
``configs/<name>.json``, its kind ``kinds/<kind>.py``, each mix
``traffic/<name>.json`` and each per-layer metric's reader
``metrics/<name>.py`` beside this file. A later cell, kind, mix or
metric is a new file and a new entry: nothing here lists them.

A kind module draws a configuration's tables and judges the answers
to them; it imports torch, numpy and ``joinbench.datagen`` /
``joinbench.reference`` only, never the program. It gives:

- ``KEYS``: the configuration keys it reads, None for any value or a
  tuple of the values it implements (``control`` among them);
- ``CONTROLS`` and ``control(mode, left, right)``: the columns the
  control answers the join of ``left`` and ``right`` with;
- ``check(cfg, traffic)``: its own consistency checks (raises
  ``ValueError``);
- ``inputs(cfg, seed, device, probe=True)``: the tables on one rank,
  drawn from the seed (``probe`` False: the build side alone);
- ``sides(inputs)``: (left columns, right columns) of the join;
- ``on(cfg)``: (left key columns, right key columns);
- ``expected_count(inputs)``: the exact rows of the join (an int or a
  0-d int64 tensor, which may stay on the device);
- ``rows_wrong(inputs, got)``: rows of the answer ``got`` (its valid
  rows) that differ from the reference's;
- ``tiny(cfg, rows)``: the configuration cut to a CPU test's size.

An open loop also needs ``OPEN_HOOKS``: ``probe(inputs, gen, rows,
selectivity)``, the inputs of one query against the resident build side
(a probe table of ``rows`` rows drawn from ``gen``), and
``key_range(cfg)``, the key range the resident side declares. A world
of ranks needs ``WORLD_HOOKS``: ``world_inputs(cfg, seed, rank, world,
device)``, rank ``rank``'s share of one draw over the world;
``world_build_side(cfg, seed, world, device)``, the whole world's build
side drawn again; ``world_owner(cfg, got)``, the rank that owns each
row of an answer; and ``world_rows_wrong(inputs, build, got)``, rows of
what a rank owns that differ from the reference's join of its probe
side against ``build``.

``check`` refuses a configuration or mix that sets a key the harness
does not read, or a value it does not implement (the kind's ``KEYS``,
``TRAFFIC_KEYS``), and a kind that lacks a hook its loop or its ranks
need: a file asking for, say, on-off arrivals or repeated build keys
would otherwise run the old traffic under a new name. Such a cell needs
a generator in the harness first.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Callable, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# Keys that describe a configuration or mix and are read by no code.
TEXT_KEYS = frozenset({"source", "guarantees", "payload", "inputs", "reduced", "assumed"})
# What the harness reads of a mix, by its ``loop``: None takes any value, a tuple only the
# values the harness implements.
TRAFFIC_KEYS = {
    "closed": {"loop": None, "ranks": None, "clients": (1,), "trace_calls": None,
               "join_config": None},
    "open": {"loop": None, "ranks": (1,), "clients": (1,), "arrivals": ("poisson",),
             "sizes": ("log-uniform",), "rate_per_s": None, "schedule_seed": None,
             "probe_rows_min": None, "probe_rows_max": None, "selectivity": None,
             "serve": None, "sample_answers": None, "wait_after_close_s": None,
             "trace_stretch_s": None, "join_config": None},
}
KIND_HOOKS = ("KEYS", "CONTROLS", "check", "inputs", "sides", "on", "expected_count",
              "rows_wrong", "control", "tiny")
OPEN_HOOKS = ("probe", "key_range")
WORLD_HOOKS = ("world_inputs", "world_build_side", "world_owner", "world_rows_wrong")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple  # the end-to-end metric entries this cell reports
    per_layer: tuple  # the per-layer metric entries this cell reports
    here: pathlib.Path = HERE  # the benchmark's directory: its kinds, configurations, mixes

    @property
    def kind(self) -> ModuleType:
        """The configuration's kind module (``load_kind``)."""
        return load_kind(self.config["kind"], self.here)


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


def _load_path(path: pathlib.Path, mod_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mod_name(prefix: str, name: str) -> str:
    return prefix + name.replace(".", "_").replace("-", "_")


def load_reader(metric: str, here: pathlib.Path = HERE) -> Callable[[dict], Optional[float]]:
    """The ``read(ctx)`` function of ``metrics/<metric>.py``, loaded by
    path (a metric's name may hold dots)."""
    path = here / "metrics" / f"{metric}.py"
    try:
        return _load_path(path, _mod_name("joinbench_metric_", metric)).read
    except FileNotFoundError:
        raise FileNotFoundError(f"no reader for metric {metric} at {path}") from None


def load_kind(kind: str, here: pathlib.Path = HERE) -> ModuleType:
    """The module ``kinds/<kind>.py``, loaded by path; ``ValueError``
    where the benchmark has no such kind."""
    path = here / "kinds" / f"{kind}.py"
    if not isinstance(kind, str) or not path.is_file():
        raise ValueError(f"unknown configuration kind {kind!r}: no {path}")
    return _load_path(path, _mod_name("joinbench_kind_", kind))


def _check_keys(what: str, data: dict, allowed: dict) -> None:
    for key, value in data.items():
        if key in TEXT_KEYS or key == "name":
            continue
        if key not in allowed:
            raise ValueError(f"{what} sets {key!r}, which the harness does not read")
        if allowed[key] is not None and value not in allowed[key]:
            raise ValueError(f"{what}: {key} = {value!r} is not implemented "
                             f"(only {list(allowed[key])})")


def check_traffic(traffic: dict) -> None:
    """Refuse a mix the harness would not run as it says."""
    loop = traffic.get("loop")
    if loop not in TRAFFIC_KEYS:
        raise ValueError(f"mix {traffic.get('name')}: unknown loop {loop!r}")
    _check_keys(f"mix {traffic.get('name')}", traffic, TRAFFIC_KEYS[loop])


def check(cfg: dict, traffic: dict, here: pathlib.Path = HERE) -> ModuleType:
    """Refuse a configuration or mix the harness would not run as it
    says; returns the configuration's kind module."""
    check_traffic(traffic)
    kind = load_kind(cfg.get("kind"), here)
    what = f"configuration {cfg.get('name')} (kind {cfg['kind']})"
    missing = [h for h in KIND_HOOKS if not hasattr(kind, h)]
    if traffic["loop"] == "open":
        missing += [h for h in OPEN_HOOKS if not hasattr(kind, h)]
    if traffic.get("ranks", 1) > 1:
        missing += [h for h in WORLD_HOOKS if not hasattr(kind, h)]
    if missing:
        raise ValueError(f"{what}: its kind lacks {missing}, which the {traffic['loop']} loop "
                         f"of mix {traffic.get('name')} at {traffic.get('ranks', 1)} rank(s) "
                         "needs")
    _check_keys(what, cfg, kind.KEYS)
    kind.check(cfg, traffic)
    return kind


def _reported(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its
    ``workloads``, or, without that key, in every cell that reports
    the end-to-end metric it moves (or every cell, for an end-to-end
    metric without the key)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def find(workload: str, bench: Optional[dict] = None, here: pathlib.Path = HERE) -> Cell:
    """The cell named ``workload``, with its configuration, mix and
    metrics read from their files and its mix checked. Its kind is not
    loaded (a kind imports torch, which the parent of a world never
    does): ``check`` or ``resolve`` checks it."""
    bench = load_benchmark(here.parent) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[workload]
    cfg = load_config(w["config"], here)
    traffic = load_traffic(w["traffic"], here)
    check_traffic(traffic)
    e2e = tuple(m for m in bench["end_to_end"] if _reported(m, workload, set()))
    names = {m["name"] for m in e2e}
    layer = tuple(m for m in bench["per_layer"] if _reported(m, workload, names))
    return Cell(workload, int(w["chips"]), cfg, traffic, e2e, layer, here)


def resolve(workload: str, bench: Optional[dict] = None, here: pathlib.Path = HERE) -> Cell:
    """The cell named ``workload`` (``find``), checked against its kind."""
    cell = find(workload, bench, here)
    check(cell.config, cell.traffic, here)
    return cell

"""The benchmark is driven by data, and imports neither JAX nor the JAX
package; its reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from joinbench import spec

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dj_tpu"}
# Modules that judge or feed the program, and so import nothing of it.
INDEPENDENT = ("reference.py", "datagen.py", "roofline.py", "readers.py", "profiling.py",
               "spec.py", *sorted(str(p.relative_to(HERE)) for p in HERE.glob("kinds/*.py")))


def _imports(path: pathlib.Path) -> set:
    """Top-level names of every module ``path`` imports (absolute)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


BENCH = spec.load_benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = spec.resolve(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["loop"] in ("closed", "open")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_device_gb"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(spec.load_reader(m["name"]))
    moves = {m["moves"] for m in c.per_layer}
    assert moves <= {m["name"] for m in c.end_to_end}


def test_every_config_file_is_named_in_the_benchmark():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
        assert c["file"] == f"joinbench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]


def test_new_config_mix_and_metric_are_found_without_editing_a_file(tmp_path):
    """A later cell adds files and entries: copy the benchmark, add a
    configuration, a mix and a reader, and resolve the new cell."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "joinbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "joinbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    new_cfg = dict(json.loads((HERE / "configs" / "int64-100m.json").read_text()),
                   build_rows=50_000_000)
    (root / "joinbench" / "configs" / "int64-50m.json").write_text(json.dumps(new_cfg))
    (root / "joinbench" / "traffic" / "join.burst.json").write_text(
        json.dumps({"loop": "closed", "ranks": 1, "trace_calls": 2}))
    (root / "joinbench" / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.get('stretch_calls') or 0) or None\n")
    bench["configs"].append({"name": "int64-50m", "source": "a test",
                             "file": "joinbench/configs/int64-50m.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "int64-50m.join.burst", "config": "int64-50m",
                               "traffic": "join.burst", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "input_gb_per_s",
                               "workloads": ["int64-50m.join.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("int64-50m.join.burst", bench, root / "joinbench")
    assert cell.config["build_rows"] == 50_000_000
    assert cell.traffic["trace_calls"] == 2
    assert [m["name"] for m in cell.per_layer if m["name"] == "calls_traced"]
    assert spec.load_reader("calls_traced", root / "joinbench")({"stretch_calls": 3}) == 3.0
    after = {p: p.read_bytes() for p in before}
    assert after == before, "resolving a new cell edited no file that was there"


@pytest.mark.parametrize("path", sorted(str(p.relative_to(HERE)) for p in HERE.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = _imports(HERE / path) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("name", INDEPENDENT)
def test_the_reference_side_imports_nothing_of_the_program(name):
    assert "dj_tpu_torch" not in _imports(HERE / name)


def test_importing_the_reference_loads_no_program_module():
    code = ("import sys; import joinbench.reference, joinbench.datagen, joinbench.roofline; "
            "from joinbench import spec; "
            "[spec.load_kind(p.stem) for p in (spec.HERE / 'kinds').glob('*.py')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'dj_tpu_torch', 'dj_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert out == "[]"


@pytest.mark.parametrize("cell", ["int64-100m.join", "int64-100m.join.w4"])
def test_run_refuses_without_the_cards(cell):
    """No card here: exit non-zero, no result on standard output (a
    world's ranks look for the cards)."""
    p = subprocess.run([sys.executable, "joinbench/run.py", "--workload", cell,
                        "--seed", "3000000001", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=180)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_file_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "joinbench/run.py"]
    assert BENCH["paths"] == ["joinbench"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_the_world_parent_imports_neither_torch_nor_the_program():
    """A world's parent only starts its ranks and joins their reports."""
    code = ("import sys; import joinbench.run, joinbench.world, joinbench.profiling, "
            "joinbench.spec, joinbench.readers; joinbench.spec.find('int64-100m.join.w4'); "
            "[spec_.load_reader(m['name']) for spec_ in [joinbench.spec] "
            "for m in spec_.load_benchmark()['per_layer']]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'dj_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert out == "[]"


def _cell_files(name: str) -> tuple:
    c = spec.resolve(name)
    return dict(c.config), dict(c.traffic)


@pytest.mark.parametrize("cell, where, key, value", [
    ("int64-100m.serve", "traffic", "arrivals", "on-off"),
    ("int64-100m.serve", "traffic", "sizes", "zipf"),
    ("int64-100m.join", "traffic", "clients", 4),
    ("int64-100m.join", "traffic", "probe_zipf_theta", 0.99),
    ("int64-100m.join", "config", "unique_build_keys", False),
    ("int64-100m.join", "config", "key_type", "int32"),
    ("tpch-sf100-split8.join", "config", "orders_rows", 1_000_000),
    ("tpch-sf100-split8.join", "config", "split", 8),
    ("int64-100m.join.w4", "config", "rand_max", 1_000_000_000),
])
def test_a_key_the_harness_does_not_implement_is_refused(cell, where, key, value):
    """A mix or configuration asking for what no generator draws is
    refused, not run as the old traffic under a new name."""
    cfg, traffic = _cell_files(cell)
    (cfg if where == "config" else traffic)[key] = value
    with pytest.raises(ValueError):
        spec.check(cfg, traffic)


def test_the_join_idle_share_counts_collective_kernels_as_idle():
    """An NCCL kernel spins while its rank waits: the join's idle share
    reads the time outside every other operation."""
    read = spec.load_reader("device_idle_pct.join")
    prof = {"window_s": 1.0, "busy_s": 0.96, "busy_ex_collective_s": 0.90}
    assert read({"loop": "closed", "profiles": [prof, prof]}) == pytest.approx(10.0)
    assert read({"loop": "open", "profiles": [prof]}) is None

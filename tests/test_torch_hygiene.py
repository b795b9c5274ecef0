"""Import hygiene of dj_tpu_torch and chip_smoke.py.

The port must not use JAX or anything of the JAX package: importing all
of its modules pulls in neither, and no module (nor chip_smoke.py) names
them in an import. chip_smoke.py must fail, printing no result, without
a CUDA device and without the package beside it.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "dj_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dj_tpu")


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _run(args, cwd, timeout=120):
    # -I: ignore PYTHONPATH and user site, so nothing outside the
    # checkout can import JAX behind the test's back.
    return subprocess.run(
        [sys.executable, "-I", *args], cwd=cwd, capture_output=True, text=True,
        timeout=timeout,
    )


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    for m in ("ops.scan", "convert", "ops.merge", "ops.expand", "resilience.errors",
              "hw.probe_sort", "hw.probe_gather", "parallel.spmd", "parallel.communicator",
              "parallel.bootstrap", "parallel.topology", "data.generator",
              "compress.cascaded", "parallel.warmup"):
        assert f"dj_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_no_module_names_jax_or_dj_tpu():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "torch_world_worker.py"]
    for p in files:
        for node in ast.walk(ast.parse(p.read_text(), filename=str(p))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{p}: imports {n}"


def test_chip_smoke_fails_without_a_card():
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert r.stdout == ""


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout

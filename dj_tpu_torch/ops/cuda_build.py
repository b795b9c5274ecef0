"""Build and load the port's hand-written CUDA kernels.

Each ``dj_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``dj_tpu_torch/_build/`` (listed in .gitignore), then loaded with
ctypes; ``csrc/*.cuh`` are headers the sources share. The library's
file name carries a hash of its source and the headers, so an edited
source rebuilds and an unchanged one is reused. The first call
starts one ``nvcc`` per missing source, all at once, and waits for all;
nothing is compiled when a module is imported. A kernel that does not
build, load or launch raises ``resilience.errors.KernelError``, which
the degradation ladder never turns into a pin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

from ..resilience.errors import KernelError

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    # The shared headers are part of every source they may be included in.
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every source whose library is missing, in parallel.
    Returns {kernel name: library path}. Raises with nvcc's output on
    any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _lib_path(src)) for src in sources()}
    procs = []
    for name, (src, lib) in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [
            _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src),
        ]
        p = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, p, tmp, lib))
    failures = []
    for name, p, tmp, lib in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failures.append(f"{name}: nvcc exit {p.returncode}\n{out}")
            continue
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(out)
        os.replace(tmp, lib)
    if failures:
        raise KernelError("kernel build failed:\n" + "\n".join(failures))
    return {name: lib for name, (_, lib) in targets.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels on
    first use."""
    with _lock:
        if name not in _libs:
            for n, path in build_all().items():
                if n not in _libs:
                    try:
                        _libs[n] = ctypes.CDLL(str(path))
                    except OSError as e:
                        raise KernelError(f"{n}: cannot load {path.name}: {e}") from e
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA launch failed with error {rc}")

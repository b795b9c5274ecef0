"""ctypes binding of the native host runtime (``native/dj_native.cpp``).

Counterpart of ``dj_tpu/native.py``, with its surface: ``build``,
``is_available``, ``murmur3_32``, ``generate_build_probe``,
``expected_match_count`` and ``parse_tbl_column``. The library supplies
the host-side roles the reference implements in C++/CUDA: dataset
generation with exact selectivity, the murmur3 host oracle of the
device hash, and the ``.tbl`` column parser.

The port builds its own copy of the library: ``build()`` compiles the
source, unedited, with the flags of ``native/Makefile`` into
``dj_tpu_torch/_build/`` (git-ignored); the first wrapper call builds
it when it is missing or older than the source. Without ``g++`` the
library does not load, ``is_available()`` says so, and every wrapper
takes its numpy path (``murmur3_32``'s is the port's
``ops.hashing.murmur3_32`` on a CPU tensor; ``expected_match_count``
has none and returns None, as in dj_tpu).

Build by hand with ``python -m dj_tpu_torch.native --build``.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _REPO / "native" / "dj_native.cpp"
LIB_PATH = pathlib.Path(__file__).resolve().parent / "_build" / "libdj_native.so"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dj_murmur3_32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p,
    ]
    lib.dj_generate_build_probe.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.dj_expected_match_count.restype = ctypes.c_int64
    lib.dj_expected_match_count.argtypes = [ctypes.c_int64, ctypes.c_double, ctypes.c_uint64]
    lib.dj_tbl_count_rows.restype = ctypes.c_int64
    lib.dj_tbl_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    for name in ("dj_parse_tbl_int64", "dj_parse_tbl_float64"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                       ctypes.c_int64]
    lib.dj_parse_tbl_string.restype = ctypes.c_int64
    lib.dj_parse_tbl_string.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    return lib


def _stale() -> bool:
    return not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime


def build(force: bool = False) -> bool:
    """Compile the library into ``_build/`` when it is missing, older
    than the source, or ``force``; returns whether it exists after.
    Raises ``RuntimeError`` with the compiler's output when ``g++`` is
    there and fails; returns False when there is no ``g++``."""
    with _lock:
        if not force and not _stale():
            return True
        cxx = shutil.which("g++")
        if cxx is None:
            return False
        LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        tmp = LIB_PATH.with_suffix(f".tmp{os.getpid()}")
        r = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp, LIB_PATH)
        return True


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it at first use; None without one."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if not _tried:
        _tried = True
        try:
            build()
        except RuntimeError:
            pass
    if _stale():
        return None
    _lib = _bind(ctypes.CDLL(str(LIB_PATH)))
    return _lib


def is_available() -> bool:
    """Whether the library is loaded (built at first use)."""
    return _load() is not None


def murmur3_32(data: np.ndarray, seed: int = 0) -> np.ndarray:
    """Host murmur3 of a 4- or 8-byte-element array (the oracle of the
    device hash in ``ops.hashing``), as uint32."""
    data = np.ascontiguousarray(data)
    if data.dtype.itemsize not in (4, 8):
        raise ValueError(f"murmur3_32 hashes 4- or 8-byte elements, not {data.dtype}")
    lib = _load()
    if lib is None:
        import torch

        from .ops import hashing

        return hashing.murmur3_32(torch.from_numpy(data), seed).numpy().astype(np.uint32)
    out = np.empty(data.shape, np.uint32)
    lib.dj_murmur3_32(data.ctypes.data_as(ctypes.c_void_p), data.size, data.dtype.itemsize,
                      ctypes.c_uint32(seed), out.ctypes.data_as(ctypes.c_void_p))
    return out


def generate_build_probe(n_build: int, n_probe: int, selectivity: float, rand_max: int,
                         unique_build: bool = True, seed: int = 0
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Build and probe int64 key columns with the reference's semantics
    (its generate_dataset.cuh): unique (or uniform) build keys in [0,
    rand_max]; a probe key hits the build set with probability
    ``selectivity``, else misses provably."""
    build_keys = np.empty(n_build, np.int64)
    probe = np.empty(n_probe, np.int64)
    lib = _load()
    if lib is None:
        rng = np.random.default_rng(seed)
        if unique_build:
            # O(domain) memory; the native path is O(1).
            perm = rng.permutation(rand_max + 1)
            build_keys[:] = perm[:n_build]
            comp = perm[n_build:]
        else:
            build_keys[:] = rng.integers(0, rand_max + 1, n_build)
            comp = None
        hit = rng.random(n_probe) < selectivity
        hits = build_keys[rng.integers(0, n_build, n_probe)]
        if comp is not None and comp.size:
            misses = comp[rng.integers(0, comp.size, n_probe)]
        else:
            misses = rng.integers(rand_max + 1, 2 * (rand_max + 1), n_probe)
        probe[:] = np.where(hit, hits, misses)
        return build_keys, probe
    lib.dj_generate_build_probe(n_build, n_probe, selectivity, rand_max,
                                1 if unique_build else 0, ctypes.c_uint64(seed),
                                build_keys.ctypes.data_as(ctypes.c_void_p),
                                probe.ctypes.data_as(ctypes.c_void_p))
    return build_keys, probe


def expected_match_count(n_probe: int, selectivity: float, seed: int = 0) -> Optional[int]:
    """The exact inner-join match total of ``generate_build_probe``'s
    output with unique build keys, by replaying the probe's selectivity
    draws (a hit matches one build key, a miss none). None without the
    library: the numpy generator draws another stream."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.dj_expected_match_count(n_probe, float(selectivity), ctypes.c_uint64(seed)))


def parse_tbl_column(data: bytes, field_idx: int, kind: str = "int64"):
    """Parse one pipe-delimited column of ``.tbl`` file bytes.

    kind: 'int64' | 'float64' | 'string' (which returns (sizes, chars)).
    """
    lib = _load()
    if lib is None:
        rows = [line.split(b"|")[field_idx] for line in data.splitlines() if line]
        if kind == "int64":
            return np.array([int(r) for r in rows], np.int64)
        if kind == "float64":
            return np.array([float(r) for r in rows], np.float64)
        sizes = np.array([len(r) for r in rows], np.int32)
        chars = np.frombuffer(b"".join(rows), np.uint8).copy()
        return sizes, chars
    n = lib.dj_tbl_count_rows(data, len(data))
    if kind == "int64":
        out = np.empty(n, np.int64)
        got = lib.dj_parse_tbl_int64(data, len(data), field_idx,
                                     out.ctypes.data_as(ctypes.c_void_p), n)
        if got < 0:
            raise ValueError(f"malformed int64 field {field_idx}")
        return out[:got]
    if kind == "float64":
        out = np.empty(n, np.float64)
        got = lib.dj_parse_tbl_float64(data, len(data), field_idx,
                                       out.ctypes.data_as(ctypes.c_void_p), n)
        return out[:got]
    sizes = np.empty(n, np.int32)
    lib.dj_parse_tbl_string(data, len(data), field_idx, sizes.ctypes.data_as(ctypes.c_void_p),
                            None, None, n)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(sizes, out=offsets[1:])
    chars = np.empty(max(1, int(offsets[-1])), np.uint8)
    lib.dj_parse_tbl_string(data, len(data), field_idx, None,
                            offsets.ctypes.data_as(ctypes.c_void_p),
                            chars.ctypes.data_as(ctypes.c_void_p), n)
    return sizes, chars


if __name__ == "__main__":
    import sys

    if "--build" in sys.argv:
        ok = build(force=True)
        print("built" if ok else "build FAILED (no g++)")
        sys.exit(0 if ok else 1)

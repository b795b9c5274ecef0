"""dj_tpu_torch's native host runtime against dj_tpu's, test for test.

The counterparts of the 8 tests of ``tests/test_native.py``: the build,
murmur3 held to the port's hash and to dj_tpu's wrapper on the same
inputs, the generator's uniqueness, selectivity and determinism (and its
keys equal to dj_tpu's wrapper's), the ``.tbl`` parser, and the exact
match count. Wherever ``g++`` exists the port's own library, built into
``dj_tpu_torch/_build/``, must be the path taken.
"""

import pathlib
import shutil

import numpy as np
import pytest
import torch

from dj_tpu import native as jnative
from dj_tpu_torch import native
from dj_tpu_torch.ops import hashing

HAVE_GXX = shutil.which("g++") is not None


def same_path() -> bool:
    """Both wrappers on their libraries, or both on numpy: the two
    generators draw one stream only then (dj_tpu's library is built by
    its own tests, ``make -C native``)."""
    return native.is_available() == jnative.is_available()


def test_build_if_missing():
    assert native.build() or not HAVE_GXX, "g++ exists but the native build failed"
    assert native.is_available() == HAVE_GXX
    if HAVE_GXX:
        lib = pathlib.Path(native._load()._name)
        assert lib == native.LIB_PATH
        assert lib.parent.name == "_build" and lib.parent.parent.name == "dj_tpu_torch"


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.uint32, np.uint64])
@pytest.mark.parametrize("seed", [0, 12345678])
def test_murmur3_matches_device(dtype, seed):
    rng = np.random.default_rng(1)
    info = np.iinfo(dtype)
    vals = rng.integers(info.min, info.max, 1000, dtype=dtype, endpoint=True)
    host = native.murmur3_32(vals, seed)
    assert host.dtype == np.uint32
    dev = hashing.murmur3_32(torch.from_numpy(vals), seed).numpy().astype(np.uint32)
    np.testing.assert_array_equal(host, dev)
    np.testing.assert_array_equal(host, jnative.murmur3_32(vals, seed))


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.uint16])
def test_murmur3_refuses_other_widths(dtype):
    with pytest.raises(ValueError, match="4- or 8-byte"):
        native.murmur3_32(np.zeros(3, dtype))


def test_murmur3_numpy_path_is_the_ports_hash(monkeypatch):
    vals = np.arange(-500, 500, dtype=np.int64)
    want = native.murmur3_32(vals, 7)
    monkeypatch.setattr(native, "_load", lambda: None)
    np.testing.assert_array_equal(native.murmur3_32(vals, 7), want)


def test_generator_unique_and_selectivity():
    n_build, n_probe = 20_000, 40_000
    rand_max = 2 * n_build
    build, probe = native.generate_build_probe(n_build, n_probe, 0.3, rand_max,
                                               unique_build=True, seed=7)
    assert build.shape == (n_build,)
    assert np.unique(build).size == n_build
    assert build.min() >= 0 and build.max() <= rand_max
    hits = np.isin(probe, build).mean()
    sigma = np.sqrt(0.3 * 0.7 / n_probe)
    assert abs(hits - 0.3) < 5 * sigma, hits
    if same_path():
        jb, jp = jnative.generate_build_probe(n_build, n_probe, 0.3, rand_max, unique_build=True,
                                              seed=7)
        np.testing.assert_array_equal(build, jb)
        np.testing.assert_array_equal(probe, jp)


def test_generator_nonunique():
    build, probe = native.generate_build_probe(5_000, 10_000, 0.5, 20_000, unique_build=False,
                                               seed=3)
    hits = np.isin(probe, build).mean()
    assert abs(hits - 0.5) < 5 * np.sqrt(0.25 / 10_000)
    if same_path():
        jb, jp = jnative.generate_build_probe(5_000, 10_000, 0.5, 20_000, unique_build=False,
                                              seed=3)
        np.testing.assert_array_equal(build, jb)
        np.testing.assert_array_equal(probe, jp)


def test_generator_seed_determinism():
    a = native.generate_build_probe(1000, 1000, 0.3, 4000, seed=9)
    b = native.generate_build_probe(1000, 1000, 0.3, 4000, seed=9)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    c = native.generate_build_probe(1000, 1000, 0.3, 4000, seed=10)
    assert not np.array_equal(a[0], c[0])


BLOB = b"1|3.5|URGENT|\n-42|0.25|LOW|\n7|1234.125||\n999999999999|-2.5|x|\n"


def test_tbl_parser():
    ints = native.parse_tbl_column(BLOB, 0, "int64")
    np.testing.assert_array_equal(ints, [1, -42, 7, 999999999999])
    floats = native.parse_tbl_column(BLOB, 1, "float64")
    np.testing.assert_allclose(floats, [3.5, 0.25, 1234.125, -2.5])
    sizes, chars = native.parse_tbl_column(BLOB, 2, "string")
    np.testing.assert_array_equal(sizes, [6, 3, 0, 1])
    assert bytes(chars.tobytes()) == b"URGENTLOWx"
    for field, kind in ((0, "int64"), (1, "float64")):
        np.testing.assert_array_equal(native.parse_tbl_column(BLOB, field, kind),
                                      jnative.parse_tbl_column(BLOB, field, kind))
    js, jc = jnative.parse_tbl_column(BLOB, 2, "string")
    np.testing.assert_array_equal(sizes, js)
    np.testing.assert_array_equal(chars, jc)


def test_tbl_parser_no_trailing_newline():
    blob = b"5|a|\n6|b|"
    ints = native.parse_tbl_column(blob, 0, "int64")
    np.testing.assert_array_equal(ints, [5, 6])
    np.testing.assert_array_equal(ints, jnative.parse_tbl_column(blob, 0, "int64"))


def test_expected_match_count_exact():
    """The analytical oracle equals np.isin on the generated keys at
    every selectivity (unique build keys: each hit matches once)."""
    assert native.is_available() == HAVE_GXX
    if not HAVE_GXX:
        assert native.expected_match_count(100_000, 0.3, seed=42) is None
        return
    for sel in (0.0, 0.3, 1.0):
        b, p = native.generate_build_probe(50_000, 100_000, sel, 100_000, unique_build=True,
                                           seed=42)
        want = int(np.isin(p, b).sum())
        assert native.expected_match_count(100_000, sel, seed=42) == want
        if jnative.is_available():
            assert jnative.expected_match_count(100_000, sel, seed=42) == want

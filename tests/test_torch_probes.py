"""dj_tpu_torch.hw probes (plain versions) vs the JAX probes of scripts/hw/.

scripts/hw/ is not a package, so each test loads a probe by its path as
a fresh module, sets its size constants (read when its kernel is
traced) to a small size, and replaces the module's ``pl`` with a
namespace whose ``pallas_call`` runs in interpret mode. The same numpy
inputs then go through the JAX probe and the port's CPU route (the
plain version); every output word must be equal. The CUDA kernels are
checked against the plain versions on the card by chip_smoke.py.
"""

import functools
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dj_tpu_torch.hw import gather_variants, probe_gather, probe_sort

ROOT = pathlib.Path(__file__).resolve().parents[1]
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _jax_probe(name: str, **sizes):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / "scripts" / "hw" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in sizes.items():
        setattr(mod, k, v)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id,
    )
    return mod


def _jax_loop(mod):
    """The JAX probe's slope loop, which its main defines inside itself
    (it reads only module globals, so it rebinds to the module's)."""
    code = next(c for c in mod.main.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "loop")
    assert not code.co_freevars
    return jax.jit(types.FunctionType(code, vars(mod)))


def _u32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)).view(torch.uint32)


def _words(pattern: str, n: int, rng) -> np.ndarray:
    rand = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if pattern == "random":  # half the words >= 2^31
        return rand
    if pattern == "all_equal":
        return np.full(n, 0x80000001, np.uint32)
    if pattern == "sorted":
        return np.sort(rand)
    if pattern == "reverse_sorted":
        return np.sort(rand)[::-1].copy()
    # heavy duplicates around both ends and the sign bit
    return rng.choice(np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32), n)


@pytest.mark.parametrize("pattern", ["random", "all_equal", "sorted", "reverse_sorted", "duplicates"])
@pytest.mark.parametrize("nt", [1, 4])
@pytest.mark.parametrize("tile", [1, 3, 256, 1000])
def test_tile_sort_plain_matches_pallas(tile, nt, pattern):
    rng = np.random.default_rng(tile * 10 + nt)
    x = _words(pattern, tile * nt, rng)
    jmod = _jax_probe("probe_sort", TILE=tile, NT=nt)
    want = np.asarray(jmod.tile_sort(jnp.asarray(x)))
    np.testing.assert_array_equal(want.reshape(nt, tile), np.sort(x.reshape(nt, tile), axis=1))
    for got in (probe_sort.tile_sort(_u32(x), tile), probe_sort.tile_sort_plain(_u32(x), tile)):
        assert got.dtype == torch.uint32 and got.shape == (tile * nt,)
        np.testing.assert_array_equal(probe_sort.to_numpy_u32(got), want)


@pytest.mark.parametrize("pattern", ["random", "duplicates"])
@pytest.mark.parametrize("tile", [31, 32, 33, 1023, 1024, 1025])
def test_tile_sort_plain_matches_pallas_around_a_warp(tile, pattern):
    """Tiles around the kernel's register and warp geometry: a thread
    holds 32 words and the smallest padded tile is one warp's 1024."""
    rng = np.random.default_rng(tile)
    x = _words(pattern, 2 * tile, rng)
    want = np.asarray(_jax_probe("probe_sort", TILE=tile, NT=2).tile_sort(jnp.asarray(x)))
    np.testing.assert_array_equal(want.reshape(2, tile), np.sort(x.reshape(2, tile), axis=1))
    got = probe_sort.tile_sort_plain(_u32(x), tile)
    np.testing.assert_array_equal(probe_sort.to_numpy_u32(got), want)


def _indices(kind: str, n: int, rng) -> np.ndarray:
    if kind == "in_range":
        return rng.integers(0, n, n, dtype=np.int32)
    if kind == "negative":  # [-N, 0) wraps
        return rng.integers(-n, 0, n, dtype=np.int32)
    if kind == "outside":  # outside [-N, N): INT32_MIN
        far = rng.permutation(np.concatenate([rng.integers(n, 4 * n, n),
                                              rng.integers(INT32_MIN, -n, n)]))[:n]
        far[: min(n, 4)] = [n, -n - 1, INT32_MIN, INT32_MAX][: min(n, 4)]
        return far.astype(np.int32)
    idx = rng.integers(-3 * n, 3 * n, n, dtype=np.int32)  # mixed
    idx[: min(n, 6)] = [0, n - 1, -n, n, INT32_MIN, INT32_MAX][: min(n, 6)]
    return idx


@pytest.mark.parametrize("kind", ["in_range", "negative", "outside", "mixed"])
@pytest.mark.parametrize("n", [1, 7, 1024])
def test_run_plain_matches_pallas(n, kind):
    rng = np.random.default_rng(n)
    vals = rng.integers(INT32_MIN, INT32_MAX, n, dtype=np.int32)
    idx = _indices(kind, n, rng)
    jmod = _jax_probe("probe_gather", N=n)
    want = np.asarray(jmod.run(jnp.asarray(vals), jnp.asarray(idx)))
    tv, ti = torch.from_numpy(vals), torch.from_numpy(idx)
    for got in (probe_gather.run(tv, ti), probe_gather.run_cluster(tv, ti),
                probe_gather.run_plain(tv, ti)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["in_range", "mixed"])
@pytest.mark.parametrize("n", [probe_gather.MAX_N + 1, probe_gather.MAX_N + 3])
def test_run_past_the_cluster_cap_matches_numpy(n, kind):
    """run has no cap on N (vals is read through L2, not staged in a
    cluster's shared memory): past run_cluster's MAX_N it still equals
    run_plain and numpy's take with wrap and fill."""
    rng = np.random.default_rng(n)
    vals = rng.integers(INT32_MIN, INT32_MAX, n, dtype=np.int32)
    idx = _indices(kind, n, rng)
    i64 = idx.astype(np.int64)
    want = np.where((i64 >= -n) & (i64 < n), vals[np.remainder(i64, n)], INT32_MIN)
    tv, ti = torch.from_numpy(vals), torch.from_numpy(idx)
    for got in (probe_gather.run(tv, ti), probe_gather.run_plain(tv, ti)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["in_range", "mixed"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n", [7, 1024])
def test_loop_matches_pallas_loop(n, k, kind):
    rng = np.random.default_rng(100 + n)
    vals = rng.integers(0, 1 << 30, n, dtype=np.int32)
    idx = _indices(kind, n, rng)
    jmod = _jax_probe("probe_gather", N=n)
    want = np.asarray(_jax_loop(jmod)(jnp.asarray(vals), jnp.asarray(idx), k))
    got = probe_gather.loop(torch.from_numpy(vals), torch.from_numpy(idx), k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("probe,argv", [
    (probe_sort, ["--tile", "256", "--nt", "4"]),
    (probe_sort, ["--tile", "1000", "--nt", "3", "--seed", "5"]),
    (probe_gather, ["--n", "1024"]),
    (probe_gather, ["--n", "7", "--seed", "3"]),
    (probe_gather, ["--n", str(probe_gather.MAX_N + 1)]),  # run alone: past run_cluster's cap
])
def test_main_on_cpu_prints_correct(probe, argv, capsys):
    res = probe.main(["--device", "cpu", *argv])
    lines = capsys.readouterr().out.splitlines()
    assert "CORRECT" in lines
    assert "ms" not in res  # no time from a CPU run


@pytest.mark.parametrize("probe", [probe_sort, probe_gather, gather_variants])
def test_main_without_a_card_raises(probe, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])
    assert capsys.readouterr().out == ""


TILE_SORT_BAD = {
    "tile_zero": (torch.zeros(8, dtype=torch.int32).view(torch.uint32), 0),
    "tile_over_shared_memory": (torch.zeros(32769, dtype=torch.int32).view(torch.uint32), 32769),
    "not_whole_tiles": (torch.zeros(10, dtype=torch.int32).view(torch.uint32), 4),
    "empty": (torch.zeros(0, dtype=torch.int32).view(torch.uint32), 4),
    "int32_words": (torch.zeros(8, dtype=torch.int32), 4),
    "two_dimensional": (torch.zeros(2, 4, dtype=torch.int32).view(torch.uint32), 4),
    "meta_device": (torch.empty(8, dtype=torch.uint32, device="meta"), 4),
}


@pytest.mark.parametrize("case", sorted(TILE_SORT_BAD))
def test_tile_sort_rejects(case):
    x, tile = TILE_SORT_BAD[case]
    with pytest.raises(ValueError):
        probe_sort.tile_sort(x, tile)


def _i32(n, device="cpu"):
    return torch.zeros(n, dtype=torch.int32, device=device)


RUN_BAD = {
    "int64_idx": (_i32(8), torch.zeros(8, dtype=torch.int64)),
    "int64_vals": (torch.zeros(8, dtype=torch.int64), _i32(8)),
    "lengths_differ": (_i32(8), _i32(9)),
    "empty": (_i32(0), _i32(0)),
    "two_dimensional": (torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 4, dtype=torch.int32)),
    "meta_device": (_i32(8, "meta"), _i32(8, "meta")),
}


@pytest.mark.parametrize("case", sorted(RUN_BAD))
@pytest.mark.parametrize("gather", ["run", "run_cluster"])
def test_run_rejects(gather, case):
    vals, idx = RUN_BAD[case]
    with pytest.raises(ValueError):
        getattr(probe_gather, gather)(vals, idx)


def test_largest_gather_fits_the_cluster():
    """run_cluster's N words of vals fit across a cluster's shared memory
    (227 KB per CTA) up to MAX_N; the kernel's share of the largest N is
    227 KB."""
    share = -(-probe_gather.MAX_N // probe_gather.CLUSTER)
    assert share * 4 == 232_448
    assert -(-(probe_gather.MAX_N + 1) // probe_gather.CLUSTER) * 4 > 232_448


def test_gather_variants_edit_the_kernel_source():
    """Each timing variant is the cluster gather's source with its edits
    applied exactly once (a variant whose text no longer matches the
    source raises instead of timing the unedited kernel)."""
    base = gather_variants.SOURCE.read_text()
    sources = gather_variants._sources(base)
    assert set(sources) == set(gather_variants.VARIANTS) | {"plain gather, no cluster"}
    for name, (edits, _) in gather_variants.VARIANTS.items():
        assert (sources[name][0] == base) == (not edits), name
    with pytest.raises(RuntimeError, match="is not once"):
        gather_variants._sources(base.replace(gather_variants.STAGE, ""))

"""dj_tpu_torch's merge and rank expansion vs the Pallas kernels, and the
run search primitives vs dj_tpu.core.search.

The Pallas kernels run in interpret mode (merge_sorted_u64 at tiles 128
and 256; expand_ranks at the shrunk geometry of
tests/test_pallas_expand.py). On the CPU the port's wrappers take their
plain versions, which must equal the kernels exactly: every compared
value is an integer (u64 words compare as their bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_tpu.core import search as jsearch
from dj_tpu.ops.pallas_expand import expand_ranks as jax_expand_ranks
from dj_tpu.ops.pallas_merge import merge_sorted_u64 as jax_merge
from dj_tpu.ops.pallas_merge import merge_splits as jax_merge_splits
from dj_tpu_torch.core import search as tsearch
from dj_tpu_torch.ops import expand, merge

GEO = dict(t_j=256, span=1024, blk=64, lane=128, interpret=True)
ONES = np.uint64(2**64 - 1)


def _t(u64: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(u64).view(np.int64))


def _sorted_u64(rng, lo, hi, n, tail=0):
    x = np.sort(rng.integers(lo, hi, max(n, 1), dtype=np.uint64))[:n]
    if tail:
        x[-tail:] = ONES  # the join's all-ones padding
    return np.sort(x)


def _merge_case(case):
    rng = np.random.default_rng(len(case))
    if case == "random_sentinel_tails":  # tests/test_prepared.py:68-89
        return (_sorted_u64(rng, 0, 2**63, 1000, 250), _sorted_u64(rng, 0, 2**63, 700, 140))
    if case == "short":
        return _sorted_u64(rng, 0, 2**63, 5), _sorted_u64(rng, 0, 2**63, 3)
    if case == "empty_b":
        return _sorted_u64(rng, 0, 2**63, 700), _sorted_u64(rng, 0, 2**63, 0)
    if case == "empty_a":
        return _sorted_u64(rng, 0, 2**63, 0), _sorted_u64(rng, 0, 2**63, 5)
    if case == "cross_duplicates":  # keys in [0, 50), sentinel tails
        return _sorted_u64(rng, 0, 50, 800, 37), _sorted_u64(rng, 0, 50, 600, 11)
    if case == "a_wholly_above_b":  # top bit set on every a word
        return _sorted_u64(rng, 2**63, 2**64 - 1, 301), _sorted_u64(rng, 0, 2**63, 517)
    if case == "length_one":
        return _sorted_u64(rng, 0, 2**64 - 1, 1), _sorted_u64(rng, 0, 2**64 - 1, 1)
    raise KeyError(case)


MERGE_CASES = ["random_sentinel_tails", "short", "empty_b", "empty_a",
               "cross_duplicates", "a_wholly_above_b", "length_one"]


@pytest.mark.parametrize("tile", [128, 256])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_plain_matches_pallas_interpret(case, tile):
    a, b = _merge_case(case)
    want = np.asarray(jax_merge(jnp.asarray(a), jnp.asarray(b), tile=tile, interpret=True))
    got = merge.merge_sorted_u64(_t(a), _t(b))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(want, np.sort(np.concatenate([a, b])))


@pytest.mark.parametrize("tile", [128, 256, 4096])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_splits_match(case, tile):
    a, b = _merge_case(case)
    if a.size and b.size:
        want = np.asarray(jax_merge_splits(jnp.asarray(a), jnp.asarray(b), tile))
    else:
        # dj_tpu's merge never splits an empty operand (it returns the
        # other one), and its gather rejects one: every word is a's.
        S = a.size + b.size
        want = np.minimum(np.arange(-(-S // tile) + 1) * tile, a.size).astype(np.int32)
    got = merge.merge_splits(_t(a), _t(b), tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # Each tile's windows are bounded by the tile on both operands.
    k = np.minimum(np.arange(want.size) * tile, a.size + b.size)
    acnt = np.diff(want)
    assert (acnt >= 0).all() and (acnt <= tile).all()
    assert ((np.diff(k) - acnt) >= 0).all() and ((np.diff(k) - acnt) <= tile).all()


def test_merge_rejects_bad_inputs():
    x = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        merge.merge_sorted_u64(x.to(torch.int32), x)
    with pytest.raises(ValueError):
        merge.merge_sorted_u64(x.reshape(2, 2), x)
    with pytest.raises(ValueError):
        merge.merge_sorted_u64(x.to("meta"), x.to("meta"))


def _csum_case(case):
    rng = np.random.default_rng(len(case) + 100)
    if case == "uniform_dense":
        cnt = rng.integers(0, 3, 4000)
    elif case == "all_zero":
        cnt = np.zeros(3000, np.int64)
    elif case == "one_hot_row":  # one row's window is wider than the span
        cnt = np.zeros(5000, np.int64)
        cnt[2345] = 1500
    elif case == "sparse":  # windows of ~1000 rows per slot, past the span
        cnt = (rng.random(20_000) < 0.002).astype(np.int64)
    else:
        raise KeyError(case)
    return np.cumsum(cnt)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n_out_of", ["below_total", "multiple_of_tile", "above_total"])
@pytest.mark.parametrize("case", ["uniform_dense", "all_zero", "one_hot_row", "sparse"])
def test_expand_ranks_plain_matches_pallas_interpret(case, n_out_of, dtype):
    csum = _csum_case(case).astype(dtype)
    total = int(csum[-1])
    n_out = {"below_total": max(1, total // 2 + 3), "multiple_of_tile": 1024,
             "above_total": total + 777}[n_out_of]
    want = np.asarray(jax_expand_ranks(jnp.asarray(csum), n_out, **GEO))
    got = expand.expand_ranks(torch.from_numpy(csum), n_out)
    assert got.dtype == torch.int32 and got.shape == (n_out,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.searchsorted(csum, np.arange(n_out), "right"))


def test_expand_ranks_edges():
    z = torch.zeros(7, dtype=torch.int32)
    assert expand.expand_ranks(z, 0).shape == (0,)
    assert expand.expand_ranks(torch.zeros(0, dtype=torch.int32), 5).tolist() == [0] * 5
    for bad in (z.to(torch.float32), z.reshape(7, 1)):
        with pytest.raises(ValueError):
            expand.expand_ranks(bad, 4)
    with pytest.raises(ValueError):
        expand.expand_ranks(z, 2**31)
    with pytest.raises(ValueError):
        expand.expand_ranks(z.to("meta"), 4)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n_ref", [0, 1, 2, 3, 7, 100, 1000])
def test_rank_in_run_matches(n_ref, side):
    """tests/test_probe_join.py:70-80: unsorted queries straddling the
    run's range, including empty and single-element runs."""
    rng = np.random.default_rng(n_ref * 2 + (side == "right"))
    ref = np.sort(rng.integers(0, 50, max(n_ref, 1)))[:n_ref].astype(np.uint64)
    q = (rng.integers(-1, 52, 137) % (1 << 12)).astype(np.uint64)
    want = np.asarray(jsearch.rank_in_run(jnp.asarray(ref), jnp.asarray(q), side))
    got = tsearch.rank_in_run(_t(ref), _t(q), side)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_run_bounds_match():
    rng = np.random.default_rng(5)
    ref = np.sort(rng.integers(0, 16, 4096)).astype(np.uint64)
    q = rng.integers(0, 20, 512).astype(np.uint64)
    want = jsearch.run_bounds(jnp.asarray(ref), jnp.asarray(q))
    got = tsearch.run_bounds(_t(ref), _t(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal((got[1] - got[0]).numpy(), [(ref == v).sum() for v in q])


@pytest.mark.parametrize("length", [1, 700, 3000])
def test_segment_index_arange_matches(length):
    csum = _csum_case("uniform_dense").astype(np.int32)[:900]
    want = np.asarray(jsearch.segment_index_arange(jnp.asarray(csum), length))
    got = tsearch.segment_index_arange(torch.from_numpy(csum), length)
    np.testing.assert_array_equal(got.numpy(), want)

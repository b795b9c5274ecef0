"""dj_tpu_torch expand_values (plain version) vs the Pallas expand_values.

The Pallas kernel runs in interpret mode at a shrunk geometry
(t_j=256, span=1024, blk=64, lane=128). Both must give equal (stag_j,
rpos) on every slot j < total (the tail is unspecified), including a
skewed input whose window overflows the span, where JAX takes its XLA
fallback branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_tpu.core import search as jsearch
from dj_tpu.ops.pallas_expand import expand_values as jax_expand_values
from dj_tpu_torch.core import search as tsearch
from dj_tpu_torch.ops import expand

GEO = dict(t_j=256, span=1024, blk=64, lane=128, interpret=True)


def _check(cnt, stag, run_start, n_out):
    csum = np.cumsum(cnt).astype(np.int32)
    want_stag, want_rpos = jax_expand_values(
        jnp.asarray(csum), jnp.asarray(cnt.astype(np.int32)),
        jnp.asarray(stag), jnp.asarray(run_start), n_out, **GEO,
    )
    args = [torch.from_numpy(a.astype(np.int32)) for a in (csum, cnt, stag, run_start)]
    got_stag, got_rpos = expand.expand_values(*args, n_out)
    k = min(int(cnt.sum()), n_out)
    np.testing.assert_array_equal(got_stag.numpy()[:k], np.asarray(want_stag)[:k])
    np.testing.assert_array_equal(got_rpos.numpy()[:k], np.asarray(want_rpos)[:k])
    return k


@pytest.mark.parametrize("seed", range(4))
def test_random_counts(seed):
    rng = np.random.default_rng(seed)
    S = 4000
    cnt = rng.integers(0, 3, S)
    stag = rng.integers(-(2**31), 2**31 - 1, S, dtype=np.int64).astype(np.int32)
    run_start = rng.integers(0, S, S).astype(np.int32)
    assert _check(cnt, stag, run_start, 1024) == 1024


def test_dense_runs_cross_tiles():
    rng = np.random.default_rng(9)
    S = 2000
    cnt = np.zeros(S, np.int64)
    hot = rng.choice(S, 12, replace=False)
    cnt[hot] = rng.integers(50, 200, 12)
    _check(cnt, rng.integers(0, S, S).astype(np.int32), rng.integers(0, S, S).astype(np.int32), 1536)


def test_skew_window_wider_than_span():
    """Every output comes from the last row: the window spans all of
    csum, which makes JAX fall back to XLA."""
    S = 8000
    cnt = np.zeros(S, np.int64)
    cnt[-1] = 512
    stag = np.arange(S, dtype=np.int32)
    run_start = np.arange(S, dtype=np.int32)[::-1].copy()
    assert _check(cnt, stag, run_start, 512) == 512


def test_all_zero_counts_and_empty_output():
    S = 300
    cnt = np.zeros(S, np.int64)
    z = np.zeros(S, np.int32)
    assert _check(cnt, z, z, 256) == 0
    stag_j, rpos = expand.expand_values(*(torch.zeros(S, dtype=torch.int32),) * 4, 0)
    assert stag_j.shape == rpos.shape == (0,)


def test_rejects_bad_inputs():
    z = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        expand.expand_values(z.to(torch.int64), z, z, z, 4)
    with pytest.raises(ValueError):
        expand.expand_values(z, z[:4], z, z, 4)
    with pytest.raises(ValueError):
        expand.expand_values(*(torch.zeros(0, dtype=torch.int32),) * 4, 4)
    with pytest.raises(ValueError):
        expand.expand_values(*(z.to("meta"),) * 4, 4)


@pytest.mark.parametrize("fn", ["count_leq_arange", "count_lt_arange"])
@pytest.mark.parametrize("length", [1, 700, 3000])
def test_arange_rank_queries_match(fn, length):
    """The rank queries behind the plain expansion equal dj_tpu's
    histogram formulation on a sorted non-negative vector, including
    values at and past ``length``."""
    rng = np.random.default_rng(length)
    vals = np.sort(rng.integers(0, 2500, 900)).astype(np.int32)
    want = np.asarray(getattr(jsearch, fn)(jnp.asarray(vals), length))
    got = getattr(tsearch, fn)(torch.from_numpy(vals), length)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

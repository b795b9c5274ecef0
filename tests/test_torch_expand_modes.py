"""dj_tpu_torch's expand_gather, expand_join, expand_carry and expand_vfull
(plain versions) vs the Pallas kernels of the same names.

The Pallas kernels run in interpret mode at a shrunk geometry (t_j=256,
span=1024, blk=64, lane=128; margin 256 for expand_join, 2 blocks for
expand_vfull). The inputs are the scans of a merged sort: runs of refs
followed by queries, each query matching every ref of its run. Both
sides must give the same bits on every slot j < min(total, n_out) (the
tail is unspecified). The cases reach the JAX functions' XLA branches
too: a window wider than the span, and a ref further below its query
than the margin. The port carries u64 payloads and keys as int64; the
TPU kernels as two int32 planes each, which the test splits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_tpu.ops import pallas_expand as px
from dj_tpu_torch.ops import expand

GEO = dict(t_j=256, span=1024, blk=64, lane=128, interpret=True)
JOIN_MARGIN = 256
VFULL_MARGIN_BLOCKS = 2


def _runs(rng, n_runs, refs, queries, hit=1.0, hot_refs=0):
    """(cnt, stag, run_start) int32 of a merged sort of ``n_runs`` key
    runs: each has refs ~ U[refs) then queries ~ U[queries) (none with
    probability 1 - hit); ``hot_refs`` puts one run of that many refs
    and three queries in the middle."""
    r = rng.integers(*refs, n_runs)
    q = np.where(rng.random(n_runs) < hit, rng.integers(*queries, n_runs), 0)
    if hot_refs:
        r[n_runs // 2], q[n_runs // 2] = hot_refs, 3
    length = r + q
    S = int(length.sum())
    starts = np.concatenate([[0], np.cumsum(length)[:-1]])
    run_start = np.repeat(starts, length)
    within = np.arange(S) - run_start
    cnt = np.where(within >= np.repeat(r, length), np.repeat(r, length), 0)
    stag = rng.permutation(S)
    return cnt.astype(np.int32), stag.astype(np.int32), run_start.astype(np.int32)


CASES = {
    "random": dict(n_runs=1500, refs=(0, 4), queries=(0, 4)),
    "dense_runs_cross_tiles": dict(n_runs=8, refs=(20, 50), queries=(10, 30)),
    "window_wider_than_span": dict(n_runs=4000, refs=(1, 3), queries=(1, 3), hit=0.02),
    "refs_past_margin": dict(n_runs=400, refs=(0, 3), queries=(0, 3), hot_refs=700),
    "all_miss": dict(n_runs=500, refs=(0, 4), queries=(0, 4), hit=0.0),
}
# Payload slots per case (1, 2 and 3 u64 slots, and none).
N_SLOTS = {"random": 1, "dense_runs_cross_tiles": 2, "window_wider_than_span": 3,
           "refs_past_margin": 2, "all_miss": 0}


def _inputs(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    cnt, stag, run_start = _runs(rng, **CASES[case])
    S = cnt.shape[0]
    csum = np.cumsum(cnt).astype(np.int32)
    # Full-range u64 bits: negative int64 values, and narrow ones.
    slots = [rng.integers(-(2**63), 2**63 - 1, S, dtype=np.int64, endpoint=True)
             for _ in range(N_SLOTS[case])]
    if slots:
        slots[0][::7] = -1
        slots[0][1::7] = -(2**40)
    key = rng.integers(-(2**63), 2**63 - 1, S, dtype=np.int64, endpoint=True)
    return csum, cnt, stag, run_start, slots, key


def _n_out(total, which):
    return {"zero": 0, "below_total": total // 2, "above_total": total + 300}[which]


def _planes(x):
    """int64 -> (low, high) int32 planes, the TPU kernels' u64 layout."""
    x = np.asarray(x, np.int64)
    return (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32), (x >> 32).astype(np.int32)


def _slot_planes(slots):
    return tuple(jnp.asarray(p) for s in slots for p in _planes(s))


def _max_run(cnt, run_start):
    pos = np.arange(cnt.shape[0])
    return jnp.int32(np.max(np.where(cnt > 0, pos - run_start, 0), initial=0))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_equal(got, want, k):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g)[:k], np.asarray(w)[:k])


@pytest.mark.parametrize("which", ["zero", "below_total", "above_total"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_gather_matches_pallas(case, which):
    csum, cnt, stag, run_start, _, _ = _inputs(case)
    n_out = _n_out(int(cnt.sum()), which)
    want = px.expand_gather(jnp.asarray(csum), jnp.asarray(stag), jnp.asarray(run_start),
                            n_out, **GEO)
    got = expand.expand_gather(_t(csum), _t(stag), _t(run_start), n_out)
    assert all(g.dtype == torch.int32 and g.shape == (n_out,) for g in got)
    _assert_equal(got, want, min(int(cnt.sum()), n_out))


@pytest.mark.parametrize("which", ["zero", "below_total", "above_total"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_join_matches_pallas(case, which):
    csum, cnt, stag, run_start, _, _ = _inputs(case)
    n_out = _n_out(int(cnt.sum()), which)
    # max_run goes to the JAX side alone: the port needs no margin.
    want = px.expand_join(jnp.asarray(csum), jnp.asarray(stag), jnp.asarray(run_start),
                          _max_run(cnt, run_start), n_out, margin=JOIN_MARGIN, **GEO)
    got = expand.expand_join(_t(csum), _t(stag), _t(run_start), n_out)
    assert all(g.dtype == torch.int32 and g.shape == (n_out,) for g in got)
    _assert_equal(got, want, min(int(cnt.sum()), n_out))


@pytest.mark.parametrize("which", ["zero", "below_total", "above_total"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_carry_matches_pallas(case, which):
    csum, cnt, _, run_start, slots, _ = _inputs(case)
    n_out = _n_out(int(cnt.sum()), which)
    want = px.expand_carry(jnp.asarray(csum), jnp.asarray(cnt), jnp.asarray(run_start),
                           _slot_planes(slots), n_out, **GEO)
    rpos, *pay = expand.expand_carry(_t(csum), _t(cnt), _t(run_start),
                                     [_t(s) for s in slots], n_out)
    assert rpos.dtype == torch.int32 and all(p.dtype == torch.int64 for p in pay)
    got = (rpos,) + tuple(p for x in pay for p in _planes(x.numpy()))
    _assert_equal(got, want, min(int(cnt.sum()), n_out))


@pytest.mark.parametrize("which", ["zero", "below_total", "above_total"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_vfull_matches_pallas(case, which):
    csum, cnt, _, run_start, slots, key = _inputs(case)
    n_out = _n_out(int(cnt.sum()), which)
    klo, khi = _planes(key)
    want = px.expand_vfull(jnp.asarray(csum), jnp.asarray(cnt), jnp.asarray(run_start),
                           _slot_planes(slots), jnp.asarray(klo), jnp.asarray(khi),
                           _max_run(cnt, run_start), n_out,
                           margin_blocks=VFULL_MARGIN_BLOCKS, **GEO)
    outs = expand.expand_vfull(_t(csum), _t(cnt), _t(run_start), [_t(s) for s in slots],
                               _t(key), n_out)
    assert len(outs) == 2 * len(slots) + 1
    assert all(o.dtype == torch.int64 and o.shape == (n_out,) for o in outs)
    got = tuple(p for x in outs for p in _planes(x.numpy()))
    _assert_equal(got, want, min(int(cnt.sum()), n_out))


def test_cases_reach_both_jax_branches():
    """The shapes above take the Pallas path and each XLA fallback."""
    dense = _inputs("dense_runs_cross_tiles")
    hot = _inputs("refs_past_margin")
    assert int(_max_run(dense[1], dense[3])) < VFULL_MARGIN_BLOCKS * GEO["blk"]
    assert int(_max_run(hot[1], hot[3])) >= JOIN_MARGIN
    csum = _inputs("window_wider_than_span")[0]
    # A tile of t_j slots spans more merged positions than the span.
    first_tile = np.searchsorted(csum, GEO["t_j"], side="right")
    assert first_tile > GEO["span"]


def test_slot_inputs_are_checked():
    z = torch.zeros(5, dtype=torch.int32)
    s = torch.zeros(5, dtype=torch.int64)
    with pytest.raises(ValueError, match="payload slots"):
        expand.expand_carry(z, z, z, [s] * 4, 4)
    with pytest.raises(ValueError):
        expand.expand_carry(z, z, z, [s.to(torch.int32)], 4)
    with pytest.raises(ValueError):
        expand.expand_vfull(z, z, z, [s], s[:4], 4)
    with pytest.raises(ValueError):
        expand.expand_gather(z, z, z[:4], 4)
    with pytest.raises(ValueError):
        expand.expand_join(z.to(torch.int64), z, z, 4)
    with pytest.raises(ValueError):
        expand.expand_join(*(z.to("meta"),) * 3, 4)

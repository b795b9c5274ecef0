"""The plan knobs DJT_JOIN_RANGE_PROBE and DJT_PROBE_EXPAND against
dj_tpu's DJ_JOIN_RANGE_PROBE and DJ_PROBE_EXPAND.

Joins under DJT_JOIN_RANGE_PROBE=0 give the rows, totals and flags of
the default plan: the unprepared join (one rank and a world of 4), the
prepared sort and merge tiers. The range probe itself returns None under
it, as dj_tpu's does. ``prepared_effective_plan`` names each tier's
kernels; a bad value raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.parallel import dist_join as jdist
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.ops import join as tjoin
from dj_tpu_torch.parallel import dist_join as tdist


@pytest.fixture(autouse=True)
def _one_thread():
    # One torch thread: the joins run many small ops, whose thread pools
    # stall when other test processes share the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_knob_values_and_the_plan_gate(monkeypatch):
    """prepared_effective_plan names the kernels of each tier and probe
    expansion, and a value outside DJT_PROBE_EXPAND's set raises."""
    assert tjoin.prepared_effective_plan("sort") == ("join_scans", "expand_values")
    assert tjoin.prepared_effective_plan("merge") == ("merge_sorted_u64", "join_scans",
                                                      "expand_values")
    for mode, kernel in (("segment", "expand_ranks"), ("hist", "expand_ranks"),
                         ("pallas", "expand_values")):
        assert tjoin.prepared_effective_plan("probe", mode) == (kernel,)
        monkeypatch.setenv("DJT_PROBE_EXPAND", mode)
        assert tjoin.prepared_effective_plan("probe") == (kernel,)
    monkeypatch.setenv("DJT_PROBE_EXPAND", "histogram")
    with pytest.raises(ValueError, match="DJT_PROBE_EXPAND"):
        tjoin.resolve_probe_expand()


def _tables(seed, n=3000, hot=False):
    rng = np.random.default_rng(seed)
    bk = rng.permutation(np.arange(3 * n))[:n].astype(np.int64)
    pk = rng.integers(0, 3 * n, n).astype(np.int64)
    if hot:
        pk[::4] = bk[0]
    return ([bk, np.arange(n, dtype=np.int64) + 10**6],
            [pk, np.arange(n, dtype=np.int64), rng.standard_normal(n).astype(np.float32)])


def _sorted_shards(out, counts, w):
    cap = out.capacity // w
    return [sorted(zip(*[c.data[r * cap:r * cap + n].tolist() for c in out.columns]))
            for r, n in enumerate(counts.tolist())]


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("w,odf", [(1, 1), (1, 4), (4, 2)])
def test_knobs_give_the_default_rows(w, odf, hot, monkeypatch):
    """The unprepared join and the prepared sort and merge tiers under
    DJT_JOIN_RANGE_PROBE=0: counts, flags and shard rows equal to the
    default plan's, with and without a hot probe key."""
    build, probe = _tables(w * 10 + odf, hot=hot)
    topo = tj.make_topology(["cpu"] * w)
    tb = tj.shard_table(topo, convert.table_from_numpy(build, ["int64"] * 2, device="cpu"))
    tp = tj.shard_table(topo, convert.table_from_numpy(probe, ["int64", "int64", "float32"],
                                                       device="cpu"))
    cfg = tj.JoinConfig(over_decom_factor=odf, bucket_factor=4.0, join_out_factor=4.0)
    prep = tj.prepare_join_side(topo, *tb, [0], cfg, left_capacity=len(probe[0]))

    def runs():
        out = {"join": tj.distributed_inner_join(topo, *tp, *tb, [0], [0], cfg)}
        for tier in ("sort", "merge"):
            monkeypatch.setenv("DJT_JOIN_MERGE", tier)
            out[tier] = tj.distributed_inner_join(topo, *tp, prep, None, [0], None, cfg)
        monkeypatch.delenv("DJT_JOIN_MERGE")
        return out

    want = runs()
    for res in want.values():
        assert not any(bool(v.any()) for v in res[2].values())
    monkeypatch.setenv("DJT_JOIN_RANGE_PROBE", "0")
    for path, (out, counts, info) in runs().items():
        wout, wcounts, winfo = want[path]
        assert counts.tolist() == wcounts.tolist(), path
        assert {k: v.tolist() for k, v in info.items()} == \
            {k: v.tolist() for k, v in winfo.items()}, path
        assert _sorted_shards(out, counts, w) == _sorted_shards(wout, wcounts, w), path


def test_range_probe_knob_matches_dj_tpu(monkeypatch):
    """Under DJT_JOIN_RANGE_PROBE=0 the range probe returns None before
    probing, as dj_tpu's under DJ_JOIN_RANGE_PROBE=0; a declared range
    still wins in both."""
    build, probe = _tables(3)
    jt = [dj_tpu.from_arrays(*[jnp.asarray(a) for a in t]) for t in (probe, build)]
    tt = [convert.table_from_numpy(t, [a.dtype.name for a in t], device="cpu")
          for t in (probe, build)]
    jc = [jnp.asarray([t.capacity], jnp.int32) for t in jt]
    tc = [torch.tensor([t.capacity], dtype=torch.int32) for t in tt]
    cfg = dj_tpu.JoinConfig()
    for env in ("1", "0"):
        monkeypatch.setenv("DJ_JOIN_RANGE_PROBE", env)
        monkeypatch.setenv("DJT_JOIN_RANGE_PROBE", env)
        want = jdist._resolve_key_range(cfg, jt[0], jc[0], jt[1], jc[1], [0], [0], 1)
        got = tdist._resolve_key_range(convert.join_config_from(cfg), tt[0], tc[0], tt[1], tc[1],
                                       [0], [0], 1)
        assert (got is None) == (want is None) == (env == "0")
        if want is not None:
            assert got == tuple(tuple(int(v) for v in p) for p in want)
    declared = dj_tpu.JoinConfig(key_range=(0, 9000))
    assert tdist._resolve_key_range(convert.join_config_from(declared), tt[0], tc[0], tt[1],
                                    tc[1], [0], [0], 1) == ((0, 9000),)

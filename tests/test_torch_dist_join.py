"""dj_tpu_torch distributed_inner_join on a one-rank world vs dj_tpu's on
a one-device mesh, plus the port's generator, sharding and converters.

The same numpy tables go through both packages; the joined tables must
be equal as row multisets, with equal flags, at over_decom_factor 1 and 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard, unshard_table as junshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.data.generator import generate_build_probe_tables, host_build_probe_keys
from dj_tpu_torch.parallel import dist_join as tdist


def _rows(table):
    return sorted(zip(*[np.asarray(c.data).tolist() for c in table.columns]))


def _both(arrays, names):
    jt = dj_tpu.from_arrays(*[jnp.asarray(a) for a in arrays],
                            dtypes=[dj_tpu.dtypes.by_name(n) for n in names])
    return jt, convert.table_from_numpy(arrays, names, device="cpu")


def _dist_compare(odf, key_dtype):
    rng = np.random.default_rng(odf)
    build, probe = host_build_probe_keys(3000, 4000, 0.3, rng, dtype=np.dtype(key_dtype))
    probe[:40] = build[:40]  # some guaranteed hits
    bp = np.arange(3000, dtype=np.int64) + 7
    pp = np.arange(4000, dtype=np.int64)
    jl, tl = _both([probe, pp], [key_dtype, "int64"])
    jr, tr = _both([build, bp], [key_dtype, "int64"])

    jtopo = jmake_topology(jax.devices()[:1])
    jls, jlc = jshard(jtopo, jl)
    jrs, jrc = jshard(jtopo, jr)
    jcfg = dj_tpu.JoinConfig(over_decom_factor=odf)
    jout, jcounts, jinfo = dj_tpu.distributed_inner_join(jtopo, jls, jlc, jrs, jrc, [0], [0], jcfg)

    ttopo = tj.make_topology(["cpu"])
    tls, tlc = tj.shard_table(ttopo, tl)
    trs, trc = tj.shard_table(ttopo, tr)
    tout, tcounts, tinfo = tj.distributed_inner_join(
        ttopo, tls, tlc, trs, trc, [0], [0], convert.join_config_from(jcfg)
    )
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist(), k
    assert _rows(tj.unshard_table(tout, tcounts)) == _rows(junshard(jout, jcounts))


@pytest.mark.parametrize("odf", [1, 4])
@pytest.mark.parametrize("key_dtype", ["int64", "int32"])
def test_distributed_join_matches_dj_tpu(odf, key_dtype):
    _dist_compare(odf, key_dtype)


# The port's DJT_JOIN_EXPAND modes and dj_tpu's DJ_JOIN_EXPAND.
EXPAND_MODES = {
    "vmeta": "pallas-vmeta", "ranks": "pallas", "fused": "pallas-fused",
    "join": "pallas-join", "vcarry": "pallas-vcarry", "vfull": "pallas-vfull",
}


@pytest.mark.parametrize("odf", [1, 4])
@pytest.mark.parametrize("mode", sorted(EXPAND_MODES))
def test_distributed_join_expand_modes_match_dj_tpu(mode, odf, tiny_pallas_geometry, monkeypatch):
    """Each expansion mode through _local_join_pipeline, against dj_tpu's
    Pallas kernels in interpret mode."""
    from dj_tpu.ops import pallas_scan as psc

    tiny_pallas_geometry(EXPAND_MODES[mode] + "-interpret")
    monkeypatch.setattr(psc, "TILE", 256)
    monkeypatch.setenv("DJ_JOIN_SCANS", "pallas-interpret")
    monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
    _dist_compare(odf, "int64")


def test_join_overflow_flag_matches():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 3, 400)  # heavy duplication overflows 1x output
    pay = np.arange(400, dtype=np.int64)
    jt, tt = _both([keys, pay], ["int64", "int64"])
    jtopo = jmake_topology(jax.devices()[:1])
    js, jc = jshard(jtopo, jt)
    ttopo = tj.make_topology(["cpu"])
    ts, tc = tj.shard_table(ttopo, tt)
    _, _, jinfo = dj_tpu.distributed_inner_join(jtopo, js, jc, js, jc, [0], [0])
    _, _, tinfo = tj.distributed_inner_join(ttopo, ts, tc, ts, tc, [0], [0])
    assert bool(tinfo["join_overflow"][0]) and bool(np.asarray(jinfo["join_overflow"])[0])
    for k in jinfo:
        assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist(), k


@pytest.mark.parametrize("odf,l_cap,r_cap", [(1, 1000, 700), (4, 1000, 700), (3, 17, 5)])
def test_batch_sizing_matches(odf, l_cap, r_cap):
    cfg = dict(over_decom_factor=odf, bucket_factor=1.5, join_out_factor=1.25)
    want = jdist.batch_sizing(dj_tpu.JoinConfig(**cfg), 1, l_cap, r_cap)
    got = tdist.batch_sizing(tdist.JoinConfig(**cfg), 1, l_cap, r_cap)
    assert tuple(got) == tuple(want)


def test_resolve_key_range_matches():
    rng = np.random.default_rng(8)
    a, b = rng.integers(-500, 10**6, 100), rng.integers(0, 10**7, 90)
    ja, ta = _both([a], ["int64"])
    jb, tb = _both([b], ["int64"])
    for kr in (None, (0, 5)):
        want = jdist._resolve_key_range(
            dj_tpu.JoinConfig(key_range=kr), ja, jnp.array([80], jnp.int32),
            jb, jnp.array([90], jnp.int32), [0], [0], 1,
        )
        got = tdist._resolve_key_range(
            tdist.JoinConfig(key_range=kr), ta, torch.tensor([80], dtype=torch.int32),
            tb, torch.tensor([90], dtype=torch.int32), [0], [0], 1,
        )
        assert got == want


@pytest.mark.parametrize("unique", [True, False])
def test_generator_semantics(unique):
    g = torch.Generator().manual_seed(11)
    out = generate_build_probe_tables(g, 5000, 7000, 0.3, 10_000, unique,
                                      return_expected_matches=unique)
    build, probe = out[0], out[1]
    bk, pk = build.columns[0].data.numpy(), probe.columns[0].data.numpy()
    assert bk.dtype == pk.dtype == np.int64
    assert bk.min() >= 0 and bk.max() <= 10_000 and pk.min() >= 0 and pk.max() <= 10_000
    np.testing.assert_array_equal(build.columns[1].data.numpy(), np.arange(5000))
    np.testing.assert_array_equal(probe.columns[1].data.numpy(), np.arange(7000))
    hits = np.isin(pk, bk)
    assert 0.25 < hits.mean() < 0.35
    if unique:
        assert len(np.unique(bk)) == 5000
        assert int(out[2]) == int(hits.sum())
        # The exact count is the join's total.
        _, total = tj.inner_join(probe, build, [0], [0], out_capacity=7000)
        assert int(total) == int(out[2])


def test_convert_roundtrip_and_shard():
    arrays = [np.array([3, -1, 7], np.int64), np.array([1.5, 2.5, -0.0], np.float32)]
    t = convert.table_from_numpy(arrays, ["timestamp_ms", "float32"], 2, device="cpu")
    back, names, vc = convert.table_to_numpy(t)
    assert names == ["timestamp_ms", "float32"] and vc == 2
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(a, b)
    topo = tj.make_topology(["cpu"])
    exact = convert.table_from_numpy(arrays, ["int64", "float32"], device="cpu")
    s, counts = tj.shard_table(topo, exact, capacity_per_shard=5)
    assert s.capacity == 5 and counts.tolist() == [3]
    u = tj.unshard_table(s, counts)
    np.testing.assert_array_equal(u.columns[0].data.numpy(), arrays[0])
    two = tj.make_topology(["cpu", "cpu"], intra_size=1)
    assert two.is_hierarchical
    assert (two.group("inter").size, two.group("intra").size) == (2, 1)
    with pytest.raises(ValueError, match="not divisible"):
        tj.make_topology(["cpu"] * 3, intra_size=2)


def test_single_rank_communicator():
    from dj_tpu_torch.parallel.communicator import SingleRankCommunicator
    from dj_tpu_torch.parallel.topology import CommunicationGroup

    for fuse in (True, False):
        comm = SingleRankCommunicator(CommunicationGroup("ranks", 1), fuse)
        a = torch.arange(6, dtype=torch.int64).reshape(1, 3, 2)
        b = torch.arange(4, dtype=torch.int32).reshape(1, 4)
        c = torch.arange(5, dtype=torch.int64).reshape(1, 5)
        out = comm.exchange([a, b, c])
        for x, y in zip((a, b, c), out):
            assert y.dtype == x.dtype and torch.equal(x, y)
        assert comm.communicate_sizes(torch.tensor([[3, 4]])).tolist() == [[3, 4]]
        assert comm.all_gather(torch.tensor(5)).tolist() == [5]
        assert comm.rank() == 0 and comm.size == 1
    with pytest.raises(ValueError):
        SingleRankCommunicator(CommunicationGroup("ranks", 2))

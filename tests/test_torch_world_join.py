"""dj_tpu_torch's joins over worlds of 2, 4 and 8 ranks vs dj_tpu's on as
many devices of the CPU mesh.

The same numpy tables, sharded the same way, go through
``distributed_inner_join`` in both packages (the port under each
``DJT_JOIN_EXPAND`` mode, dj_tpu under its default plan: the mode does not
change the rows) and through the prepared side at a world of 4 (each of
the port's merge tiers against dj_tpu's shuffle tier). The hash is bit
exact, so every shard holds the same rows in both: compared are the
[w] counts, the bool[w] flags and each shard's row multiset. dj_tpu's
Pallas kernels run in interpret mode in one case only; kernel parity
has its own tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dj_tpu
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.data.generator import host_build_probe_keys

EXPAND_MODES = ("vmeta", "ranks", "fused", "join", "vcarry", "vfull")
TIERS = ("sort", "merge", "probe")


def _shard_rows(table, counts):
    """Each shard's valid rows, sorted."""
    counts = np.asarray(counts).tolist()
    cols = [np.asarray(c.data) for c in table.columns]
    cap = cols[0].shape[0] // len(counts)
    return [sorted(zip(*[c[r * cap : r * cap + n].tolist() for c in cols]))
            for r, n in enumerate(counts)]


def _assert_same(got, want):
    """(table, counts, info) of the port and of dj_tpu: equal counts,
    flags and per-shard row multisets."""
    tout, tcounts, tinfo = got
    jout, jcounts, jinfo = want
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist(), k
    assert _shard_rows(tout, tcounts) == _shard_rows(jout, jcounts)


class _World:
    """The same build and probe tables sharded over w ranks in both
    packages."""

    def __init__(self, w, build, probe):
        self.jtopo = jmake_topology(jax.devices()[:w])
        self.ttopo = tj.make_topology(["cpu"] * w)
        self.j, self.t = {}, {}
        for side, arrays in (("build", build), ("probe", probe)):
            names = [a.dtype.name for a in arrays]
            jt = dj_tpu.from_arrays(*[jnp.asarray(a) for a in arrays],
                                    dtypes=[dj_tpu.dtypes.by_name(n) for n in names])
            self.j[side] = jshard(self.jtopo, jt)
            self.t[side] = tj.shard_table(self.ttopo, convert.table_from_numpy(arrays, names,
                                                                               device="cpu"))

    def jjoin(self, cfg):
        (jl, jlc), (jr, jrc) = self.j["probe"], self.j["build"]
        return dj_tpu.distributed_inner_join(self.jtopo, jl, jlc, jr, jrc, [0], [0], cfg)

    def tjoin(self, cfg):
        (tl, tlc), (tr, trc) = self.t["probe"], self.t["build"]
        return tj.distributed_inner_join(self.ttopo, tl, tlc, tr, trc, [0], [0],
                                         convert.join_config_from(cfg))

    def jprepare(self, cfg, **kw):
        jr, jrc = self.j["build"]
        return jdist.prepare_join_side(self.jtopo, jr, jrc, [0], cfg, tier="shuffle", **kw)

    def tprepare(self, cfg, **kw):
        tr, trc = self.t["build"]
        return tj.prepare_join_side(self.ttopo, tr, trc, [0], convert.join_config_from(cfg), **kw)

    def jquery(self, prep, cfg):
        jl, jlc = self.j["probe"]
        return dj_tpu.distributed_inner_join(self.jtopo, jl, jlc, prep, None, [0], None, cfg)

    def tquery(self, prep, cfg):
        tl, tlc = self.t["probe"]
        return tj.distributed_inner_join(self.ttopo, tl, tlc, prep, None, [0], None,
                                         convert.join_config_from(cfg))


def _join_tables():
    """Probe (int64 key, int64 row, float32 payload) JOIN build (int64
    key, int64 row + 7), selectivity 0.3."""
    rng = np.random.default_rng(7)
    build, probe = host_build_probe_keys(3000, 4000, 0.3, rng, dtype=np.dtype("int64"))
    return ([build, np.arange(3000, dtype=np.int64) + 7],
            [probe, np.arange(4000, dtype=np.int64), rng.standard_normal(4000).astype(np.float32)])


@pytest.fixture(scope="module")
def jax_joins():
    """dj_tpu's join per (w, odf), made on first use."""
    build, probe = _join_tables()
    cache = {}

    def get(w, odf):
        if (w, odf) not in cache:
            world = _World(w, build, probe)
            cache[(w, odf)] = (world, world.jjoin(dj_tpu.JoinConfig(over_decom_factor=odf)))
        return cache[(w, odf)]

    return get


@pytest.mark.parametrize("mode", EXPAND_MODES)
@pytest.mark.parametrize("odf", [1, 4])
@pytest.mark.parametrize("w", [2, 4, 8])
def test_world_join_matches_dj_tpu(w, odf, mode, jax_joins, monkeypatch):
    world, want = jax_joins(w, odf)
    assert not any(np.asarray(v).any() for v in want[2].values())
    monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
    _assert_same(world.tjoin(dj_tpu.JoinConfig(over_decom_factor=odf)), want)


def test_world_join_matches_dj_tpu_pallas_interpret(tiny_pallas_geometry, monkeypatch):
    """A world of 2 at odf 1 against dj_tpu's default kernels, join_scans
    and expand_values, in interpret mode."""
    from dj_tpu.ops import pallas_scan as psc

    tiny_pallas_geometry("pallas-vmeta-interpret")
    monkeypatch.setattr(psc, "TILE", 256)
    monkeypatch.setenv("DJ_JOIN_SCANS", "pallas-interpret")
    world = _World(2, *_join_tables())
    cfg = dj_tpu.JoinConfig()
    _assert_same(world.tjoin(cfg), world.jjoin(cfg))


def _prepared_tables(seed, nb=2400, nl=3600):
    """Build keys unique in [0, 3 nb) with both ends present (a range
    probed from the build side covers every probe key)."""
    rng = np.random.default_rng(seed)
    span = 3 * nb
    build = np.concatenate([[0, span - 1], rng.permutation(np.arange(1, span - 1))[: nb - 2]])
    probe = rng.integers(0, span, nl)
    return ([build.astype(np.int64), np.arange(nb, dtype=np.int64) + 10**6],
            [probe.astype(np.int64), np.arange(nl, dtype=np.int64)])


@pytest.fixture
def jax_query_cache_clear():
    yield
    jdist._build_prepared_query_fn.cache_clear()


@pytest.mark.parametrize("odf", [1, 4])
def test_world_prepared_matches_dj_tpu(odf, monkeypatch, jax_query_cache_clear):
    """A world of 4: the prepared side and a query under each merge tier
    against dj_tpu's shuffle tier, with a probed key range."""
    build, probe = _prepared_tables(odf)
    world = _World(4, build, probe)
    cfg = dj_tpu.JoinConfig(over_decom_factor=odf)
    jprep = world.jprepare(cfg, left_capacity=len(probe[0]))
    tprep = world.tprepare(cfg, left_capacity=len(probe[0]))
    assert tuple(tprep.plan) == tuple(jprep.plan)
    assert tuple(tprep.sizing) == tuple(jprep.sizing)
    assert tprep.key_range == tuple(jprep.key_range)
    for (tw, tp, tc), (jw, jp, jc) in zip(tprep.batches, jprep.batches):
        assert tc.tolist() == np.asarray(jc).tolist()
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int64))
        for g, w in zip(tp.columns, jp.columns):
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
    want = world.jquery(jprep, cfg)
    assert int(np.asarray(want[1]).sum()) == int(np.isin(probe[0], build[0]).sum())
    for tier in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", tier)
        _assert_same(world.tquery(tprep, cfg), want)


@pytest.mark.parametrize("tier", TIERS)
def test_prepared_side_carried_from_a_4_device_mesh(tier, monkeypatch, jax_query_cache_clear):
    """A dj_tpu PreparedSide made on 4 devices, carried into a world of 4
    ranks, serves the rows dj_tpu's query serves, shard for shard."""
    build, probe = _prepared_tables(40)
    world = _World(4, build, probe)
    cfg = dj_tpu.JoinConfig(over_decom_factor=2, key_range=(0, 3 * 2400 - 1))
    jprep = world.jprepare(cfg, left_capacity=len(probe[0]))
    tprep = convert.prepared_side_from(jprep, world.ttopo)
    assert tprep.n == 4 and tprep.batches[0][2].shape == (4,)
    monkeypatch.setenv("DJT_JOIN_MERGE", tier)
    _assert_same(world.tquery(tprep, cfg), world.jquery(jprep, cfg))

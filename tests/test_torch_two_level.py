"""dj_tpu_torch's two-level (inter, intra) topology vs dj_tpu's
('inter', 'intra') mesh on the 8-device CPU mesh.

The same numpy tables, sharded the same way, go through both packages on
(w, intra) = (4, 2), (8, 2), (8, 4) and (4, 1): ``distributed_inner_join``
(the hierarchical pre-shuffle over 'inter', seed 87654321, then the main
stage over 'intra') at odf 1 and 4, under every ``DJT_JOIN_EXPAND`` mode
and the Ring and Buffered backends at (4, 2), with string payloads and
string keys; the ``pre_shuffle_overflow`` flag at a tight
``pre_shuffle_out_factor`` and ``distributed_inner_join_auto``'s heal of
it; the prepared side under each merge tier; ``shuffle_on`` over the
world and per axis, with its split bits, stats and the identity hash,
and ``shuffle_on_auto``'s heal (the compressed wire has its own file,
``tests/test_torch_compress.py``). The hash is bit exact, so every shard
holds the same rows in both: compared are the counts, every flag and
each shard's row multiset. Then the topology itself (groups,
``largest_intra_size`` against dj_tpu's, the generator's shards) and an
in-process world's abort and returned-rank handling across groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import table as jT
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel import shuffle as jshuffle
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import largest_intra_size as jlargest
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.resilience import ledger as jledger
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.data.generator import host_build_probe_keys
from dj_tpu_torch.parallel import dist_join as tdist
from dj_tpu_torch.parallel import shuffle as tshuffle
from dj_tpu_torch.parallel import spmd
from dj_tpu_torch.parallel.communicator import WorldAborted
from dj_tpu_torch.resilience import ledger as tledger

EXPAND_MODES = ("vmeta", "ranks", "fused", "join", "vcarry", "vfull")
TIERS = ("sort", "merge", "probe")
TOPOLOGIES = [(4, 2), (8, 2), (8, 4), (4, 1)]


@pytest.fixture(autouse=True)
def empty_port_ledger(monkeypatch):
    monkeypatch.delenv("DJT_LEDGER", raising=False)
    tledger.reset()
    yield
    tledger.reset()


def _as_tables(arrays, names):
    """(dj_tpu table, port table): a string entry is a list of bytes."""
    jcols, tcols = [], []
    for a, nm in zip(arrays, names):
        if nm == "string":
            jcols.append(jT.from_strings(a))
            tcols.append(tj.from_strings(a, device="cpu"))
        else:
            jcols.append(jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(nm)))
            tcols.append(tj.Column(torch.from_numpy(np.asarray(a)), tj.dtypes.by_name(nm)))
    return jT.Table(tuple(jcols)), tj.Table(tuple(tcols))


def _shard_rows(table, counts):
    """Each shard's valid rows (strings as bytes), sorted."""
    counts = np.asarray(counts).tolist()
    w = len(counts)
    fixed = [np.asarray(c.data) for c in table.columns if not hasattr(c, "chars")]
    cap = fixed[0].shape[0] // w
    shards = []
    for r, n in enumerate(counts):
        cols = []
        for c in table.columns:
            if hasattr(c, "chars"):
                ccap = c.chars.shape[0] // w
                shard = jT.StringColumn(np.asarray(c.offsets)[r * (cap + 1):(r + 1) * (cap + 1)],
                                        np.asarray(c.chars)[r * ccap:(r + 1) * ccap])
                cols.append(jT.to_strings(shard, n))
            else:
                cols.append(np.asarray(c.data)[r * cap:r * cap + n].tolist())
        shards.append(sorted(zip(*cols)))
    return shards


def _flags(info):
    return {k: np.asarray(v).tolist() for k, v in info.items()}


def _assert_same(got, want, rows=True):
    """(table, counts, info) of the port and of dj_tpu: equal counts,
    flags and, unless a flag fired (``rows=False``), per-shard row
    multisets."""
    tout, tcounts, tinfo = got[:3]
    jout, jcounts, jinfo = want[:3]
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    assert _flags(tinfo) == _flags(jinfo)
    if rows:
        assert _shard_rows(tout, tcounts) == _shard_rows(jout, jcounts)


class _World:
    """The same build and probe tables sharded over a two-level world of
    w ranks in both packages."""

    def __init__(self, w, intra, build, probe, build_names=None, probe_names=None):
        self.jtopo = jmake_topology(jax.devices()[:w], intra_size=intra)
        self.ttopo = tj.make_topology(["cpu"] * w, intra_size=intra)
        self.j, self.t = {}, {}
        for side, arrays, names in (("build", build, build_names), ("probe", probe, probe_names)):
            names = names or [a.dtype.name for a in arrays]
            jt, tt = _as_tables(arrays, names)
            self.j[side] = jshard(self.jtopo, jt)
            self.t[side] = tj.shard_table(self.ttopo, tt)

    def jjoin(self, cfg):
        (jl, jlc), (jr, jrc) = self.j["probe"], self.j["build"]
        return dj_tpu.distributed_inner_join(self.jtopo, jl, jlc, jr, jrc, [0], [0], cfg)

    def tjoin(self, cfg):
        (tl, tlc), (tr, trc) = self.t["probe"], self.t["build"]
        return tj.distributed_inner_join(self.ttopo, tl, tlc, tr, trc, [0], [0],
                                         convert.join_config_from(cfg))

    def auto(self, cfg):
        """Both packages' distributed_inner_join_auto: (result, attempts)
        each."""
        out = []
        for pkg, mod, topo, sides, conv in ((dj_tpu, jdist, self.jtopo, self.j, cfg),
                                            (tj, tdist, self.ttopo, self.t,
                                             convert.join_config_from(cfg))):
            (l, lc), (r, rc) = sides["probe"], sides["build"]
            attempts = []
            orig = mod.distributed_inner_join

            def counted(*a, _fn=orig, **k):
                attempts.append(1)
                return _fn(*a, **k)

            mod.distributed_inner_join = counted
            try:
                res = pkg.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], conv)
            finally:
                mod.distributed_inner_join = orig
            out.append((res, len(attempts)))
        return out


def _join_tables():
    """Probe (int64 key, int64 row, float32 payload) JOIN build (int64
    key, int64 row + 7), selectivity 0.3."""
    rng = np.random.default_rng(7)
    build, probe = host_build_probe_keys(3000, 4000, 0.3, rng, dtype=np.dtype("int64"))
    return ([build, np.arange(3000, dtype=np.int64) + 7],
            [probe, np.arange(4000, dtype=np.int64), rng.standard_normal(4000).astype(np.float32)])


@pytest.fixture(scope="module")
def jax_joins():
    """dj_tpu's join per (w, intra, odf, backend), made on first use."""
    build, probe = _join_tables()
    worlds, cache = {}, {}

    def get(w, intra, odf, backend="XlaCommunicator"):
        key = (w, intra, odf, backend)
        if key not in cache:
            world = worlds.setdefault((w, intra), None) or _World(w, intra, build, probe)
            worlds[(w, intra)] = world
            cfg = dj_tpu.JoinConfig(over_decom_factor=odf,
                                    communicator_cls=getattr(dj_tpu, backend))
            cache[key] = (world, cfg, world.jjoin(cfg))
        return cache[key]

    return get


@pytest.mark.parametrize("odf", [1, 4])
@pytest.mark.parametrize("w,intra", TOPOLOGIES)
def test_two_level_join_matches_dj_tpu(w, intra, odf, jax_joins):
    world, cfg, want = jax_joins(w, intra, odf)
    assert world.ttopo.is_hierarchical
    assert not any(np.asarray(v).any() for v in want[2].values())
    got = world.tjoin(cfg)
    _assert_same(got, want)
    assert int(got[1].sum()) == int(np.isin(_join_tables()[1][0], _join_tables()[0][0]).sum())


@pytest.mark.parametrize("mode", EXPAND_MODES)
def test_two_level_join_modes_match_dj_tpu(mode, jax_joins, monkeypatch):
    world, cfg, want = jax_joins(4, 2, 1)
    monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
    _assert_same(world.tjoin(cfg), want)


@pytest.mark.parametrize("backend", ["RingCommunicator", "BufferedCommunicator"])
def test_two_level_backends_match_dj_tpu(backend, jax_joins):
    world, cfg, want = jax_joins(4, 2, 2, backend)
    _assert_same(world.tjoin(cfg), want)


@pytest.mark.parametrize("key_kind", ["int64", "string"])
def test_two_level_string_join_matches_dj_tpu(key_kind):
    """String payloads on both sides, or a string key, through both
    stages of the two-level join."""
    rng = np.random.default_rng(41)
    nb, npr = 600, 800
    bk = rng.permutation(np.arange(2 * nb))[:nb]
    pk = np.where(rng.random(npr) < 0.5, bk[rng.integers(0, nb, npr)],
                  rng.integers(2 * nb, 4 * nb, npr))
    pstr = [bytes([97 + int(k) % 26]) * (int(k) % 7 + 1) for k in pk]
    if key_kind == "string":
        probe = [[b"key-%d" % k for k in pk], np.arange(npr, dtype=np.int64), pstr]
        build = [[b"key-%d" % k for k in bk], bk * 10 + 3]
        pn, bn = ["string", "int64", "string"], ["string", "int64"]
    else:
        probe = [pk, np.arange(npr, dtype=np.int64), pstr]
        build = [bk, [b"b%d" % k for k in bk]]
        pn, bn = ["int64", "int64", "string"], ["int64", "string"]
    world = _World(4, 2, build, probe, bn, pn)
    cfg = dj_tpu.JoinConfig(bucket_factor=4.0, join_out_factor=2.0, char_out_factor=2.0)
    got, want = world.tjoin(cfg), world.jjoin(cfg)
    assert not any(v.any() for v in got[2].values())
    _assert_same(got, want)
    assert int(got[1].sum()) == int(np.isin(pk, bk).sum())


def test_tight_pre_shuffle_fires_and_heals_as_dj_tpu():
    """pre_shuffle_out_factor 0.5 fires pre_shuffle_overflow on the same
    shards in both packages; distributed_inner_join_auto then grows
    pre_shuffle_out_factor and bucket_factor to the same values in the
    same attempts, and a second call starts there from the ledger."""
    world = _World(4, 2, *_join_tables())
    tight = dj_tpu.JoinConfig(pre_shuffle_out_factor=0.5)
    got, want = world.tjoin(tight), world.jjoin(tight)
    assert _flags(got[2]) == _flags(want[2])
    assert all(got[2]["pre_shuffle_overflow"].tolist())
    (jres, jn), (tres, tn) = world.auto(tight)
    assert tn == jn > 1
    _assert_same(tres, jres)
    assert not any(v.any() for v in tres[2].values())
    for f in tdist._CONFIG_FACTOR_FIELDS:
        assert getattr(tres[3], f) == getattr(jres[3], f), f
    assert tres[3].pre_shuffle_out_factor > 0.5 and tres[3].bucket_factor > 2.0
    (_, jn2), (tres2, tn2) = world.auto(tight)
    assert tn2 == jn2 == 1 and tres2[3] == tres[3]


def _prepared_tables(seed, nb=600, nl=900):
    """Build keys unique in [0, 3 nb) with both ends present."""
    rng = np.random.default_rng(seed)
    span = 3 * nb
    build = np.concatenate([[0, span - 1], rng.permutation(np.arange(1, span - 1))[: nb - 2]])
    probe = rng.integers(0, span, nl)
    return ([build.astype(np.int64), np.arange(nb, dtype=np.int64) + 10**6],
            [probe.astype(np.int64), np.arange(nl, dtype=np.int64)])


@pytest.mark.parametrize("odf", [1, 2])
def test_two_level_prepared_matches_dj_tpu(odf, monkeypatch):
    """The prepared side at (4, 2): the build side pre-shuffled, then
    prepared, equal to dj_tpu's batch for batch; a query under each merge
    tier (its probe side pre-shuffled) equal to dj_tpu's."""
    build, probe = _prepared_tables(odf)
    world = _World(4, 2, build, probe)
    cfg = dj_tpu.JoinConfig(over_decom_factor=odf)
    jr, jrc = world.j["build"]
    tr, trc = world.t["build"]
    try:
        jprep = jdist.prepare_join_side(world.jtopo, jr, jrc, [0], cfg, tier="shuffle",
                                        left_capacity=len(probe[0]))
        tprep = tj.prepare_join_side(world.ttopo, tr, trc, [0], convert.join_config_from(cfg),
                                     left_capacity=len(probe[0]))
        assert (tprep.n, tuple(tprep.sizing)) == (jprep.n, tuple(jprep.sizing))
        assert tuple(tprep.plan) == tuple(jprep.plan) and tprep.key_range == tuple(jprep.key_range)
        for (tw, tp, tc), (jw, jp, jc) in zip(tprep.batches, jprep.batches):
            assert tc.tolist() == np.asarray(jc).tolist()
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int64))
            for g, want in zip(tp.columns, jp.columns):
                np.testing.assert_array_equal(g.data.numpy(), np.asarray(want.data))
        (jl, jlc), (tl, tlc) = world.j["probe"], world.t["probe"]
        want = dj_tpu.distributed_inner_join(world.jtopo, jl, jlc, jprep, None, [0], None, cfg)
        assert int(np.asarray(want[1]).sum()) == int(np.isin(probe[0], build[0]).sum())
        for tier in TIERS:
            monkeypatch.setenv("DJT_JOIN_MERGE", tier)
            _assert_same(tj.distributed_inner_join(world.ttopo, tl, tlc, tprep, None, [0], None,
                                                   convert.join_config_from(cfg)), want)
    finally:
        jdist._build_prepared_query_fn.cache_clear()


def test_two_level_prepare_heals_pre_shuffle_overflow_as_dj_tpu():
    """prepare_join_side from pre_shuffle_out_factor 0.5: with one attempt
    both packages raise CapacityExhausted naming pre_shuffle_overflow,
    with the same flags and factors; with the default budget both grow
    the same factors to the same prepared side, which then answers the
    auto query in one attempt."""
    from dj_tpu.resilience.errors import CapacityExhausted as JCapacityExhausted

    build, probe = _prepared_tables(3)
    world = _World(4, 2, build, probe)
    cfg = dj_tpu.JoinConfig(pre_shuffle_out_factor=0.5)
    tcfg = convert.join_config_from(cfg)
    jr, jrc = world.j["build"]
    tr, trc = world.t["build"]
    try:
        with pytest.raises(JCapacityExhausted, match="pre_shuffle_overflow") as jerr:
            jdist.prepare_join_side(world.jtopo, jr, jrc, [0], cfg, tier="shuffle",
                                    max_attempts=1)
        with pytest.raises(tj.CapacityExhausted, match="pre_shuffle_overflow") as terr:
            tj.prepare_join_side(world.ttopo, tr, trc, [0], tcfg, max_attempts=1)
        assert terr.value.flags == jerr.value.flags
        assert terr.value.factors == jerr.value.factors
        jprep = jdist.prepare_join_side(world.jtopo, jr, jrc, [0], cfg, tier="shuffle")
        tprep = tj.prepare_join_side(world.ttopo, tr, trc, [0], tcfg)
        for f in tdist._CONFIG_FACTOR_FIELDS:
            assert getattr(tprep.config, f) == getattr(jprep.config, f), f
        assert tprep.config.pre_shuffle_out_factor > 0.5
        assert tuple(tprep.sizing) == tuple(jprep.sizing)
        (jl, jlc), (tl, tlc) = world.j["probe"], world.t["probe"]
        jres = dj_tpu.distributed_inner_join_auto(world.jtopo, jl, jlc, jprep, None, [0], None,
                                                  cfg)
        tres = tj.distributed_inner_join_auto(world.ttopo, tl, tlc, tprep, None, [0], None, tcfg)
        _assert_same(tres, jres)
        assert not any(v.any() for v in tres[2].values())
        assert tres[3].pre_shuffle_out_factor == jres[3].pre_shuffle_out_factor
    finally:
        jdist._build_prepared_query_fn.cache_clear()


# --- shuffle_on ----------------------------------------------------------


def _shuffle_table(w, hot=False):
    """A sharded (int64 key, int64 row, float32) table of 96 rows a rank;
    with ``hot``, one row in three on one key."""
    rng = np.random.default_rng(50 + w)
    n = 96 * w
    keys = rng.integers(0, 10**6, n)
    if hot:
        keys[::3] = 424242
    return [keys, np.arange(n, dtype=np.int64), rng.standard_normal(n).astype(np.float32)]


def _shuffle_both(w, intra, arrays, axes, **kw):
    """shuffle_on in both packages over ``axes`` in turn (None: the
    world; 'inter' hashes with the pre-shuffle's seed 87654321, so that
    'intra' does not see one hash value per domain): the last call's
    results of each, (dj_tpu, port)."""
    jtopo = jmake_topology(jax.devices()[:w], intra_size=intra)
    ttopo = tj.make_topology(["cpu"] * w, intra_size=intra)
    jt, tt = _as_tables(arrays, [a.dtype.name for a in arrays])
    (jt, jc), (tt, tc) = jshard(jtopo, jt), tj.shard_table(ttopo, tt)
    for axis in axes:
        jg = None if axis is None else jtopo.group(axis)
        tg = None if axis is None else ttopo.group(axis)
        akw = {"seed": tdist.INTER_DOMAIN_SEED, **kw} if axis == "inter" else kw
        jres = dj_tpu.shuffle_on(jtopo, jt, jc, [0], group=jg, **akw)
        tres = tj.shuffle_on(ttopo, tt, tc, [0], group=tg, **akw)
        (jt, jc), (tt, tc) = jres[:2], tres[:2]
    return jres, tres


def _assert_same_shuffle(jres, tres, rows=True):
    jt, jc, jovf = jres[:3]
    tt, tc, tovf = tres[:3]
    assert tc.tolist() == np.asarray(jc).tolist()
    assert tovf.tolist() == np.asarray(jovf).tolist()
    if rows:
        for a, b in zip(tt.columns, jt.columns):
            np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data))
    for jx, tx in zip(jres[3:], tres[3:]):  # the stats and split dicts
        assert set(tx) == set(jx)
        for k in jx:
            assert tx[k].tolist() == np.asarray(jx[k]).tolist(), k


@pytest.mark.parametrize("how", ["flat", "per_axis"])
@pytest.mark.parametrize("w", [4, 8])
def test_shuffle_on_matches_dj_tpu(w, how):
    """shuffle_on over the world of a flat topology, or over 'inter'
    then 'intra' at intra 2: leaf for leaf (padding included), counts,
    overflow, the STAT_KEYS zeros and the split bits."""
    intra, axes = (None, [None]) if how == "flat" else (2, ["inter", "intra"])
    jres, tres = _shuffle_both(w, intra, _shuffle_table(w), axes, with_stats=True,
                               with_split_overflow=True)
    _assert_same_shuffle(jres, tres)
    assert not tres[2].any() and set(tres[3]) == set(tshuffle.STAT_KEYS)
    assert all(not v.any() for v in tres[3].values())
    # Equal keys now share a shard: the flat hash's shard, or per axis.
    keys = [set(r[0] for r in s) for s in _shard_rows(tres[0], tres[1])]
    assert all(not (a & b) for i, a in enumerate(keys) for b in keys[i + 1:])


@pytest.mark.parametrize("how", ["flat", "inter"])
def test_shuffle_on_tight_factors_match_dj_tpu(how):
    """Factors too small for the rows: the same overflow and split bits
    in both packages."""
    intra, axes = (None, [None]) if how == "flat" else (2, ["inter"])
    for bf, of in ((0.3, 2.0), (2.0, 0.3)):
        jres, tres = _shuffle_both(4, intra, _shuffle_table(4), axes, bucket_factor=bf,
                                   out_factor=of, with_split_overflow=True)
        _assert_same_shuffle(jres, tres, rows=False)
        assert tres[3]["bucket" if bf < 1 else "out"].any()


def test_shuffle_on_identity_hash_matches_dj_tpu():
    arrays = _shuffle_table(4)
    arrays[0] = arrays[0] % 1000
    jres, tres = _shuffle_both(4, None, arrays, [None], hash_function=tj.HASH_IDENTITY)
    _assert_same_shuffle(jres, tres)
    for r, s in enumerate(_shard_rows(tres[0], tres[1])):
        # The identity hash of key k is k: it lands on shard k % 4.
        assert s and all(k % 4 == r for k, *_ in s)


@pytest.mark.parametrize("axis", [None, "inter"])
def test_shuffle_on_auto_heals_as_dj_tpu(axis, monkeypatch):
    """One row in three on one key from factors 1.2 / 1.2: the same
    attempts and final factors as dj_tpu's, the same rows; the second
    call of the shape takes 1 attempt through the ledger."""
    intra = None if axis is None else 2
    jtopo = jmake_topology(jax.devices()[:4], intra_size=intra)
    ttopo = tj.make_topology(["cpu"] * 4, intra_size=intra)
    arrays = _shuffle_table(4, hot=True)
    jt, tt = _as_tables(arrays, [a.dtype.name for a in arrays])
    (jt, jc), (tt, tc) = jshard(jtopo, jt), tj.shard_table(ttopo, tt)
    kw = lambda topo: {} if axis is None else {"group": topo.group(axis)}  # noqa: E731
    runs = []
    for _ in range(2):
        calls = {"j": 0, "t": 0}
        for key, mod in (("j", jshuffle), ("t", tshuffle)):
            orig = mod.shuffle_on

            def counted(*a, _fn=orig, _k=key, **k):
                calls[_k] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(mod, "shuffle_on", counted)
        jres = jshuffle.shuffle_on_auto(jtopo, jt, jc, [0], **kw(jtopo))
        tres = tshuffle.shuffle_on_auto(ttopo, tt, tc, [0], **kw(ttopo))
        monkeypatch.undo()
        assert calls["t"] == calls["j"]
        assert tres[3:5] == tuple(jres[3:5])
        _assert_same_shuffle(jres[:3], tres[:3])
        runs.append((calls["t"], tres[3:5]))
    (n1, f1), (n2, f2) = runs
    assert n1 > 1 and f1[0] > 1.2 and n2 == 1 and f2 == f1
    assert tledger.entries() == jledger.entries() and len(tledger.entries()) == 1


def test_shuffle_on_takes_compression_and_refuses_foreign_groups():
    topo = tj.make_topology(["cpu"] * 4, intra_size=2)
    table = convert.table_from_numpy([np.arange(800)], ["int64"], device="cpu")
    t, c = tj.shard_table(topo, table)
    opts = tj.generate_auto_select_compression_options(table)
    assert opts[0].method == "cascaded"
    out, counts, ovf, stats = tj.shuffle_on(topo, t, c, [0], group=topo.group("inter"),
                                            compression=opts, with_stats=True)
    assert int(counts.sum()) == 800 and not ovf.any()
    assert sorted(tj.unshard_table(out, counts).columns[0].data.tolist()) == list(range(800))
    assert bool((stats["comp_actual_bytes"] > 0).all())
    with pytest.raises(ValueError, match="single-axis"):
        tj.shuffle_on(topo, t, c, [0])
    with pytest.raises(ValueError):
        tj.shuffle_on(topo, t, c, [0], group=tj.CommunicationGroup("intra", 4))


# --- the topology ---------------------------------------------------------


@pytest.mark.parametrize("w,intra", TOPOLOGIES)
def test_two_level_topology_groups_match_dj_tpu(w, intra):
    jt = jmake_topology(jax.devices()[:w], intra_size=intra)
    tt = tj.make_topology(["cpu"] * w, intra_size=intra)
    assert tt.axis_names == jt.axis_names == ("inter", "intra")
    assert tt.is_hierarchical and tt.world_size == w
    for axis in tt.axis_names:
        assert (tt.group(axis).axis_name, tt.group(axis).size) == \
            (jt.group(axis).axis_name, jt.group(axis).size)
    with pytest.raises(ValueError, match="single-axis"):
        tt.world_group()
    # Rank r = inter index * intra + intra index, dj_tpu's mesh layout.
    grid = np.arange(w).reshape(w // intra, intra)
    for r in range(w):
        assert tt.group_ranks("intra", r) == grid[r // intra].tolist()
        assert tt.group_ranks("inter", r) == grid[:, r % intra].tolist()


def test_topology_flat_and_refusals():
    for intra in (None, 4, 8):
        t = tj.make_topology(["cpu"] * 4, intra_size=intra)
        assert not t.is_hierarchical and t.axis_names == ("ranks",)
        assert t.world_group().size == 4
    for w, intra in ((6, 4), (8, 3), (5, 2)):
        with pytest.raises(ValueError, match="not divisible"):
            jmake_topology(jax.devices()[:w], intra_size=intra)
        with pytest.raises(ValueError, match="not divisible"):
            tj.make_topology(["cpu"] * w, intra_size=intra)


def test_largest_intra_size_matches_dj_tpu():
    for world in range(1, 65):
        for max_domain in range(1, 71):
            assert tj.largest_intra_size(world, max_domain) == jlargest(world, max_domain), \
                (world, max_domain)


@pytest.mark.parametrize("w,intra", TOPOLOGIES)
def test_generate_two_level_equals_flat(w, intra):
    """generate_tables_distributed on a two-level topology gives the flat
    world's shards (dj_tpu's tests/test_generator.py:71-73)."""
    two = tj.generate_tables_distributed(tj.make_topology(["cpu"] * w, intra_size=intra),
                                         8 * w, 16 * w, 0.3, 99, True, seed=5)
    flat = tj.generate_tables_distributed(tj.make_topology(["cpu"] * w),
                                          8 * w, 16 * w, 0.3, 99, True, seed=5)
    for a, b in zip(two, flat):
        if isinstance(a, torch.Tensor):
            assert a.tolist() == b.tolist()
        else:
            for x, y in zip(a.columns, b.columns):
                assert torch.equal(x.data, y.data)


def test_a_rank_raising_in_an_intra_rendezvous_aborts_the_world(monkeypatch):
    """Rank 1 raises while its intra peer waits in an intra exchange and
    the other domain waits in 'inter': every rank wakes with
    WorldAborted and the caller gets rank 1's error, within the time
    limit."""
    monkeypatch.setattr(spmd, "RENDEZVOUS_TIMEOUT_S", 60.0)
    topo = tj.make_topology(["cpu"] * 4, intra_size=2)
    seen = []

    def body(comm):
        r = comm.world_rank()
        if r == 1:
            raise ValueError("rank 1 fails on purpose")
        try:
            if r == 0:
                comm.all_to_all(torch.zeros(2, 3))
            else:
                comm.sub("inter").all_to_all(torch.zeros(2, 3))
                comm.all_to_all(torch.zeros(2, 3))
        except WorldAborted:
            seen.append(r)
            raise
        return torch.zeros(1)

    with pytest.raises(ValueError, match="on purpose"):
        spmd.run_spmd(topo, body)
    assert sorted(seen) == [0, 2, 3]


def test_a_returned_rank_fails_only_its_own_groups_rendezvous():
    """Inter group 0 (ranks 0 and 2) returns after one exchange while
    inter group 1 (ranks 1 and 3) makes two: group 1's second one
    completes. A rank left alone in its group by a returned peer raises."""
    topo = tj.make_topology(["cpu"] * 4, intra_size=2)

    def body(comm):
        r = comm.world_rank()
        inter = comm.sub("inter")
        x = torch.full((2, 1), r, dtype=torch.int64)
        out = inter.all_to_all(x)
        if r % 2:
            out = inter.all_to_all(out + 10)
        return out.reshape(1, 2)

    got = spmd.run_spmd(topo, body)
    assert got.tolist() == [[0, 2], [11, 11], [0, 2], [13, 13]]

    def lonely(comm):
        if comm.world_rank() == 0:
            comm.all_to_all(torch.zeros(2, 1))
        return torch.zeros(1)

    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1\] returned"):
        spmd.run_spmd(topo, lonely)


def test_two_level_phases_time_the_pre_shuffle():
    """record_phases names the pre-shuffle's phases dj_pre_shuffle and
    dj_pre_shuffle/a2a_*, apart from the main stage's."""
    build, probe = _join_tables()
    topo = tj.make_topology(["cpu"] * 4, intra_size=2)
    (l, lc), (r, rc) = (tj.shard_table(topo, convert.table_from_numpy(a, [x.dtype.name for x in a],
                                                                      device="cpu"))
                        for a in (probe, build))
    with spmd.record_phases() as runs:
        tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0])
    assert len(runs) == 1 and len(runs[0]) == 4
    for phases in runs[0]:
        assert {"dj_pre_shuffle", "dj_pre_shuffle/a2a_exchange", "a2a_exchange",
                "dj_partition", "dj_join"} <= set(phases)


def test_chip_smoke_two_level_phases_rehearse_on_cpu(monkeypatch, capsys):
    """chip_smoke's phases 4e and 4f at 8000 rows on CPU tables: the
    card's calls stubbed (synchronize, memory stats), the kernels'
    wrappers made to count their plain calls, every check of the phases
    run as on the card."""
    import importlib.util
    import pathlib
    import types

    from dj_tpu_torch.ops import expand, join as tjoin, merge, scan

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name, fn in (("synchronize", lambda *a, **k: None),
                     ("reset_peak_memory_stats", lambda *a, **k: None),
                     ("max_memory_allocated", lambda *a, **k: 0),
                     ("memory_allocated", lambda *a, **k: 0),
                     ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    counters = [("join_scans", scan, "launches"), ("merge_sorted_u64", merge, "launches")] + [
        (name, expand, c) for name, c in cs.EXPAND_COUNTERS.items()]
    for name, module, counter in counters:
        real = getattr(tjoin, name)

        def counted(*a, _real=real, _m=module, _c=counter, **k):
            setattr(_m, _c, getattr(_m, _c) + 1)
            return _real(*a, **k)

        monkeypatch.setattr(tjoin, name, counted)
    rows = 8000
    gen = torch.Generator().manual_seed(0)
    build, probe, expected = tj.generate_build_probe_tables(
        gen, rows, rows, 0.3, 2 * rows, True, return_expected_matches=True)
    one = tj.make_topology(["cpu"])
    (l1, lc1), (r1, rc1) = tj.shard_table(one, probe), tj.shard_table(one, build)
    ref = cs.sorted_rows(*tj.distributed_inner_join(one, l1, lc1, r1, rc1, [0], [0])[:2])
    dj = types.SimpleNamespace(**{k: getattr(tj, k) for k in tj.__all__})
    cpu = torch.device("cpu")
    launches, digests = cs.run_two_level(dj, cpu, build, probe, int(expected), ref, rows, "cpu")
    assert launches["unprepared"][4]["join_scans"] == 4 * cs.WORLD
    assert launches["prepared_probe"][1]["expand_ranks"] == cs.WORLD
    assert sum(d[0] for d in digests) == int(expected)
    shuffled = cs.run_shuffle_on(dj, cpu, rows, 0, "cpu")
    assert sum(d[0] for d in shuffled) == rows
    out = capsys.readouterr().out
    for line in ("[two_level_path]", "[two_level_auto]", "[two_level_prepare]", "[two_level]",
                 "[shuffle_on]", "[shuffle_on_auto]", "[shuffle_on_phase]"):
        assert line in out
    assert '"pre_shuffle_ms": ' in out

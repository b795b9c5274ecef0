"""dj_tpu_torch's prepared side with string columns vs dj_tpu's.

Seeded numpy tables with string payloads on the build side, the probe
side or both go through both packages: ``prepare_packed_batch`` and each
merge tier's per-batch join (``inner_join_prepared``, sort, merge and
probe, with ``char_out_factor``), then ``prepare_join_side`` and a
query at worlds of 1 and 4 ranks and odf 1 and 4, the ``char_overflow``
flag firing and ``distributed_inner_join_auto`` healing it, and the
ValueError a string key raises. Then the probe tier's expansions
(``DJT_PROBE_EXPAND`` segment, hist and pallas) against dj_tpu's
(``DJ_PROBE_EXPAND`` segment, hist and pallas-interpret) at the ops
level. Compared exactly: words, totals, counts, every flag, and row
multisets with strings as bytes (shard for shard in the worlds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import table as jT
from dj_tpu.ops import join as jjoin
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.ops import join as tjoin

TIERS = ("sort", "merge", "probe")
PRIORITIES = [b"1-URGENT", b"2-HIGH", b"3-MEDIUM", b"4-NOT SPECIFIED", b"5-LOW"]


@pytest.fixture(autouse=True)
def _fresh_ledger():
    # One torch thread: the port's side runs many small ops, whose thread
    # pools stall when other test processes share the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tj.resilience.ledger.reset()
    yield
    tj.resilience.ledger.reset()
    torch.set_num_threads(threads)


def _both(arrays, names, valid=None):
    """(dj_tpu table, port table): a "string" entry is a list of bytes."""
    jcols, tcols = [], []
    for a, nm in zip(arrays, names):
        if nm == "string":
            jcols.append(jT.from_strings(a))
            tcols.append(tj.from_strings(a, device="cpu"))
        else:
            a = np.asarray(a, dtype=nm)
            jcols.append(jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(nm)))
            tcols.append(convert.table_from_numpy([a], [nm], device="cpu").columns[0])
    tv = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    return (jT.Table(tuple(jcols), None if valid is None else jnp.int32(valid)),
            tj.Table(tuple(tcols), tv))


def _rows(table, count):
    """The first ``count`` rows (strings as bytes), sorted."""
    cols = [jT.to_strings(jT.StringColumn(np.asarray(c.offsets), np.asarray(c.chars)), count)
            if hasattr(c, "chars") else np.asarray(c.data)[:count].tolist()
            for c in table.columns]
    return sorted(zip(*cols))


def _side_tables(sides, seed, nb=400, nl=600, dup=1, all_match=False):
    """(build arrays, names, probe arrays, names, key range): build keys
    unique in [0, 3 nb) (each ``dup`` times) with both ends present,
    probe keys in the span (build keys with ``all_match``); a string
    payload on ``sides`` ("build", "probe" or "both")."""
    rng = np.random.default_rng(seed)
    span = 3 * nb
    bk = np.concatenate([[0, span - 1], rng.permutation(np.arange(1, span - 1))[: nb - 2]])
    bk = np.tile(bk, dup)
    pk = rng.choice(bk, nl) if all_match else rng.integers(0, span, nl)
    build = [bk, np.arange(bk.size) + 10**6]
    bnames = ["int64", "int64"]
    probe = [pk, np.arange(nl)]
    pnames = ["int64", "int64"]
    if sides in ("build", "both"):
        build.append([PRIORITIES[k % 5] for k in bk])
        bnames.append("string")
    if sides in ("probe", "both"):
        probe.append([b"p%d" % k * (int(k) % 4) for k in pk])
        pnames.append("string")
    return build, bnames, probe, pnames, (0, span - 1)


@pytest.fixture(scope="module")
def ops_ref():
    """dj_tpu's prepare_packed_batch and per-batch join (its CPU default
    tier) of one seeded pair with a string payload on both sides and
    duplicate build keys, at char_out_factor 3 and 0.2, made once."""
    build, bnames, probe, pnames, kr = _side_tables("both", 4, 60, 90, dup=2)
    jr, tr = _both(build, bnames, valid=len(build[0]) - 7)
    jl, tl = _both(probe, pnames, valid=85)
    plan = jjoin.plan_prepared_pack(kr, [np.int64], jl.capacity + jr.capacity)
    # Compiled whole: dj_tpu's eager ops would each compile on first use.
    jw, jpay, _ = jax.jit(lambda r: jjoin.prepare_packed_batch(r, [0], plan))(jr)
    join = jax.jit(lambda f: jjoin.inner_join_prepared(jl, [0], jw, jpay, plan, 1024, f, "xla"),
                   static_argnums=0)
    return tr, tl, plan, jw, jpay, [join(f) for f in (3.0, 0.2)]


# Column positions (in the both-sides pair and its join result) that a
# pair with strings on ``sides`` keeps: the left columns then the
# payload columns.
OPS_KEEP = {"build": ([0, 1, 2], [0, 1, 3, 4]), "probe": ([0, 1], [0, 1, 2, 3]),
            "both": ([0, 1, 2], [0, 1, 2, 3, 4])}


@pytest.mark.parametrize("sides", ["build", "probe", "both"])
def test_prepared_string_ops_match_dj_tpu(sides, ops_ref):
    """prepare_packed_batch carries the build side's strings in sorted
    order, and every tier's join gathers both sides' strings at
    char_out_factor 3 (with duplicate build keys), equal to dj_tpu's (its
    CPU default tier). A pair with strings on one side only is the
    both-sides pair without the other side's string column, so its
    reference is dj_tpu's result without that column."""
    tr, tl, plan, jw, jpay, ((jres, jtot, jflags), (jres1, _, _)) = ops_ref
    rkeep, okeep = OPS_KEEP[sides]
    tr = tj.Table(tuple(tr.columns[i] for i in rkeep), tr.valid_count)
    if sides == "build":
        tl = tj.Table(tl.columns[:2], tl.valid_count)
    jres = jT.Table(tuple(jres.columns[i] for i in okeep), jres.count())
    jres1 = jT.Table(tuple(jres1.columns[i] for i in okeep), jres1.count())
    tplan = tjoin.PreparedPackPlan(*plan)
    tw, tpay, _ = tjoin.prepare_packed_batch(tr, [0], tplan)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int64))
    jpay = jT.Table(tuple(jpay.columns[i - 1] for i in rkeep[1:]), jpay.count())
    n = int(jpay.count())
    assert _rows(tpay, n) == _rows(jpay, n)
    for g, w in zip(tpay.columns, jpay.columns):
        if hasattr(w, "chars"):
            assert jT.to_strings(jT.StringColumn(g.offsets.numpy(), g.chars.numpy())) == \
                jT.to_strings(w)
    k = int(jres.count())
    for tier in TIERS:
        tres, ttot, tflags = tjoin.inner_join_prepared(tl, [0], tw, tpay, tplan, 1024, tier,
                                                       char_out_factor=3.0)
        assert int(ttot) == int(jtot) > 0
        assert not bool(tflags["prepared_plan_mismatch"]) and not bool(jflags["prepared_plan_mismatch"])
        assert [c.dtype.name for c in tres.columns] == [c.dtype.name for c in jres.columns]
        for g, w in zip(tres.columns, jres.columns):
            if hasattr(w, "chars"):
                assert g.chars.shape == w.chars.shape, tier
                assert bool(g.char_overflow()) == bool(w.char_overflow()) is False
        assert _rows(tres, k) == _rows(jres, k), tier
    # At factor 0.2 the matched rows' strings need more bytes than the
    # output holds: char_overflow in both packages, on every tier.
    want = [bool(c.char_overflow()) for c in jres1.columns if hasattr(c, "chars")]
    assert any(want)
    for tier in TIERS:
        tres1 = tjoin.inner_join_prepared(tl, [0], tw, tpay, tplan, 1024, tier,
                                          char_out_factor=0.2)[0]
        assert [bool(c.char_overflow()) for c in tres1.columns if hasattr(c, "chars")] == want


class _World:
    def __init__(self, w, build, bnames, probe, pnames):
        self.w = w
        self.jtopo = jmake_topology(jax.devices()[:w])
        self.ttopo = tj.make_topology(["cpu"] * w)
        jb, tb = _both(build, bnames)
        jp, tp = _both(probe, pnames)
        self.jr, self.jrc = jshard(self.jtopo, jb)
        self.jl, self.jlc = jshard(self.jtopo, jp)
        self.tr, self.trc = tj.shard_table(self.ttopo, tb)
        self.tl, self.tlc = tj.shard_table(self.ttopo, tp)
        self.nl = len(probe[0])

    def prepare(self, cfg):
        jprep = jdist.prepare_join_side(self.jtopo, self.jr, self.jrc, [0], cfg, tier="shuffle",
                                        left_capacity=self.nl)
        tprep = tj.prepare_join_side(self.ttopo, self.tr, self.trc, [0],
                                     convert.join_config_from(cfg), left_capacity=self.nl)
        return jprep, tprep

    def jquery(self, prep, cfg):
        return dj_tpu.distributed_inner_join(self.jtopo, self.jl, self.jlc, prep, None, [0], None,
                                             cfg)

    def tquery(self, prep, cfg):
        return tj.distributed_inner_join(self.ttopo, self.tl, self.tlc, prep, None, [0], None,
                                         convert.join_config_from(cfg))


def _shard_rows(table, counts, w):
    counts = np.asarray(counts).tolist()
    cap = table.capacity // w
    out = []
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
        out.append(sorted(zip(*cols)))
    return out


def _assert_same(got, want, w, what):
    tout, tcounts, tinfo = got
    jout, jcounts, jinfo = want
    assert tcounts.tolist() == np.asarray(jcounts).tolist(), what
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist(), (what, k)
    assert _shard_rows(tout, tcounts, w) == _shard_rows(jout, jcounts, w), what


@pytest.mark.parametrize("w,odf,sides", [(1, 1, "build"), (1, 1, "probe"), (1, 4, "both"),
                                         (4, 1, "both")])
def test_prepared_string_join_matches_dj_tpu(w, odf, sides, monkeypatch):
    """prepare_join_side and a query under each merge tier: counts,
    flags (all False) and each shard's rows with their strings equal to
    dj_tpu's shuffle tier."""
    build, bnames, probe, pnames, kr = _side_tables(sides, 10 * w + odf)
    world = _World(w, build, bnames, probe, pnames)
    cfg = dj_tpu.JoinConfig(over_decom_factor=odf, key_range=kr, bucket_factor=4.0,
                            char_out_factor=2.0)
    jprep, tprep = world.prepare(cfg)
    for (tw, tp, tc), (jw, jp, jc) in zip(tprep.batches, jprep.batches):
        assert tc.tolist() == np.asarray(jc).tolist()
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int64))
    want = world.jquery(jprep, cfg)
    assert not any(np.asarray(v).any() for v in want[2].values())
    assert int(np.asarray(want[1]).sum()) == int(np.isin(probe[0], build[0]).sum())
    for tier in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", tier)
        _assert_same(world.tquery(tprep, cfg), want, w, tier)
    jdist._build_prepared_query_fn.cache_clear()


@pytest.mark.parametrize("w", [4])
def test_prepared_char_overflow_fires_and_heals_as_dj_tpu(w, monkeypatch):
    """Every probe row on four build rows at char_out_factor 1: the
    query's char_overflow fires on the same ranks as dj_tpu's, and
    distributed_inner_join_auto heals it to the same factor and rows."""
    build, bnames, probe, pnames, kr = _side_tables("both", 50 + w, 100, 300, dup=4,
                                                    all_match=True)
    world = _World(w, build, bnames, probe, pnames)
    cfg = dj_tpu.JoinConfig(key_range=kr, join_out_factor=8.0)
    jprep, tprep = world.prepare(cfg)
    _, _, jinfo = world.jquery(jprep, cfg)
    assert np.asarray(jinfo["char_overflow"]).any()
    for tier in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", tier)
        _, _, tinfo = world.tquery(tprep, cfg)
        for k in jinfo:
            assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist(), (tier, k)
    monkeypatch.delenv("DJT_JOIN_MERGE")
    jout, jcounts, _, jcfg, _ = dj_tpu.distributed_inner_join_auto(
        world.jtopo, world.jl, world.jlc, jprep, None, [0], None, cfg)
    tout, tcounts, tinfo, tcfg, _ = tj.distributed_inner_join_auto(
        world.ttopo, world.tl, world.tlc, tprep, None, [0], None, convert.join_config_from(cfg))
    assert tcfg.char_out_factor == jcfg.char_out_factor > 1.0
    assert not any(bool(v.any()) for v in tinfo.values())
    assert _shard_rows(tout, tcounts, w) == _shard_rows(jout, jcounts, w)
    jdist._build_prepared_query_fn.cache_clear()


def test_string_keys_raise_dj_tpus_errors():
    """A string build key raises dj_tpu's ValueError from both
    prepare_join_side calls; a string probe key against an int64 plan
    raises PreparedPlanMismatch in both packages."""
    keys = [b"k%d" % k for k in range(40)]
    jt, tt = _both([keys, np.arange(40)], ["string", "int64"])
    world = _World(1, [np.arange(40), np.arange(40)], ["int64", "int64"],
                   [keys, np.arange(40)], ["string", "int64"])
    with pytest.raises(ValueError, match="fixed-width int join keys") as je:
        jdist.prepare_join_side(world.jtopo, *jshard(world.jtopo, jt), [0], tier="shuffle")
    with pytest.raises(ValueError, match="fixed-width int join keys") as te:
        tj.prepare_join_side(world.ttopo, *tj.shard_table(world.ttopo, tt), [0])
    assert str(te.value) == str(je.value)
    cfg = dj_tpu.JoinConfig(key_range=(0, 39))
    jprep, tprep = world.prepare(cfg)
    with pytest.raises(jdist.PreparedPlanMismatch):
        world.jquery(jprep, cfg)
    with pytest.raises(tj.PreparedPlanMismatch):
        world.tquery(tprep, cfg)


def _probe_case(name):
    """(left keys, right keys, L, R) of dj_tpu's probe-expansion cases
    (tests/test_prepared_tier.py:588-602)."""
    rng = np.random.default_rng(len(name))
    L, R = 96, 64
    if name == "empty-right":
        return rng.integers(0, 30, L), np.full(R, 10**6), L, R
    if name == "all-match":
        return np.full(L, 3), np.full(R, 3), L, R
    return rng.integers(0, 12, L), rng.integers(0, 12, R), L, R


@pytest.mark.parametrize("case", ["duplicate-heavy", "all-match", "empty-right"])
def test_probe_expand_modes_match_dj_tpu(case, monkeypatch, tiny_pallas_geometry):
    """Each DJT_PROBE_EXPAND mode of the port's probe tier against each of
    dj_tpu's DJ_PROBE_EXPAND implementations (pallas in interpret mode),
    with a string payload on the build side: equal totals, flags and
    rows."""
    tiny_pallas_geometry("pallas-vmeta-interpret")
    lk, rk, L, R = _probe_case(case)
    hi = max(int(lk.max()), int(rk.max()))
    rs = [PRIORITIES[int(k) % 5] for k in rk]
    jr, tr = _both([rk, np.arange(R) + 10**6, rs], ["int64", "int64", "string"])
    jl, tl = _both([lk, np.arange(L)], ["int64", "int64"])
    plan = jjoin.plan_prepared_pack((0, hi), [np.int64], L + R)
    tplan = tjoin.PreparedPackPlan(*plan)
    jw, jpay, _ = jax.jit(lambda r: jjoin.prepare_packed_batch(r, [0], plan))(jr)
    tw, tpay, _ = tjoin.prepare_packed_batch(tr, [0], tplan)
    wants = []
    for impl in ("segment", "hist", "pallas-interpret"):
        monkeypatch.setenv("DJ_PROBE_EXPAND", impl)  # read as the jit traces
        res, tot, flags = jax.jit(
            lambda: jjoin.inner_join_probe(jl, [0], jw, jpay, plan, 8192, 4.0))()
        wants.append((int(tot), _rows(res, int(res.count()))))
    assert wants[0] == wants[1] == wants[2]
    for mode in ("segment", "hist", "pallas"):
        monkeypatch.setenv("DJT_PROBE_EXPAND", mode)
        res, tot, flags = tjoin.inner_join_probe(tl, [0], tw, tpay, tplan, 8192, 4.0)
        assert not bool(flags["prepared_plan_mismatch"])
        assert (int(tot), _rows(res, int(res.count()))) == wants[0], mode
        assert tjoin.prepared_effective_plan("probe") == (
            ("expand_values",) if mode == "pallas" else ("expand_ranks",))
    monkeypatch.setenv("DJT_PROBE_EXPAND", "pallas-interpret")
    with pytest.raises(ValueError, match="DJT_PROBE_EXPAND"):
        tjoin.inner_join_probe(tl, [0], tw, tpay, tplan, 8192)


def test_probe_expand_modes_through_the_query(monkeypatch):
    """Each DJT_PROBE_EXPAND mode of a probe-tier query at a world of 4
    and odf 2 serves dj_tpu's rows (its default probe expansion) shard
    for shard, one probe row in 25 on a hot build key."""
    build, bnames, probe, pnames, kr = _side_tables("both", 72, 300, 500, dup=2)
    probe[0][::25] = build[0][0]
    world = _World(4, build, bnames, probe, pnames)
    cfg = dj_tpu.JoinConfig(over_decom_factor=2, key_range=kr, bucket_factor=8.0,
                            join_out_factor=4.0, char_out_factor=4.0)
    jprep, tprep = world.prepare(cfg)
    monkeypatch.setenv("DJ_JOIN_MERGE", "probe")
    want = world.jquery(jprep, cfg)
    assert not any(np.asarray(v).any() for v in want[2].values())
    monkeypatch.setenv("DJT_JOIN_MERGE", "probe")
    for mode in ("segment", "hist", "pallas"):
        monkeypatch.setenv("DJT_PROBE_EXPAND", mode)
        _assert_same(world.tquery(tprep, cfg), want, 4, mode)
    jdist._build_prepared_query_fn.cache_clear()

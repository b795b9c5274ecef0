"""dj_tpu_torch's prepared build side end to end vs dj_tpu's.

prepare_join_side, then distributed_inner_join with the PreparedSide, on
a one-rank CPU world in the port and on a one-device mesh in dj_tpu
(``jax.devices()[:1]``, the shuffle tier), at over_decom_factor 1 and 4,
with a declared and a probed key range: each of the port's merge tiers
against each of dj_tpu's (its CPU default xla, its Pallas merge kernel
in interpret mode, its probe tier). Compared: counts, flags and row
multisets, exactly. Also: a dj_tpu PreparedSide carried into the port
serves the same rows, PreparedPlanMismatch is raised on the same
structural mismatches as in dj_tpu, and the prepare heals as dj_tpu's
does (with one attempt, both raise the same CapacityExhausted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
import dj_tpu.ops.pallas_merge as PM
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard, unshard_table as junshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.resilience import errors as jerrors
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.resilience import errors as terrors

TIERS = ("sort", "merge", "probe")


@pytest.fixture(autouse=True)
def empty_port_ledger():
    """The port's capacity ledger empty around each test, as dj_tpu's
    conftest keeps dj_tpu's: a healed prepare would widen later ones."""
    tj.resilience.ledger.reset()
    yield
    tj.resilience.ledger.reset()


def _rows(table):
    return sorted(zip(*[np.asarray(c.data).tolist() for c in table.columns]))


def _both(arrays):
    names = [a.dtype.name for a in arrays]
    jt = dj_tpu.from_arrays(*[jnp.asarray(a) for a in arrays],
                            dtypes=[dj_tpu.dtypes.by_name(n) for n in names])
    return jt, convert.table_from_numpy(arrays, names, device="cpu")


def _tables(seed, nb=2000, nl=3000, key_dtype=np.int64):
    """Build keys unique in [0, 3 nb) with both ends present, so that a
    range probed from the build side covers every probe key."""
    rng = np.random.default_rng(seed)
    span = 3 * nb
    build = np.concatenate([[0, span - 1], rng.permutation(np.arange(1, span - 1))[: nb - 2]])
    probe = rng.integers(0, span, nl)
    build, probe = build.astype(key_dtype), probe.astype(key_dtype)
    want = int(np.isin(probe, build).sum())
    return (
        [build, np.arange(nb, dtype=np.int64) + 10**6],
        [probe, np.arange(nl, dtype=np.int64)],
        (0, span - 1),
        want,
    )


class _World:
    """The same sharded build and probe tables in both packages."""

    def __init__(self, build, probe):
        self.jtopo = jmake_topology(jax.devices()[:1])
        self.ttopo = tj.make_topology(["cpu"])
        jb, tb = _both(build)
        jp, tp = _both(probe)
        self.jr, self.jrc = jshard(self.jtopo, jb)
        self.jl, self.jlc = jshard(self.jtopo, jp)
        self.tr, self.trc = tj.shard_table(self.ttopo, tb)
        self.tl, self.tlc = tj.shard_table(self.ttopo, tp)

    def jprepare(self, cfg, **kw):
        return jdist.prepare_join_side(self.jtopo, self.jr, self.jrc, [0], cfg, tier="shuffle", **kw)

    def tprepare(self, cfg, **kw):
        return tj.prepare_join_side(self.ttopo, self.tr, self.trc, [0], convert.join_config_from(cfg), **kw)

    def jquery(self, prep, cfg):
        out, counts, info = dj_tpu.distributed_inner_join(self.jtopo, self.jl, self.jlc, prep, None, [0], None, cfg)
        return junshard(out, counts), counts, info

    def tquery(self, prep, cfg):
        out, counts, info = tj.distributed_inner_join(
            self.ttopo, self.tl, self.tlc, prep, None, [0], None, convert.join_config_from(cfg)
        )
        return tj.unshard_table(out, counts), counts, info


@pytest.fixture
def jax_tier(request, monkeypatch):
    """Set dj_tpu's merge tier (DJ_JOIN_MERGE) for the test and drop the
    query modules traced under it afterwards (the interpret tile is read
    at trace time and is not part of the build-cache key)."""
    tier = request.param
    monkeypatch.setenv("DJ_JOIN_MERGE", tier)
    if tier == "pallas-interpret":
        monkeypatch.setattr(PM, "TILE_M", 1024)
        monkeypatch.setenv("DJ_SHARDMAP_CHECK_VMA", "0")
    yield tier
    jdist._build_prepared_query_fn.cache_clear()


@pytest.mark.parametrize("jax_tier", ["xla", "pallas-interpret", "probe"], indirect=True)
@pytest.mark.parametrize("declared", [True, False])
@pytest.mark.parametrize("odf", [1, 4])
def test_prepared_join_matches_dj_tpu(odf, declared, jax_tier, monkeypatch):
    build, probe, kr, want = _tables(odf * 10 + declared)
    w = _World(build, probe)
    cfg = dj_tpu.JoinConfig(over_decom_factor=odf, key_range=kr if declared else None)
    jprep = w.jprepare(cfg, left_capacity=len(probe[0]))
    tprep = w.tprepare(cfg, left_capacity=len(probe[0]))
    assert tuple(tprep.plan) == tuple(jprep.plan)
    assert tuple(tprep.sizing) == tuple(jprep.sizing)
    assert tprep.key_range == tuple(jprep.key_range)
    jt, jcounts, jinfo = w.jquery(jprep, cfg)
    assert int(np.asarray(jcounts).sum()) == want
    for tier in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", tier)
        tt, tcounts, tinfo = w.tquery(tprep, cfg)
        assert tcounts.tolist() == np.asarray(jcounts).tolist(), tier
        assert set(tinfo) == set(jinfo)
        for k in jinfo:
            assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist() == [False], (tier, k)
        assert _rows(tt) == _rows(jt), tier


@pytest.mark.parametrize("tier", TIERS)
def test_prepared_unsigned_columns_match_dj_tpu(tier, monkeypatch):
    """uint32 keys past 2^31 with a uint64 build payload and a uint16
    probe payload, each with its top bit set; the key range is probed."""
    build, probe, _, want = _tables(31, nb=600, nl=900, key_dtype=np.int64)
    shift = 2**32 - 3 * 600
    build[0] = (build[0] + shift).astype(np.uint32)
    probe[0] = (probe[0] + shift).astype(np.uint32)
    build[1] = build[1].astype(np.uint64) + np.uint64(2**63)
    probe[1] = probe[1].astype(np.uint16) + np.uint16(2**15)
    w = _World(build, probe)
    cfg = dj_tpu.JoinConfig(over_decom_factor=2)
    jprep = w.jprepare(cfg, left_capacity=len(probe[0]))
    tprep = w.tprepare(cfg, left_capacity=len(probe[0]))
    assert tuple(tprep.plan) == tuple(jprep.plan)
    jt, jcounts, _ = w.jquery(jprep, cfg)
    monkeypatch.setenv("DJT_JOIN_MERGE", tier)
    tt, tcounts, tinfo = w.tquery(tprep, cfg)
    assert int(tcounts[0]) == int(np.asarray(jcounts)[0]) == want
    assert not any(bool(v.any()) for v in tinfo.values())
    assert [c.data.dtype for c in tt.columns] == [torch.uint32, torch.uint16, torch.uint64]
    assert _rows(tt) == _rows(jt)


@pytest.mark.parametrize("declared", [True, False])
@pytest.mark.parametrize("tier", TIERS)
def test_prepared_uint64_keys_match_dj_tpu(tier, declared, monkeypatch):
    """uint64 keys past 2^63, declared or probed, at odf 1 (the hash of a
    uint64 key differs from its int64 image's, so odf > 1 batches differ):
    the prepared plan, the prepared words and each tier's rows equal
    dj_tpu's for the same keys less 2^63 as int64 (dj_tpu cannot pad a
    uint64 key; the map keeps order and equality, so the words' fields
    and tags agree)."""
    build, probe, kr, want = _tables(33, nb=600, nl=900, key_dtype=np.int64)
    w64 = _World(build, probe)
    for t in (build, probe):
        t[0] = t[0].astype(np.uint64) + np.uint64(2**63)
    w = _World.__new__(_World)
    w.ttopo = tj.make_topology(["cpu"])
    _, tb = _both(build)
    _, tp = _both(probe)
    w.tr, w.trc = tj.shard_table(w.ttopo, tb)
    w.tl, w.tlc = tj.shard_table(w.ttopo, tp)
    jcfg = dj_tpu.JoinConfig(key_range=kr if declared else None)
    jprep = w64.jprepare(jcfg, left_capacity=len(probe[0]))
    ukr = tuple(v + 2**63 for v in kr)
    tprep = w.tprepare(dj_tpu.JoinConfig(key_range=ukr if declared else None),
                       left_capacity=len(probe[0]))
    # Anchors are unsigned-order images: k + 2^63 either way.
    assert tprep.plan.anchors == tuple(jprep.plan.anchors)
    assert tprep.plan.widths == tuple(jprep.plan.widths)
    assert tprep.plan.key_dtypes == ("uint64",)
    (tw, _, tc), (jw, _, jc) = tprep.batches[0], jprep.batches[0]
    assert tc.tolist() == np.asarray(jc).tolist()
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int64))
    jt, jcounts, _ = w64.jquery(jprep, jcfg)
    monkeypatch.setenv("DJT_JOIN_MERGE", tier)
    tt, tcounts, tinfo = w.tquery(tprep, jcfg)
    assert int(tcounts[0]) == int(np.asarray(jcounts)[0]) == want
    assert not any(bool(v.any()) for v in tinfo.values())
    assert tt.columns[0].data.dtype == torch.uint64
    assert sorted((r[0] - 2**63,) + r[1:] for r in _rows(tt)) == _rows(jt)


def test_probe_keys_outside_plan_flag_in_both(monkeypatch):
    build, probe, kr, _ = _tables(3)
    probe[0][::7] += 10**6  # outside the declared range
    w = _World(build, probe)
    cfg = dj_tpu.JoinConfig(key_range=kr)
    jprep = w.jprepare(cfg, left_capacity=len(probe[0]))
    tprep = w.tprepare(cfg, left_capacity=len(probe[0]))
    _, _, jinfo = w.jquery(jprep, cfg)
    assert bool(np.asarray(jinfo["prepared_plan_mismatch"])[0])
    for tier in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", tier)
        _, _, tinfo = w.tquery(tprep, cfg)
        for k in jinfo:
            assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist(), (tier, k)


@pytest.mark.parametrize("odf", [1, 4])
def test_prepared_side_carried_from_dj_tpu(odf, monkeypatch):
    build, probe, kr, want = _tables(20 + odf)
    w = _World(build, probe)
    cfg = dj_tpu.JoinConfig(over_decom_factor=odf, key_range=kr)
    jprep = w.jprepare(cfg, left_capacity=len(probe[0]))
    tprep = convert.prepared_side_from(jprep, w.ttopo)
    assert tprep.batches[0][0].dtype == torch.int64
    jt, jcounts, _ = w.jquery(jprep, cfg)
    for tier in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", tier)
        tt, tcounts, tinfo = w.tquery(tprep, cfg)
        assert int(tcounts[0]) == int(np.asarray(jcounts)[0]) == want
        assert not any(bool(v.any()) for v in tinfo.values())
        assert _rows(tt) == _rows(jt), tier


def _mismatch_cases(w, probe):
    """(name, dj_tpu query thunk, port query thunk) per structural
    mismatch."""
    cfg = dj_tpu.JoinConfig(key_range=(0, 6000))
    jprep = w.jprepare(cfg, left_capacity=len(probe[0]))
    tprep = w.tprepare(cfg, left_capacity=len(probe[0]))
    cases = []
    # odf differs from the prepared side's.
    odf4 = dj_tpu.JoinConfig(over_decom_factor=4, key_range=(0, 6000))
    cases.append(("odf", lambda: w.jquery(jprep, odf4), lambda: w.tquery(tprep, odf4)))
    # int32 probe keys against an int64 plan.
    jl32, tl32 = _both([probe[0].astype(np.int32), probe[1]])
    j32, jc32 = jshard(w.jtopo, jl32)
    t32, tc32 = tj.shard_table(w.ttopo, tl32)
    cases.append((
        "dtype",
        lambda: dj_tpu.distributed_inner_join(w.jtopo, j32, jc32, jprep, None, [0], None, cfg),
        lambda: tj.distributed_inner_join(w.ttopo, t32, tc32, tprep, None, [0], None,
                                          convert.join_config_from(cfg)),
    ))
    # A probe table 8x larger needs a wider tag field.
    big = [np.tile(a, 8) for a in probe]
    jbig, tbig = _both(big)
    jb, jbc = jshard(w.jtopo, jbig)
    tb, tbc = tj.shard_table(w.ttopo, tbig)
    cases.append((
        "tag_width",
        lambda: dj_tpu.distributed_inner_join(w.jtopo, jb, jbc, jprep, None, [0], None, cfg),
        lambda: tj.distributed_inner_join(w.ttopo, tb, tbc, tprep, None, [0], None,
                                          convert.join_config_from(cfg)),
    ))
    return cases


def test_plan_mismatch_raised_where_dj_tpu_raises():
    build, probe, _, _ = _tables(5)
    w = _World(build, probe)
    for name, jrun, trun in _mismatch_cases(w, probe):
        with pytest.raises(jdist.PreparedPlanMismatch):
            jrun()
        with pytest.raises(tj.PreparedPlanMismatch):
            trun()
    assert issubclass(tj.PreparedPlanMismatch, terrors.DJError)
    assert issubclass(tj.PreparedPlanMismatch, RuntimeError)
    assert jdist.PreparedPlanMismatch is jerrors.PlanMismatch


def test_one_attempt_prepare_raises_typed_errors():
    build, probe, kr, _ = _tables(6)
    w = _World(build, probe)
    # Build keys outside a declared range, and send buckets far below the
    # batch's rows: with one attempt both packages run out of budget and
    # raise CapacityExhausted naming the flag; with the default budget
    # both heal (re-probe the range, grow bucket_factor) to the same side.
    for cfg in (dj_tpu.JoinConfig(key_range=(10, 20)),
                dj_tpu.JoinConfig(over_decom_factor=4, bucket_factor=0.5, key_range=kr)):
        flag = "prep_range_violation" if cfg.bucket_factor > 1 else "shuffle_overflow"
        with pytest.raises(jerrors.CapacityExhausted, match=flag) as jerr:
            w.jprepare(cfg, max_attempts=1)
        with pytest.raises(terrors.CapacityExhausted, match=flag) as err:
            w.tprepare(cfg, max_attempts=1)
        assert err.value.flags == jerr.value.flags and err.value.flags[flag]
        assert err.value.attempts == jerr.value.attempts == 1
        assert err.value.factors == jerr.value.factors
        jprep, tprep = w.jprepare(cfg), w.tprepare(cfg)
        assert tprep.key_range == tuple(jprep.key_range)
        assert tuple(tprep.plan) == tuple(jprep.plan)
        assert tprep.config.bucket_factor == jprep.config.bucket_factor
    # A forced broadcast tier builds dj_tpu's side and serves its rows.
    bcfg = dj_tpu.JoinConfig(key_range=kr)
    nl = len(probe[0])
    jb = jdist.prepare_join_side(w.jtopo, w.jr, w.jrc, [0], bcfg, tier="broadcast",
                                 left_capacity=nl)
    tb = tj.prepare_join_side(w.ttopo, w.tr, w.trc, [0], convert.join_config_from(bcfg),
                              tier="broadcast", left_capacity=nl)
    assert tb.tier == jb.tier == "broadcast" and tuple(tb.plan) == tuple(jb.plan)
    (jt, jcounts, _), (tt, tcounts, _) = w.jquery(jb, bcfg), w.tquery(tb, bcfg)
    assert tcounts.tolist() == np.asarray(jcounts).tolist() and _rows(tt) == _rows(jt)
    with pytest.raises(ValueError, match="empty build side"):
        tj.prepare_join_side(w.ttopo, w.tr, torch.zeros(1, dtype=torch.int32), [0])
    with pytest.raises(ValueError, match="right_counts=None"):
        prep = w.tprepare(dj_tpu.JoinConfig(key_range=kr))
        tj.distributed_inner_join(w.ttopo, w.tl, w.tlc, prep, w.trc, [0], None)
    with pytest.raises(TypeError, match="right_counts and right_on"):
        tj.distributed_inner_join(w.ttopo, w.tl, w.tlc, w.tr, None, [0], None)

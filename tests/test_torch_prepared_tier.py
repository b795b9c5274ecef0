"""dj_tpu_torch's broadcast- and salted-prepared build sides vs dj_tpu's.

A seeded build side with two fifths of its rows on one key (int64 key,
int64 and string payloads) is prepared in both packages on the 8-device
CPU mesh, through ``DJT_PREPARED_TIER`` in the port and ``tier=`` in
dj_tpu, at a world of 4 (and 1 for broadcast) and odf 1 and 3: the tier,
salt set and replicas, the plan and every batch's words bit for bit,
then a query under each of the port's merge tiers (and each probe
expansion under the probe tier) against dj_tpu's query, shard for shard.
Then the tag width a query's left capacity needs (PreparedPlanMismatch
exactly where dj_tpu raises it), ``auto``, the ledger's replay and
revalidation, an append to a broadcast and to a salted side, and
``convert.prepared_side_from`` on a dj_tpu side of each tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import table as jT
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.resilience import ledger as jledger
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.parallel import dist_join as tdist
from dj_tpu_torch.resilience import errors as terrors

TIERS = ("sort", "merge", "probe")
PROBE_EXPAND = ("segment", "hist", "pallas")
NB, NL = 1000, 1500
SPAN = 3 * NB
KEY_RANGE = (0, SPAN - 1)


@pytest.fixture(autouse=True)
def _fresh_ledger():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tj.resilience.ledger.reset()
    yield
    tj.resilience.ledger.reset()
    torch.set_num_threads(threads)


def _knobs(mp, **kv):
    """Set each knob in both packages: ``DJ_<name>`` and ``DJT_<name>``."""
    for k, v in kv.items():
        for prefix in ("DJ_", "DJT_"):
            if v is None:
                mp.delenv(prefix + k, raising=False)
            else:
                mp.setenv(prefix + k, str(v))


def _arrays(seed, hot_share=0.4, extra=0):
    """(build, probe): build keys from [0, SPAN) with ``hot_share`` of
    them on one key (a probe row carries it), probe keys from the span;
    int64 and string payloads. ``extra`` more build rows (a later
    append) on keys of their own."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(np.arange(SPAN))
    bk = keys[:NB].copy()
    bk[: int(hot_share * NB)] = bk[0]
    bk[1], bk[2] = 0, SPAN - 1  # both ends present
    pk = rng.integers(0, SPAN, NL)
    pk[pk == bk[0]] = bk[3]
    pk[5] = bk[0]
    if extra:
        bk = np.concatenate([bk, keys[NB:NB + extra]])
    build = [bk.astype(np.int64), np.arange(bk.size, dtype=np.int64) + 10**6,
             [b"s%d" % (k % 13) for k in bk]]
    probe = [pk.astype(np.int64), np.arange(NL, dtype=np.int64)]
    return build, probe


class _World:
    """Tables sharded over w ranks in both packages."""

    def __init__(self, w, **tables):
        self.w = w
        self.jtopo = jmake_topology(jax.devices()[:w])
        self.ttopo = tj.make_topology(["cpu"] * w)
        self.j, self.t = {}, {}
        for name, arrays in tables.items():
            jcols, tcols = [], []
            for a in arrays:
                if isinstance(a, list):
                    jcols.append(jT.from_strings(a))
                    tcols.append(tj.from_strings(a, device="cpu"))
                else:
                    jcols.append(jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(a.dtype.name)))
                    tcols.append(tj.Column(torch.from_numpy(a.copy()),
                                           tj.dtypes.by_name(a.dtype.name)))
            self.j[name] = jshard(self.jtopo, jT.Table(tuple(jcols)))
            self.t[name] = tj.shard_table(self.ttopo, tj.Table(tuple(tcols)))

    def jprepare(self, cfg, tier, side="build", **kw):
        return jdist.prepare_join_side(self.jtopo, *self.j[side], [0], cfg, tier=tier,
                                       left_capacity=NL, **kw)

    def tprepare(self, cfg, side="build", **kw):
        return tj.prepare_join_side(self.ttopo, *self.t[side], [0], convert.join_config_from(cfg),
                                    left_capacity=NL, **kw)

    def jquery(self, prep, cfg, side="probe"):
        return dj_tpu.distributed_inner_join(self.jtopo, *self.j[side], prep, None, [0], None, cfg)

    def tquery(self, prep, cfg, side="probe"):
        return tj.distributed_inner_join(self.ttopo, *self.t[side], prep, None, [0], None,
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


def _result(res, w):
    out, counts, info = res[:3]
    return {"counts": np.asarray(counts).tolist(), "rows": _shard_rows(out, counts, w),
            "flags": {k: np.asarray(v).tolist() for k, v in info.items()}}


def _config(odf):
    return dj_tpu.JoinConfig(over_decom_factor=odf, key_range=KEY_RANGE, bucket_factor=4.0,
                             join_out_factor=4.0, char_out_factor=2.0)


def _same_side(tprep, jprep):
    """The tier, salt, plan, sizing and every batch bit for bit."""
    assert (tprep.tier, tprep.salt, tprep.salt_replicas) == (
        jprep.tier, tuple(jprep.salt), jprep.salt_replicas)
    assert tuple(tprep.plan) == tuple(jprep.plan) and tprep.n == jprep.n
    assert tuple(tprep.sizing) == tuple(jprep.sizing)
    assert len(tprep.batches) == len(jprep.batches)
    for (tw, _, tc), (jw, _, jc) in zip(tprep.batches, jprep.batches):
        assert tc.tolist() == np.asarray(jc).tolist()
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int64))


# (w, odf) of each tier's cases: broadcast also at one rank.
CASES = [("broadcast", 1, 3), ("broadcast", 4, 1), ("broadcast", 4, 3), ("salted", 4, 1),
         ("salted", 4, 3)]


@pytest.fixture(scope="module")
def jax_sides():
    """dj_tpu's prepared side and its query per (tier, w, odf), made on
    first use from an empty ledger."""
    cache = {}

    def get(tier, w, odf):
        if (tier, w, odf) not in cache:
            world = _World(w, build=_arrays(w + odf)[0], probe=_arrays(w + odf)[1])
            jledger.reset()
            jprep = world.jprepare(_config(odf), tier)
            cache[(tier, w, odf)] = (world, jprep, _result(world.jquery(jprep, _config(odf)), w))
            jledger.reset()
        return cache[(tier, w, odf)]

    yield get
    jdist._build_prepared_query_fn.cache_clear()


@pytest.mark.parametrize("tier,w,odf", CASES)
def test_prepared_tier_matches_dj_tpu(tier, w, odf, jax_sides, monkeypatch):
    world, jprep, want = jax_sides(tier, w, odf)
    assert jprep.tier == tier
    assert not any(any(v) for v in want["flags"].values())
    monkeypatch.setenv("DJT_PREPARED_TIER", tier)
    tprep = world.tprepare(_config(odf))
    _same_side(tprep, jprep)
    if tier == "salted":
        assert tprep.salt_replicas >= 2 and tprep.salt
    for merge in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", merge)
        expands = PROBE_EXPAND if merge == "probe" else (None,)
        for expand in expands:
            if expand is not None:
                monkeypatch.setenv("DJT_PROBE_EXPAND", expand)
            assert _result(world.tquery(tprep, _config(odf)), w) == want, (merge, expand)
    monkeypatch.delenv("DJT_PROBE_EXPAND")


@pytest.mark.parametrize("tier", ["broadcast", "salted"])
def test_tag_width_mismatch_raises_where_dj_tpu_does(tier, jax_sides):
    """A query's left capacity sets its merged size; both packages raise
    PreparedPlanMismatch at exactly the same capacities, and a real
    query at one of them raises in both."""
    world, jprep, _ = jax_sides(tier, 4, 1)
    tprep = convert.prepared_side_from(jprep, world.ttopo)
    tcfg = convert.join_config_from(_config(1))
    outcomes = []
    for l_cap in range(1, 4 * NL, 17):
        try:
            want = jdist._prepared_query_sizing(world.jtopo, _config(1), l_cap, jprep)
        except jdist.PreparedPlanMismatch:
            want = "mismatch"
        try:
            got = tdist._prepared_query_sizing(world.ttopo, tcfg, l_cap, tprep)
        except terrors.PreparedPlanMismatch:
            got = "mismatch"
        assert got == (want if want == "mismatch" else tuple(want)), l_cap
        outcomes.append((l_cap, got == "mismatch"))
    assert any(m for _, m in outcomes) and not all(m for _, m in outcomes)
    rows = 4 * next(c for c, m in outcomes if m)
    keys = np.resize(_arrays(9)[1][0], rows)
    big = _World(4, probe=[keys, np.arange(rows, dtype=np.int64)])
    with pytest.raises(jdist.PreparedPlanMismatch):
        dj_tpu.distributed_inner_join(world.jtopo, *big.j["probe"], jprep, None, [0], None,
                                      _config(1))
    with pytest.raises(terrors.PreparedPlanMismatch):
        tj.distributed_inner_join(world.ttopo, *big.t["probe"], tprep, None, [0], None, tcfg)


def test_auto_and_ledger_replay_match_dj_tpu(monkeypatch):
    """``auto`` picks broadcast by fit, salted on the skewed side when
    nothing fits, and shuffle on an even side; each decision persists,
    replays whatever DJT_PREPARED_TIER says later, and demotes when it
    no longer fits (a shrunk budget, a salt set the geometry cannot
    hold). The ledger records and the sides equal dj_tpu's."""
    build, _ = _arrays(21)
    even, _ = _arrays(21, hot_share=0.0)
    world = _World(4, build=build, even=even)
    cfg = _config(1)
    tsig = {s: tj.resilience.plan_signature(world.ttopo, None, world.t[s][0], None, (0,),
                                            convert.join_config_from(cfg)) for s in world.t}
    jsig = {s: jledger.plan_signature(world.jtopo, None, world.j[s][0], None, (0,), cfg)
            for s in world.j}
    assert tsig == jsig

    def both(side, tier=None, **knobs):
        _knobs(monkeypatch, **knobs)
        jprep = world.jprepare(cfg, tier, side=side)
        tprep = world.tprepare(cfg, side=side)
        _same_side(tprep, jprep)
        t_rec = tj.resilience.ledger.consult(tsig[side])["prepared_tier"]
        j_rec = jledger.consult(jsig[side])["prepared_tier"]
        assert t_rec == j_rec
        return tprep.tier, t_rec

    # auto: broadcast by fit, then replayed under any later knob.
    assert both("build", PREPARED_TIER="auto")[0] == "broadcast"
    assert both("build", PREPARED_TIER="salted")[0] == "broadcast"
    # The budget shrinks: the replayed broadcast demotes to shuffle.
    assert both("build", BROADCAST_BYTES="1000") == (
        "shuffle", {"tier": "shuffle", "salt": [], "replicas": 1, "ratio": None})
    tj.resilience.ledger.reset()
    jledger.reset()
    # Nothing fits: auto salts the skewed side and keeps the even one on
    # shuffle (the record holds the measured ratio).
    tier, rec = both("build", PREPARED_TIER="auto", BROADCAST_BYTES="0")
    assert tier == "salted" and rec["salt"] and rec["replicas"] >= 2 and rec["ratio"] >= 2.0
    assert both("build", PREPARED_TIER="shuffle")[0] == "salted"  # replayed
    tier, rec = both("even", PREPARED_TIER="auto")
    assert tier == "shuffle" and rec["ratio"] < 2.0
    # A salted record the geometry cannot hold demotes.
    for bad in ({"salt": [99], "replicas": 2}, {"salt": [1], "replicas": 9}):
        rec = {"prepared_tier": {"tier": "salted", "ratio": 3.0, **bad}}
        tj.resilience.ledger.update(tsig["build"], **rec)
        jledger.update(jsig["build"], **rec)
        assert both("build")[0] == "shuffle", bad
    # salted requested on the even side: no heavy partition, demoted.
    tj.resilience.ledger.reset()
    jledger.reset()
    assert both("even", "salted", PREPARED_TIER="salted")[0] == "shuffle"
    with pytest.raises(ValueError, match="DJT_PREPARED_TIER"):
        _knobs(monkeypatch, PREPARED_TIER="nope")
        tj.resilience.ledger.reset()
        world.tprepare(cfg, side="even")


@pytest.mark.parametrize("tier,odf", [("broadcast", 3), ("salted", 1)])
def test_append_reprepares_on_the_tier_as_dj_tpu(tier, odf, monkeypatch):
    """Rows appended to a broadcast or a salted side: the side re-prepares
    on its tier from the combined source (every batch touched, no flag),
    and its queries under each merge tier equal dj_tpu's appended side's
    and the unprepared join of the combined table's rows."""
    w = 4
    build, probe = _arrays(31, hot_share=0.5, extra=200)
    resident = [a[:NB] for a in build]
    appended = [a[NB:] for a in build]
    probe[0][:200] = build[0][NB:]  # the appended keys match
    world = _World(w, build=resident, rows=appended, probe=probe)
    cfg = _config(odf)
    _knobs(monkeypatch, PREPARED_TIER=tier)
    jprep = world.jprepare(cfg, tier)
    tprep = world.tprepare(cfg)
    _same_side(tprep, jprep)
    jnew, jinfo = jdist.append_to_prepared(world.jtopo, jprep, *world.j["rows"])
    tnew, tinfo = tj.append_to_prepared(world.ttopo, tprep, *world.t["rows"])
    assert tnew.tier == jnew.tier == tier
    _same_side(tnew, jnew)
    assert tinfo["touched"] == jinfo["touched"] == tuple(range(len(tnew.batches)))
    for k in tdist._APPEND_FLAG_KEYS:
        assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist() == [False] * w
    want = _result(world.jquery(jnew, cfg), w)
    total = sum(want["counts"])
    assert total == sum(int((build[0] == k).sum()) for k in probe[0])
    for merge in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", merge)
        assert _result(world.tquery(tnew, cfg), w) == want, merge


@pytest.mark.parametrize("tier,w,odf", [("broadcast", 4, 1), ("salted", 4, 3)])
def test_prepared_side_from_converts_each_tier(tier, w, odf, jax_sides, monkeypatch):
    """A dj_tpu side of each tier carried into the port keeps its tier,
    salt set and batches, and serves dj_tpu's rows under each merge
    tier."""
    world, jprep, want = jax_sides(tier, w, odf)
    tprep = convert.prepared_side_from(jprep, world.ttopo)
    _same_side(tprep, jprep)
    for merge in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", merge)
        assert _result(world.tquery(tprep, _config(odf)), w) == want, merge

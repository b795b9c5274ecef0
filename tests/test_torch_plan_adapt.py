"""dj_tpu_torch's skew-adaptive planner and unprepared plan tiers vs dj_tpu's.

The planner's host logic first, on the same inputs in both packages:
``plan_adapt.decide`` / ``demote`` / ``decision_from_entry`` (torn and
foreign ledger records among them, a ``DJT_LEDGER`` file replayed after
``reset``, the ``DJT_SALT_REPLICAS`` clamp), ``obs.skew.batch_skew``,
``obs.bytemodel.replicated_table_bytes`` and
``ops.partition.salted_partition_ids``. Then the unprepared join under
``DJT_PLAN_ADAPT=1`` (dj_tpu's ``DJ_PLAN_ADAPT=1``) on the 8-device CPU
mesh at worlds of 3, 4 and 5 and odf 1 and 3, on an int64 key with
int64 and string payloads: the broadcast tier by fit, and the salted
tier under ``DJT_BROADCAST_BYTES=0`` on a probe side with 60% of its
rows on one key. Compared exactly: the decision (tier, salt set,
replicas, ratio, source), then the counts, every flag and each shard's
row multiset (strings as bytes). Then the heal from a tight
join_out_factor under each tier, the demotes (a broadcast that no longer
fits, a salt set the geometry cannot hold) and a two-level topology
staying on shuffle.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import table as jT
from dj_tpu.obs import bytemodel as jbytes
from dj_tpu.obs import skew as jskew
from dj_tpu.ops import partition as jpart
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel import plan_adapt as jplan
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.resilience import ledger as jledger
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.obs import bytemodel as tbytes
from dj_tpu_torch.obs import skew as tskew
from dj_tpu_torch.ops import partition as tpart
from dj_tpu_torch.parallel import dist_join as tdist
from dj_tpu_torch.parallel import plan_adapt as tplan

TAGS = (b"a", b"bb", b"", b"dddd", b"e")


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


def _knobs(mp, **kv):
    """Set each knob in both packages: ``DJ_<name>`` and ``DJT_<name>``."""
    for k, v in kv.items():
        for prefix in ("DJ_", "DJT_"):
            if v is None:
                mp.delenv(prefix + k, raising=False)
            else:
                mp.setenv(prefix + k, str(v))


def _fields(d):
    return None if d is None else (d.tier, tuple(d.salt), d.replicas, d.ratio, d.source)


# --- the planner's host logic --------------------------------------------


def test_batch_skew_and_salted_ids_match_dj_tpu():
    rng = np.random.default_rng(3)
    for n, odf in ((2, 1), (3, 3), (4, 2), (5, 1)):
        counts = rng.integers(0, 50, (n, n * odf))
        counts[:, n - 1] += 400  # a hot destination in batch 0
        for topk in (1, 3, 9):
            assert tskew.batch_skew(counts, n, odf, topk=topk) == \
                jskew.batch_skew(counts, n, odf, topk=topk)
        assert tskew.batch_skew(np.zeros((n, n * odf), np.int64), n, odf) == \
            jskew.batch_skew(np.zeros((n, n * odf), np.int64), n, odf)
        m = n * odf
        for heavy, replicas in (((0,), 2), ((m - 1, 1), n), (tuple(range(0, m, 2)), 2)):
            pid = rng.integers(0, m + 1, 1001).astype(np.int32)  # m: padding rows
            got = tpart.salted_partition_ids(torch.from_numpy(pid), m, n, heavy, replicas)
            want = jpart.salted_partition_ids(jnp.asarray(pid), m, n, heavy, replicas)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert got.dtype == torch.int32
    with pytest.raises(ValueError):
        tpart.salted_partition_ids(torch.zeros(4, dtype=torch.int32), 4, 2, (0,), 3)
    with pytest.raises(ValueError):
        tpart.salted_partition_ids(torch.zeros(4, dtype=torch.int32), 4, 2, (4,), 2)


def test_replicated_table_bytes_match_dj_tpu():
    keys = np.arange(12, dtype=np.int64)
    strs = [TAGS[k % 5] for k in keys]
    jt = jT.Table((jT.Column(jnp.asarray(keys), dj_tpu.dtypes.int64),
                   jT.Column(jnp.asarray(keys.astype(np.int16)), dj_tpu.dtypes.int16),
                   jT.from_strings(strs)))
    tt = tj.Table((tj.Column(torch.from_numpy(keys), tj.dtypes.int64),
                   tj.Column(torch.from_numpy(keys.astype(np.int16)), tj.dtypes.int16),
                   tj.from_strings(strs, device="cpu")))
    assert tbytes.replicated_table_bytes(tt) == jbytes.replicated_table_bytes(jt)
    assert tbytes.buffer_bytes((3, 5), 8) == jbytes.buffer_bytes((3, 5), 8) == 120


def test_knobs_and_ledger_records_match_dj_tpu(monkeypatch):
    """Every knob parses as dj_tpu's does; decision_from_entry reads the
    same records, torn and foreign ones included."""
    for budget in (None, "0", "-5", "1e3", "junk"):
        for hbm in (None, "2e9", "junk"):
            _knobs(monkeypatch, BROADCAST_BYTES=budget, SERVE_HBM_BUDGET=hbm)
            assert tplan.broadcast_budget_bytes() == jplan.broadcast_budget_bytes()
            assert tplan.available_broadcast_bytes() == jplan.available_broadcast_bytes()
    for v in (None, "0", "yes", "ON", "2"):
        _knobs(monkeypatch, PLAN_ADAPT=v)
        assert tplan.enabled() == jplan.enabled()
    for ratio in (None, "0.5", "3", "x"):
        for topk in (None, "0", "5", "x"):
            _knobs(monkeypatch, SALT_RATIO=ratio, SALT_TOPK=topk)
            assert (tplan.salt_ratio(), tplan.salt_topk()) == (jplan.salt_ratio(), jplan.salt_topk())
    for reps in (None, "1", "3", "99", "x"):
        _knobs(monkeypatch, SALT_REPLICAS=reps)
        for n in (2, 3, 5, 8):
            for r in (1.0, 1.5, 2.0, 3.4, 7.9, 100.0):
                assert tplan.salt_replicas(n, r) == jplan.salt_replicas(n, r), (reps, n, r)
    entries = [None, {}, {"plan_adapt": 3}, {"plan_adapt": {}}, {"plan_adapt": {"tier": "x"}},
               {"plan_adapt": {"tier": "broadcast"}},
               {"plan_adapt": {"tier": "shuffle", "ratio": 1.7}},
               {"plan_adapt": {"tier": "salted", "salt": [3, 1], "replicas": 2, "ratio": 2.5}},
               {"plan_adapt": {"tier": "salted", "salt": [], "replicas": 3}},
               {"plan_adapt": {"tier": "salted", "salt": [1], "replicas": 1}},
               {"plan_adapt": {"tier": "salted", "salt": ["a"], "replicas": 2}},
               {"plan_adapt": {"tier": "salted", "salt": [1], "replicas": "two"}},
               {"plan_adapt": {"tier": "broadcast", "ratio": None}}]
    for e in entries:
        assert _fields(tplan.decision_from_entry(e)) == _fields(jplan.decision_from_entry(e)), e


def _decide(pkg, sig, counts, n, odf, rbytes, probes):
    def counts_fn():
        probes.append(pkg)
        return counts

    return pkg.decide(sig, n=n, odf=odf, right_bytes_fn=lambda: rbytes, counts_fn=counts_fn)


def test_decide_and_demote_match_dj_tpu(monkeypatch, tmp_path):
    """decide on count matrices of every shape of skew, against a fitting
    and a non-fitting side, then its ledger replay (no probe), a
    ``DJT_LEDGER`` file replayed after reset with a torn line, and
    demote."""
    rng = np.random.default_rng(5)
    _knobs(monkeypatch, PLAN_ADAPT=1)
    probes: list = []
    cases = []
    for n, odf in ((1, 1), (2, 1), (4, 1), (4, 3), (5, 2)):
        flat = rng.integers(90, 110, (n, n * odf))
        hot = flat.copy()
        hot[:, -1] += 60 * n  # the last batch's last destination
        two = flat.copy()
        two[:, 0] += 50 * n
        two[:, -1] += 50 * n
        cases += [(n, odf, c) for c in (flat, hot, two, np.zeros_like(flat))]
    for reps in (None, "2"):
        _knobs(monkeypatch, SALT_REPLICAS=reps)
        for i, (n, odf, counts) in enumerate(cases):
            for rbytes, budget in ((1e3, None), (1e3, "0"), (5e3, "4e3")):
                _knobs(monkeypatch, BROADCAST_BYTES=budget)
                sig = f"join|case={i},{rbytes},{budget},{reps}"
                got = _decide(tplan, sig, counts, n, odf, rbytes, probes)
                want = _decide(jplan, sig, counts, n, odf, rbytes, probes)
                assert _fields(got) == _fields(want), (n, odf, budget, counts)
                assert probes.count(tplan) == probes.count(jplan)
                before = len(probes)
                assert _fields(_decide(tplan, sig, counts, n, odf, rbytes, probes)) == \
                    _fields(_decide(jplan, sig, counts, n, odf, rbytes, probes))
                assert len(probes) == before  # a replay takes no probe
    _knobs(monkeypatch, BROADCAST_BYTES=None, SALT_REPLICAS=None)
    # A ledger file replayed after reset, its last line torn.
    monkeypatch.setenv("DJT_LEDGER", str(tmp_path / "t.jsonl"))
    monkeypatch.setenv("DJ_LEDGER", str(tmp_path / "j.jsonl"))
    n, odf, counts = cases[9]  # n = 4, odf 1, one hot destination
    for pkg, led in ((tplan, tj.resilience.ledger), (jplan, jledger)):
        _knobs(monkeypatch, BROADCAST_BYTES="0")
        first = _decide(pkg, "join|file", counts, n, odf, 1.0, probes)
        assert first.tier == "salted" and first.source == "probe"
        led.reset()
    for name in ("t.jsonl", "j.jsonl"):
        with open(tmp_path / name, "a") as f:
            f.write('{"sig": "join|file", "plan_adapt": {"tier": "broad\n')
    before = len(probes)
    replayed = [_fields(_decide(p, "join|file", counts, n, odf, 1.0, probes))
                for p in (tplan, jplan)]
    assert replayed[0] == replayed[1] and replayed[0][0] == "salted"
    assert replayed[0][4] == "ledger" and len(probes) == before
    got, want = tplan.demote("join|file", "misfit"), jplan.demote("join|file", "misfit")
    assert _fields(got) == _fields(want) == ("shuffle", (), 1, 1.0, "demote")
    tj.resilience.ledger.reset()
    jledger.reset()
    assert _fields(_decide(tplan, "join|file", counts, n, odf, 1.0, probes)) == \
        _fields(_decide(jplan, "join|file", counts, n, odf, 1.0, probes)) == \
        ("shuffle", (), 1, 1.0, "ledger")
    assert [json.loads(x)["plan_adapt"]["tier"] for x in
            (tmp_path / "t.jsonl").read_text().splitlines()[-1:]] == ["shuffle"]
    _knobs(monkeypatch, PLAN_ADAPT=None)
    assert tplan.decide("x", n=4, odf=1, right_bytes_fn=None, counts_fn=None) is tplan.SHUFFLE


# --- the unprepared tiers against dj_tpu's joins ---------------------------


def _arrays(seed, hot_share, nb=600, nl=900):
    """(build, probe) columns: unique build keys in [0, 3 nb) with an
    int64 and a string payload, probe keys drawn from the span with
    ``hot_share`` of them on one build key and an int64 payload."""
    rng = np.random.default_rng(seed)
    bk = rng.permutation(np.arange(3 * nb))[:nb].astype(np.int64)
    pk = rng.integers(0, 3 * nb, nl).astype(np.int64)
    pk[: int(hot_share * nl)] = bk[7]
    build = [bk, np.arange(nb, dtype=np.int64) + 10**6, [b"b%d" % (k % 97) for k in bk]]
    probe = [pk, np.arange(nl, dtype=np.int64)]
    return build, probe


class _World:
    """One (build, probe) pair sharded over w ranks in both packages."""

    def __init__(self, w, build, probe, intra=None):
        self.jtopo = jmake_topology(jax.devices()[:w], intra_size=intra)
        self.ttopo = tj.make_topology(["cpu"] * w, intra_size=intra)
        self.j, self.t = {}, {}
        for side, arrays in (("build", build), ("probe", probe)):
            jcols, tcols = [], []
            for a in arrays:
                if isinstance(a, list):
                    jcols.append(jT.from_strings(a))
                    tcols.append(tj.from_strings(a, device="cpu"))
                else:
                    jcols.append(jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(a.dtype.name)))
                    tcols.append(tj.Column(torch.from_numpy(a.copy()),
                                           tj.dtypes.by_name(a.dtype.name)))
            self.j[side] = jshard(self.jtopo, jT.Table(tuple(jcols)))
            self.t[side] = tj.shard_table(self.ttopo, tj.Table(tuple(tcols)))

    def jargs(self):
        (jl, jlc), (jr, jrc) = self.j["probe"], self.j["build"]
        return jl, jlc, jr, jrc, (0,), (0,)

    def targs(self):
        (tl, tlc), (tr, trc) = self.t["probe"], self.t["build"]
        return tl, tlc, tr, trc, (0,), (0,)


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


def _result(out, counts, info, w):
    return {"counts": np.asarray(counts).tolist(), "rows": _shard_rows(out, counts, w),
            "flags": {k: np.asarray(v).tolist() for k, v in info.items()}}


# (tier, knobs) of each unprepared tier's case.
TIER_KNOBS = {"broadcast": {}, "salted": {"BROADCAST_BYTES": "0"}}
CONFIG = dict(bucket_factor=4.0, join_out_factor=2.0, char_out_factor=2.0)


@pytest.fixture(scope="module")
def jax_tiers():
    """dj_tpu's decision and join per (tier, w, odf), made on first use
    under DJ_PLAN_ADAPT=1 and the tier's knobs, from an empty ledger."""
    cache = {}

    def get(tier, w, odf):
        if (tier, w, odf) not in cache:
            world = _World(w, *_arrays(10 * w + odf, 0.6))
            cfg = dj_tpu.JoinConfig(over_decom_factor=odf, **CONFIG)
            with pytest.MonkeyPatch.context() as mp:
                _knobs(mp, PLAN_ADAPT=1, **TIER_KNOBS[tier])
                jledger.reset()
                decision = jdist._resolve_plan_decision(world.jtopo, *world.jargs(), cfg)
                res = dj_tpu.distributed_inner_join(world.jtopo, *world.jargs(), cfg)
                jledger.reset()
            cache[(tier, w, odf)] = (world, decision, _result(*res, w))
        return cache[(tier, w, odf)]

    return get


@pytest.mark.parametrize("odf", [1, 3])
@pytest.mark.parametrize("w", [3, 4, 5])
@pytest.mark.parametrize("tier", ["broadcast", "salted"])
def test_unprepared_tier_matches_dj_tpu(tier, w, odf, jax_tiers, monkeypatch):
    world, jdecision, want = jax_tiers(tier, w, odf)
    assert jdecision.tier == tier
    assert not any(any(v) for v in want["flags"].values())
    _knobs(monkeypatch, PLAN_ADAPT=1, **TIER_KNOBS[tier])
    cfg = tj.JoinConfig(over_decom_factor=odf, **CONFIG)
    decision = tdist._resolve_plan_decision(world.ttopo, *world.targs(), cfg)
    assert _fields(decision) == _fields(jdecision)
    got = _result(*tj.distributed_inner_join(world.ttopo, *world.targs(), cfg), w)
    assert got == want
    # The join replayed the decision: a second resolve reads the ledger.
    again = tdist._resolve_plan_decision(world.ttopo, *world.targs(), cfg)
    assert again.source == "ledger" and again.tier == tier


@pytest.mark.parametrize("tier,factor", [("broadcast", 0.1), ("salted", 0.2), ("shuffle", 0.05)])
def test_auto_heals_a_tight_join_out_factor_under_each_tier(tier, factor, monkeypatch):
    """A join_out_factor one doubling short overflows the output under
    each plan; both packages heal it to the same factor, rows and
    flags."""
    w = 4
    world = _World(w, *_arrays(77, 0.6 if tier == "salted" else 0.0))
    knobs = {**TIER_KNOBS.get(tier, {}), "PLAN_ADAPT": None if tier == "shuffle" else 1}
    _knobs(monkeypatch, **knobs)
    base = dict(bucket_factor=4.0, join_out_factor=factor, char_out_factor=2.0)
    jout, jcounts, jinfo, jcfg = dj_tpu.distributed_inner_join_auto(
        world.jtopo, *world.jargs(), dj_tpu.JoinConfig(**base))
    tout, tcounts, tinfo, tcfg = tj.distributed_inner_join_auto(
        world.ttopo, *world.targs(), tj.JoinConfig(**base))
    assert tcfg.join_out_factor == jcfg.join_out_factor == 2 * factor
    assert _result(tout, tcounts, tinfo, w) == _result(jout, jcounts, jinfo, w)
    if tier != "shuffle":
        rec = tj.resilience.ledger.consult(tj.resilience.plan_signature(
            world.ttopo, world.t["probe"][0], world.t["build"][0], (0,), (0,),
            tj.JoinConfig(**base)))
        assert rec["plan_adapt"]["tier"] == tier
        assert rec["factors"]["join_out_factor"] == tcfg.join_out_factor


def test_misfit_and_bad_salt_demote_as_dj_tpu(monkeypatch):
    """A broadcast decision replayed under a budget its side no longer
    fits, and a salt set the geometry cannot hold, demote to shuffle in
    both packages; the join then runs the shuffle plan."""
    w = 4
    world = _World(w, *_arrays(5, 0.0))
    cfg = dict(bucket_factor=4.0, join_out_factor=2.0, char_out_factor=2.0)
    jcfg, tcfg = dj_tpu.JoinConfig(**cfg), tj.JoinConfig(**cfg)
    _knobs(monkeypatch, PLAN_ADAPT=1)
    first = [_fields(tdist._resolve_plan_decision(world.ttopo, *world.targs(), tcfg)),
             _fields(jdist._resolve_plan_decision(world.jtopo, *world.jargs(), jcfg))]
    assert first[0] == first[1] == ("broadcast", (), 1, 1.0, "fit")
    _knobs(monkeypatch, BROADCAST_BYTES="1000")
    demoted = [_fields(tdist._resolve_plan_decision(world.ttopo, *world.targs(), tcfg)),
               _fields(jdist._resolve_plan_decision(world.jtopo, *world.jargs(), jcfg))]
    assert demoted[0] == demoted[1] == ("shuffle", (), 1, 1.0, "demote")
    tsig = tj.resilience.plan_signature(world.ttopo, world.t["probe"][0], world.t["build"][0],
                                        (0,), (0,), tcfg)
    jsig = jledger.plan_signature(world.jtopo, world.j["probe"][0], world.j["build"][0],
                                  (0,), (0,), jcfg)
    assert tsig == jsig
    for bad in ({"salt": [99], "replicas": 2}, {"salt": [1], "replicas": 5}):
        rec = {"plan_adapt": {"tier": "salted", "ratio": 3.0, **bad}}
        tj.resilience.ledger.update(tsig, **rec)
        jledger.update(jsig, **rec)
        got = [_fields(tdist._resolve_plan_decision(world.ttopo, *world.targs(), tcfg)),
               _fields(jdist._resolve_plan_decision(world.jtopo, *world.jargs(), jcfg))]
        assert got[0] == got[1] == ("shuffle", (), 1, 1.0, "demote"), bad
    out, counts, info = tj.distributed_inner_join(world.ttopo, *world.targs(), tcfg)
    want = dj_tpu.distributed_inner_join(world.jtopo, *world.jargs(), jcfg)
    assert _result(out, counts, info, w) == _result(*want, w)


def test_two_level_topology_stays_on_shuffle(monkeypatch):
    """At intra_size 2 both packages plan the shuffle tier (source
    default, nothing persisted) under every knob, and join alike."""
    w = 4
    world = _World(w, *_arrays(9, 0.6), intra=2)
    cfg = dict(bucket_factor=4.0, join_out_factor=2.0, char_out_factor=2.0)
    jcfg, tcfg = dj_tpu.JoinConfig(**cfg), tj.JoinConfig(**cfg)
    for knobs in ({}, {"BROADCAST_BYTES": "0"}):
        _knobs(monkeypatch, PLAN_ADAPT=1, **knobs)
        got = [_fields(tdist._resolve_plan_decision(world.ttopo, *world.targs(), tcfg)),
               _fields(jdist._resolve_plan_decision(world.jtopo, *world.jargs(), jcfg))]
        assert got[0] == got[1] == _fields(tplan.SHUFFLE)
        assert tj.resilience.ledger.entries() == {}
    out, counts, info = tj.distributed_inner_join(world.ttopo, *world.targs(), tcfg)
    want = dj_tpu.distributed_inner_join(world.jtopo, *world.jargs(), jcfg)
    assert _result(out, counts, info, w) == _result(*want, w)

"""dj_tpu_torch's coalesced dispatches vs dj_tpu's.

``distributed_inner_join_coalesced`` (K queries against one
PreparedSide) on the shuffle, salted and broadcast prepared tiers, and
``distributed_inner_join_coalesced_unprepared`` (K two-table joins), at
K = 1 and 3 on a world of 4 at odf 2 on the 8-device CPU mesh: each
member's counts, flags and per-shard row multisets equal dj_tpu's
member's and the port's own singleton query's, exactly, under each of
the port's merge tiers (dj_tpu runs its default one: the rows do not
depend on it); the members and the build side carry string payloads
on the shuffle tier. A coalesced call
exchanges once an odf batch whatever K (none at all on a broadcast
side). Then the ledger-widened factors, an overflowing member beside
clean ones, and the refusals: members of two schemas or capacities,
``DJT_PLAN_ADAPT`` and a two-level topology for the unprepared entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import table as jT
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.parallel import dist_join as tdist

W, ODF = 4, 2
NB, NL = 400, 600
SPAN = 3 * NB
MERGE_TIERS = ("sort", "merge", "probe")
KNOBS = ("PLAN_ADAPT", "PREPARED_TIER", "JOIN_MERGE", "SHAPE_BUCKET", "LEDGER",
         "BROADCAST_BYTES")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _knobs(monkeypatch, **dict.fromkeys(KNOBS))
    tj.resilience.ledger.reset()
    yield
    tj.resilience.ledger.reset()
    torch.set_num_threads(threads)


def _knobs(mp, **kv):
    for k, v in kv.items():
        for prefix in ("DJ_", "DJT_"):
            if v is None:
                mp.delenv(prefix + k, raising=False)
            else:
                mp.setenv(prefix + k, str(v))


def _tables(arrays):
    jcols, tcols = [], []
    for a in arrays:
        if isinstance(a, list):
            jcols.append(jT.from_strings(a))
            tcols.append(tj.from_strings(a, device="cpu"))
        else:
            jcols.append(jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(a.dtype.name)))
            tcols.append(tj.Column(torch.from_numpy(a.copy()), tj.dtypes.by_name(a.dtype.name)))
    return jT.Table(tuple(jcols)), tj.Table(tuple(tcols))


class _World:
    def __init__(self, w, tables, intra=None):
        self.jtopo = jmake_topology(jax.devices()[:w], intra_size=intra)
        self.ttopo = tj.make_topology(["cpu"] * w, intra_size=intra)
        self.j, self.t = {}, {}
        for name, arrays in tables.items():
            jt, tt = _tables(arrays)
            self.j[name] = jshard(self.jtopo, jt)
            self.t[name] = tj.shard_table(self.ttopo, tt)

    def members(self, names):
        """([dj_tpu tables], [dj_tpu counts], [port tables], [port counts])."""
        return ([self.j[n][0] for n in names], [self.j[n][1] for n in names],
                [self.t[n][0] for n in names], [self.t[n][1] for n in names])


def _shard_rows(table, counts):
    counts = np.asarray(counts).tolist()
    w = len(counts)
    cap = next(np.asarray(c.data).shape[0] for c in table.columns if not hasattr(c, "chars")) // w
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


def _result(res):
    out, counts, info = res[:3]
    return {"counts": np.asarray(counts).tolist(), "rows": _shard_rows(out, counts),
            "flags": {k: np.asarray(v).tolist() for k, v in info.items()}}


def _arrays(seed, k=3, hot_share=0.4, strings=True):
    """A build side with ``hot_share`` of its rows on one key (a probe
    row of each member carries it) and K probe sides of NL rows, each
    with a string payload unless ``strings`` is False (dj_tpu's string
    modules take twice as long to compile)."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(np.arange(SPAN))
    bk = keys[:NB].copy()
    bk[: int(hot_share * NB)] = bk[0]
    bk[1], bk[2] = 0, SPAN - 1
    out = {"build": [bk.astype(np.int64), np.arange(NB, dtype=np.int64) + 10**6,
                     [b"b%d" % (v % 7) for v in bk]]}
    for q in range(k):
        pk = rng.integers(0, SPAN, NL)
        pk[pk == bk[0]] = bk[3]
        pk[5 + q] = bk[0]
        out[f"p{q}"] = [pk.astype(np.int64), np.arange(NL, dtype=np.int64) + 1000 * q,
                        [b"q%d-%d" % (q, v % 5) * (1 + v % 3) for v in pk]]
    return out if strings else {name: cols[:2] for name, cols in out.items()}


def _config(**kw):
    return dj_tpu.JoinConfig(**{"over_decom_factor": ODF, "key_range": (0, SPAN - 1),
                                "bucket_factor": 4.0, "join_out_factor": 4.0,
                                "char_out_factor": 4.0, **kw})


class _Epochs:
    """Counts the exchange epochs the port's dist_join starts (each of
    the W ranks starts its part of an epoch: W calls an epoch), and every
    collective of the in-process transport, while active."""

    def __init__(self, mp):
        from dj_tpu_torch.parallel.communicator import InProcessTransport

        self.epochs = self.collectives = 0
        orig = tdist.shuffle_tables_start

        def epoch(*a, **k):
            self.epochs += 1
            return orig(*a, **k)

        mp.setattr(tdist, "shuffle_tables_start", epoch)
        for name in ("all_to_all_start", "all_gather", "all_reduce", "shift_start"):
            fn = getattr(InProcessTransport, name)

            def counted(*a, _fn=fn, **k):
                self.collectives += 1
                return _fn(*a, **k)

            mp.setattr(InProcessTransport, name, counted)

    def reset(self):
        self.epochs = self.collectives = 0


_PREPARED = {}


def _prepared_case(tier, k):
    """dj_tpu's coalesced results of K members against a ``tier`` side,
    computed once for the module (with the world and both sides)."""
    if tier not in _PREPARED:
        world = _World(W, _arrays(seed={"shuffle": 1, "salted": 2, "broadcast": 3}[tier],
                                  strings=tier == "shuffle"))
        cfg = _config()
        jprep = dj_tpu.prepare_join_side(world.jtopo, *world.j["build"], [0], cfg, tier=tier,
                                         left_capacity=NL)
        tprep = tj.prepare_join_side(world.ttopo, *world.t["build"], [0],
                                     convert.join_config_from(cfg), tier=tier, left_capacity=NL)
        assert tprep.tier == jprep.tier == tier
        _PREPARED[tier] = {"world": world, "cfg": cfg, "jprep": jprep, "tprep": tprep}
    case = _PREPARED[tier]
    if k not in case:
        jl, jc, _, _ = case["world"].members([f"p{q}" for q in range(k)])
        per_query, jcfg = dj_tpu.distributed_inner_join_coalesced(
            case["world"].jtopo, jl, jc, case["jprep"], [0], case["cfg"])
        case[k] = [_result(r) for r in per_query]
    return case


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("tier", ["shuffle", "salted", "broadcast"])
def test_coalesced_prepared_matches_dj_tpu(tier, k, monkeypatch):
    case = _prepared_case(tier, k)
    world, tprep = case["world"], case["tprep"]
    tcfg = convert.join_config_from(case["cfg"])
    _, _, tl, tc = world.members([f"p{q}" for q in range(k)])
    epochs = _Epochs(monkeypatch)
    for merge in MERGE_TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", merge)
        epochs.reset()
        per_query, used = tj.distributed_inner_join_coalesced(world.ttopo, tl, tc, tprep, [0],
                                                              tcfg)
        assert used == tcfg
        assert (epochs.epochs, epochs.collectives == 0) == (
            (0, True) if tier == "broadcast" else (W * ODF, False))
        got = [_result(r) for r in per_query]
        assert got == case[k], merge
        for q in range(k):
            assert not any(any(v) for v in got[q]["flags"].values())
            alone = tj.distributed_inner_join(world.ttopo, tl[q], tc[q], tprep, None, [0], None,
                                              tcfg)
            assert _result(alone) == got[q]
    assert sum(sum(g["counts"]) for g in got) > 0


_UNPREPARED = {}


def _unprepared_world():
    """Members p0..p2 and their right sides r0..r2 (the build side's rows,
    its payload shifted by the member), built once for the module."""
    if "world" not in _UNPREPARED:
        arrays = _arrays(seed=7, hot_share=0.0, strings=False)  # no hot key: the buckets fit
        b = arrays["build"]
        for q in range(3):
            arrays[f"r{q}"] = [b[0], b[1] + q]
        _UNPREPARED["world"] = _World(W, arrays)
    return _UNPREPARED["world"]


@pytest.mark.parametrize("k", [1, 3])
def test_coalesced_unprepared_matches_dj_tpu(k, monkeypatch):
    """K two-table joins in one call: dj_tpu's members, the port's
    singletons, ODF epochs in all."""
    world = _unprepared_world()
    cfg = _config(key_range=None)
    tcfg = convert.join_config_from(cfg)
    jl, jc, tl, tc = world.members([f"p{q}" for q in range(k)])
    jr, jrc, tr, trc = world.members([f"r{q}" for q in range(k)])
    per_query, _ = dj_tpu.distributed_inner_join_coalesced_unprepared(
        world.jtopo, jl, jc, jr, jrc, [0], [0], cfg)
    want = [_result(r) for r in per_query]
    epochs = _Epochs(monkeypatch)
    got, used = tj.distributed_inner_join_coalesced_unprepared(world.ttopo, tl, tc, tr, trc, [0],
                                                               [0], tcfg)
    assert used == tcfg and epochs.epochs == W * ODF
    got = [_result(r) for r in got]
    assert got == want
    for q in range(k):
        assert not any(any(v) for v in got[q]["flags"].values())
        alone = tj.distributed_inner_join(world.ttopo, tl[q], tc[q], tr[q], trc[q], [0], [0],
                                          tcfg)
        assert _result(alone) == got[q]
    assert epochs.epochs == W * ODF * (1 + k)


def test_an_overflowing_member_fires_alone_as_dj_tpu():
    """Member 1, a third of its probe rows on the hot build key (160
    build rows), outgrows its output capacity; members 0 and 2 stay
    clean, and their rows, counts and every member's flags are
    dj_tpu's."""
    arrays = _arrays(seed=9, strings=False)
    hot = arrays["build"][0][0]
    arrays["p1"][0][::3] = hot
    world = _World(W, arrays)
    cfg = _config()
    jprep = dj_tpu.prepare_join_side(world.jtopo, *world.j["build"], [0], cfg, left_capacity=NL)
    tprep = tj.prepare_join_side(world.ttopo, *world.t["build"], [0],
                                 convert.join_config_from(cfg), left_capacity=NL)
    jl, jc, tl, tc = world.members(["p0", "p1", "p2"])
    want = dj_tpu.distributed_inner_join_coalesced(world.jtopo, jl, jc, jprep, [0], cfg)[0]
    got = tj.distributed_inner_join_coalesced(world.ttopo, tl, tc, tprep, [0],
                                              convert.join_config_from(cfg))[0]
    fired = [bool(info["join_overflow"].any()) for _, _, info in got]
    assert fired == [False, True, False]
    for q, (g, w_) in enumerate(zip(got, want)):
        g, w_ = _result(g), _result(w_)
        assert (g["counts"], g["flags"]) == (w_["counts"], w_["flags"])
        if not fired[q]:
            assert g["rows"] == w_["rows"]


def test_coalesced_runs_at_the_ledger_widened_factors():
    """A signature healed by the singleton auto path (join_out_factor
    0.25 on duplicate-heavy keys) runs coalesced at the learned factor:
    no member overflows and every count is the oracle's (dj_tpu
    tests/test_serve.py:386)."""
    n = 512
    rng = np.random.default_rng(44)
    rk = rng.integers(0, 16, n).astype(np.int64)
    arrays = {"build": [rk, np.arange(n, dtype=np.int64)]}
    oracles = []
    for q in range(2):
        pk = rng.integers(0, 16, n).astype(np.int64)
        arrays[f"p{q}"] = [pk, np.arange(n, dtype=np.int64)]
        oracles.append(int(sum((pk == v).sum() * (rk == v).sum() for v in range(16))))
    world = _World(1, arrays)
    cfg = tj.JoinConfig(bucket_factor=8.0, join_out_factor=0.25)
    prep = tj.prepare_join_side(world.ttopo, *world.t["build"], [0], cfg, left_capacity=n)
    _, counts, _, healed, _ = tj.distributed_inner_join_auto(world.ttopo, *world.t["p0"], prep,
                                                             None, [0], None, cfg)
    assert int(counts.sum()) == oracles[0] and healed.join_out_factor > cfg.join_out_factor
    _, _, tl, tc = world.members(["p0", "p1"])
    per_query, used = tj.distributed_inner_join_coalesced(world.ttopo, tl, tc, prep, [0], cfg)
    assert used.join_out_factor == healed.join_out_factor
    assert [int(c.sum()) for _, c, _ in per_query] == oracles
    assert not any(bool(v.any()) for _, _, info in per_query for v in info.values())


def test_coalesced_refusals_match_dj_tpu(monkeypatch):
    """Members of two schemas or two capacities raise ValueError in both
    packages' entries; the unprepared entry refuses DJT_PLAN_ADAPT and a
    two-level topology as dj_tpu's does."""
    arrays = _arrays(seed=5, k=2, strings=False)
    arrays["p_short"] = [a[: NL - 40] for a in arrays["p0"]]
    arrays["p_int32"] = [arrays["p0"][0].astype(np.int32)] + arrays["p0"][1:]
    world = _World(W, arrays)
    cfg = _config()
    jprep = dj_tpu.prepare_join_side(world.jtopo, *world.j["build"], [0], cfg, left_capacity=NL)
    tprep = tj.prepare_join_side(world.ttopo, *world.t["build"], [0],
                                 convert.join_config_from(cfg), left_capacity=NL)
    for bad in ("p_short", "p_int32"):
        jl, jc, tl, tc = world.members(["p0", bad])
        with pytest.raises(ValueError, match="one capacity and column schema"):
            dj_tpu.distributed_inner_join_coalesced(world.jtopo, jl, jc, jprep, [0], cfg)
        with pytest.raises(ValueError, match="one capacity and column schema"):
            tj.distributed_inner_join_coalesced(world.ttopo, tl, tc, tprep, [0],
                                                convert.join_config_from(cfg))
        with pytest.raises(ValueError, match="one capacity and column schema"):
            tj.distributed_inner_join_coalesced_unprepared(world.ttopo, tl, tc, tl, tc, [0], [0])
    jl, jc, tl, tc = world.members(["p0", "p1"])
    _knobs(monkeypatch, PLAN_ADAPT=1)
    for call in (lambda: dj_tpu.distributed_inner_join_coalesced_unprepared(
                     world.jtopo, jl, jc, jl, jc, [0], [0]),
                 lambda: tj.distributed_inner_join_coalesced_unprepared(
                     world.ttopo, tl, tc, tl, tc, [0], [0])):
        with pytest.raises(ValueError, match="adaptive planner"):
            call()
    _knobs(monkeypatch, PLAN_ADAPT=None)
    two = _World(W, {k: arrays[k] for k in ("p0", "p1")}, intra=2)
    jl, jc, tl, tc = two.members(["p0", "p1"])
    for call in (lambda: dj_tpu.distributed_inner_join_coalesced_unprepared(
                     two.jtopo, jl, jc, jl, jc, [0], [0]),
                 lambda: tj.distributed_inner_join_coalesced_unprepared(
                     two.ttopo, tl, tc, tl, tc, [0], [0])):
        with pytest.raises(ValueError, match="flat"):
            call()

"""dj_tpu_torch's join pipeline vs dj_tpu's (``parallel/pipeline.py``).

Seeded TPC-H Q3-shaped tables (lineitem <- orders <- customer, with
string payloads in the Q3 cases) go through ``plan_pipeline`` and
``distributed_join_pipeline(_auto)`` in both packages on the 8-device
CPU mesh: the stage modes, derived key ranges, range sources, output
partitioning and ``pipeline_signature`` strings; each stage's flags and
the result's counts and per-shard row multisets, exact, at worlds 1 and
4, odf 1 and 3; a shuffle-then-local chain (the local stage issues no
collective) and its re-shuffle under ``DJT_PIPELINE_COPART=0``; a
prepared stage on each prepared tier; the per-stage heal; a poisonous
declared range; a two-level chain; the range probes the plan takes and
an in-place write after a probe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import table as jT
from dj_tpu.parallel import pipeline as jpipe
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.parallel import dist_join as tdist
from dj_tpu_torch.parallel import pipeline as tpipe
from dj_tpu_torch.parallel.communicator import InProcessTransport

CFG = dict(join_out_factor=8.0, bucket_factor=4.0, pre_shuffle_out_factor=4.0,
           char_out_factor=32.0)
KNOBS = ("PIPELINE_COPART", "PIPELINE_BROADCAST", "PIPELINE_RANGE_DERIVE", "SHAPE_BUCKET",
         "BROADCAST_BYTES", "PLAN_ADAPT", "PREPARED_TIER", "JOIN_RANGE_PROBE", "LEDGER")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _knobs(monkeypatch, **dict.fromkeys(KNOBS))
    tj.resilience.ledger.reset()
    yield
    tj.resilience.ledger.reset()
    torch.set_num_threads(threads)


@pytest.fixture
def probes():
    """The port's obs on, with a clean registry, for the body; yields
    the count of range probes taken so far
    (``dj_range_probe_total{result="probe"}``) as a function."""
    was = tj.obs.enabled()
    tj.obs.reset(reenable=True)
    yield lambda: tj.obs.counter_value("dj_range_probe_total", result="probe")
    tj.obs.reset(reenable=was)
    tj.obs.drain()


def _knobs(mp, **kv):
    """Each knob in both packages: ``DJ_<name>`` and ``DJT_<name>``."""
    for k, v in kv.items():
        for prefix in ("DJ_", "DJT_"):
            if v is None:
                mp.delenv(prefix + k, raising=False)
            else:
                mp.setenv(prefix + k, str(v))


def _q3_arrays(seed=0, n_cust=64, n_ord=256, n_li=1024, strings=False):
    """customer (key, segment), orders (key, custkey, priority), lineitem
    (orderkey, value): benchmarks/tpch.py --q3's shape. With ``strings``
    the segment and the priority are string columns, else int64 codes
    (dj_tpu's string modules take twice as long to compile)."""
    rng = np.random.default_rng(seed)
    seg, pri = rng.integers(0, 5, n_cust), rng.integers(0, 5, n_ord)
    cust = [np.arange(n_cust, dtype=np.int64),
            [b"SEG-%d" % s for s in seg] if strings else seg.astype(np.int64)]
    orders = [np.arange(n_ord, dtype=np.int64), rng.integers(0, n_cust, n_ord).astype(np.int64),
              [b"%d-PRI" % p * (1 + p % 2) for p in pri] if strings else pri.astype(np.int64)]
    li = [rng.integers(0, n_ord, n_li).astype(np.int64), np.arange(n_li, dtype=np.int64) * 7]
    return {"cust": cust, "orders": orders, "li": li}


def _tables(arrays):
    """(dj_tpu table, port table) of a list of columns (a list of bytes
    is a string column)."""
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
    """Tables sharded over w ranks (two-level at ``intra``) in both
    packages: ``j[name]`` / ``t[name]`` are (table, counts)."""

    def __init__(self, w, tables, intra=None):
        self.w = w
        self.jtopo = jmake_topology(jax.devices()[:w], intra_size=intra)
        self.ttopo = tj.make_topology(["cpu"] * w, intra_size=intra)
        self.j, self.t = {}, {}
        for name, arrays in tables.items():
            jt, tt = _tables(arrays)
            self.j[name] = jshard(self.jtopo, jt)
            self.t[name] = tj.shard_table(self.ttopo, tt)

    def stages(self, specs):
        """(dj_tpu stages, port stages) of ``specs``: (right name,
        left_on, right_on, extra JoinStage fields); a right that is not a
        name is a (dj_tpu, port) pair of PreparedSides."""
        js, ts = [], []
        for right, lo, ro, kw in specs:
            kw = dict(kw)
            cfg = kw.pop("config", None)
            if isinstance(right, str):
                jr, tr = self.j[right], self.t[right]
            else:
                jr, tr = (right[0], None), (right[1], None)
            js.append(dj_tpu.JoinStage(right=jr[0], right_counts=jr[1], left_on=lo,
                                       right_on=ro, config=cfg, **kw))
            ts.append(tj.JoinStage(right=tr[0], right_counts=tr[1], left_on=lo, right_on=ro,
                                   config=None if cfg is None else convert.join_config_from(cfg),
                                   **kw))
        return js, ts


def _shard_rows(table, counts):
    """Each shard's valid rows (strings as bytes), sorted."""
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


def _result(out, counts, infos):
    return {"counts": np.asarray(counts).tolist(), "rows": _shard_rows(out, counts),
            "flags": [{k: np.asarray(v).tolist() for k, v in i.items()} for i in infos]}


def _clean(res):
    for i, flags in enumerate(res["flags"]):
        assert not any(any(v) for v in flags.values()), (i, flags)


def _all_rows(res):
    return sorted(r for shard in res["rows"] for r in shard)


def _plan_view(plan):
    return [(sp.mode, sp.key_range, sp.range_source, sp.out_partitioned_by)
            for sp in plan.stage_plans]


def _run_both(world, specs, cfg, auto=False, **kw):
    """The pipeline in both packages: (dj_tpu result, port result[, the
    two config lists])."""
    js, ts = world.stages(specs)
    (jl, jlc), (tl, tlc) = world.j["li"], world.t["li"]
    tcfg = convert.join_config_from(cfg)
    if auto:
        jout = dj_tpu.distributed_join_pipeline_auto(world.jtopo, jl, jlc, js, cfg, **kw)
        tout = tj.distributed_join_pipeline_auto(world.ttopo, tl, tlc, ts, tcfg, **kw)
        return _result(*jout[:3]), _result(*tout[:3]), jout[3], tout[3]
    jout = dj_tpu.distributed_join_pipeline(world.jtopo, jl, jlc, js, cfg, **kw)
    tout = tj.distributed_join_pipeline(world.ttopo, tl, tlc, ts, tcfg, **kw)
    return _result(*jout), _result(*tout)


def _composed(world, specs, cfg):
    """The port's composed distributed_inner_join calls: the rows a
    pipeline of Table-right stages must give."""
    cur = world.t["li"]
    tcfg = convert.join_config_from(cfg)
    infos = []
    for right, lo, ro, _ in specs:
        out, counts, info = tj.distributed_inner_join(world.ttopo, *cur, *world.t[right], lo, ro,
                                                      tcfg)
        cur = (out, counts)
        infos.append(info)
    return _result(*cur, infos)


Q3 = [("orders", (0,), (0,), {}), ("cust", (2,), (0,), {})]
Q3_SHUFFLE_FIRST = [("orders", (0,), (0,), {"mode": "shuffle"}), ("cust", (2,), (0,), {})]


def _copart_arrays(seed=3):
    """Q3's tables and ``orders2``: a copy of orders keyed on its
    orderkey, later shuffled by the main seed (a co-partitioned right
    side for a second join on the orderkey)."""
    arrays = _q3_arrays(seed)
    o = arrays["orders"]
    arrays["orders2"] = [o[0].copy(), o[1] * 10 + 1]
    return arrays


def _shuffled_right(world, name, mp=None):
    """``name`` hash-partitioned by column 0 under the main join seed in
    both packages (shuffle_on over the world), replacing its tables."""
    jres = dj_tpu.shuffle_on(world.jtopo, *world.j[name], [0], seed=tdist.MAIN_JOIN_SEED,
                             out_factor=4.0)
    tres = tj.shuffle_on(world.ttopo, *world.t[name], [0], seed=tdist.MAIN_JOIN_SEED,
                         out_factor=4.0)
    assert not tres[2].any() and not np.asarray(jres[2]).any()
    world.j[name], world.t[name] = jres[:2], tres[:2]


LOCAL_CHAIN = [("orders", (0,), (0,), {"mode": "shuffle"}),
               ("orders2", (0,), (0,), {"right_partitioned": True})]


# -- plans ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["q3", "q3_no_broadcast", "local_chain", "copart_off",
                                  "unresolved", "declared", "no_derive"])
def test_plans_and_signatures_match_dj_tpu(case, monkeypatch):
    """Each stage's (mode, key_range, range_source, out_partitioned_by)
    and the pipeline_signature string, at a world of 4."""
    world = _World(4, _copart_arrays())
    _shuffled_right(world, "orders2")
    specs, kw = Q3, {}
    if case == "q3_no_broadcast":
        _knobs(monkeypatch, PIPELINE_BROADCAST=0)
    elif case in ("local_chain", "copart_off"):
        specs = LOCAL_CHAIN
        if case == "copart_off":
            _knobs(monkeypatch, PIPELINE_COPART=0, PIPELINE_BROADCAST=0)  # the re-shuffle
    elif case == "unresolved":
        kw = {"resolve_ranges": False}
        specs = [Q3[0], ("cust", (2,), (0,), {"key_range": (0, 63)})]
    elif case == "declared":
        specs = [("orders", (0,), (0,), {"key_range": ((0, 255),)}), Q3[1]]
    elif case == "no_derive":
        _knobs(monkeypatch, PIPELINE_RANGE_DERIVE=0)
    js, ts = world.stages(specs)
    cfg = dj_tpu.JoinConfig(**CFG)
    jplan = dj_tpu.plan_pipeline(world.jtopo, *world.j["li"], js, cfg, **kw)
    tplan = tj.plan_pipeline(world.ttopo, *world.t["li"], ts, convert.join_config_from(cfg), **kw)
    assert _plan_view(tplan) == _plan_view(jplan)
    assert tpipe.pipeline_signature(world.ttopo, tplan) == jpipe.pipeline_signature(
        world.jtopo, jplan)
    want = {"q3": ["broadcast", "broadcast"], "q3_no_broadcast": ["shuffle", "shuffle"],
            "local_chain": ["shuffle", "local"], "copart_off": ["shuffle", "shuffle"]}.get(case)
    if want:
        assert [sp.mode for sp in tplan.stage_plans] == want


def test_explicit_local_without_copartition_raises_as_dj_tpu():
    world = _World(2, _q3_arrays())
    specs = [Q3[0], ("cust", (2,), (0,), {"mode": "local", "right_partitioned": True})]
    js, ts = world.stages(specs)
    with pytest.raises(ValueError, match="requires the left side"):
        dj_tpu.plan_pipeline(world.jtopo, *world.j["li"], js)
    with pytest.raises(ValueError, match="requires the left side"):
        tj.plan_pipeline(world.ttopo, *world.t["li"], ts)
    bad = [("orders", (0,), (0,), {"mode": "sideways"})]
    with pytest.raises(ValueError, match="is not one of"):
        tj.plan_pipeline(world.ttopo, *world.t["li"], world.stages(bad)[1])


# -- rows -------------------------------------------------------------------


@pytest.mark.parametrize("w,odf", [(1, 1), (1, 3), (4, 1), (4, 3)])
def test_q3_chain_with_strings_matches_dj_tpu(w, odf):
    """lineitem |> orders (shuffle) |> customer (broadcast), string
    payloads on both right sides: counts, flags and rows shard for
    shard, and the rows of two composed distributed_inner_join calls."""
    world = _World(w, _q3_arrays(seed=w + odf, strings=True))
    cfg = dj_tpu.JoinConfig(over_decom_factor=odf, **CFG)
    jres, tres = _run_both(world, Q3_SHUFFLE_FIRST, cfg)
    assert tres == jres
    _clean(tres)
    assert sum(tres["counts"]) == 1024
    assert _all_rows(tres) == _all_rows(_composed(world, Q3_SHUFFLE_FIRST, cfg))


class _Collectives:
    """Counts the in-process transport's calls while active."""

    def __init__(self, mp):
        self.n = 0
        for name in ("all_to_all_start", "all_gather", "all_reduce", "shift_start"):
            orig = getattr(InProcessTransport, name)

            def counted(*a, _fn=orig, **k):
                self.n += 1
                return _fn(*a, **k)

            mp.setattr(InProcessTransport, name, counted)


def test_local_chain_matches_dj_tpu_and_issues_no_collective(monkeypatch):
    """At odf 3, stage 0 shuffles lineitem |> orders on the orderkey; stage 1 joins
    the intermediate with orders2, shuffled by the main seed, on the same
    key: planned local, it issues no collective of any kind and gives
    dj_tpu's rows shard for shard; the re-shuffle under
    DJT_PIPELINE_COPART=0 (and DJT_PIPELINE_BROADCAST=0, else the stage
    would be broadcast) gives the same rows on the same shards."""
    world = _World(4, _copart_arrays(seed=3))
    _shuffled_right(world, "orders2")
    cfg = dj_tpu.JoinConfig(over_decom_factor=3, **CFG)
    tcfg = convert.join_config_from(cfg)
    jres, tres = _run_both(world, LOCAL_CHAIN, cfg)
    assert tres == jres
    _clean(tres)
    assert sum(tres["counts"]) == 1024
    ts = world.stages(LOCAL_CHAIN)[1]
    coll = _Collectives(monkeypatch)
    tj.distributed_join_pipeline(world.ttopo, *world.t["li"], ts[:1], tcfg)
    stage0 = coll.n
    tj.distributed_join_pipeline(world.ttopo, *world.t["li"], ts, tcfg)
    assert stage0 > 0 and coll.n == 2 * stage0  # the local stage added none
    _knobs(monkeypatch, PIPELINE_COPART=0, PIPELINE_BROADCAST=0)
    jres2, tres2 = _run_both(world, LOCAL_CHAIN, cfg)
    assert tres2 == jres2
    assert tres2["rows"] == tres["rows"]
    assert coll.n > 3 * stage0  # the re-shuffle's exchanges


def _dim_arrays(seed, n_cust=64, hot_share=0.4):
    """A build side on the custkey with two fifths of its rows on one key
    (so that a salted prepare finds a heavy partition)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_cust, 160).astype(np.int64)
    keys[: int(hot_share * 160)] = 7
    return [keys, np.arange(160, dtype=np.int64) + 1000]


@pytest.mark.parametrize("tier", ["shuffle", "broadcast", "salted"])
def test_prepared_stage_matches_dj_tpu(tier):
    """Stage 1 against a PreparedSide of each tier (plan mode
    "prepared", out_partitioned_by as the tier says): dj_tpu's rows."""
    arrays = _q3_arrays(seed=11)
    arrays["dim"] = _dim_arrays(11)
    world = _World(4, arrays)
    cfg = dj_tpu.JoinConfig(key_range=(0, 255), **CFG)
    # The probe side is stage 0's output: 4 ranks of one batch's output
    # capacity (lineitem 256 rows a rank, orders 64).
    inter = 4 * tdist.batch_sizing(convert.join_config_from(cfg), 4, 256, 64).out_cap
    jprep = dj_tpu.prepare_join_side(world.jtopo, *world.j["dim"], [0], cfg, tier=tier,
                                     left_capacity=inter)
    tprep = tj.prepare_join_side(world.ttopo, *world.t["dim"], [0],
                                 convert.join_config_from(cfg), tier=tier, left_capacity=inter)
    assert tprep.tier == jprep.tier == tier
    specs = [Q3_SHUFFLE_FIRST[0], ((jprep, tprep), (2,), None, {})]
    js, ts = world.stages(specs)
    jplan = dj_tpu.plan_pipeline(world.jtopo, *world.j["li"], js, cfg)
    tplan = tj.plan_pipeline(world.ttopo, *world.t["li"], ts, convert.join_config_from(cfg))
    assert _plan_view(tplan) == _plan_view(jplan)
    assert tplan.stage_plans[1].mode == "prepared"
    assert tpipe.pipeline_signature(world.ttopo, tplan) == jpipe.pipeline_signature(
        world.jtopo, jplan)
    jres, tres = _run_both(world, specs, cfg)
    assert tres == jres
    _clean(tres)


def test_heal_grows_only_the_fired_stage_as_dj_tpu():
    """Stage 1's join_out_factor 0.006 (196 output rows a rank for 247 to
    260) overflows; the auto wrapper doubles it once and leaves stage 0's
    config as it was, in both; the healed rows are dj_tpu's."""
    world = _World(4, _q3_arrays(seed=5))
    cfg = dj_tpu.JoinConfig(**CFG)
    tight = dj_tpu.JoinConfig(**{**CFG, "join_out_factor": 0.006})
    specs = [Q3_SHUFFLE_FIRST[0], ("cust", (2,), (0,), {"mode": "shuffle", "config": tight})]
    jres, tres, jcfgs, tcfgs = _run_both(world, specs, cfg, auto=True)
    assert tres == jres
    _clean(tres)
    assert [c.join_out_factor for c in tcfgs] == [c.join_out_factor for c in jcfgs] == [8.0, 0.012]
    ts = world.stages(specs)[1]
    out, counts, infos = tj.distributed_join_pipeline(world.ttopo, *world.t["li"], ts,
                                                      convert.join_config_from(cfg))
    assert bool(infos[1]["join_overflow"].any()) and not infos[0]["join_overflow"].any()


def test_poisonous_declared_range_drops_for_its_stage_only_as_dj_tpu():
    """A declared two-key stage range whose second field is too narrow
    (the data spans to 100) fires pack_range_overflow; the auto wrapper
    drops that stage's range alone, and its rows are dj_tpu's."""
    rng = np.random.default_rng(17)
    n = 256
    lk1, lk2 = rng.integers(0, 50, n), rng.integers(0, 100, n)
    arrays = {"li": [lk1, lk2, np.arange(n, dtype=np.int64)],
              "mid": [np.arange(50, dtype=np.int64), np.arange(50, dtype=np.int64) * 3],
              "right2": [lk1.copy(), lk2.copy(), np.arange(n, dtype=np.int64) * 7]}
    world = _World(4, arrays)
    cfg = dj_tpu.JoinConfig(**CFG)
    specs = [("mid", (0,), (0,), {"key_range": (0, 63)}),
             ("right2", (0, 1), (0, 1), {"key_range": ((0, 50), (0, 7))})]
    ts = world.stages(specs)[1]
    _, _, infos = tj.distributed_join_pipeline(world.ttopo, *world.t["li"], ts,
                                               convert.join_config_from(cfg))
    assert bool(infos[1]["pack_range_overflow"].any())
    assert not infos[0]["pack_range_overflow"].any()
    jres, tres, _, tcfgs = _run_both(world, specs, cfg, auto=True)
    assert tres == jres
    _clean(tres)
    assert _all_rows(tres) == _all_rows(_composed(world, specs, dj_tpu.JoinConfig(**CFG)))


def _reshard_j(world, jres):
    """A dj_tpu sharded (table, counts) of a flat world moved, block for
    block, onto ``world``'s topology."""
    sh = world.jtopo.row_sharding()
    return jax.tree_util.tree_map(lambda a: jax.device_put(np.asarray(a), sh), tuple(jres[:2]))


def test_two_level_chain_matches_dj_tpu():
    """At 2 domains of 2: (i) a right side shuffled per axis ('inter' by
    the pre-shuffle's seed, then 'intra' by the main seed) is
    co-partitioned with a shuffle stage's output, and the port's local
    stage gives the composed calls' rows; (ii) a right side
    shuffled by the main seed over the flat world of 4 and declared
    right_partitioned also plans local in both (dj_tpu's _resolve_mode
    does not read the topology), and both give the same rows, fewer than
    the composed calls' (ROADMAP section 3, "Reference differences")."""
    arrays = _copart_arrays(seed=21)
    world = _World(4, arrays, intra=2)
    flat = _World(4, {"orders2": arrays["orders2"]})
    cfg = dj_tpu.JoinConfig(**CFG)
    tcfg = convert.join_config_from(cfg)
    # (i) per axis, in the port (its shuffle_on per axis is held to
    # dj_tpu's in tests/test_torch_two_level.py)
    right = world.t["orders2"]
    for axis, seed in (("inter", tdist.INTER_DOMAIN_SEED), ("intra", tdist.MAIN_JOIN_SEED)):
        right = tj.shuffle_on(world.ttopo, *right, [0], group=world.ttopo.group(axis),
                              seed=seed, out_factor=4.0)[:2]
    ts = [tj.JoinStage(world.t["orders"][0], world.t["orders"][1], (0,), (0,), mode="shuffle"),
          tj.JoinStage(*right, (0,), (0,), right_partitioned=True)]
    plan = tj.plan_pipeline(world.ttopo, *world.t["li"], ts, tcfg)
    assert [sp.mode for sp in plan.stage_plans] == ["shuffle", "local"]
    tres = _result(*tj.distributed_join_pipeline(world.ttopo, *world.t["li"], ts, tcfg,
                                                 plan=plan))
    _clean(tres)
    full = _all_rows(_composed(world, LOCAL_CHAIN, cfg))
    assert _all_rows(tres) == full and len(full) == 1024
    # (ii) the flat world's main-seed shuffle, declared co-partitioned
    _shuffled_right(flat, "orders2")
    world.j["orders2"] = _reshard_j(world, flat.j["orders2"])
    world.t["orders2"] = flat.t["orders2"]
    jres, tres = _run_both(world, LOCAL_CHAIN, cfg)
    assert tres == jres
    _clean(tres)
    got = _all_rows(tres)
    assert len(got) < len(full)
    assert set(got) <= set(full)


# -- the range probes -------------------------------------------------------


def test_derived_ranges_probe_only_inputs_and_memoize(probes):
    """Planning Q3 probes four input columns (the orderkeys of lineitem
    and orders, O_CUSTKEY and C_CUSTKEY), never an intermediate; a
    re-plan over the same tables probes nothing; a chain of the plan runs
    with no other probe."""
    world = _World(4, _q3_arrays(seed=9))
    cfg = convert.join_config_from(dj_tpu.JoinConfig(**CFG))
    ts = world.stages(Q3)[1]
    before = probes()
    plan = tj.plan_pipeline(world.ttopo, *world.t["li"], ts, cfg)
    assert probes() - before == 4
    assert [sp.range_source for sp in plan.stage_plans] == ["derived", "derived"]
    assert [sp.key_range for sp in plan.stage_plans] == [((0, 255),), ((0, 63),)]
    tj.plan_pipeline(world.ttopo, *world.t["li"], ts, cfg)
    tj.distributed_join_pipeline(world.ttopo, *world.t["li"], ts, cfg, plan=plan)
    assert probes() - before == 4


def test_an_in_place_write_after_a_probe_is_seen(probes):
    """A join probes the key range of both 64-bit key columns; writing
    new keys (past the probed range) into the tables in place, the next
    join probes again and gives dj_tpu's rows of the new data."""
    rng = np.random.default_rng(4)
    arrays = {"l": [rng.integers(0, 100, 300), np.arange(300, dtype=np.int64)],
              "r": [rng.permutation(120)[:100].astype(np.int64), np.arange(100, dtype=np.int64)]}
    world = _World(2, arrays)
    before = probes()
    tj.distributed_inner_join(world.ttopo, *world.t["l"], *world.t["r"], [0], [0])
    tj.distributed_inner_join(world.ttopo, *world.t["l"], *world.t["r"], [0], [0])
    assert probes() - before == 2
    new_l = arrays["l"][0] * 1000 + 7
    new_r = arrays["r"][0] * 1000 + 7
    world.t["l"][0].columns[0].data.copy_(torch.from_numpy(new_l))
    world.t["r"][0].columns[0].data[:] = torch.from_numpy(new_r)
    tout = tj.distributed_inner_join(world.ttopo, *world.t["l"], *world.t["r"], [0], [0])
    assert probes() - before == 4
    fresh = _World(2, {"l": [new_l, arrays["l"][1]], "r": [new_r, arrays["r"][1]]})
    jout = dj_tpu.distributed_inner_join(fresh.jtopo, *fresh.j["l"], *fresh.j["r"], [0], [0])
    assert _result(*tout[:2], [tout[2]]) == _result(*jout[:2], [jout[2]])
    assert sum(tout[1].tolist()) > 0

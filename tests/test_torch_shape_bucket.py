"""dj_tpu_torch's shape buckets, the small core pieces of the
composition layers and the warmups, vs dj_tpu.

Under ``DJT_SHAPE_BUCKET=1`` (dj_tpu's ``DJ_SHAPE_BUCKET=1``) on the
8-device CPU mesh: the grid arithmetic and ``grid_points``; the pad of
fixed and string columns, shard for shard and byte for byte, against
dj_tpu's ``bucket_table``; ``table_shape`` and the plan signatures; a
bucketed join and a bucketed prepared query, shard for shard; the pad
memo (one padded object under concurrent first calls, a new pad after
an in-place write to the source); the range memo reading a pad's range
from its source. Then ``rank_in_sorted``, ``gather_rows`` and
``intersect_key_ranges`` against dj_tpu's, and ``warmup_all_to_all`` /
``warmup_prepared_join`` on the CPU in worlds of 1 and 4 (and 4 as two
domains of 2).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import search as jsearch
from dj_tpu.core import table as jT
from dj_tpu.ops import join as jjoin
from dj_tpu.parallel import shape_bucket as jsb
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.resilience import ledger as jledger
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.core import search as tsearch
from dj_tpu_torch.core import table as tT
from dj_tpu_torch.ops import join as tjoin
from dj_tpu_torch.parallel import dist_join as tdist
from dj_tpu_torch.parallel import shape_bucket as tsb
from dj_tpu_torch.resilience import ledger as tledger

KNOBS = ("SHAPE_BUCKET", "SHAPE_BUCKET_MIN", "SHAPE_BUCKET_RATIO", "LEDGER", "PLAN_ADAPT")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _knobs(monkeypatch, **dict.fromkeys(KNOBS))
    tledger.reset()
    yield
    tledger.reset()
    torch.set_num_threads(threads)


def _knobs(mp, **kv):
    for k, v in kv.items():
        for prefix in ("DJ_", "DJT_"):
            if v is None:
                mp.delenv(prefix + k, raising=False)
            else:
                mp.setenv(prefix + k, str(v))


def _arm(mp, minimum=64, ratio=None):
    _knobs(mp, SHAPE_BUCKET=1, SHAPE_BUCKET_MIN=minimum, SHAPE_BUCKET_RATIO=ratio)


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


def _table(n, seed, hi=500, strings=False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, n).astype(np.int64)
    cols = [keys, np.arange(n, dtype=np.int64)]
    if strings:
        cols.append([b"s%d-%d" % (k, i) for i, k in enumerate(keys)])
    return cols


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


def _leaves(table):
    return [np.asarray(x) for c in table.columns
            for x in ((c.offsets, c.chars) if hasattr(c, "chars") else (c.data,))]


# -- the grid ---------------------------------------------------------------


@pytest.mark.parametrize("floor,ratio", [(64, 1.25), (16, 1.25), (32, 2.0), (1024, 1.1)])
def test_grid_math_matches_dj_tpu(floor, ratio, monkeypatch):
    """bucket_capacity on raw capacities 0..3000 (explicit and from the
    knobs), its idempotence and monotonicity, and grid_points."""
    prev = 0
    for raw in range(0, 3001, 7):
        b = tsb.bucket_capacity(raw, floor=floor, ratio=ratio)
        assert b == jsb.bucket_capacity(raw, floor=floor, ratio=ratio)
        assert tsb.bucket_capacity(b, floor=floor, ratio=ratio) == b
        assert b >= raw and b >= prev
        prev = b
    _arm(monkeypatch, minimum=floor, ratio=ratio)
    assert (tsb.grid_floor(), tsb.grid_ratio()) == (jsb.grid_floor(), jsb.grid_ratio())
    for lo, hi in ((1, 1), (33, 200), (floor, 10 * floor), (100, 100_000)):
        assert tsb.grid_points(lo, hi) == jsb.grid_points(lo, hi)
        assert tsb.bucket_capacity(hi) == jsb.bucket_capacity(hi)


def test_malformed_knobs_fall_back_as_dj_tpu(monkeypatch):
    for ratio, minimum in (("0.5", "x"), ("bad", "-3"), ("", "")):
        monkeypatch.setenv("DJ_SHAPE_BUCKET_RATIO", ratio)
        monkeypatch.setenv("DJT_SHAPE_BUCKET_RATIO", ratio)
        monkeypatch.setenv("DJ_SHAPE_BUCKET_MIN", minimum)
        monkeypatch.setenv("DJT_SHAPE_BUCKET_MIN", minimum)
        assert (tsb.grid_ratio(), tsb.grid_floor()) == (jsb.grid_ratio(), jsb.grid_floor())
    for v in ("1", "true", "yes", "on", "0", "", "no"):
        _knobs(monkeypatch, SHAPE_BUCKET=v)
        assert tsb.enabled() == jsb.enabled()


# -- the pad ----------------------------------------------------------------


@pytest.mark.parametrize("w,n", [(4, 437), (1, 300), (8, 1100)])
def test_pad_matches_dj_tpu_leaf_for_leaf(w, n, monkeypatch):
    """A table of int64, int32 and string columns padded to its bucket:
    every buffer equal to dj_tpu's pad (padding included), the counts
    untouched, and both capacities on the grid."""
    _arm(monkeypatch)
    cols = _table(n, seed=w, strings=True)
    cols.insert(1, (cols[0] % 1000).astype(np.int32))
    world = _World(w, {"t": cols})
    jp = jsb.bucket_table(world.jtopo, world.j["t"][0])
    tp = tsb.bucket_table(world.ttopo, world.t["t"][0])
    assert tp is not world.t["t"][0]
    for a, b in zip(_leaves(tp), _leaves(jp)):
        np.testing.assert_array_equal(a, b)
    assert tsb.bucket_capacity(tp.capacity // w) == tp.capacity // w
    ccap = tp.columns[3].chars.shape[0] // w
    assert tsb.bucket_capacity(ccap) == ccap
    assert _shard_rows(tp, world.t["t"][1]) == _shard_rows(world.t["t"][0], world.t["t"][1])


def test_on_grid_table_and_a_pad_are_not_padded_again(monkeypatch):
    _arm(monkeypatch)
    world = _World(4, {"t": _table(256, 3)})  # 64 rows a shard: the floor
    t = world.t["t"][0]
    before = dict(tsb.totals)
    assert tsb.bucket_table(world.ttopo, t) is t
    assert tsb.bucket_table(world.ttopo, t) is t
    assert tsb.totals["exact"] - before["exact"] == 1 and tsb.totals["pad"] == before["pad"]
    world = _World(4, {"t": _table(300, 3)})
    p = tsb.bucket_table(world.ttopo, world.t["t"][0])
    assert tsb.bucket_table(world.ttopo, p) is p
    assert tsb.bucket_table(world.ttopo, world.t["t"][0]) is p  # the memo
    assert tsb.totals["pad"] - before["pad"] == 1 and tsb.totals["memo_hit"] > before["memo_hit"]


def test_table_shape_and_signatures_match_dj_tpu(monkeypatch):
    """With buckets on, two raw shapes of one bucket share a signature,
    and each signature string (join, prepare; a string column's char
    capacity too) is dj_tpu's; off, they are the raw shapes' (dj_tpu's
    too)."""
    world = _World(4, {"a": _table(410, 12), "b": _table(431, 13), "s": _table(437, 15, True),
                       "r": _table(390, 14)})
    cfg = dj_tpu.JoinConfig()
    tcfg = convert.join_config_from(cfg)

    def sigs():
        out = []
        for name in ("a", "b", "s"):
            j, t = world.j[name][0], world.t[name][0]
            out.append((tledger.plan_signature(world.ttopo, t, world.t["r"][0], (0,), (0,), tcfg),
                        jledger.plan_signature(world.jtopo, j, world.j["r"][0], (0,), (0,), cfg)))
            out.append((tledger.plan_signature(world.ttopo, None, t, None, (0,), tcfg),
                        jledger.plan_signature(world.jtopo, None, j, None, (0,), cfg)))
            assert tledger.table_shape(t, 4) == jsb.table_shape(j, 4)
        return out

    off = sigs()
    assert all(t == j for t, j in off) and off[0][0] != off[2][0]
    _arm(monkeypatch)
    on = sigs()  # 103 and 108 rows a shard: one bucket of 125
    assert all(t == j for t, j in on) and on[0][0] == on[2][0] and on[1][0] == on[3][0]


def test_bucketed_join_and_prepared_query_match_dj_tpu(monkeypatch):
    """A join of two off-grid tables and a prepared query of an off-grid
    probe side, bucketed in both packages: shard for shard dj_tpu's, and
    the rows of the unbucketed join (string columns' pads are held to
    dj_tpu's in test_pad_matches_dj_tpu_leaf_for_leaf)."""
    world = _World(4, {"l": _table(437, 1), "r": _table(391, 2),
                       "q": _table(455, 3)})
    cfg = dj_tpu.JoinConfig(bucket_factor=4.0, join_out_factor=4.0, char_out_factor=4.0)
    tcfg = convert.join_config_from(cfg)
    plain = _result(tj.distributed_inner_join(world.ttopo, *world.t["l"], *world.t["r"], [0], [0],
                                              tcfg))
    _arm(monkeypatch)
    got = _result(tj.distributed_inner_join(world.ttopo, *world.t["l"], *world.t["r"], [0], [0],
                                            tcfg))
    want = _result(dj_tpu.distributed_inner_join(world.jtopo, *world.j["l"], *world.j["r"], [0],
                                                 [0], cfg))
    assert got == want
    assert got["rows"] == plain["rows"] and not any(any(v) for v in got["flags"].values())
    pcfg = dj_tpu.JoinConfig(bucket_factor=4.0, join_out_factor=4.0, key_range=(0, 499))
    tp = tj.prepare_join_side(world.ttopo, *world.t["r"], [0], convert.join_config_from(pcfg),
                              left_capacity=440)
    jp = dj_tpu.prepare_join_side(world.jtopo, *world.j["r"], [0], pcfg, left_capacity=440)
    assert (tp.l_cap, tp.r_cap, tp.plan.tag_bits) == (jp.l_cap, jp.r_cap, jp.plan.tag_bits)
    got = _result(tj.distributed_inner_join(world.ttopo, *world.t["q"], tp, None, [0], None,
                                            convert.join_config_from(pcfg)))
    want = _result(dj_tpu.distributed_inner_join(world.jtopo, *world.j["q"], jp, None, [0], None,
                                                 pcfg))
    assert got == want and sum(got["counts"]) > 0


def test_pad_memo_gives_one_object_to_concurrent_calls(monkeypatch):
    """Concurrent first pads of the same source (8 threads) return one
    padded object, padded once (dj_tpu tests/test_shape_bucket.py:361)."""
    _arm(monkeypatch)
    world = _World(8, {"t": _table(410, 90)})
    t = world.t["t"][0]
    before = tsb.totals["pad"]
    results, errors = [], []
    barrier = threading.Barrier(8)

    def go():
        try:
            barrier.wait(timeout=60)
            results.append(tsb.bucket_table(world.ttopo, t))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=go, daemon=True) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors and len(results) == 8
    assert all(r is results[0] for r in results)
    assert tsb.totals["pad"] - before == 1


def test_in_place_write_to_a_padded_source_pads_again(monkeypatch):
    """Writing into a padded table's source in place: the next
    bucket_table pads anew (the new data), the old pad's alias no longer
    resolves, and the range memo probes the new data."""
    _arm(monkeypatch)
    world = _World(4, {"t": _table(300, 5)})
    t, c = world.t["t"]
    first = tsb.bucket_table(world.ttopo, t)
    assert tsb.alias_base(first.columns[0].data) is t.columns[0].data
    assert tdist._memo_minmax(first.columns[0].data, c, 4) == tdist._memo_minmax(
        t.columns[0].data, c, 4)
    t.columns[0].data.add_(10_000)
    second = tsb.bucket_table(world.ttopo, t)
    assert second is not first
    assert tsb.alias_base(first.columns[0].data) is None
    np.testing.assert_array_equal(
        second.columns[0].data.reshape(4, -1)[:, :75].numpy(),
        t.columns[0].data.reshape(4, -1).numpy())
    mn, mx = tdist._memo_minmax(second.columns[0].data, c, 4)
    assert mn >= 10_000


def test_range_memo_reads_a_pad_from_its_source(monkeypatch):
    """The range of a pad's column comes from its source's memo entry:
    no new probe (dj_tpu tests/test_shape_bucket.py:335)."""
    _arm(monkeypatch)
    world = _World(8, {"t": _table(410, 16)})
    t, c = world.t["t"]
    first = tdist._memo_minmax(t.columns[0].data, c, 8)
    probes = tdist.range_probes
    padded = tsb.bucket_table(world.ttopo, t)
    assert padded is not t
    assert tdist._memo_minmax(padded.columns[0].data, c, 8) == first
    assert tdist.range_probes == probes


# -- the core pieces --------------------------------------------------------


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", ["int64", "int32", "uint32"])
def test_rank_in_sorted_matches_dj_tpu(side, dtype):
    rng = np.random.default_rng(31)
    ref = np.sort(rng.integers(0, 50, 300)).astype(dtype)
    q = rng.integers(-5, 60, 200).clip(0).astype(dtype)
    want = np.asarray(jsearch.rank_in_sorted(jnp.asarray(ref), jnp.asarray(q), side))
    got = tsearch.rank_in_sorted(torch.from_numpy(ref.astype(np.int64)),
                                 torch.from_numpy(q.astype(np.int64)), side)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    empty = tsearch.rank_in_sorted(torch.zeros(0, dtype=torch.int64), torch.from_numpy(
        q.astype(np.int64)), side)
    assert empty.tolist() == [0] * q.shape[0]


def test_gather_rows_matches_dj_tpu():
    """Columns of four element widths (each of them twice), gathered with
    in- and out-of-range indices: dj_tpu's columns bit for bit; a
    negative index gives 0 as take_fill does."""
    rng = np.random.default_rng(32)
    n = 257
    arrays = [rng.integers(-2**62, 2**62, n), rng.standard_normal(n),
              rng.integers(-2**31, 2**31, n).astype(np.int32), rng.standard_normal(n).astype(
                  np.float32), rng.integers(0, 2**16, n).astype(np.uint16),
              rng.integers(-128, 128, n).astype(np.int8), rng.integers(0, 256, n).astype(np.uint8)]
    # Indices in range and past the end: JAX wraps a negative index where
    # the port fills it (ROADMAP section 3, "Reference differences").
    idx = rng.integers(0, n + 20, 400).astype(np.int32)
    jcols = [jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(a.dtype.name)) for a in arrays]
    tcols = [tT.Column(torch.from_numpy(a.copy()), tj.dtypes.by_name(a.dtype.name))
             for a in arrays]
    want = jT.gather_rows(jcols, jnp.asarray(idx))
    got = tT.gather_rows(tcols, torch.from_numpy(idx).to(torch.int64))
    for g, w_ in zip(got, want):
        assert str(g.dtype) == str(w_.dtype)
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w_.data))
    neg = tT.gather_rows(tcols, torch.tensor([-1, 0, -n]))
    assert all(c.data[0] == 0 and c.data[2] == 0 for c in neg)


def test_intersect_key_ranges_matches_dj_tpu():
    cases = [(((0, 10),), ((5, 20),)), (((0, 10), (-5, 5)), ((11, 20), (0, 9))),
             (((3, 3),), ((3, 3),)), (None, ((0, 1),)), (((-2**63, 2**63 - 1),), ((0, 7),))]
    for a, b in cases:
        assert tjoin.intersect_key_ranges(a, b) == jjoin.intersect_key_ranges(a, b)


# -- the warmups ------------------------------------------------------------


@pytest.mark.parametrize("w,intra", [(1, None), (4, None), (4, 2)])
def test_warmups_run_on_the_cpu(w, intra, monkeypatch):
    """warmup_all_to_all over each axis of a world of w (one all-to-all
    per rank and axis), and warmup_prepared_join of one throwaway query
    (a lease-like wrapper unwrapped), which leaves the prepared side as
    it was."""
    from dj_tpu_torch.parallel.communicator import InProcessTransport, SingleRankTransport

    calls = []
    for cls in (InProcessTransport, SingleRankTransport):
        orig = cls.all_to_all_start

        def counted(self, x, _fn=orig):
            calls.append(tuple(x.shape))
            return _fn(self, x)

        monkeypatch.setattr(cls, "all_to_all_start", counted)
    topo = tj.make_topology(["cpu"] * w, intra_size=intra)
    tj.warmup_all_to_all(topo, nbytes=80_000)
    assert len(calls) == w * len(topo.axis_names)
    world = _World(w, {"r": _table(200, 7), "q": _table(160, 8)}, intra=intra)
    cfg = tj.JoinConfig(key_range=(0, 499))
    prep = tj.prepare_join_side(world.ttopo, *world.t["r"], [0], cfg, left_capacity=160)

    class Lease:
        prepared = prep

    batches = prep.batches
    tj.warmup_prepared_join(world.ttopo, Lease(), *world.t["q"], [0])
    tj.warmup_prepared_join(world.ttopo, prep, *world.t["q"], [0], cfg)
    assert prep.batches is batches

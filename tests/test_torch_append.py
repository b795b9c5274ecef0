"""dj_tpu_torch's appends to a prepared side vs dj_tpu's, on the same inputs.

Seeded numpy tables (int64 keys, an int64 and a string payload) are
prepared in both packages, then the same appended rows go through
``append_to_prepared``: at worlds of 1, 4 and 8 ranks (dj_tpu on as many
devices of the CPU mesh) and odf 1, 2 and 4. Compared exactly: every
batch's words bit for bit, its payload columns (strings as bytes) on
each shard's valid prefix, its counts, ``touched``, every flag,
``r_cap`` and the combined source's rows per shard; then a query after
the append under each merge tier against dj_tpu's query, and against a
fresh prepare of the combined source. Also: ``merge_packed_batch`` alone
(fixed and string payloads, an empty appended side), the overflow and
mismatch flags, an append that touches one batch only (the others keep
their tensors), the refusals, and a dj_tpu side after an append carried
into the port.
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
from dj_tpu_torch.ops.partition import partition_ids
from dj_tpu_torch.parallel.dist_join import MAIN_JOIN_SEED

TIERS = ("sort", "merge", "probe")
NB, NA, NL = 480, 64, 600  # build, appended and probe rows
SPAN = 3 * NB
FLAGS = ("append_shuffle_overflow", "append_overflow", "prepared_plan_mismatch")


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


def _both(arrays, names):
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
    return jT.Table(tuple(jcols)), tj.Table(tuple(tcols))


NAMES = ["int64", "int64", "string"]


def _rows_of(keys, base):
    """(key, payload, string) columns for ``keys``."""
    keys = np.asarray(keys, np.int64)
    return [keys, np.arange(keys.size, dtype=np.int64) + base,
            [b"s%d-%d" % (k, k % 5) for k in keys]]


def _tables(seed):
    """Build keys unique in [0, SPAN) with both ends present; appended
    keys three quarters new to the build side, the rest its keys; probe
    keys anywhere in the span."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, SPAN - 1))
    bk = np.concatenate([[0, SPAN - 1], perm[: NB - 2]])
    new = perm[NB - 2 : NB - 2 + 3 * NA // 4]
    ak = np.concatenate([new, rng.choice(bk, NA - new.size)])
    pk = rng.integers(0, SPAN, NL)
    return _rows_of(bk, 10**6), _rows_of(rng.permutation(ak), 2 * 10**6), _rows_of(pk, 0)


def _shard_rows(table, counts, w):
    """Each shard's valid rows (strings as bytes), sorted."""
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


def _shard_columns(table, counts, w):
    """Each shard's valid prefix of each column, in order (strings as
    bytes)."""
    counts = np.asarray(counts).tolist()
    cap = table.capacity // w
    out = []
    for c in table.columns:
        per = []
        for r, n in enumerate(counts):
            if hasattr(c, "chars"):
                ccap = c.chars.shape[0] // w
                shard = jT.StringColumn(np.asarray(c.offsets)[r * (cap + 1):(r + 1) * (cap + 1)],
                                        np.asarray(c.chars)[r * ccap:(r + 1) * ccap])
                per.append(jT.to_strings(shard, n))
            else:
                per.append(np.asarray(c.data)[r * cap:r * cap + n].tolist())
        out.append(per)
    return out


class _World:
    """The build, appended and probe tables sharded over w ranks in both
    packages (the build side at twice its rows of capacity, so that the
    batches hold slack for the appended rows)."""

    def __init__(self, w, build, rows, probe, build_cap=None):
        self.w = w
        self.jtopo = jmake_topology(jax.devices()[:w])
        self.ttopo = tj.make_topology(["cpu"] * w)
        cap = build_cap if build_cap is not None else 2 * NB // w
        self.j, self.t = {}, {}
        for side, arrays, kw in (("build", build, {"capacity_per_shard": cap}),
                                 ("rows", rows, {}), ("probe", probe, {})):
            jt, tt = _both(arrays, NAMES[: len(arrays)])
            self.j[side] = jshard(self.jtopo, jt, **kw)
            self.t[side] = tj.shard_table(self.ttopo, tt, **kw)

    def prepare(self, cfg):
        jprep = jdist.prepare_join_side(self.jtopo, *self.j["build"], [0], cfg, tier="shuffle",
                                        left_capacity=NL)
        tprep = tj.prepare_join_side(self.ttopo, *self.t["build"], [0],
                                     convert.join_config_from(cfg), left_capacity=NL)
        return jprep, tprep

    def append(self, jprep, tprep, side="rows"):
        return (jdist.append_to_prepared(self.jtopo, jprep, *self.j[side]),
                tj.append_to_prepared(self.ttopo, tprep, *self.t[side]))

    def jquery(self, prep, cfg):
        return dj_tpu.distributed_inner_join(self.jtopo, *self.j["probe"], prep, None, [0], None,
                                             cfg)

    def tquery(self, prep, cfg):
        return tj.distributed_inner_join(self.ttopo, *self.t["probe"], prep, None, [0], None,
                                         convert.join_config_from(cfg))


def _config(odf):
    return dj_tpu.JoinConfig(over_decom_factor=odf, key_range=(0, SPAN - 1), bucket_factor=4.0,
                             join_out_factor=4.0, char_out_factor=2.0)


@pytest.fixture(scope="module")
def appended():
    """dj_tpu's and the port's prepare, append and query per (w, odf),
    made on first use."""
    cache = {}

    def get(w, odf):
        if (w, odf) not in cache:
            world = _World(w, *_tables(w * 10 + odf))
            cfg = _config(odf)
            jprep, tprep = world.prepare(cfg)
            (jnew, jinfo), (tnew, tinfo) = world.append(jprep, tprep)
            cache[(w, odf)] = (world, cfg, jprep, tprep, jnew, jinfo, tnew, tinfo,
                               world.jquery(jnew, cfg))
            jdist._build_prepared_query_fn.cache_clear()
        return cache[(w, odf)]

    return get


def _assert_batches_equal(tbatches, jbatches, w):
    assert len(tbatches) == len(jbatches)
    for (tw, tp, tc), (jw, jp, jc) in zip(tbatches, jbatches):
        assert tc.tolist() == np.asarray(jc).tolist()
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int64))
        assert [c.dtype.name for c in tp.columns] == [c.dtype.name for c in jp.columns]
        assert _shard_columns(tp, tc, w) == _shard_columns(jp, jc, w)


# Worlds of 1, 4 and 8 ranks, odf 1, 2 and 4 (dj_tpu builds one module
# a touched batch, so each odf costs its compiles; one rank at odf 1 is
# the flag cases' world).
WORLDS = [(1, 4), (4, 2), (8, 1)]


@pytest.mark.parametrize("w,odf", WORLDS)
def test_append_matches_dj_tpu(w, odf, appended):
    world, cfg, jprep, tprep, jnew, jinfo, tnew, tinfo, _ = appended(w, odf)
    assert tinfo["touched"] == tuple(jinfo["touched"]) != ()
    for k in FLAGS:
        assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist() == [False] * w, k
    assert tnew.r_cap == int(jnew.r_cap) == tprep.r_cap + NA // w
    _assert_batches_equal(tnew.batches, jnew.batches, w)
    for b, batch in enumerate(tprep.batches):
        assert (tnew.batches[b] is batch) == (b not in tinfo["touched"])
    assert _shard_rows(tnew.right, tnew.right_counts, w) == \
        _shard_rows(jnew.right, jnew.right_counts, w)
    assert int(tnew.right_counts.sum()) == NB + NA
    got = tj.combine_prepared_source(world.ttopo, tprep, *world.t["rows"])
    assert _shard_rows(*got, w) == _shard_rows(tnew.right, tnew.right_counts, w)


@pytest.mark.parametrize("w,odf", WORLDS)
def test_query_after_append_matches_dj_tpu(w, odf, appended, monkeypatch):
    """Under each merge tier: the query's counts, flags and shard rows
    equal dj_tpu's query after its append, and the rows of a fresh
    prepare of the combined source (the oracle of dj_tpu's own test)."""
    world, cfg, _, _, _, _, tnew, _, (jout, jcounts, jinfo) = appended(w, odf)
    bk, ak, pk = (t[0] for t in _tables(w * 10 + odf))
    keys, mult = np.unique(np.concatenate([bk, ak]), return_counts=True)
    at = np.searchsorted(keys, pk).clip(0, keys.size - 1)
    assert int(np.asarray(jcounts).sum()) == int(np.where(keys[at] == pk, mult[at], 0).sum())
    tcfg = convert.join_config_from(cfg)
    fresh = tj.prepare_join_side(world.ttopo, tnew.right, tnew.right_counts, [0], tcfg,
                                 left_capacity=NL)
    for tier in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", tier)
        tout, tcounts, tinfo = world.tquery(tnew, cfg)
        assert tcounts.tolist() == np.asarray(jcounts).tolist(), tier
        assert set(tinfo) == set(jinfo)
        for k in jinfo:
            assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist() == [False] * w, (tier, k)
        rows = _shard_rows(tout, tcounts, w)
        assert rows == _shard_rows(jout, jcounts, w), tier
        fout, fcounts, _ = tj.distributed_inner_join(world.ttopo, *world.t["probe"], fresh, None,
                                                     [0], None, tcfg)
        assert sorted(sum(_shard_rows(fout, fcounts, w), [])) == sorted(sum(rows, [])), tier


def _merge_case(case):
    """(resident arrays, appended arrays, names, R, appended valid)."""
    rng = np.random.default_rng(len(case))
    rk = rng.permutation(200)[:90]
    ak = rng.integers(0, 200, 40)
    if case == "fixed":
        return ([rk, rk * 3], [ak, ak * 5 + 1], ["int64", "int64"], 150, 33)
    if case == "strings":
        rs = [b"r%d" % k * (int(k) % 3) for k in rk]
        as_ = [bytes([65 + int(k) % 26]) * (int(k) % 6) for k in ak]
        return ([rk, rs, rk.astype(np.int32)], [ak, as_, ak.astype(np.int32)],
                ["int64", "string", "int32"], 150, 40)
    if case == "empty_appended":
        return ([rk, [b"x%d" % k for k in rk]], [ak, [b"y" for _ in ak]],
                ["int64", "string"], 120, 0)
    if case == "overflow":
        return ([rk, rk * 3], [ak, ak * 5 + 1], ["int64", "int64"], 100, 40)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["fixed", "strings", "empty_appended", "overflow"])
def test_merge_packed_batch_matches_dj_tpu(case):
    ra, aa, names, R, av = _merge_case(case)
    jr, tr = _both(ra, names)
    ja, ta = _both(aa, names)
    pad = R - len(ra[0])
    # The resident batch at capacity R: the build rows plus padding.
    jr = jT.Table(tuple(jT.Column(jnp.concatenate([c.data, jnp.zeros(pad, c.data.dtype)]), c.dtype)
                        if not hasattr(c, "chars")
                        else jT.StringColumn(jnp.concatenate([c.offsets, jnp.full(pad, c.offsets[-1])]),
                                             c.chars)
                        for c in jr.columns), jnp.int32(len(ra[0])))
    tr = convert.table_from_numpy(
        [(np.asarray(c.offsets), np.asarray(c.chars)) if hasattr(c, "chars") else np.asarray(c.data)
         for c in jr.columns], names, len(ra[0]), device="cpu")
    ja = ja.with_count(jnp.int32(av))
    ta = ta.with_count(tj.from_arrays(np.array(av, np.int32), device="cpu").columns[0].data)
    plan = jjoin.plan_prepared_pack((0, 199), [np.int64], R + ja.capacity + 1)
    tplan = tjoin.PreparedPackPlan(*plan)

    def merged(r, a):  # compiled whole: dj_tpu's eager ops compile one by one
        w, pay, _ = jjoin.prepare_packed_batch(r, [0], plan)
        return jjoin.merge_packed_batch(w, pay, a, jjoin._anchored_pack_word(a, [0], plan, R)[0],
                                        [0], plan)

    want = jax.jit(merged)(jr, ja)
    tw, tpay, _ = tjoin.prepare_packed_batch(tr, [0], tplan)
    taw, _ = tjoin._anchored_pack_word(ta, [0], tplan, R)
    got = tjoin.merge_packed_batch(tw, tpay, ta, taw, [0], tplan)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).view(np.int64))
    assert int(got[2]) == int(want[2]) == len(ra[0]) + av
    assert bool(got[3]) == bool(want[3]) == (case == "overflow")
    n = min(R, int(got[2]))
    for g, w in zip(got[1].columns, want[1].columns):
        if hasattr(w, "chars"):
            np.testing.assert_array_equal(g.offsets.numpy(), np.asarray(w.offsets))
            np.testing.assert_array_equal(g.chars.numpy(), np.asarray(w.chars))
        else:
            np.testing.assert_array_equal(g.data.numpy()[:n], np.asarray(w.data)[:n])


def _flag_case_tables(case):
    build, rows, probe = _tables(77)
    if case == "mismatch":
        rows[0] = rows[0].copy()
        rows[0][5] = 10 * SPAN  # outside the anchored plan
    return build, rows, probe


@pytest.mark.parametrize("case", ["overflow", "mismatch"])
def test_append_flags_match_dj_tpu(case):
    """One rank at odf 1: with no slack (the build rows fill the batch)
    append_overflow fires, and an appended key outside the plan's anchors
    fires prepared_plan_mismatch, in both packages."""
    world = _World(1, *_flag_case_tables(case), build_cap=NB if case == "overflow" else None)
    jprep, tprep = world.prepare(_config(1))
    (_, jinfo), (_, tinfo) = world.append(jprep, tprep)
    assert tinfo["touched"] == tuple(jinfo["touched"]) == (0,)
    for k in FLAGS:
        assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist(), k
    fired = {"overflow": "append_overflow", "mismatch": "prepared_plan_mismatch"}[case]
    assert [k for k in FLAGS if bool(tinfo[k].any())] == [fired]


def test_append_touching_one_batch():
    """Appended keys that all hash into batch 0 of 4 touch it alone; the
    other batches are the same tensors, and the batches equal dj_tpu's."""
    build, _, probe = _tables(5)
    keys = np.arange(SPAN, 2 * SPAN, dtype=np.int64)
    ids = partition_ids(tj.from_arrays(keys, device="cpu"), [0], 4, seed=MAIN_JOIN_SEED).numpy()
    rows = _rows_of(keys[ids == 0][:NA], 3 * 10**6)
    world = _World(1, build, rows, probe)
    cfg = dj_tpu.JoinConfig(over_decom_factor=4, key_range=(0, 2 * SPAN))
    jprep = jdist.prepare_join_side(world.jtopo, *world.j["build"], [0], cfg, tier="shuffle",
                                    left_capacity=NL)
    tprep = tj.prepare_join_side(world.ttopo, *world.t["build"], [0],
                                 convert.join_config_from(cfg), left_capacity=NL)
    (jnew, jinfo), (tnew, tinfo) = world.append(jprep, tprep)
    assert tinfo["touched"] == tuple(jinfo["touched"]) == (0,)
    assert all(tnew.batches[b] is tprep.batches[b] for b in (1, 2, 3))
    assert tnew.batches[0] is not tprep.batches[0]
    _assert_batches_equal(tnew.batches, jnew.batches, 1)


def test_append_refusals_match_dj_tpu():
    """A two-level topology, another schema and an appended capacity the
    tag field cannot hold raise PreparedPlanMismatch in both packages; a
    shard with no appended capacity raises ValueError."""
    build, rows, probe = _tables(6)
    world = _World(4, build, rows, probe)
    jprep, tprep = world.prepare(_config(1))
    other = [rows[0], rows[1].astype(np.int32), rows[2]]
    jo, to = _both(other, ["int64", "int32", "string"])
    big = _rows_of(np.zeros(1 << 12, np.int64), 0)
    jb, tb = _both(big, NAMES)
    tiny = _rows_of(np.zeros(3, np.int64), 0)
    jt_, tt_ = _both(tiny, NAMES)
    for exc_j, exc_t, (jrows, trows) in (
        (jdist.PreparedPlanMismatch, tj.PreparedPlanMismatch, (jo, to)),
        (jdist.PreparedPlanMismatch, tj.PreparedPlanMismatch, (jb, tb)),
        (ValueError, ValueError, (jt_, tt_)),
    ):
        with pytest.raises(exc_j):
            jdist.append_to_prepared(world.jtopo, jprep, jrows, jnp.zeros(4, jnp.int32))
        with pytest.raises(exc_t):
            tj.append_to_prepared(world.ttopo, tprep, trows,
                                  tj.from_arrays(np.zeros(4, np.int32), device="cpu")
                                  .columns[0].data)
    topo2 = tj.make_topology(["cpu"] * 4, intra_size=2)
    tr2, trc2 = tj.shard_table(topo2, _both(build, NAMES)[1])
    prep2 = tj.prepare_join_side(topo2, tr2, trc2, [0], convert.join_config_from(_config(1)))
    with pytest.raises(tj.PreparedPlanMismatch, match="hierarchical"):
        tj.append_to_prepared(topo2, prep2, *tj.shard_table(topo2, _both(rows, NAMES)[1]))


@pytest.mark.parametrize("append", [False, True])
def test_prepared_side_after_append_carried_from_dj_tpu(append, appended, monkeypatch):
    """A dj_tpu PreparedSide with a string payload, fresh or after an
    append (r_cap grown), converts into the port batch for batch equal to
    the port's own side and serves its rows under every tier: the port's
    prepare of the same build table (fresh), dj_tpu's query (after the
    append)."""
    world, cfg, jprep, tprep, jnew, _, tnew, _, jq = appended(4, 2)
    jside, tside = (jnew, tnew) if append else (jprep, tprep)
    carried = convert.prepared_side_from(jside, world.ttopo)
    assert carried.r_cap == int(jside.r_cap) == tside.r_cap and carried.right.has_strings
    assert carried.r_cap == 2 * NB // 4 + (NA // 4 if append else 0)
    for (cw, cp, cc), (tw, tp, tc) in zip(carried.batches, tside.batches):
        assert torch.equal(cw, tw) and torch.equal(cc, tc)
        assert _shard_columns(cp, cc, 4) == _shard_columns(tp, tc, 4)
    for tier in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", tier)
        tout, tcounts, tinfo = world.tquery(carried, cfg)
        assert not any(bool(v.any()) for v in tinfo.values())
        wout, wcounts, _ = jq if append else world.tquery(tprep, cfg)
        assert _shard_rows(tout, tcounts, 4) == _shard_rows(wout, wcounts, 4), tier

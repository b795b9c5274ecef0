"""dj_tpu_torch's prepared-join ops vs dj_tpu.ops.join on the same inputs.

Seeded numpy tables go through both packages: the anchored pack plan,
the packed words and their fit flag, the one-time batch preparation
(words bit for bit, payloads and ok equal), and the per-query join under
each of the port's merge tiers (sort, merge, probe) against each of
dj_tpu's: its CPU defaults (xla, probe), its merge kernel with the
Pallas scans and vmeta expansion in interpret mode (the TPU plan of the
merge tier), and its probe tier with the Pallas expand_ranks in
interpret mode (the TPU plan of the probe tier). Joined tables compare
as row multisets, with equal totals, counts and flags. Every compared
value is an integer: the tolerance is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
import dj_tpu.ops.pallas_merge as PM
from dj_tpu.core.table import Column as JColumn, Table as JTable
from dj_tpu.ops import join as jjoin
from dj_tpu.ops import pallas_scan as psc
from dj_tpu_torch import convert
from dj_tpu_torch.ops import join as tjoin

TIERS = ("sort", "merge", "probe")


def _pair(arrays, valid=None):
    """(dj_tpu table, dj_tpu_torch CPU table) of the same columns."""
    names = [a.dtype.name for a in arrays]
    jt = JTable(
        tuple(JColumn(jnp.asarray(a), dj_tpu.dtypes.by_name(n)) for a, n in zip(arrays, names)),
        None if valid is None else jnp.int32(valid),
    )
    return jt, convert.table_from_numpy(arrays, names, valid, device="cpu")


def _rows(table, count):
    return sorted(zip(*[np.asarray(c.data)[:count].tolist() for c in table.columns]))


@pytest.mark.parametrize(
    "key_range,dtypes,S",
    [
        ((0, 300), (np.int64,), 1200),
        ((-(2**40), -(2**40) + 60), (np.int64,), 600),
        ((-1000, 999), (np.int32,), 4096),
        ((0, 2**62), (np.int64,), 2**20),  # does not fit: None
        ((-(2**63), 2**63 - 1), (np.int64,), 8),  # does not fit: None
        (((0, 40), (-3, 3)), (np.int64, np.int32), 700),
        ((7, 7), (np.int16,), 1),
    ],
)
def test_plan_prepared_pack_matches(key_range, dtypes, S):
    want = jjoin.plan_prepared_pack(key_range, dtypes, S)
    got = tjoin.plan_prepared_pack(key_range, [torch.from_numpy(np.zeros(1, d)).dtype for d in dtypes], S)
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want)


@pytest.mark.parametrize(
    "case", ["inside", "out_of_anchor_low", "out_of_anchor_high", "empty", "int32_negative", "multi_key"]
)
def test_anchored_pack_word_matches(case):
    rng = np.random.default_rng(len(case))
    kr, on = (0, 300), [0]
    keys = [rng.integers(0, 301, 257)]
    valid = 200
    if case == "out_of_anchor_low":
        keys[0][17] = -1
    elif case == "out_of_anchor_high":
        keys[0][150] = 512
    elif case == "empty":
        keys[0][:] = 10**6
        valid = 0
    elif case == "int32_negative":
        kr, keys = (-1000, -900), [rng.integers(-1000, -899, 257).astype(np.int32)]
    elif case == "multi_key":
        kr, on = ((0, 40), (-3, 3)), [0, 1]
        keys = [rng.integers(0, 41, 257), rng.integers(-3, 4, 257).astype(np.int32)]
    keys[0][valid:] = 10**6 if keys[0].dtype == np.int64 else 0  # padding garbage
    jt, tt = _pair(keys + [np.arange(257, dtype=np.int64)], valid)
    plan = jjoin.plan_prepared_pack(kr, [k.dtype for k in keys], 514)
    want_w, want_ok = jjoin._anchored_pack_word(jt, on, plan, 257)
    got_w, got_ok = tjoin._anchored_pack_word(tt, on, tjoin.PreparedPackPlan(*plan), 257)
    np.testing.assert_array_equal(got_w.numpy().view(np.uint64), np.asarray(want_w))
    assert bool(got_ok) == bool(want_ok) == (case not in ("out_of_anchor_low", "out_of_anchor_high"))


@pytest.mark.parametrize("case", ["int64_dups", "int32_negative", "partly_valid", "empty", "float_payload"])
def test_prepare_packed_batch_matches(case):
    rng = np.random.default_rng(len(case) + 7)
    R = 300
    keys = rng.integers(0, 40, R)
    kr, valid = (0, 40), None
    pays = [np.arange(R, dtype=np.int64) * 7, rng.integers(-9, 9, R).astype(np.int32)]
    if case == "int32_negative":
        keys, kr = rng.integers(-500, 500, R).astype(np.int32), (-500, 499)
    elif case == "partly_valid":
        valid = 211
    elif case == "empty":
        valid = 0
    elif case == "float_payload":
        pays = [rng.standard_normal(R).astype(np.float32), np.full(R, -0.0)]
    jt, tt = _pair([pays[0], keys, pays[1]], valid)
    plan = jjoin.plan_prepared_pack(kr, [keys.dtype], 2 * R)
    jw, jpay, jok = jjoin.prepare_packed_batch(jt, [1], plan)
    tw, tpay, tok = tjoin.prepare_packed_batch(tt, [1], tjoin.PreparedPackPlan(*plan))
    np.testing.assert_array_equal(tw.numpy().view(np.uint64), np.asarray(jw))
    assert bool(tok) == bool(jok)
    assert int(tpay.count()) == int(jpay.count())
    assert [c.dtype.name for c in tpay.columns] == [c.dtype.name for c in jpay.columns]
    for g, w in zip(tpay.columns, jpay.columns):
        np.testing.assert_array_equal(
            g.data.numpy().view(np.uint8), np.asarray(w.data).view(np.uint8)
        )


def _join_case(case):
    """(left arrays, left valid, right arrays, right valid, key_range,
    left_on, right_on, out_capacity)."""
    rng = np.random.default_rng(len(case) + 11)
    nl, nr = 700, 500
    if case == "oracle":  # tests/test_prepared.py:139-168
        lk, rk = rng.integers(0, 300, nl), rng.integers(0, 300, nr)
        return ([lk, np.arange(nl)], nl - 30, [rk, np.arange(nr) * 7], nr - 20,
                (0, 300), [0], [0], 8192)
    if case == "duplicate_heavy":
        lk, rk = rng.integers(0, 8, 512), rng.integers(0, 8, 512)
        return [lk, np.arange(512)], None, [np.arange(512), rk], None, (0, 8), [0], [1], 65536
    if case in ("empty_left", "empty_right", "empty_both"):
        lk, rk = rng.integers(0, 100, 256), rng.integers(0, 100, 256)
        lv = 0 if case in ("empty_left", "empty_both") else 256
        rv = 0 if case in ("empty_right", "empty_both") else 256
        return [lk, np.arange(256)], lv, [rk, np.arange(256)], rv, (0, 100), [0], [0], 1024
    if case == "out_of_anchor_left":
        rk = rng.integers(0, 100, 200)
        return ([rk + 50_000, np.arange(200)], None, [rk, np.arange(200)], None,
                (0, 100), [0], [0], 1024)
    if case == "overflow":
        z = np.zeros(256, np.int64)
        return [z, np.arange(256)], None, [z.copy(), np.arange(256)], None, (0, 1), [0], [0], 100
    if case == "int32_keys":
        lk = rng.integers(-1000, 1000, 400).astype(np.int32)
        rk = rng.integers(-1000, 1000, 300).astype(np.int32)
        return ([np.arange(400), lk], 390, [rk, np.arange(300), np.arange(300) * 3], None,
                (-1000, 999), [1], [0], 2048)
    if case == "multi_key":  # tests/test_prepared.py:171-209
        lk1, lk2 = rng.integers(0, 40, 400), rng.integers(-3, 4, 400).astype(np.int32)
        rk1, rk2 = rng.integers(0, 40, 300), rng.integers(-3, 4, 300).astype(np.int32)
        return ([lk1, lk2, np.arange(400)], None, [rk1, rk2, np.arange(300) + 9000], None,
                ((0, 40), (-3, 3)), [0, 1], [0, 1], 16384)
    raise KeyError(case)


JOIN_CASES = ["oracle", "duplicate_heavy", "empty_left", "empty_right", "empty_both",
              "out_of_anchor_left", "overflow", "int32_keys", "multi_key"]


@pytest.fixture
def jax_tier(request, monkeypatch, tiny_pallas_geometry):
    """Configure dj_tpu's prepared join for one of its tiers; returns the
    merge_impl to pass to its inner_join_prepared."""
    name = request.param
    if name == "pallas-interpret":
        monkeypatch.setattr(PM, "TILE_M", 1024)
        monkeypatch.setattr(psc, "TILE", 256)
        monkeypatch.setenv("DJ_JOIN_SCANS", "pallas-interpret")
        tiny_pallas_geometry("pallas-vmeta-interpret")
        return "pallas-interpret"
    if name == "probe-pallas-interpret":
        tiny_pallas_geometry("pallas-interpret")
        return "probe"
    return name


@pytest.mark.parametrize(
    "jax_tier", ["xla", "pallas-interpret", "probe", "probe-pallas-interpret"], indirect=True
)
@pytest.mark.parametrize("case", JOIN_CASES)
def test_inner_join_prepared_matches(case, jax_tier):
    la, lv, ra, rv, kr, left_on, right_on, out_cap = _join_case(case)
    jl, tl = _pair(la, lv)
    jr, tr = _pair(ra, rv)
    S = jl.capacity + jr.capacity
    plan = jjoin.plan_prepared_pack(kr, [ra[c].dtype for c in right_on], S)
    jw, jpay, jok = jjoin.prepare_packed_batch(jr, right_on, plan)
    jres, jtot, jflags = jjoin.inner_join_prepared(jl, left_on, jw, jpay, plan, out_cap, 1.0, jax_tier)
    tplan = tjoin.PreparedPackPlan(*plan)
    tw, tpay, tok = tjoin.prepare_packed_batch(tr, right_on, tplan)
    assert bool(tok) == bool(jok)
    mismatch = bool(jflags["prepared_plan_mismatch"])
    assert mismatch == (case == "out_of_anchor_left")
    for tier in TIERS:
        tres, ttot, tflags = tjoin.inner_join_prepared(tl, left_on, tw, tpay, tplan, out_cap, tier)
        assert {k: bool(v) for k, v in tflags.items()} == {k: bool(v) for k, v in jflags.items()}, tier
        if mismatch:
            continue  # the output is unspecified
        assert int(ttot) == int(jtot) and ttot.dtype == torch.int64, tier
        assert int(tres.count()) == int(jres.count()), tier
        assert tres.capacity == jres.capacity == out_cap
        assert [c.dtype.name for c in tres.columns] == [c.dtype.name for c in jres.columns]
        if int(jtot) <= out_cap:
            k = int(jres.count())
            assert _rows(tres, k) == _rows(jres, k), tier
    if case == "overflow":
        assert int(jtot) == 256 * 256 and int(jres.count()) == out_cap
    if case.startswith("empty"):
        assert int(jtot) == 0


def test_probe_entry_is_the_probe_tier():
    la, lv, ra, rv, kr, left_on, right_on, out_cap = _join_case("oracle")
    _, tl = _pair(la, lv)
    _, tr = _pair(ra, rv)
    plan = tjoin.plan_prepared_pack(kr, [torch.int64], tl.capacity + tr.capacity)
    tw, tpay, _ = tjoin.prepare_packed_batch(tr, right_on, plan)
    a = tjoin.inner_join_probe(tl, left_on, tw, tpay, plan, out_cap)
    b = tjoin.inner_join_prepared(tl, left_on, tw, tpay, plan, out_cap, "probe")
    assert int(a[1]) == int(b[1]) > 0
    for x, y in zip(a[0].columns, b[0].columns):
        assert torch.equal(x.data, y.data)


def test_merge_impl_knob_and_geometry_checks(monkeypatch):
    la, lv, ra, rv, kr, left_on, right_on, out_cap = _join_case("oracle")
    _, tl = _pair(la, lv)
    _, tr = _pair(ra, rv)
    S = tl.capacity + tr.capacity
    plan = tjoin.plan_prepared_pack(kr, [torch.int64], S)
    tw, tpay, _ = tjoin.prepare_packed_batch(tr, right_on, plan)
    assert tjoin.resolve_merge_impl() == "sort"
    totals = set()
    for tier in TIERS:
        monkeypatch.setenv("DJT_JOIN_MERGE", tier)
        assert tjoin.resolve_merge_impl() == tier
        totals.add(int(tjoin.inner_join_prepared(tl, left_on, tw, tpay, plan, out_cap)[1]))
    assert len(totals) == 1
    monkeypatch.setenv("DJT_JOIN_MERGE", "pallas")
    with pytest.raises(ValueError, match="DJT_JOIN_MERGE"):
        tjoin.resolve_merge_impl()
    # A plan built for another merged size has another tag width.
    other = tjoin.plan_prepared_pack(kr, [torch.int64], 4 * S)
    with pytest.raises(ValueError, match="tag_bits"):
        tjoin.inner_join_prepared(tl, left_on, tw, tpay, other, out_cap, "sort")
    assert tjoin.prepared_effective_plan("merge") == ("merge_sorted_u64", "join_scans", "expand_values")
    assert tjoin.prepared_effective_plan("probe") == ("expand_ranks",)

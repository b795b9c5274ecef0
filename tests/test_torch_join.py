"""dj_tpu_torch inner_join vs dj_tpu.inner_join on the same tables.

Tables are made with numpy from a seed and handed to both packages.
Compared: the multiset of valid output rows, the int64 total, the valid
count and the flags — once with dj_tpu's CPU defaults (XLA scans, hist
expansion) and once with its Pallas kernels in interpret mode at a
shrunk geometry (the kernels the port's CUDA kernels replace).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core.table import Column as JColumn, Table as JTable
from dj_tpu.core import table as jT
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.ops import pallas_scan as psc
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.ops import join as tjoin


def _tables(lk, rk, l_valid, r_valid, l_cap=None, r_cap=None, pay="int64"):
    """(jax left, jax right, torch left, torch right): key + one payload
    (left) / key + two payloads (right) of dtype ``pay``, padded to
    capacity. Unsigned payloads have their top bit set, where the bits
    of a signed and an unsigned view differ."""
    top = 2 ** (np.iinfo(pay).bits - 1) if np.dtype(pay).kind == "u" else 0
    out = []
    for keys, valid, cap, npay, base in (
        (lk, l_valid, l_cap, 1, 0), (rk, r_valid, r_cap, 2, 10_000),
    ):
        cap = len(keys) if cap is None else cap
        kd = np.zeros(cap, keys.dtype)
        kd[: len(keys)] = keys
        arrays = [kd] + [
            (np.arange(cap) + base + 100_000 * p).astype(pay) + np.array(top, pay)
            for p in range(npay)
        ]
        names = [kd.dtype.name] + [pay] * npay
        jt = JTable(
            tuple(JColumn(jnp.asarray(a), dj_tpu.dtypes.by_name(n)) for a, n in zip(arrays, names)),
            jnp.int32(valid),
        )
        out.append((jt, convert.table_from_numpy(arrays, names, valid, device="cpu")))
    (jl, tl), (jr, tr) = out
    return jl, jr, tl, tr


def _rows(table, count):
    return sorted(zip(*[np.asarray(c.data)[:count].tolist() for c in table.columns]))


def _compare(jl, jr, tl, tr, out_capacity, key_range=None):
    jt, jtot, jflags = dj_tpu.inner_join(
        jl, jr, [0], [0], out_capacity=out_capacity, return_flags=True, key_range=key_range
    )
    tt, ttot, tflags = tjoin.inner_join(
        tl, tr, [0], [0], out_capacity=out_capacity, return_flags=True, key_range=key_range
    )
    assert int(ttot) == int(jtot)
    assert ttot.dtype == torch.int64
    assert int(tt.count()) == int(jt.count())
    assert tt.capacity == jt.capacity and tt.num_columns == jt.num_columns
    assert [c.dtype.name for c in tt.columns] == [c.dtype.name for c in jt.columns]
    assert {k: bool(v) for k, v in tflags.items()} == {k: bool(v) for k, v in jflags.items()}
    if int(jtot) <= out_capacity:
        k = int(jt.count())
        assert _rows(tt, k) == _rows(jt, k)
    return int(ttot), {k: bool(v) for k, v in tflags.items()}


def _case(name, rng):
    if name == "dups_int64":
        return rng.integers(0, 40, 300), rng.integers(0, 40, 350), 280, 340, None, None, 8192
    if name == "negative_int64":
        return (rng.integers(-(2**40), -(2**40) + 60, 300),
                rng.integers(-(2**40), -(2**40) + 60, 250), 300, 250, None, None, 4096)
    if name == "int32_keys":
        return (rng.integers(-1000, 1000, 400).astype(np.int32),
                rng.integers(-1000, 1000, 300).astype(np.int32), 390, 300, 512, 384, 2048)
    if name == "empty_left":
        return rng.integers(0, 9, 50), rng.integers(0, 9, 60), 0, 60, None, None, 128
    if name == "empty_right_capacity":
        return rng.integers(0, 9, 50), np.zeros(0, np.int64), 50, 0, None, None, 64
    if name == "overflow":
        return rng.integers(0, 5, 200), rng.integers(0, 5, 200), 200, 200, None, None, 100
    if name == "uint16_keys":  # keys past the int16 range
        return (rng.integers(65_000, 65_536, 300).astype(np.uint16),
                rng.integers(65_000, 65_536, 250).astype(np.uint16), 290, 250, 320, None, 2048)
    if name == "uint32_keys":  # keys past the int32 range
        return (rng.integers(2**32 - 500, 2**32, 300).astype(np.uint32),
                rng.integers(2**32 - 500, 2**32, 280).astype(np.uint32), 300, 270, None, 300, 1024)
    if name == "uint64_payload":
        return rng.integers(0, 60, 300), rng.integers(0, 60, 280), 300, 280, None, None, 4096
    raise KeyError(name)


# Each case's payload dtype, where it is not int64.
PAYLOADS = {"uint32_keys": "uint32", "uint64_payload": "uint64"}

CASES = ["dups_int64", "negative_int64", "int32_keys", "empty_left", "empty_right_capacity", "overflow",
         "uint16_keys", "uint32_keys", "uint64_payload"]


@pytest.mark.parametrize("case", CASES)
def test_inner_join_matches_cpu_defaults(case):
    lk, rk, lv, rv, lcap, rcap, out_cap = _case(case, np.random.default_rng(len(case)))
    total, _ = _compare(*_tables(lk, rk, lv, rv, lcap, rcap, PAYLOADS.get(case, "int64")), out_cap)
    if case == "overflow":
        assert total > out_cap
    if case.startswith("empty"):
        assert total == 0


@pytest.mark.parametrize("case", CASES)
def test_inner_join_matches_pallas_interpret(case, tiny_pallas_geometry, monkeypatch):
    tiny_pallas_geometry("pallas-vmeta-interpret")
    monkeypatch.setenv("DJ_JOIN_SCANS", "pallas-interpret")
    monkeypatch.setattr(psc, "TILE", 256)
    lk, rk, lv, rv, lcap, rcap, out_cap = _case(case, np.random.default_rng(len(case)))
    _compare(*_tables(lk, rk, lv, rv, lcap, rcap, PAYLOADS.get(case, "int64")), out_cap)


def test_declared_range_and_pack_overflow_flag():
    """A declared key_range makes the pack decision static; data whose
    span overflows the packed word raises pack_range_overflow in both."""
    rng = np.random.default_rng(5)
    lk, rk = rng.integers(0, 100, 64), rng.integers(0, 100, 64)
    _, flags = _compare(*_tables(lk, rk, 64, 64), 512, key_range=(0, 99))
    assert not flags["pack_range_overflow"]
    wide_l = np.array([-(2**63), 2**63 - 1] * 4, np.int64)
    _, flags = _compare(*_tables(wide_l, wide_l.copy(), 8, 8), 64, key_range=(0, 99))
    assert flags["pack_range_overflow"]


def test_column_order_contract():
    """Result = all left columns (key included), then the right columns
    without right_on — here the right key is column 1."""
    l = convert.table_from_numpy([np.array([1, 2, 3]), np.array([10, 20, 30])], ["int64"] * 2, device="cpu")
    r = convert.table_from_numpy(
        [np.array([7, 8]), np.array([3, 1]), np.array([70, 80])], ["int64"] * 3, device="cpu"
    )
    t, total = tjoin.inner_join(l, r, [0], [1])
    assert int(total) == 2 and t.num_columns == 4
    assert _rows(t, 2) == [(1, 10, 8, 80), (3, 30, 7, 70)]


def test_unsupported_inputs_raise_not_implemented():
    """A string column converts and joins, and the prepared side takes it
    as a payload on every tier: a forced broadcast tier serves dj_tpu's
    broadcast side's rows, strings byte for byte."""
    offsets, chars = np.array([0, 1, 1, 3], np.int32), np.frombuffer(b"abc", np.uint8)
    t = convert.table_from_numpy([np.array([1, 2, 3]), (offsets, chars)], ["int64", "string"],
                                 device="cpu")
    assert tj.to_strings(t.columns[1]) == [b"a", b"", b"bc"]
    out, total = tjoin.inner_join(t, t, [0], [0])
    assert int(total) == 3 and tj.to_strings(out.columns[1], 3) == [b"a", b"", b"bc"]
    topo = tj.make_topology(["cpu"])
    prep = tj.prepare_join_side(topo, *tj.shard_table(topo, t), [0])
    out, counts, _ = tj.distributed_inner_join(topo, *tj.shard_table(topo, t), prep, None, [0],
                                               None)
    assert int(counts[0]) == 3 and tj.to_strings(out.columns[2], 3) == [b"a", b"", b"bc"]
    bprep = tj.prepare_join_side(topo, *tj.shard_table(topo, t), [0], tier="broadcast")
    jtopo = jmake_topology(jax.devices()[:1])
    jt = JTable((JColumn(jnp.asarray(np.array([1, 2, 3])), dj_tpu.dtypes.int64),
                 jT.StringColumn(jnp.asarray(offsets), jnp.asarray(chars))))
    jprep = jdist.prepare_join_side(jtopo, *jshard(jtopo, jt), [0], tier="broadcast")
    assert bprep.tier == jprep.tier == "broadcast" and tuple(bprep.plan) == tuple(jprep.plan)
    out, counts, _ = tj.distributed_inner_join(topo, *tj.shard_table(topo, t), bprep, None, [0],
                                               None)
    jout, jcounts, _ = dj_tpu.distributed_inner_join(jtopo, *jshard(jtopo, jt), jprep, None, [0],
                                                     None)
    assert int(counts[0]) == int(jcounts[0]) == 3
    got = sorted(zip(out.columns[0].data[:3].tolist(), tj.to_strings(out.columns[2], 3)))
    want = sorted(zip(np.asarray(jout.columns[0].data)[:3].tolist(),
                      jT.to_strings(jout.columns[2], 3)))
    assert got == want == [(1, b"a"), (2, b""), (3, b"bc")]


def _limit_case(name):
    """(left tables, right tables, left_on, right_on, out_capacity,
    inner_join keywords) of an input the port refused before it took
    every fixed-width key."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 9, 20)
    wide = np.array([-(2**63), 2**63 - 1, 0, 7], np.int64)
    if name == "multi_key":
        sides = []
        for keys in (a, a[::-1].copy()):
            arrays = [keys, (keys % 3).astype(np.int32), np.arange(20)]
            names = ["int64", "int32", "int64"]
            sides.append((JTable(tuple(JColumn(jnp.asarray(x), dj_tpu.dtypes.by_name(n))
                                       for x, n in zip(arrays, names)), jnp.int32(18)),
                          convert.table_from_numpy(arrays, names, 18, device="cpu")))
        (jl, tl), (jr, tr) = sides
        return (jl, jr, tl, tr), [0, 1], [0, 1], 512, {}
    if name == "carry":
        return _tables(a, a.copy(), 20, 20), [0], [0], 512, {"carry_payloads": True}
    if name == "float":
        f = a.astype(np.float64) - 4.0
        f[::3] = np.nan
        f[1::5] = -0.0
        return _tables(f, f[::-1].copy(), 20, 20), [0], [0], 512, {}
    if name == "wide_range":
        return _tables(wide, wide[::-1].copy(), 4, 4), [0], [0], 64, {}
    raise KeyError(name)


@pytest.mark.parametrize("name", ["multi_key", "carry", "float", "wide_range"])
def test_former_limits_match_dj_tpu(name):
    """Multi-column keys, carry_payloads, float keys and a 64-bit key whose
    observed span overflows the packed word now join as in dj_tpu: the
    same row multiset, total, valid count and flags."""
    (jl, jr, tl, tr), lon, ron, cap, kw = _limit_case(name)
    jt, jtot, jflags = dj_tpu.inner_join(jl, jr, lon, ron, out_capacity=cap, return_flags=True, **kw)
    tt, ttot, tflags = tjoin.inner_join(tl, tr, lon, ron, out_capacity=cap, return_flags=True, **kw)
    assert int(ttot) == int(jtot) > 0 and int(tt.count()) == int(jt.count())
    assert {k: bool(v) for k, v in tflags.items()} == {k: bool(v) for k, v in jflags.items()}
    k = int(jt.count())
    assert repr(_rows(tt, k)) == repr(_rows(jt, k))


def test_argument_errors_match_dj_tpu():
    t = convert.table_from_numpy([np.arange(4)], ["int64"], device="cpu")
    with pytest.raises(ValueError):
        tjoin.inner_join(t, t, [0], [0, 0])
    with pytest.raises(IndexError):
        tjoin.inner_join(t, t, [1], [0])
    with pytest.raises(ValueError, match="out_capacity"):
        tjoin.inner_join(t, t, [0], [0], out_capacity=2**31)


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64, np.uint16, np.uint32])
def test_unsigned_order_roundtrip(dtype):
    info = np.iinfo(dtype)
    x = np.unique(np.array([info.min, info.min + 1, 0, info.max - 1, info.max], dtype))
    u = tjoin._to_unsigned_order(torch.from_numpy(x))
    s = u ^ tjoin.INT64_MIN  # signed order of s == unsigned order of u
    assert (s[1:] > s[:-1]).all()
    back = tjoin._from_unsigned_order(u, torch.from_numpy(x).dtype)
    np.testing.assert_array_equal(back.numpy(), x)


def test_plan_key_pack_matches_dj_tpu():
    from dj_tpu.ops.join import plan_key_pack as jplan

    for kr, S in [(((0, 99),), 1000), (((-(2**62), 2**62),), 2**20), (((0, 2**43),), 2**20)]:
        want = jplan(kr, [np.dtype(np.int64)], S)
        assert tuple(tjoin.plan_key_pack(kr, [np.dtype(np.int64)], S)) == tuple(want)

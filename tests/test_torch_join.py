"""dj_tpu_torch inner_join vs dj_tpu.inner_join on the same tables.

Tables are made with numpy from a seed and handed to both packages.
Compared: the multiset of valid output rows, the int64 total, the valid
count and the flags — once with dj_tpu's CPU defaults (XLA scans, hist
expansion) and once with its Pallas kernels in interpret mode at a
shrunk geometry (the kernels the port's CUDA kernels replace).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core.table import Column as JColumn, Table as JTable
from dj_tpu.ops import pallas_scan as psc
from dj_tpu_torch import convert
from dj_tpu_torch.ops import join as tjoin


def _tables(lk, rk, l_valid, r_valid, l_cap=None, r_cap=None):
    """(jax left, jax right, torch left, torch right): key + int64
    payload (left) / key + two payloads (right), padded to capacity."""
    out = []
    for keys, valid, cap, npay, base in (
        (lk, l_valid, l_cap, 1, 0), (rk, r_valid, r_cap, 2, 10_000),
    ):
        cap = len(keys) if cap is None else cap
        kd = np.zeros(cap, keys.dtype)
        kd[: len(keys)] = keys
        arrays = [kd] + [
            np.arange(cap, dtype=np.int64) + base + 100_000 * p for p in range(npay)
        ]
        names = [kd.dtype.name] + ["int64"] * npay
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
    raise KeyError(name)


CASES = ["dups_int64", "negative_int64", "int32_keys", "empty_left", "empty_right_capacity", "overflow"]


@pytest.mark.parametrize("case", CASES)
def test_inner_join_matches_cpu_defaults(case):
    lk, rk, lv, rv, lcap, rcap, out_cap = _case(case, np.random.default_rng(len(case)))
    total, _ = _compare(*_tables(lk, rk, lv, rv, lcap, rcap), out_cap)
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
    _compare(*_tables(lk, rk, lv, rv, lcap, rcap), out_cap)


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
    rng = np.random.default_rng(1)
    a = rng.integers(0, 9, 20)
    t = convert.table_from_numpy([a, a], ["int64", "int64"], device="cpu")
    with pytest.raises(NotImplementedError, match="multi-key"):
        tjoin.inner_join(t, t, [0, 1], [0, 1])
    with pytest.raises(NotImplementedError, match="carry"):
        tjoin.inner_join(t, t, [0], [0], carry_payloads=True)
    f = convert.table_from_numpy([a.astype(np.float64)], ["float64"], device="cpu")
    with pytest.raises(NotImplementedError, match="unpacked sort"):
        tjoin.inner_join(f, f, [0], [0])
    with pytest.raises(NotImplementedError, match="string"):
        convert.table_from_numpy([np.zeros(3, np.uint8)], ["string"], device="cpu")
    wide = convert.table_from_numpy([np.array([-(2**63), 2**63 - 1])], ["int64"], device="cpu")
    with pytest.raises(NotImplementedError, match="observed range"):
        tjoin.inner_join(wide, wide, [0], [0])


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

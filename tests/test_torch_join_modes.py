"""dj_tpu_torch inner_join under each DJT_JOIN_EXPAND mode vs dj_tpu's
inner_join under the matching DJ_JOIN_EXPAND, on the same tables.

dj_tpu runs its Pallas kernels (join_scans and the mode's expansion) in
interpret mode at a shrunk geometry; the port runs the plain versions of
its kernels on CPU tensors. Compared: the multiset of valid rows, the
int64 total, the valid count, the column dtypes and the flags; and every
column of the port's output reads 0 past the valid count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dj_tpu
from dj_tpu.core.table import Column as JColumn, Table as JTable
from dj_tpu.ops import pallas_scan as psc
from dj_tpu_torch import convert
from dj_tpu_torch.ops import join as tjoin

# The port's mode names and dj_tpu's.
MODES = {
    "vmeta": "pallas-vmeta", "ranks": "pallas", "fused": "pallas-fused",
    "join": "pallas-join", "vcarry": "pallas-vcarry", "vfull": "pallas-vfull",
}


@pytest.fixture
def mode_env(tiny_pallas_geometry, monkeypatch):
    """Sets both packages' expansion knobs for one port mode; returns
    the names of the port's expansion functions that inner_join called."""
    monkeypatch.setattr(psc, "TILE", 256)
    monkeypatch.setenv("DJ_JOIN_SCANS", "pallas-interpret")
    called = []
    for name in set(tjoin.EXPAND_KERNELS.values()):
        fn = getattr(tjoin, name)
        monkeypatch.setattr(
            tjoin, name, lambda *a, _fn=fn, _name=name: called.append(_name) or _fn(*a)
        )

    def apply(mode):
        tiny_pallas_geometry(MODES[mode] + "-interpret")
        monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
        return called

    return apply


def _side(arrays, names, valid, cap):
    """(dj_tpu table, port table) of ``arrays`` padded with zeros to
    ``cap`` rows, ``valid`` of them valid."""
    padded = []
    for a in arrays:
        p = np.zeros(cap, np.asarray(a).dtype)
        p[: len(a)] = a
        padded.append(p)
    jt = JTable(
        tuple(JColumn(jnp.asarray(a), dj_tpu.dtypes.by_name(n)) for a, n in zip(padded, names)),
        jnp.int32(valid),
    )
    return jt, convert.table_from_numpy(padded, names, valid, device="cpu")


def _rows(table, count):
    return sorted(zip(*[np.asarray(c.data)[:count].tolist() for c in table.columns]))


def _payloads(rng, n, names):
    out = []
    for name in names:
        if name == "int32":
            a = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
            a[::5] = -1
        elif name == "float64":
            a = rng.standard_normal(n)
        elif name.startswith("uint"):
            # Full range: the top bit, where the signed view differs, is set in half.
            a = rng.integers(0, np.iinfo(name).max, n, dtype=name, endpoint=True)
            a[::5] = np.iinfo(name).max
        else:
            a = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True)
            a[::5] = -(2**40)
        out.append(a)
    return out


def _case(name):
    """(left arrays, names, valid, cap), (right ...), right key index,
    out_capacity."""
    rng = np.random.default_rng(len(name))
    if name == "dups_int64":
        lk, rk = rng.integers(0, 40, 300), rng.integers(0, 40, 350)
        lp, rp = ["int64"], ["int64", "int32"]
        lv, rv, out_cap = 280, 340, 8192
    elif name == "negative_int64":
        lk = rng.integers(-(2**40), -(2**40) + 60, 300)
        rk = rng.integers(-(2**40), -(2**40) + 60, 250)
        lp, rp = ["int64", "float64"], ["int32"]
        lv, rv, out_cap = 300, 250, 4096
    elif name == "int32_keys":
        lk = rng.integers(-1000, 1000, 400).astype(np.int32)
        rk = rng.integers(-1000, 1000, 300).astype(np.int32)
        lp, rp = ["int32", "int64", "int64"], ["int64"]
        lv, rv, out_cap = 390, 300, 2048
    elif name == "three_payloads_each":
        lk, rk = rng.integers(-50, 50, 500), rng.integers(-50, 50, 400)
        lp, rp = ["int64", "int32", "int64"], ["int32", "int64", "float64"]
        lv, rv, out_cap = 500, 400, 4096
    elif name == "key_only_left":
        lk, rk = rng.integers(0, 30, 200), rng.integers(0, 30, 200)
        lp, rp = [], ["int64", "int64"]
        lv, rv, out_cap = 200, 200, 2048
    elif name == "empty_left":
        lk, rk = rng.integers(0, 9, 50), rng.integers(0, 9, 60)
        lp, rp = ["int64"], ["int64"]
        lv, rv, out_cap = 0, 60, 128
    elif name == "duplicate_heavy":
        lk, rk = rng.integers(0, 3, 200), rng.integers(0, 3, 300)
        lp, rp = ["int64"], ["int64"]
        lv, rv, out_cap = 200, 300, 24_000
    elif name == "overflow":
        lk, rk = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
        lp, rp = ["int64"], ["int64"]
        lv, rv, out_cap = 200, 200, 100
    elif name == "uint16_keys":  # keys past the int16 range, unsigned payloads
        lk = rng.integers(65_000, 65_536, 300).astype(np.uint16)
        rk = rng.integers(65_000, 65_536, 260).astype(np.uint16)
        lp, rp = ["uint64", "uint16"], ["uint32"]
        lv, rv, out_cap = 290, 260, 2048
    elif name == "uint32_keys":  # keys past the int32 range, unsigned payloads
        lk = rng.integers(2**32 - 400, 2**32, 300).astype(np.uint32)
        rk = rng.integers(2**32 - 400, 2**32, 250).astype(np.uint32)
        lp, rp = ["uint32"], ["uint64", "uint16", "int64"]
        lv, rv, out_cap = 300, 240, 2048
    elif name == "four_payloads_degrade":
        lk, rk = rng.integers(0, 60, 300), rng.integers(0, 60, 300)
        lp, rp = ["int64"] * 4, ["int32"]
        lv, rv, out_cap = 300, 300, 4096
    else:
        raise KeyError(name)
    kname = np.asarray(lk).dtype.name
    left = ([lk] + _payloads(rng, len(lk), lp), [kname] + lp, lv, len(lk) + 7)
    # The right key sits at column 1, between payloads.
    rpay = _payloads(rng, len(rk), rp)
    rarr = rpay[:1] + [rk] + rpay[1:]
    rnames = rp[:1] + [kname] + rp[1:]
    r_on = 1 if rp else 0
    right = (rarr, rnames, rv, len(rk) + 3)
    return left, right, r_on, out_cap


CASES = ["dups_int64", "negative_int64", "int32_keys", "three_payloads_each", "key_only_left",
         "empty_left", "duplicate_heavy", "overflow", "four_payloads_degrade", "uint16_keys",
         "uint32_keys"]


def _compare(left, right, r_on, out_cap, key_range=None):
    jl, tl = _side(*left)
    jr, tr = _side(*right)
    jt, jtot, jflags = dj_tpu.inner_join(
        jl, jr, [0], [r_on], out_capacity=out_cap, return_flags=True, key_range=key_range
    )
    tt, ttot, tflags = tjoin.inner_join(
        tl, tr, [0], [r_on], out_capacity=out_cap, return_flags=True, key_range=key_range
    )
    assert int(ttot) == int(jtot) and ttot.dtype == torch.int64
    assert int(tt.count()) == int(jt.count())
    assert tt.capacity == jt.capacity == out_cap
    assert [c.dtype.name for c in tt.columns] == [c.dtype.name for c in jt.columns]
    assert [c.data.dtype for c in tt.columns] == [
        getattr(torch, np.dtype(c.data.dtype).name) for c in jt.columns
    ]
    flags = {k: bool(v) for k, v in tflags.items()}
    assert flags == {k: bool(v) for k, v in jflags.items()}
    k = int(tt.count())
    if int(jtot) <= out_cap:
        assert _rows(tt, k) == _rows(jt, k)
        for c in tt.columns:
            assert not c.data[k:].to(torch.float64).any(), "slots past the count must read 0"
    return int(ttot), flags


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_inner_join_mode_matches_dj_tpu(mode, case, mode_env):
    called = mode_env(mode)
    left, right, r_on, out_cap = _case(case)
    total, _ = _compare(left, right, r_on, out_cap)
    ran = "vmeta" if case == "four_payloads_degrade" and mode in ("vcarry", "vfull") else mode
    assert called == [tjoin.EXPAND_KERNELS[ran]]
    if case == "overflow":
        assert total > out_cap
    if case == "empty_left":
        assert total == 0


@pytest.mark.parametrize("mode", ["vmeta", "join", "vcarry", "vfull"])
def test_declared_range_lie_flags_pack_overflow(mode, mode_env):
    """A declared key_range that lies about the span overflows the packed
    word: both packages raise pack_range_overflow; a true one does not."""
    mode_env(mode)
    rng = np.random.default_rng(5)
    lk, rk = rng.integers(0, 100, 64), rng.integers(0, 100, 64)
    pay = np.arange(64, dtype=np.int64)
    _, flags = _compare(([lk, pay], ["int64"] * 2, 64, 64), ([rk, pay], ["int64"] * 2, 64, 64),
                        0, 512, key_range=(0, 99))
    assert not flags["pack_range_overflow"]
    wide = np.array([-(2**63), 2**63 - 1] * 4, np.int64)
    _, flags = _compare(([wide, pay[:8]], ["int64"] * 2, 8, 8),
                        ([wide.copy(), pay[:8]], ["int64"] * 2, 8, 8), 0, 64, key_range=(0, 99))
    assert flags["pack_range_overflow"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resolver_degrade_rules(mode, monkeypatch):
    """dj_tpu's gate: vcarry and vfull run vmeta past three payload
    slots; every other mode runs whatever the payload count."""
    monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
    for n_payload in (0, 1, 3):
        assert tjoin.effective_plan(n_payload).expand == mode
    assert tjoin.effective_plan(4).expand == ("vmeta" if mode in ("vcarry", "vfull") else mode)


def test_resolver_reads_the_knob(monkeypatch):
    monkeypatch.delenv("DJT_JOIN_EXPAND", raising=False)
    assert tjoin.resolve_expand_impl() == "vmeta"
    monkeypatch.setenv("DJT_JOIN_EXPAND", "hist")
    assert tjoin.resolve_expand_impl() == "hist"
    for bad in ("pallas", "pallas-vfull", ""):
        monkeypatch.setenv("DJT_JOIN_EXPAND", bad)
        with pytest.raises(ValueError, match="DJT_JOIN_EXPAND"):
            tjoin.effective_plan(1)


@pytest.mark.parametrize("mode", ["vcarry", "vfull"])
@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32"])
def test_carry_modes_recover_every_key(mode, dtype, monkeypatch):
    """The key is recovered from the sorted word (a logical shift, plus
    kmin for 64-bit keys): each dtype's extremes come back exactly."""
    monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
    info = np.iinfo(dtype)
    if info.bits == 64:
        # A 64-bit key packs relative to its minimum: a span that fits.
        keys = np.array([-(2**40), -(2**40) + 1, -1, 0, 5, 2**20], dtype)
    else:
        keys = np.unique(np.array([info.min, info.min + 1, 0, 1, info.max - 1, info.max], dtype))
    pay = np.arange(len(keys), dtype=np.int64)
    lt = convert.table_from_numpy([keys, pay], [dtype, "int64"], device="cpu")
    rt = convert.table_from_numpy([keys[::-1].copy(), pay * 10], [dtype, "int64"], device="cpu")
    t, total = tjoin.inner_join(lt, rt, [0], [0], out_capacity=len(keys) + 2)
    assert int(total) == len(keys)
    assert t.columns[0].data.dtype == lt.columns[0].data.dtype
    got = _rows(t, len(keys))
    want = sorted((int(k), int(p), int(10 * (len(keys) - 1 - p))) for k, p in zip(keys, pay))
    assert got == want
    assert (t.columns[0].data[len(keys):] == 0).all()


@pytest.mark.parametrize("n,hi", [(1, 1), (2, 3), (1000, 50), (5000, 1), (100_000, 10**6)])
def test_run_offsets_match_dj_tpu_cummax(n, hi):
    """The ranks and fused modes' within-run offset equals dj_tpu's
    ``j - cummax(where(run_starts(src), j, -1))`` (join.py:1660-1665)."""
    import jax

    from dj_tpu.ops.join import _run_starts

    src = np.sort(np.random.default_rng(n + hi).integers(0, hi, n)).astype(np.int32)
    j = jnp.arange(n, dtype=jnp.int32)
    want = j - jax.lax.cummax(jnp.where(_run_starts(jnp.asarray(src)), j, -1))
    got = tjoin._run_offsets(torch.from_numpy(src))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

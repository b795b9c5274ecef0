"""dj_tpu_torch inner_join on every fixed-width key kind vs dj_tpu's.

The same numpy tables (seeded, padded past their valid counts) go through
``dj_tpu.inner_join`` with its Pallas kernels in interpret mode (join_scans
and the vmeta expansion at a shrunk geometry, as
``tests/test_torch_join_modes.py`` runs them) and through the port under
each ``DJT_JOIN_EXPAND`` mode: uint64 keys with the top bit set, mixed
key dtypes, float keys with -0.0, NaN and +-inf, 2- and 3-column keys
packed through a declared range and unpacked, at the dtype extremes, a
64-bit key whose span overflows the word (observed, and declared too
narrow), and carry_payloads. Compared: the row multiset (unless
pack_range_overflow leaves the rows unspecified), the int64 total, the
valid count and the flags. dj_tpu's rows do not depend on its
expansion mode, so one dj_tpu join per key kind is the reference of
every mode; the plan each mode runs is held to dj_tpu's
``effective_plan`` on its own.

dj_tpu cannot join a uint64 key here: its padding fill
``jnp.iinfo(uint64).max`` overflows JAX's int64 argument parse
(OverflowError, JAX 0.9). A uint64 kind is therefore held to dj_tpu's
int64 join of the same keys less 2^63 (an order-preserving bijection),
with the key column mapped back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core.table import Column as JColumn, Table as JTable
from dj_tpu.ops import join as jjoin
from dj_tpu.ops import pallas_scan as psc
from dj_tpu_torch import convert
from dj_tpu_torch.ops import join as tjoin
from dj_tpu_torch.ops.scan import join_scans_plain

MODES = ("vmeta", "ranks", "hist", "fused", "join", "vcarry", "vfull")
DJ_MODES = {"vmeta": "pallas-vmeta", "ranks": "pallas", "hist": "hist", "fused": "pallas-fused",
            "join": "pallas-join", "vcarry": "pallas-vcarry", "vfull": "pallas-vfull"}
I64 = np.iinfo(np.int64)


def _pad(a, cap):
    p = np.zeros(cap, np.asarray(a).dtype)
    p[: len(a)] = a
    return p


def _side(arrays, names, valid, cap):
    """(dj_tpu table, port table) of ``arrays`` padded to ``cap`` rows."""
    padded = [_pad(a, cap) for a in arrays]
    jt = JTable(
        tuple(JColumn(jnp.asarray(a), dj_tpu.dtypes.by_name(n)) for a, n in zip(padded, names)),
        jnp.int32(valid),
    )
    return jt, convert.table_from_numpy(padded, names, valid, device="cpu")


def _cell(x):
    return "nan" if isinstance(x, float) and x != x else x


def _rows(table, count):
    """Sorted valid rows; NaN cells compare as a marker, -0.0 keeps its
    sign (repr)."""
    rows = zip(*[np.asarray(c.data)[:count].tolist() for c in table.columns])
    return sorted((tuple(_cell(x) for x in r) for r in rows), key=repr)


def _payloads(rng, n, names):
    out = []
    for name in names:
        if name == "float64":
            out.append(rng.standard_normal(n))
        elif name == "uint64":
            a = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
            a[::4] = 2**63 + 5
            out.append(a)
        elif name == "int32":
            out.append(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32))
        else:
            out.append(rng.integers(I64.min, I64.max, n, dtype=np.int64))
    return out


def _with_extremes(rng, dtype, n, lo=None, hi=None):
    """n keys of ``dtype`` drawn from a small set that holds the dtype's
    extremes (or [lo, hi]), so that runs repeat."""
    info = np.iinfo(dtype)
    lo = info.min if lo is None else lo
    hi = info.max if hi is None else hi
    pool = np.array(sorted({lo, lo + 1, (lo + hi) // 2, hi - 1, hi}), dtype=dtype)
    return pool[rng.integers(0, len(pool), n)]


def _kind(name):
    """(left (arrays, names, valid, cap), right (...), left_on, right_on,
    out_capacity, inner_join keywords)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    kw = {}
    if name.startswith("uint64"):
        if name == "uint64_top_bit":  # a span that packs
            lk = np.uint64(2**63 - 20) + rng.integers(0, 40, 300).astype(np.uint64)
            rk = np.uint64(2**63 - 20) + rng.integers(0, 40, 260).astype(np.uint64)
        elif name == "uint64_declared":
            lk = np.uint64(2**63) + rng.integers(0, 30, 300).astype(np.uint64)
            rk = np.uint64(2**63) + rng.integers(0, 30, 260).astype(np.uint64)
            kw["key_range"] = (2**63, 2**63 + 29)
        else:  # the full range: the observed span does not pack
            pool = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1], np.uint64)
            lk, rk = pool[rng.integers(0, 6, 300)], pool[rng.integers(0, 6, 260)]
        left = ([lk] + _payloads(rng, 300, ["int64"]), ["uint64", "int64"], 290, 310)
        right = ([rk] + _payloads(rng, 260, ["uint64", "int32"]), ["uint64", "uint64", "int32"],
                 250, 264)
        return left, right, [0], [0], 8192, kw
    if name.startswith("mixed_"):
        _, ld, rd = name.split("_")
        lk = _with_extremes(rng, ld, 300)
        # Right keys: the left's values (some of them) plus values outside
        # the left dtype's range.
        rk = np.concatenate([lk[:150].astype(rd), _with_extremes(rng, rd, 110)])
        left = ([lk] + _payloads(rng, 300, ["int64"]), [ld, "int64"], 295, 300)
        right = ([rk] + _payloads(rng, 260, ["float64"]), [rd, "float64"], 255, 262)
        return left, right, [0], [0], 16_384, kw
    if name.startswith("float"):
        d = name.removeprefix("floats_")
        tiny = np.finfo(d).smallest_subnormal
        pool = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25, 3e30, tiny, -tiny], d)
        lk, rk = pool[rng.integers(0, 10, 300)], pool[rng.integers(0, 10, 250)]
        left = ([lk] + _payloads(rng, 300, ["int64"]), [d, "int64"], 290, 305)
        right = ([rk] + _payloads(rng, 250, ["int32"]), [d, "int32"], 245, 250)
        return left, right, [0], [0], 16_384, kw
    if name.startswith(("two_keys", "three_keys")):
        dts = ["int8", "uint16", "int32"]
        if name.startswith("three"):
            # The three fields take 8 + 16 + 12 bits beside 10 tag bits.
            spans = [(-128, 127), (0, 65535), (-2048, 2047)]
        else:
            dts = ["int64", "uint32"]
            spans = [(I64.min, I64.min + 1000), (0, 2**32 - 1)]
        if name.endswith("unpacked"):
            spans = [(None, None)] * len(dts)
        lcols = [_with_extremes(rng, d, 300, lo, hi) for d, (lo, hi) in zip(dts, spans)]
        rcols = [np.concatenate([c[:120], _with_extremes(rng, d, 100, lo, hi)])
                 for c, d, (lo, hi) in zip(lcols, dts, spans)]
        if name.endswith("packed") and not name.endswith("unpacked"):
            kw["key_range"] = tuple(spans)
        n_keys = len(dts)
        left = (lcols + _payloads(rng, 300, ["int64"]), dts + ["int64"], 280, 300)
        # The right keys in reverse order behind a payload.
        right = (_payloads(rng, 220, ["int32"]) + rcols[::-1], ["int32"] + dts[::-1], 210, 230)
        return left, right, list(range(n_keys)), list(range(n_keys, 0, -1)), 16_384, kw
    if name.startswith("wide"):
        keys = np.array([I64.min, I64.max, 0, -1, 7, 7], np.int64)
        lk, rk = keys[rng.integers(0, 6, 200)], keys[rng.integers(0, 6, 180)]
        if name == "wide_declared_too_narrow":
            kw["key_range"] = (0, 99)
        left = ([lk] + _payloads(rng, 200, ["int64"]), ["int64", "int64"], 190, 200)
        right = ([rk] + _payloads(rng, 180, ["int64"]), ["int64", "int64"], 180, 181)
        return left, right, [0], [0], 16_384, kw
    if name.startswith("carry"):
        kw["carry_payloads"] = True
        kd = "int32" if name == "carry_int32" else "int64"
        lk = rng.integers(-40, 40, 300).astype(kd)
        rk = rng.integers(-40, 40, 250).astype(kd)
        left = ([lk] + _payloads(rng, 300, ["float64", "uint64"]), [kd, "float64", "uint64"],
                290, 300)
        right = ([rk] + _payloads(rng, 250, ["int32"]), [kd, "int32"], 240, 256)
        return left, right, [0], [0], 8192, kw
    raise KeyError(name)


KINDS = ["uint64_top_bit", "uint64_declared", "uint64_full_range",
         "mixed_int8_int32", "mixed_int16_int64", "mixed_uint16_int32", "mixed_uint16_int64",
         "floats_float32", "floats_float64",
         "two_keys_packed", "two_keys_unpacked", "three_keys_packed", "three_keys_unpacked",
         "wide_observed", "wide_declared_too_narrow", "carry_int64", "carry_int32"]

_U64_SHIFT = np.uint64(2**63)


def _as_int64_keys(arrays, names, on):
    """The uint64 key columns less 2^63, as int64 (order and equality
    kept)."""
    arrays, names = list(arrays), list(names)
    for c in on:
        arrays[c] = (arrays[c] - _U64_SHIFT).view(np.int64)
        names[c] = "int64"
    return arrays, names


_REF = {}


@pytest.fixture
def pallas_interpret(tiny_pallas_geometry, monkeypatch):
    monkeypatch.setattr(psc, "TILE", 256)
    monkeypatch.setenv("DJ_JOIN_SCANS", "pallas-interpret")
    tiny_pallas_geometry("pallas-vmeta-interpret")


def _reference(name):
    """dj_tpu's (rows, total, count, flags) for one kind, once per
    module: its TPU default plan with its kernels in interpret mode."""
    if name in _REF:
        return _REF[name]
    left, right, lon, ron, cap, kw = _kind(name)
    kw = dict(kw)
    if name.startswith("uint64"):
        left = _as_int64_keys(*left[:2], lon) + left[2:]
        right = _as_int64_keys(*right[:2], ron) + right[2:]
        if "key_range" in kw:
            kw["key_range"] = tuple(v - 2**63 for v in kw["key_range"])
    jl, _ = _side(*left)
    jr, _ = _side(*right)
    jt, jtot, jflags = dj_tpu.inner_join(jl, jr, lon, ron, out_capacity=cap, return_flags=True, **kw)
    k = int(jt.count())
    rows = _rows(jt, k)
    if name.startswith("uint64"):
        rows = sorted(((r[0] + 2**63,) + r[1:] for r in rows), key=repr)
    _REF[name] = (rows, int(jtot), k, {f: bool(v) for f, v in jflags.items()})
    return _REF[name]


@pytest.fixture
def expansions(monkeypatch):
    """Records the port's expansion kernels and join_scans as inner_join
    calls them."""
    called = []
    for fn_name in set(tjoin.EXPAND_KERNELS.values()) | {"join_scans"}:
        fn = getattr(tjoin, fn_name)
        monkeypatch.setattr(
            tjoin, fn_name, lambda *a, _fn=fn, _n=fn_name: called.append(_n) or _fn(*a)
        )
    return called


def _plan_inputs(name):
    """effective_plan's arguments for one kind, as inner_join derives them."""
    left, right, lon, ron, cap, kw = _kind(name)
    single = len(lon) == 1 and left[1][lon[0]] == right[1][ron[0]] and "float" not in left[1][0]
    n_pay = max(len(left[0]) - 1, len(right[0]) - len(ron)) if single else 0
    mk = (not single and "key_range" in kw
          and jjoin.plan_key_pack(kw["key_range"], [np.dtype(left[1][c]) for c in lon],
                                  left[3] + right[3]).fits)
    return dict(single_int_key=single, carry_payloads=kw.get("carry_payloads"),
                multi_key_packed=bool(mk)), n_pay


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", KINDS)
def test_key_kind_matches_dj_tpu(name, mode, pallas_interpret, expansions, monkeypatch):
    rows, total, count, flags = _reference(name)
    monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
    left, right, lon, ron, cap, kw = _kind(name)
    _, tl = _side(*left)
    _, tr = _side(*right)
    tt, ttot, tflags = tjoin.inner_join(tl, tr, lon, ron, out_capacity=cap, return_flags=True, **kw)
    assert int(ttot) == total and ttot.dtype == torch.int64
    assert int(tt.count()) == count
    assert {f: bool(v) for f, v in tflags.items()} == flags
    assert [str(c.data.dtype) for c in tt.columns] == [
        f"torch.{n}" for n in left[1] + [n for i, n in enumerate(right[1]) if i not in ron]]
    if not flags["pack_range_overflow"]:  # else every row is unspecified
        assert repr(_rows(tt, count)) == repr(rows)
    for c in tt.columns:
        assert not c.data[count:].view(torch.uint8).any(), "slots past the count must read 0"
    plan_kw, n_pay = _plan_inputs(name)
    ran = tjoin.effective_plan(n_pay, **plan_kw).expand
    assert tjoin.join_plan(tl, tr, lon, ron, kw.get("key_range"), kw.get("carry_payloads")
                           ).expand == ran
    kernel = tjoin.EXPAND_KERNELS.get(ran)
    assert expansions == ["join_scans"] + ([kernel] if kernel else [])
    if name == "wide_declared_too_narrow":
        assert flags["pack_range_overflow"]
    else:
        assert total > 0 and not any(flags.values())


@pytest.mark.parametrize("mode", MODES)
def test_plan_matches_dj_tpu_effective_plan(mode, monkeypatch):
    """The port's plan resolver gives dj_tpu's expansion, packing and
    carry for every gate (dj_tpu off its TPU, x64 on)."""
    port_of = {v: k for k, v in DJ_MODES.items()}
    monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
    monkeypatch.setenv("DJ_JOIN_EXPAND", DJ_MODES[mode])
    for pack in ("1", "0"):
        monkeypatch.setenv("DJT_JOIN_PACK", pack)
        monkeypatch.setenv("DJ_JOIN_PACK", pack)
        for single in (True, False):
            for n_pay in (0, 3, 4):
                for carry in (None, False, True):
                    for mk in (False, True):
                        args = dict(single_int_key=single, carry_payloads=carry,
                                    multi_key_packed=mk)
                        got = tjoin.effective_plan(n_pay, **args)
                        want = jjoin.effective_plan(n_payload=n_pay, **args)
                        assert (got.expand, got.packed, got.carry) == (
                            port_of[want.expand], want.packed, want.carry), (args, n_pay)
    monkeypatch.setenv("DJT_JOIN_CARRY", "1")
    assert tjoin.effective_plan(1).carry


DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float16", "float32", "float64"]


def test_promote_key_dtype_matches_jnp_promote_types():
    for a in DTYPES:
        for b in DTYPES:
            want = np.dtype(jnp.promote_types(a, b)).name
            got = tjoin.promote_key_dtype(getattr(torch, a), getattr(torch, b))
            assert str(got) == f"torch.{want}", (a, b)


@pytest.mark.parametrize("d", ["float32", "float64"])
def test_order_image_sorts_as_jax_lax_sort(d):
    """A stable sort of the image orders floats as jax.lax.sort does:
    -0.0, 0.0 and the subnormals equal (kept in row order: XLA flushes
    subnormals to zero), every NaN equal and last."""
    rng = np.random.default_rng(3)
    pool = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-45, -1e-45, 2.0, -2.0,
                     np.finfo(d).max, np.finfo(d).min], d)
    x = pool[rng.integers(0, len(pool), 500)]
    want = np.asarray(jax.lax.sort((jnp.asarray(x), jnp.arange(500)), num_keys=1,
                                   is_stable=True)[1])
    img = tjoin._order_image(torch.from_numpy(x))
    got = torch.sort(img, stable=True).indices.numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["two_keys_unpacked", "three_keys_unpacked", "floats_float64",
                                  "mixed_uint16_int64"])
def test_unpacked_scans_match_match_scans_xla(name):
    """join_scans over the re-packed words of the unpacked sort gives
    dj_tpu's ``_match_scans_xla`` over its variadic sort: cnt and csum at
    every position, stag and run_start at every valid one (the padding
    tail is ordered differently and reads no match in both)."""
    left, right, lon, ron, _, _ = _kind(name)
    jl, tl = _side(*left)
    jr, tr = _side(*right)
    L, R = tl.capacity, tr.capacity
    boundary, stag = jjoin._multi_key_merged_sort(jl, jr, lon, ron)
    want = (stag,) + jjoin._match_scans_xla(boundary, stag, jl.count(), jr.count(), L, R)
    tag_bits = max(1, (L + R).bit_length())
    images, floats = tjoin._key_images(tl, tr, lon, ron)
    words, _ = tjoin._unpacked_words(images, floats, tl.count(), tr.count(), L, R, tag_bits)
    got = join_scans_plain(words, tl.count(), tr.count(), tag_bits, L, R)
    nv = left[2] + right[2]
    for k, (g, w) in enumerate(zip(got, want)):
        upto = nv if k < 2 else L + R
        np.testing.assert_array_equal(g.numpy()[:upto], np.asarray(w)[:upto])


def test_uint64_carry_modes_recover_top_bit_keys(monkeypatch):
    """vcarry and vfull recover a uint64 key from the packed word (kmin
    in the flipped image, flipped back); the rows equal the default
    mode's."""
    left, right, lon, ron, cap, _ = _kind("uint64_top_bit")
    _, tl = _side(*left)
    _, tr = _side(*right)
    out = {}
    for mode in ("vmeta", "vcarry", "vfull"):
        monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
        t, total = tjoin.inner_join(tl, tr, lon, ron, out_capacity=cap)
        out[mode] = _rows(t, int(t.count()))
        assert t.columns[0].data.dtype == torch.uint64
    assert out["vcarry"] == out["vmeta"] == out["vfull"]
    assert min(r[0] for r in out["vmeta"]) >= 2**63 - 20


def test_pack_knob_off_sorts_unpacked(monkeypatch):
    """DJT_JOIN_PACK=0 takes the unpacked sort for an int key; the rows
    are the packed sort's."""
    left, right, lon, ron, cap, _ = _kind("carry_int64")
    _, tl = _side(*left)
    _, tr = _side(*right)
    t1, n1 = tjoin.inner_join(tl, tr, lon, ron, out_capacity=cap)
    monkeypatch.setenv("DJT_JOIN_PACK", "0")
    assert not tjoin.effective_plan(2).packed
    t0, n0 = tjoin.inner_join(tl, tr, lon, ron, out_capacity=cap)
    assert int(n0) == int(n1) > 0
    assert _rows(t0, int(n0)) == _rows(t1, int(n1))

"""dj_tpu_torch's string columns vs dj_tpu's, on the same inputs.

The inputs are made with numpy from a seed and handed to both packages
on the CPU. Compared exactly (no tolerance anywhere): StringColumn's
take, char_overflow and concatenate leaf for leaf (offsets and every
byte of chars, padding included); ``_string_hash`` and
``string_surrogate64`` bit for bit; ``hash_partition`` of a table with
string columns leaf for leaf; ``inner_join`` with string payloads under
every expansion mode and under carry, with string keys, mixed string and
int keys, and the surrogate-collision verifier, as full-row multisets
with the total, the count, the flags and each output string column's
char_overflow; the plan gate against dj_tpu's ``effective_plan``; the
char_overflow heal's attempts and factors; the port of
``make_tpch_sample.make_split``; and the prepared side's refusal.
"""

import functools
import importlib.util
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import table as jT
from dj_tpu.ops import hashing as jhash
from dj_tpu.ops import join as jjoin
from dj_tpu.ops import pallas_scan as psc
from dj_tpu.ops import partition as jpart
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.core import table as tT
from dj_tpu_torch.data import tpch
from dj_tpu_torch.ops import hashing as thash
from dj_tpu_torch.ops import join as tjoin
from dj_tpu_torch.ops import partition as tpart

REPO = pathlib.Path(__file__).resolve().parents[1]

# The port's expansion mode names and dj_tpu's.
MODES = {
    "vmeta": "pallas-vmeta", "ranks": "pallas", "fused": "pallas-fused",
    "join": "pallas-join", "vcarry": "pallas-vcarry", "vfull": "pallas-vfull",
}


@pytest.fixture(autouse=True)
def _fresh_ledger():
    tj.resilience.ledger.reset()
    yield
    tj.resilience.ledger.reset()


def _random_strings(rng, n, max_len=20, alphabet=None):
    """n byte strings of lengths in [0, max_len], any byte value (or
    drawn from ``alphabet``)."""
    out = []
    for ln in rng.integers(0, max_len + 1, n):
        if alphabet is None:
            out.append(rng.integers(0, 256, ln).astype(np.uint8).tobytes())
        else:
            out.append(bytes(rng.choice(list(alphabet), ln)))
    return out


def _str_arrays(strings, char_pad=0):
    """(offsets, chars) numpy pair of ``strings``, chars padded with
    ``char_pad`` zero bytes (at least one byte)."""
    sizes = np.array([len(s) for s in strings], np.int32)
    offsets = np.zeros(len(strings) + 1, np.int32)
    np.cumsum(sizes, out=offsets[1:])
    chars = np.frombuffer(b"".join(strings) + b"\0" * char_pad, np.uint8)
    if chars.size == 0:
        chars = np.zeros(1, np.uint8)
    return offsets, chars.copy()


def _tables(arrays, names, valid=None):
    """(dj_tpu table, port table) of the same columns: a "string"
    entry of ``arrays`` is an (offsets, chars) pair."""
    cols = []
    for a, nm in zip(arrays, names):
        if nm == "string":
            cols.append(jT.StringColumn(jnp.asarray(a[0]), jnp.asarray(a[1])))
        else:
            cols.append(jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(nm)))
    jvc = None if valid is None else jnp.int32(valid)
    return jT.Table(tuple(cols), jvc), convert.table_from_numpy(arrays, names, valid, device="cpu")


def _leaves(col):
    """A column's arrays as numpy: (offsets, chars) or (data,)."""
    if hasattr(col, "chars"):
        return np.asarray(col.offsets), np.asarray(col.chars)
    return (np.asarray(col.data),)


def _assert_same_column(t, j):
    assert t.dtype.name == j.dtype.name
    for a, b in zip(_leaves(t), _leaves(j), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _rows(table, count, to_strings):
    cols = []
    for c in table.columns:
        if hasattr(c, "chars"):
            cols.append(to_strings(c, count))
        else:
            cols.append(np.asarray(c.data)[:count].tolist())
    return sorted(zip(*cols))


def _char_overflows(table):
    return [bool(c.char_overflow()) for c in table.columns if hasattr(c, "chars")]


# --- StringColumn ------------------------------------------------------


def test_from_strings_to_strings_round_trip():
    rng = np.random.default_rng(0)
    strs = _random_strings(rng, 300) + [b"", "héllo wörld", b"\x00\xff"]
    col = tj.from_strings(strs, device="cpu")
    want = [s.encode() if isinstance(s, str) else s for s in strs]
    assert tj.to_strings(col) == want
    assert tj.to_strings(col, 5) == want[:5]
    _assert_same_column(col, jT.from_strings(strs))
    empty = tj.from_strings([], device="cpu")
    assert empty.size == 0 and empty.chars.shape == (1,) and tj.to_strings(empty) == []
    np.testing.assert_array_equal(col.sizes().numpy(), [len(s) for s in want])


@pytest.mark.parametrize("out_cap", [None, 7, 10_000, "total", "all_out_of_range",
                                     "row_longer_than_a_tile"])
def test_take_matches_dj_tpu(out_cap):
    """Duplicated rows, out-of-range indices (the row count and past
    it), and output char capacities below, at, exactly at and above the
    need; every index out of range; a row longer than string_gather's
    tile, gathered several times. Indices are non-negative: JAX wraps a
    negative index, the port's gathers (``take_fill``) fill it; no join
    passes one."""
    rng = np.random.default_rng(1)
    strs = _random_strings(rng, 200, max_len=30)
    if out_cap == "row_longer_than_a_tile":
        strs[5] = rng.integers(0, 256, 5000).astype(np.uint8).tobytes()
    off, chars = _str_arrays(strs, char_pad=17)
    jc = jT.StringColumn(jnp.asarray(off), jnp.asarray(chars))
    tc = tT.StringColumn(torch.from_numpy(off), torch.from_numpy(chars))
    idx = rng.integers(0, 210, 400).astype(np.int32)
    idx[:6] = [3, 3, 3, 0, 200, 199]
    if out_cap == "all_out_of_range":
        idx = rng.integers(200, 400, 400).astype(np.int32)
        out_cap = 64
    elif out_cap == "row_longer_than_a_tile":
        idx[6:10] = 5
        out_cap = 30_000
    elif out_cap == "total":
        out_cap = int(sum(len(strs[i]) for i in idx if i < 200))
    want = jc.take(jnp.asarray(idx), out_cap)
    got = tc.take(torch.from_numpy(idx), out_cap)
    _assert_same_column(got, want)
    assert bool(got.char_overflow()) == bool(want.char_overflow())
    keep = [strs[i] if 0 <= i < 200 else b"" for i in idx]
    if out_cap == 7:
        assert bool(got.char_overflow())
    if out_cap is not None and out_cap >= sum(map(len, keep)):
        assert not bool(got.char_overflow())
        assert tj.to_strings(got) == keep
    # No rows at all: empty offsets, zero chars.
    none = tc.take(torch.zeros(0, dtype=torch.int32), 5)
    assert none.offsets.tolist() == [0] and none.chars.tolist() == [0] * 5


@pytest.mark.parametrize("counts", [(2, 2), (3, 0), (0, 2), (1, 1)])
def test_concatenate_strings_matches_dj_tpu(counts):
    """Row-compacting concatenation (dj_tpu tests/test_strings.py:58):
    the payload string of key k is (k % 7 + 1) copies of one letter."""
    def pay(keys):
        return [bytes([ord("a") + int(k) % 26]) * (int(k) % 7 + 1) for k in keys]

    keys = [np.array([1, 2, 3], np.int64), np.array([10, 11], np.int64)]
    jts, tts = [], []
    for k, c in zip(keys, counts):
        j, t = _tables([k, _str_arrays(pay(k), char_pad=3)], ["int64", "string"], c)
        jts.append(j)
        tts.append(t)
    want = jT.concatenate(jts)
    got = tT.concatenate(tts)
    assert int(got.count()) == int(want.count()) == sum(counts)
    for g, w in zip(got.columns, want.columns):
        _assert_same_column(g, w)
    n = int(got.count())
    assert tj.to_strings(got.columns[1], n) == pay(got.columns[0].data[:n].tolist())


def test_table_nbytes_and_capacity_of_a_sharded_string_table():
    j, t = _tables([np.arange(4), _str_arrays([b"ab", b"", b"xyz", b"q"])], ["int64", "string"])
    assert tT.table_nbytes(t) == jT.table_nbytes(j) == 4 * 8 + 5 * 4 + 6
    topo = tj.make_topology(["cpu"] * 2)
    s, counts = tj.shard_table(topo, t)
    assert s.capacity == 4 and s.columns[1].offsets.shape == (6,) and counts.tolist() == [2, 2]


# --- hashing -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 12345678, 0xFFFFFFFF, 0xB0F57EE3, 0x83B58237])
def test_string_hash_bit_exact(seed):
    """Every length 0-200 (full blocks, 1-3 byte tails, past the 64-byte
    window) with any byte value, as dj_tpu's _string_hash."""
    rng = np.random.default_rng(seed % 1000)
    strs = [rng.integers(0, 256, n).astype(np.uint8).tobytes() for n in range(201)]
    strs += [b"", "naïve".encode(), b"x" * 64, b"x" * 64 + b"y", b"\xff" * 3]
    off, chars = _str_arrays(strs, char_pad=5)
    jc = jT.StringColumn(jnp.asarray(off), jnp.asarray(chars))
    tc = tT.StringColumn(torch.from_numpy(off), torch.from_numpy(chars))
    want = np.asarray(jhash._string_hash(jc, np.uint32(seed))).astype(np.int64)
    np.testing.assert_array_equal(thash._string_hash(tc, seed).numpy(), want)


def test_string_surrogate64_bit_exact():
    """Both seeds packed into int64 bits, h1 >= 2^31 included (negative
    surrogates); strings equal in their first 64 bytes and length share
    a surrogate, as dj_tpu documents."""
    rng = np.random.default_rng(2)
    strs = _random_strings(rng, 2000, max_len=100)
    strs += [b"p" * 64 + b"AAA", b"p" * 64 + b"BBB", b"p" * 64 + b"BBBB"]
    off, chars = _str_arrays(strs)
    jc = jT.StringColumn(jnp.asarray(off), jnp.asarray(chars))
    tc = tT.StringColumn(torch.from_numpy(off), torch.from_numpy(chars))
    got = thash.string_surrogate64(tc)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jhash.string_surrogate64(jc)))
    assert (got < 0).any() and (got > 0).any()
    assert got[-3] == got[-2] != got[-1]


def test_hash_columns_with_strings_bit_exact():
    rng = np.random.default_rng(3)
    strs = _random_strings(rng, 500, max_len=70)
    keys = rng.integers(-(2**40), 2**40, 500)
    j, t = _tables([keys, _str_arrays(strs)], ["int64", "string"])
    for cols in ([1], [0, 1], [1, 0]):
        want = np.asarray(jhash.hash_table(j, cols, 77)).astype(np.int64)
        np.testing.assert_array_equal(thash.hash_table(t, cols, 77).numpy(), want)
    with pytest.raises(AssertionError, match="fixed-width"):
        thash.hash_columns([t.columns[1]], 0, thash.HASH_IDENTITY)


@pytest.mark.parametrize("npartitions", [1, 4, 7])
@pytest.mark.parametrize("on", [[0], [1], [1, 0]])
def test_hash_partition_with_strings_matches(npartitions, on):
    """A string key or payload rides the partition's permutation: every
    leaf equal to dj_tpu's, padding included."""
    rng = np.random.default_rng(npartitions)
    n, valid = 600, 571
    strs = _random_strings(rng, n, max_len=40)
    keys = rng.integers(0, 50, n)
    j, t = _tables([keys, _str_arrays(strs, char_pad=9), np.arange(n, dtype=np.int32)],
                   ["int64", "string", "int32"], valid)
    jout, joff = jpart.hash_partition(j, on, npartitions, seed=12345678)
    tout, toff = tpart.hash_partition(t, on, npartitions, seed=12345678)
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
    assert int(tout.count()) == valid
    for g, w in zip(tout.columns, jout.columns):
        _assert_same_column(g, w)


# --- inner_join --------------------------------------------------------


def _payload_case(rng, l_valid=290, r_valid=190):
    """Left (int64 key, string payload), right (int64 key, string
    payload, int64 payload): duplicate keys on both sides, non-ASCII
    bytes, empty strings."""
    lk, rk = rng.integers(0, 40, 300), rng.integers(0, 40, 200)
    lstr = _random_strings(rng, 300, max_len=12)
    rstr = _random_strings(rng, 200, max_len=9)
    left = ([lk, _str_arrays(lstr, char_pad=4)], ["int64", "string"], l_valid)
    right = ([rk, _str_arrays(rstr), rk * 5 + 1], ["int64", "string", "int64"], r_valid)
    return left, right


def _compare_joins(left, right, lon, ron, out_cap, **kw):
    """Both packages' inner_join with flags: equal totals, counts,
    flags, column dtypes, char overflows and full-row multisets."""
    jl, tl = _tables(*left)
    jr, tr = _tables(*right)
    jt, jtot, jflags = dj_tpu.inner_join(jl, jr, lon, ron, out_capacity=out_cap,
                                         return_flags=True, **kw)
    tt, ttot, tflags = tjoin.inner_join(tl, tr, lon, ron, out_capacity=out_cap,
                                        return_flags=True, **kw)
    assert int(ttot) == int(jtot)
    assert int(tt.count()) == int(jt.count())
    assert [c.dtype.name for c in tt.columns] == [c.dtype.name for c in jt.columns]
    assert {k: bool(v) for k, v in tflags.items()} == {k: bool(v) for k, v in jflags.items()}
    assert _char_overflows(tt) == _char_overflows(jt)
    for g, w in zip(tt.columns, jt.columns):
        if hasattr(g, "chars"):
            assert g.chars.shape == w.chars.shape
    k = int(tt.count())
    if int(jtot) <= out_cap:
        assert _rows(tt, k, tj.to_strings) == _rows(jt, k, jT.to_strings)
    return tt, int(ttot), {k: bool(v) for k, v in tflags.items()}


@pytest.fixture
def mode_env(tiny_pallas_geometry, monkeypatch):
    """Sets both packages' expansion knobs for one port mode (dj_tpu's
    Pallas kernels in interpret mode); returns the names of the port's
    expansion functions that inner_join called."""
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


@pytest.mark.parametrize("char_out_factor", [1.0, 8.0])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_string_payload_join_matches_dj_tpu(mode, char_out_factor, mode_env):
    """Every expansion mode; vcarry and vfull take vmeta with strings,
    as dj_tpu's effective_plan resolves them. At factor 1 the output
    chars overflow (flagged alike), at 8 they fit."""
    called = mode_env(mode)
    left, right = _payload_case(np.random.default_rng(4))
    tt, total, _ = _compare_joins(left, right, [0], [0], 4000, char_out_factor=char_out_factor)
    ran = "vmeta" if mode in ("vcarry", "vfull") else mode
    assert called == [tjoin.EXPAND_KERNELS[ran]]
    assert _char_overflows(tt) == ([True, True] if char_out_factor == 1.0 else [False, False])
    assert total > 0


@pytest.mark.parametrize("expand", ["ranks", "hist"])
def test_string_payload_join_under_carry_matches_dj_tpu(expand, monkeypatch):
    """carry_payloads: the fixed-width payloads ride the sort, the
    strings are gathered by the carried rows' ids."""
    monkeypatch.setenv("DJT_JOIN_EXPAND", expand)
    left, right = _payload_case(np.random.default_rng(5))
    plan = tjoin.join_plan(_tables(*left)[1], _tables(*right)[1], [0], [0], carry_payloads=True)
    assert plan.carry and plan.expand == expand
    _compare_joins(left, right, [0], [0], 4000, char_out_factor=8.0, carry_payloads=True)


@pytest.mark.parametrize("mode", sorted(MODES) + ["hist"])
@pytest.mark.parametrize("carry", [None, True])
def test_has_strings_plan_gate_matches_effective_plan(mode, carry, monkeypatch):
    monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
    monkeypatch.setenv("DJ_JOIN_EXPAND", MODES.get(mode, mode))
    for has_strings in (False, True):
        for single in (False, True):
            got = tjoin.effective_plan(1, single_int_key=single, has_strings=has_strings,
                                       carry_payloads=carry)
            want = jjoin.effective_plan(single_int_key=single, has_strings=has_strings,
                                        carry_payloads=carry)
            inv = {v: k for k, v in MODES.items()} | {"hist": "hist"}
            assert got.expand == inv[want.expand], (has_strings, single)
            assert (got.packed, got.carry) == (want.packed, want.carry)


def _key_case(rng, nprobe=512, nbuild=256):
    """Left (string key, row id), right (string key, k * 10 + 3): right
    keys distinct, about half the probe keys hit (dj_tpu
    tests/test_strings.py:136-163)."""
    build_k = rng.permutation(np.arange(nbuild * 2))[:nbuild]
    probe_k = np.where(rng.random(nprobe) < 0.5, build_k[rng.integers(0, nbuild, nprobe)],
                       rng.integers(nbuild * 2, nbuild * 4, nprobe))
    left = ([_str_arrays([b"key-%d" % k for k in probe_k]), np.arange(nprobe, dtype=np.int64)],
            ["string", "int64"], None)
    right = ([_str_arrays([b"key-%d" % k for k in build_k]), build_k * 10 + 3],
             ["string", "int64"], None)
    return probe_k, build_k, left, right


@pytest.mark.parametrize("mode", ["vmeta", "join", "vcarry"])
def test_string_key_join_matches_dj_tpu(mode, mode_env):
    """The left string key stays as a payload, the right one and both
    surrogates are dropped; every row's payloads agree with its key."""
    mode_env(mode)
    probe_k, build_k, left, right = _key_case(np.random.default_rng(7))
    tt, total, flags = _compare_joins(left, right, [0], [0], 512)
    hits = np.isin(probe_k, build_k)
    assert total == int(hits.sum()) and not flags["surrogate_collision"]
    assert tt.num_columns == 3
    keys = tj.to_strings(tt.columns[0], total)
    lpay, rpay = tt.columns[1].data[:total].tolist(), tt.columns[2].data[:total].tolist()
    for s, lp, rp in zip(keys, lpay, rpay):
        k = int(s.decode().removeprefix("key-"))
        assert probe_k[lp] == k and rp == k * 10 + 3


def test_string_key_join_with_declared_range_and_carry():
    """A declared key_range is dropped for string keys (the surrogates
    span 64 bits), and carry joins them through the unpacked sort."""
    probe_k, build_k, left, right = _key_case(np.random.default_rng(8), 300, 200)
    _compare_joins(left, right, [0], [0], 512, key_range=(0, 10))
    _compare_joins(left, right, [0], [0], 512, carry_payloads=True)


def test_mixed_string_int_multikey_join_matches_dj_tpu():
    """(string, int) keys (dj_tpu tests/test_strings.py:183-229)."""
    rng = np.random.default_rng(8)
    n = 256
    grp, sub = rng.integers(0, 8, n), rng.integers(0, 4, n)
    bg, bs = np.repeat(np.arange(8), 2), np.tile(np.array([0, 2]), 8)
    left = ([_str_arrays([b"g%d" % g for g in grp]), sub, np.arange(n, dtype=np.int64)],
            ["string", "int64", "int64"], None)
    right = ([_str_arrays([b"g%d" % g for g in bg]), bs, bg * 100 + bs],
             ["string", "int64", "int64"], None)
    tt, total, _ = _compare_joins(left, right, [0, 1], [0, 1], n)
    want = {(g, s) for g, s in zip(bg, bs)}
    assert total == sum((g, s) in want for g, s in zip(grp, sub))
    _compare_joins(left, right, [1, 0], [1, 0], n)


def test_string_against_int_key_raises():
    _, t1 = _tables([_str_arrays([b"a", b"b"])], ["string"])
    _, t2 = _tables([np.array([1, 2])], ["int64"])
    for a, b in ((t1, t2), (t2, t1)):
        with pytest.raises(TypeError, match="string column"):
            tjoin.inner_join(a, b, [0], [0], out_capacity=4)


def _fake_surrogate(col, max_len=64):
    """Degenerate surrogate: the string's length, so distinct strings
    of one length collide (dj_tpu tests/test_string_collision.py:50-54)."""
    return col.sizes().astype(jnp.int64)


def _fake_surrogate_torch(col, max_len=64):
    return col.sizes().to(torch.int64)


def _collision_tables(probe, build):
    left = ([_str_arrays(probe), np.arange(len(probe), dtype=np.int64)], ["string", "int64"], None)
    right = ([_str_arrays(build), np.arange(len(build), dtype=np.int64) * 7],
             ["string", "int64"], None)
    return left, right


@pytest.mark.parametrize("case", ["clean", "forced", "true_match", "opt_out"])
def test_collision_verifier_matches_dj_tpu(case, monkeypatch):
    """The verifier's four cases (dj_tpu tests/test_string_collision.py:
    58-108), the surrogate patched alike in both packages."""
    if case != "clean":
        monkeypatch.setattr(jhash, "string_surrogate64", _fake_surrogate)
        monkeypatch.setattr(thash, "string_surrogate64", _fake_surrogate_torch)
    if case == "opt_out":
        monkeypatch.setenv("DJ_STRING_VERIFY", "0")
        monkeypatch.setenv("DJT_STRING_VERIFY", "0")
    probe, build = {
        "clean": ([b"apple", b"pear", b"plum", b"apple"], [b"apple", b"fig"]),
        "forced": ([b"aaa", b"xy"], [b"bbb"]),
        "true_match": ([b"abc"], [b"abc"]),
        "opt_out": ([b"aaa"], [b"bbb"]),
    }[case]
    _, total, flags = _compare_joins(*_collision_tables(probe, build), [0], [0], 8)
    assert flags["surrogate_collision"] == (case == "forced")
    assert total == {"clean": 2, "forced": 1, "true_match": 1, "opt_out": 1}[case]


def test_verifier_reads_only_the_64_byte_window(monkeypatch):
    """Keys equal in their first 64 bytes and their length are equal by
    design, unflagged; a difference inside the window is flagged."""
    monkeypatch.setattr(thash, "string_surrogate64", _fake_surrogate_torch)
    monkeypatch.setattr(jhash, "string_surrogate64", _fake_surrogate)
    long_a, long_b = b"p" * 64 + b"AAA", b"p" * 64 + b"BBB"
    _, _, flags = _compare_joins(*_collision_tables([long_a], [long_b]), [0], [0], 4)
    assert not flags["surrogate_collision"]
    _, _, flags = _compare_joins(*_collision_tables([b"q" + long_a[1:]], [long_b]), [0], [0], 4)
    assert flags["surrogate_collision"]


def test_unverified_string_keys_warn_once(monkeypatch):
    monkeypatch.setattr(tjoin, "_warned_unverified_string_keys", False)
    _, _, left, right = _key_case(np.random.default_rng(9), 40, 20)
    tl, tr = _tables(*left)[1], _tables(*right)[1]
    with pytest.warns(RuntimeWarning, match="verifier is SKIPPED"):
        tjoin.inner_join(tl, tr, [0], [0], out_capacity=64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tjoin.inner_join(tl, tr, [0], [0], out_capacity=64)
        tjoin.inner_join(tl, tr, [0], [0], out_capacity=64, return_flags=True)


@pytest.mark.parametrize("sides", ["empty_left", "empty_right", "both_empty"])
def test_capacity_zero_string_sides_match_dj_tpu(sides):
    """A capacity-0 side joins empty, its string columns all-fill, and
    the verifier does not run (dj_tpu tests/test_string_collision.py:
    111-124)."""
    empty = ([_str_arrays([]), np.zeros(0, np.int64)], ["string", "int64"], None)
    one = ([_str_arrays([b"a"]), np.array([4])], ["string", "int64"], None)
    left, right = {"empty_left": (empty, one), "empty_right": (one, empty),
                   "both_empty": (empty, empty)}[sides]
    tt, total, flags = _compare_joins(left, right, [0], [0], 4)
    assert total == 0 and not flags["surrogate_collision"] and int(tt.count()) == 0
    # A string payload from an empty side: its all-fill column's shape.
    _compare_joins((left[0][::-1], left[1][::-1], None), (right[0][::-1], right[1][::-1], None),
                   [0], [0], 4)


def test_join_char_overflow_detected():
    """One build key matched 64 times duplicates a 100-byte string
    (dj_tpu tests/test_strings.py:278-301)."""
    left = ([np.zeros(64, np.int64)], ["int64"], None)
    right = ([np.array([0]), _str_arrays([b"x" * 100])], ["int64", "string"], None)
    tt, total, _ = _compare_joins(left, right, [0], [0], 64)
    assert total == 64 and _char_overflows(tt) == [True]
    tt, _, _ = _compare_joins(left, right, [0], [0], 64, char_out_factor=64.0)
    assert _char_overflows(tt) == [False]
    assert tj.to_strings(tt.columns[1], 64) == [b"x" * 100] * 64


# --- the heal ------------------------------------------------------------


def test_char_overflow_heal_matches_dj_tpu():
    """distributed_inner_join_auto at char_out_factor 1: each of the
    probe's 4 duplicate matches copies a string, so the heal doubles
    char_out_factor to 4 in both packages; a second call of the same
    shape starts from the ledger and takes one attempt."""
    rng = np.random.default_rng(10)
    bk = rng.permutation(np.arange(400))[:200]
    pk = np.repeat(bk, 4)
    strs = _random_strings(rng, 200, max_len=15, alphabet=b"abcdef")
    build = [bk, _str_arrays(strs)]
    probe = [pk, np.arange(pk.shape[0], dtype=np.int64)]
    jtopo = jmake_topology(jax.devices()[:1])
    ttopo = tj.make_topology(["cpu"])
    jb = jshard(jtopo, jT.Table((jT.Column(jnp.asarray(bk), dj_tpu.dtypes.int64),
                                 jT.StringColumn(*map(jnp.asarray, build[1])))))
    jp = jshard(jtopo, dj_tpu.from_arrays(*map(jnp.asarray, probe)))
    tb = tj.shard_table(ttopo, convert.table_from_numpy(build, ["int64", "string"], device="cpu"))
    tp = tj.shard_table(ttopo, convert.table_from_numpy(probe, ["int64"] * 2, device="cpu"))
    cfg = dj_tpu.JoinConfig(join_out_factor=8.0)
    attempts = {"j": [], "t": []}
    jrun = jdist.distributed_inner_join
    trun = tj.parallel.dist_join.distributed_inner_join

    def counting(fn, key):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            attempts[key].append({k: bool(np.asarray(v).any()) for k, v in out[2].items()})
            return out
        return wrapped

    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(jdist, "distributed_inner_join", counting(jrun, "j"))
        m.setattr(tj.parallel.dist_join, "distributed_inner_join", counting(trun, "t"))
        jout, jcounts, _, jcfg = jdist.distributed_inner_join_auto(
            jtopo, *jp, *jb, [0], [0], cfg)
        tout, tcounts, _, tcfg = tj.distributed_inner_join_auto(
            ttopo, *tp, *tb, [0], [0], convert.join_config_from(cfg))
        assert attempts["t"] == attempts["j"] and len(attempts["t"]) == 3
        assert [a["char_overflow"] for a in attempts["t"]] == [True, True, False]
        assert tcfg.char_out_factor == jcfg.char_out_factor == 4.0
        assert tcounts.tolist() == np.asarray(jcounts).tolist() == [800]
        jrows = _rows(dj_tpu.unshard_table(jout, jcounts), 800, jT.to_strings)
        assert _rows(tj.unshard_table(tout, tcounts), 800, tj.to_strings) == jrows
        tj.distributed_inner_join_auto(ttopo, *tp, *tb, [0], [0], convert.join_config_from(cfg))
        assert len(attempts["t"]) == 4 and not any(attempts["t"][-1].values())


def test_auto_raises_on_a_collision_and_does_not_heal(monkeypatch):
    """A forced collision is terminal in both packages (dj_tpu
    tests/test_string_collision.py:127-143)."""
    monkeypatch.setattr(jhash, "string_surrogate64", _fake_surrogate)
    monkeypatch.setattr(thash, "string_surrogate64", _fake_surrogate_torch)
    n = 64
    left, right = _collision_tables([b"k%03d" % i for i in range(n)],
                                    [b"q%03d" % (i + n) for i in range(n)])
    ttopo = tj.make_topology(["cpu"] * 4)
    tl = tj.shard_table(ttopo, _tables(*left)[1])
    tr = tj.shard_table(ttopo, _tables(*right)[1])
    cfg = tj.JoinConfig(bucket_factor=9.0, join_out_factor=70.0, char_out_factor=70.0)
    _, _, info = tj.distributed_inner_join(ttopo, *tl, *tr, [0], [0], cfg)
    assert info["surrogate_collision"].any()
    jtopo = jmake_topology(jax.devices()[:4])
    jl = jshard(jtopo, _tables(*left)[0])
    jr = jshard(jtopo, _tables(*right)[0])
    jcfg = dj_tpu.JoinConfig(bucket_factor=9.0, join_out_factor=70.0, char_out_factor=70.0)
    _, _, jinfo = dj_tpu.distributed_inner_join(jtopo, *jl, *jr, [0], [0], jcfg)
    assert info["surrogate_collision"].tolist() == np.asarray(jinfo["surrogate_collision"]).tolist()
    calls = []
    real = tj.parallel.dist_join.distributed_inner_join
    monkeypatch.setattr(tj.parallel.dist_join, "distributed_inner_join",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with pytest.raises(RuntimeError, match="surrogate_collision") as err:
        tj.distributed_inner_join_auto(ttopo, *tl, *tr, [0], [0], cfg)
    with pytest.raises(RuntimeError, match="surrogate_collision") as jerr:
        dj_tpu.distributed_inner_join_auto(jtopo, *jl, *jr, [0], [0], jcfg)
    assert str(err.value) == str(jerr.value) and calls == [1]


# --- the data, the prepared side, the converters -------------------------


def _load_make_tpch_sample():
    spec = importlib.util.spec_from_file_location(
        "make_tpch_sample", REPO / "scripts" / "make_tpch_sample.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("split", [0, 3])
def test_tpch_split_matches_make_split(split):
    """Every column equal to the script's (read through pyarrow, which
    only the test uses)."""
    pytest.importorskip("pyarrow")
    script = _load_make_tpch_sample()
    o, li, c = script.make_split(split, 1500, 7, 4.0, 150, 1200)
    to, tli, tc = tpch.make_split(split, 1500, 7, 4.0, 150, 1200, device="cpu")
    for table, cols, arrow in ((to, ["O_ORDERKEY", "O_CUSTKEY", "O_ORDERPRIORITY"], o),
                               (tli, ["L_ORDERKEY", "L_PARTKEY", "L_QUANTITY"], li),
                               (tc, ["C_CUSTKEY", "C_MKTSEGMENT"], c)):
        assert table.num_columns == len(cols)
        for col, name in zip(table.columns, cols):
            if hasattr(col, "chars"):
                assert tj.to_strings(col) == [s.encode() for s in arrow[name].to_pylist()]
            else:
                np.testing.assert_array_equal(col.data.numpy(), arrow[name].to_numpy())
    names = tpch.customer_names(torch.tensor([0, 7, 999_999_999]))
    assert tj.to_strings(names) == [b"Customer#%09d" % k for k in (0, 7, 999_999_999)]


def test_prepared_side_refuses_string_columns():
    """The prepared side refuses a string key column only: a string key
    raises dj_tpu's ValueError in both packages, and the same string
    payload table now prepares and serves a query with a string probe
    payload, with dj_tpu's rows."""
    topo = tj.make_topology(["cpu"])
    jtopo = jmake_topology(jax.devices()[:1])
    rk = np.arange(50, dtype=np.int64)
    strings = _str_arrays([b"s%d" % k for k in rk])
    jb, tb = _tables([rk, strings], ["int64", "string"])
    jkey, tkey = _tables([strings, rk], ["string", "int64"])
    with pytest.raises(ValueError, match="fixed-width int join keys") as want:
        jdist.prepare_join_side(jtopo, *jshard(jtopo, jkey), [0], tier="shuffle")
    with pytest.raises(ValueError, match="fixed-width int join keys") as got:
        tj.prepare_join_side(topo, *tj.shard_table(topo, tkey), [0])
    assert str(got.value) == str(want.value)
    jprep = jdist.prepare_join_side(jtopo, *jshard(jtopo, jb), [0], tier="shuffle")
    tprep = tj.prepare_join_side(topo, *tj.shard_table(topo, tb), [0])
    pk = rk[::-2] % 60
    jp, tp = _tables([pk, _str_arrays([b"p%d" % k * 2 for k in pk])], ["int64", "string"])
    jout, jcounts, _ = dj_tpu.distributed_inner_join(jtopo, *jshard(jtopo, jp), jprep, None, [0],
                                                     None)
    tout, tcounts, tinfo = tj.distributed_inner_join(topo, *tj.shard_table(topo, tp), tprep, None,
                                                     [0], None)
    assert int(tcounts[0]) == int(jcounts[0]) == int(np.isin(pk, rk).sum())
    assert not any(bool(v.any()) for v in tinfo.values())
    n = int(tcounts[0])
    rows = [sorted(zip(np.asarray(o.columns[0].data)[:n].tolist(),
                       jT.to_strings(jT.StringColumn(np.asarray(o.columns[1].offsets),
                                                     np.asarray(o.columns[1].chars)), n),
                       jT.to_strings(jT.StringColumn(np.asarray(o.columns[2].offsets),
                                                     np.asarray(o.columns[2].chars)), n)))
            for o in (tout, jout)]
    assert rows[0] == rows[1]


def test_convert_round_trips_a_string_table():
    off, chars = _str_arrays([b"ab", b"", "ü".encode()], char_pad=2)
    t = convert.table_from_numpy([np.array([1, 2, 3]), (off, chars)], ["int64", "string"], 2,
                                 device="cpu")
    arrays, names, vc = convert.table_to_numpy(t)
    assert names == ["int64", "string"] and vc == 2
    np.testing.assert_array_equal(arrays[1][0], off)
    np.testing.assert_array_equal(arrays[1][1], chars)
    assert t.columns[1].offsets.dtype == torch.int32 and t.columns[1].chars.dtype == torch.uint8
    assert tj.dtypes.by_name("string").kind == "string"


def test_chip_smoke_string_phase_rehearses_on_cpu(monkeypatch, capsys):
    """chip_smoke's phases 8a-8d and 8f at a tiny split on CPU tables: the card's
    calls stubbed (synchronize, events, memory stats), the kernels'
    wrappers made to count their plain calls, every check of the phase
    run as on the card."""
    import time
    import types

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from dj_tpu_torch.ops import expand, scan

    class Event:
        def __init__(self, **kw):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    for name, fn in (("synchronize", lambda *a, **k: None), ("Event", Event),
                     ("reset_peak_memory_stats", lambda *a, **k: None),
                     ("max_memory_allocated", lambda *a, **k: 0),
                     ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    for name, module, counter in (("join_scans", scan, "launches"),
                                  ("expand_values", expand, "launches")):
        real = getattr(tjoin, name)

        def counted(*a, _real=real, _m=module, _c=counter, **k):
            setattr(_m, _c, getattr(_m, _c) + 1)
            return _real(*a, **k)

        monkeypatch.setattr(tjoin, name, counted)
    dj = types.SimpleNamespace(**{k: getattr(tj, k) for k in tj.__all__})
    dj.make_topology = lambda devs=None: tj.make_topology(["cpu"] * (1 if devs is None
                                                                      else len(devs)))
    one, world = cs.run_strings(dj, torch.device("cpu"), 0, 20_000, "cpu", verifier_rows=5_000)
    assert one["tpch_orders_lineitem"][4]["join_scans"] == 4
    assert world["tpch_string_key"][1]["expand_values"] == cs.WORLD
    out = capsys.readouterr().out
    for line in ("[tpch_join]", "[tpch_auto]", "[tpch_string_key]", "[tpch_verifier]"):
        assert line in out
    assert world["tpch_string_key_broadcast"][1]["join_scans"] == cs.WORLD
    assert '"smoke_phase": "8f"' in out

"""ops/partition.py's murmur3_partition_ids wrapper and its routes on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py's phase 8i holds it
to the plain version there); here the wrapper's input checks, its CPU
route, which keys take it, the partition's counts against dj_tpu, a
replay of the kernel's 32-bit arithmetic with the constants read from
its source, and a rehearsal of phase 8i with the card stubbed.
"""

import importlib.util
import pathlib
import re
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
import dj_tpu_torch as tj
from dj_tpu.core import dtypes as jdt
from dj_tpu.core.table import Column as JColumn, Table as JTable
from dj_tpu.ops import partition as jpart
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu_torch import convert
from dj_tpu_torch.ops import cuda_build, hashing, partition
from dj_tpu_torch.parallel import dist_join as tdist

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCE = (cuda_build.CSRC / "partition_ids.cu").read_text()


def _keys():
    gen = torch.Generator().manual_seed(1)
    return [torch.randint(-2**40, 2**40, (50,), generator=gen),
            torch.randint(-100, 100, (50,), generator=gen).to(torch.int16)]


def _count(n=45):
    return torch.tensor(n, dtype=torch.int32)


def _bad(case):
    k, c = _keys(), _count()
    return {
        "key_float16": ([k[0].to(torch.float16)], c, 4),
        "key_complex": ([k[0].to(torch.complex64)], c, 4),
        "no_keys": ([], c, 4),
        "count_int64": (k, c.to(torch.int64), 4),
        "count_1d": (k, c.reshape(1), 4),
        "meta_device": ([x.to("meta") for x in k], c.to("meta"), 4),
        "devices_differ": ([k[0].to("meta"), k[1]], c, 4),
        "key_2d": ([k[0].reshape(5, 10)], c, 4),
        "lengths_differ": ([k[0], k[1][:49]], c, 4),
        "key_not_contiguous": ([torch.stack([k[0], k[0]], 1)[:, 0]], c, 4),
        "npartitions_0": (k, c, 0),
        "npartitions_past_int32": (k, c, 2**31),
    }[case]


@pytest.mark.parametrize("case", [
    "key_float16", "key_complex", "no_keys", "count_int64", "count_1d", "meta_device",
    "devices_differ", "key_2d", "lengths_differ", "key_not_contiguous", "npartitions_0",
    "npartitions_past_int32"])
def test_rejects_bad_inputs(case):
    with pytest.raises(ValueError, match="murmur3_partition_ids"):
        partition.murmur3_partition_ids(*_bad(case))


@pytest.mark.parametrize("m", [1, 4, 33])
def test_cpu_takes_the_plain_version_and_counts_no_launch(m):
    """The plain version's ids and counts, the hash_columns hash of the
    key under the wrapper's route, and no launch counted, through the
    wrapper and through a partition of a CPU table."""
    keys, count = _keys(), _count()
    before = partition.launches
    pid, counts = partition.murmur3_partition_ids(keys, count, m, 99)
    want = partition.murmur3_partition_ids_plain(keys, count, m, 99)
    assert torch.equal(pid, want[0]) and torch.equal(counts, want[1])
    cols = [tj.Column(k, tj.dtypes.from_torch(k.dtype)) for k in keys]
    h = hashing.hash_columns(cols, 99)
    assert pid[:45].tolist() == (h[:45] % m).tolist() and pid[45:].tolist() == [m] * 5
    assert counts.tolist() == torch.bincount(h[:45] % m, minlength=m).tolist()
    table = tj.Table(tuple(cols), count)
    tj.hash_partition(table, [0, 1], m, seed=99)
    partition.partition_ids(table, [1], m)
    assert partition.launches == before


@pytest.mark.parametrize("case", ["string_key", "identity_hash", "fixed_width"])
def test_only_fixed_width_murmur3_keys_take_the_wrapper(monkeypatch, case):
    """A key with a string column and the identity hash keep the
    hash_table route; a key of fixed-width columns under murmur3 takes
    murmur3_partition_ids. Both give the ids of hash_table's hash."""
    calls = []
    real = partition.murmur3_partition_ids

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(partition, "murmur3_partition_ids", counted)
    ints = tj.Column(torch.arange(40, dtype=torch.int64) * 7919, tj.dtypes.int64)
    words = tj.from_strings([b"w%d" % (i % 9) for i in range(40)], device="cpu")
    table, on, hf = {
        "string_key": (tj.Table((ints, words), torch.tensor(33, dtype=torch.int32)), [0, 1],
                       hashing.HASH_MURMUR3),
        "identity_hash": (tj.Table((ints,), torch.tensor(33, dtype=torch.int32)), [0],
                          hashing.HASH_IDENTITY),
        "fixed_width": (tj.Table((ints,), torch.tensor(33, dtype=torch.int32)), [0],
                        hashing.HASH_MURMUR3),
    }[case]
    pid, counts = partition.partition_ids_and_counts(table, on, 8, 5, hf)
    assert len(calls) == (1 if case == "fixed_width" else 0)
    h = hashing.hash_table(table, on, 5, hf)
    assert pid.tolist() == (h % 8).tolist()[:33] + [8] * 7
    assert torch.equal(counts, partition.partition_counts_from_ids(pid, 8))
    part, offsets = tj.hash_partition(table, on, 8, seed=5, hash_function=hf)
    assert offsets.tolist() == [0] + torch.cumsum(counts, 0).tolist()
    assert len(calls) == (2 if case == "fixed_width" else 0)


def _jtable(arrays, count):
    cols = tuple(JColumn(jnp.asarray(a), jdt.from_jnp(a.dtype)) for a in arrays)
    return JTable(cols, jnp.asarray(count, dtype=jnp.int32))


@pytest.mark.parametrize("dtypes", [("int64",), ("int32", "float64"),
                                    ("uint16", "int8", "float32")])
@pytest.mark.parametrize("m", [2, 3, 4])
def test_hash_partition_counts_match_dj_tpu(dtypes, m):
    """hash_partition on the new route: offsets equal dj_tpu's, the
    counts partition_counts_from_ids of the ids, every row in place."""
    rng = np.random.default_rng(m)
    arrays = []
    for d in dtypes:
        if np.issubdtype(np.dtype(d), np.integer):
            info = np.iinfo(d)
            arrays.append(rng.integers(info.min, info.max, 300, endpoint=True, dtype=d))
        else:
            x = (rng.standard_normal(300) * 1e3).astype(d)
            x[:3] = [-0.0, 0.0, np.finfo(d).tiny / 4]
            arrays.append(x)
    arrays.append(np.arange(300, dtype=np.int64))
    on = list(range(len(dtypes)))
    jt, joff = jpart.hash_partition(_jtable(arrays, 280), on, m, seed=tdist.MAIN_JOIN_SEED)
    tt = convert.table_from_numpy(arrays, [a.dtype.name for a in arrays], valid_count=280,
                                  device="cpu")
    pid, counts = partition.partition_ids_and_counts(tt, on, m, tdist.MAIN_JOIN_SEED)
    assert torch.equal(counts, partition.partition_counts_from_ids(pid, m))
    got, offsets = tj.hash_partition(tt, on, m, seed=tdist.MAIN_JOIN_SEED)
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(joff))
    for gc, jc in zip(got.columns, jt.columns):
        np.testing.assert_array_equal(gc.data.numpy()[:280], np.asarray(jc.data)[:280])


@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_skew_probe_counts_match_dj_tpu(w):
    """The skew probe's [w, m] partition counts (each rank's shard
    through partition_ids_and_counts) equal dj_tpu's at odf 2."""
    keys = np.random.default_rng(w).integers(-10**9, 10**9, 64 * w, dtype=np.int64)
    topo = tj.make_topology(["cpu"] * w)
    t, c = tj.shard_table(topo, tj.from_arrays(keys, device="cpu"))
    got = tdist._partition_probe_counts(topo, t, c, (0,), 2)
    jtopo = jmake_topology(jax.devices()[:w])
    jt, jc = jshard(jtopo, dj_tpu.from_arrays(jnp.asarray(keys)))
    want = jdist._partition_probe_counts(jtopo, jt, jc, (0,), 2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).shape == (w, 2 * w) and np.asarray(got).sum() == keys.shape[0]


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr (?:int|uint32_t) {name} = (0x[0-9A-F]+|\d+)u?;",
                         SOURCE).group(1), 0)


def test_constants_and_thresholds_match_the_kernel_source():
    """murmur3's constants and hash_combine's in the kernel are
    ops/hashing.py's; the counting thresholds and the float flag are the
    wrapper's; the seed enters the kernel as an unsigned 32-bit value,
    which the wrapper passes as its ctypes.c_uint."""
    for name in ("C1", "C2", "MIX1", "MIX2", "N"):
        assert _constant(name) == getattr(hashing, f"_{name}"), name
    zero = torch.zeros(1, dtype=torch.int64)
    assert _constant("GOLDEN") == int(hashing.hash_combine(zero, zero))
    assert _constant("SMALL_M") == partition.SMALL_M
    assert _constant("SHARED_M") == partition.SHARED_M
    assert _constant("FLOAT_KIND") == partition.FLOAT_KIND
    assert partition.SMALL_M * _constant("NT") * 4 <= 48 * 1024
    assert partition.SHARED_M * 4 <= 48 * 1024
    assert re.search(r"long long cap, unsigned m, unsigned seed\)", SOURCE)
    assert re.search(r"int m, unsigned seed, void\* stream\)", SOURCE)
    wrapper = pathlib.Path(partition.__file__).read_text()
    assert "ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p" in wrapper
    assert "int(seed) & hashing.M32" in wrapper


def _replay(keys, count: int, m: int, seed: int):
    """The kernel's arithmetic in numpy uint32 lanes with its source's
    constants: each key's little-endian words, a float's exponent-0 values
    as +0.0, murmur3, hash_combine, the modulo, the padding id, the
    counts."""
    u32 = np.uint32
    c = {k: u32(_constant(k)) for k in ("C1", "C2", "MIX1", "MIX2", "N", "GOLDEN")}

    def rotl(x, r):
        return (x << u32(r)) | (x >> u32(32 - r))

    def mix_k(k):
        return rotl(k * c["C1"], 15) * c["C2"]

    def mix_block(h, k):
        return rotl(h ^ mix_k(k), 13) * u32(5) + c["N"]

    def fmix(h):
        h = h ^ (h >> u32(16))
        h = h * c["MIX1"]
        h = h ^ (h >> u32(13))
        h = h * c["MIX2"]
        return h ^ (h >> u32(16))

    acc = None
    for key in keys:
        a = key.numpy()
        width = a.dtype.itemsize
        raw = a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[width]).astype(np.uint64)
        lo, hi = (raw & 0xFFFFFFFF).astype(u32), (raw >> 32).astype(u32)
        if key.is_floating_point():
            zero = ((hi & u32(0x7FF00000)) == 0) if width == 8 else ((lo & u32(0x7F800000)) == 0)
            lo, hi = np.where(zero, u32(0), lo), np.where(zero, u32(0), hi)
        s = np.full(a.shape, seed & 0xFFFFFFFF, dtype=u32)
        if width == 8:
            h = mix_block(mix_block(s, lo), hi) ^ u32(8)
        elif width == 4:
            h = mix_block(s, lo) ^ u32(4)
        else:
            h = s ^ mix_k(lo & u32(0xFF if width == 1 else 0xFFFF)) ^ u32(width)
        h = fmix(h)
        acc = h if acc is None else acc ^ (h + c["GOLDEN"] + (acc << u32(6)) + (acc >> u32(2)))
    n = acc.shape[0]
    pid = np.where(np.arange(n) < count, (acc % u32(m)).astype(np.int64), m).astype(np.int32)
    counts = np.bincount(pid[pid < m], minlength=m).astype(np.int32)
    return pid, counts


def test_kernel_arithmetic_replayed_equals_the_plain_version():
    """Every edge case of chip_smoke's phase 8i, replayed in uint32 lanes
    with the kernel's constants, equals murmur3_partition_ids_plain id
    for id and count for count (the case's keys at their own values:
    the card's alignment offset changes no value)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    with np.errstate(over="ignore"):
        for case, (keys, count, m, seed, _) in cs.partition_ids_cases().items():
            want_pid, want_counts = partition.murmur3_partition_ids_plain(
                keys, torch.tensor(count, dtype=torch.int32), m, seed)
            pid, counts = _replay(keys, count, m, seed)
            np.testing.assert_array_equal(pid, want_pid.numpy(), err_msg=case)
            np.testing.assert_array_equal(counts, want_counts.numpy(), err_msg=case)


def test_chip_smoke_partition_ids_phase_rehearses_on_cpu(monkeypatch, capsys):
    """chip_smoke's phase 8i on CPU tensors: the card's calls stubbed,
    murmur3_partition_ids made to count its plain calls; every edge
    case, the two plain routes and the timed call on 20,000 keys, every
    check as on the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    class Event:
        def __init__(self, **kw):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    for name, fn in (("synchronize", lambda *a, **k: None), ("Event", Event),
                     ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    real = partition.murmur3_partition_ids

    def counted(*a, **k):
        partition.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(partition, "murmur3_partition_ids", counted)
    dj = types.SimpleNamespace(**{k: getattr(tj, k) for k in tj.__all__})
    t = cs.check_partition_ids(dj, torch.device("cpu"), 20_000, "cpu")
    assert t["rows"] == 20_000 and t["m"] == 4 and sum(t["counts"]) == 20_000
    assert t["bound_ms"] == pytest.approx(12 * 20_000 / cs.HBM_BYTES_PER_S * 1e3)
    # One a case, the checked call at size, the timed calls (a warm-up and 20).
    assert t["launches"] == len(cs.partition_ids_cases()) + 1 + 21
    out = capsys.readouterr().out
    assert out.count('"kernel": "partition_ids"') == len(cs.partition_ids_cases())
    assert out.count('"kernel": "none (plain route)"') == 2 and "[partition_ids]" in out

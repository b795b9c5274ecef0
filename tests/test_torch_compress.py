"""dj_tpu_torch's cascaded wire codec vs dj_tpu's.

The same numpy inputs go through ``dj_tpu.compress.cascaded`` and
``dj_tpu_torch.compress.cascaded``: the block codec under all 8
cascades (rle x delta x bp) on dj_tpu's patterns, values at +-2^63 and
counts below the block, word for word (padding words included) with
equal totals, overflow bits and decodes; the bucket forms for every
integer width, signed and unsigned, with ragged counts; the host size
model, the selector's (options, wire_factor) and its on-device sample;
the auto and none options trees; ``broadcast_compression_options`` in
one process and in a gloo world of 2 processes. Then the codec on the
wire, on the 8-device CPU mesh against dj_tpu's shard_map: ``shuffle_on``
flat and per axis at w 4 and 8 (a string column's sizes compressed, a
tight wire, ``shuffle_on_auto``'s heal), the two-level
``distributed_inner_join`` with both sides compressed at (4, 2), (8, 2),
(8, 4) and (4, 1), odf 1 and 4, the auto heal of a tight wire, and the
prepared side and query; compared are counts, every flag, the split
bits, the ``comp_*`` / ``pre_shuffle_comp_*`` counters (float32,
exactly) and each shard's row multiset. Last, ``warmup_compression`` and
chip_smoke's phases 4g, 4e and 4f compressed, rehearsed on the CPU.
"""

import json
import pathlib
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.compress import cascaded as jz
from dj_tpu.core import table as jT
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel import shuffle as jshuffle
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.compress import cascaded as tz
from dj_tpu_torch.data.generator import host_build_probe_keys
from dj_tpu_torch.ops import expand
from dj_tpu_torch.parallel import dist_join as tdist
from dj_tpu_torch.parallel import shuffle as tshuffle
from dj_tpu_torch.resilience import ledger as tledger

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASCADES = [(r, d, bp) for r in (0, 1) for d in (0, 1) for bp in (True, False)]
TOPOLOGIES = [(4, 2), (8, 2), (8, 4), (4, 1)]
B = 256


@pytest.fixture(autouse=True)
def empty_port_ledger(monkeypatch):
    monkeypatch.delenv("DJT_LEDGER", raising=False)
    tledger.reset()
    yield
    tledger.reset()


def _patterns() -> list:
    """dj_tpu's round-trip patterns (tests/test_compression.py:48-60), full
    64-bit patterns and values at +-2^63, as int64 bit patterns."""
    rng = np.random.default_rng(7)
    return [
        np.zeros(B, np.int64),
        np.full(B, 123456789, np.int64),
        np.arange(B, dtype=np.int64) * 3 + 1000,
        rng.integers(0, 16, B),
        rng.integers(-(2**62), 2**62, B),
        np.repeat(rng.integers(0, 5, 16), 16),
        np.concatenate([np.arange(200), np.zeros(56)]).astype(np.int64),
        rng.integers(0, 2**64, B, dtype=np.uint64).view(np.int64),
        np.where(rng.random(B) < 0.5, -(2**63), 2**63 - 1).astype(np.int64),
        np.repeat(np.array([-(2**63), 2**63 - 1, 0, -1]), B // 4).astype(np.int64),
        np.cumsum(rng.integers(0, 4, B)).astype(np.int64) + (5 - 2**63),
    ]


def _j_opts(cascade):
    return jz.CascadedOptions(*cascade)


def _t_opts(cascade):
    return tz.CascadedOptions(*cascade)


@pytest.mark.parametrize("cascade", CASCADES)
def test_block_codec_matches_dj_tpu_word_for_word(cascade):
    """compress_block: words (padding included), total and overflow equal
    to dj_tpu's for every pattern, count (the whole block, a prefix, 1,
    0) and capacity (ample, and 40 words, which overflows the wide
    ones); decompress_block equal to dj_tpu's and, without overflow, to
    the input's prefix with zeros past it."""
    jo, to = _j_opts(cascade), _t_opts(cascade)
    overflowed = 0
    for x in _patterns():
        u = x.view(np.uint64)
        for count in (B, 177, 1, 0):
            for cap in (jz.HEADER_WORDS + 2 * B + 8, jz.HEADER_WORDS + 40):
                jw, jt, jovf = jz.compress_block(jnp.asarray(u), jo, cap, jnp.int32(count))
                tw, tt, tovf = tz.compress_block(torch.from_numpy(x.copy()), to, cap, count)
                assert tw.dtype == torch.int64 and tw.shape == (cap,)
                np.testing.assert_array_equal(tw.numpy().view(np.uint64), np.asarray(jw))
                assert int(tt) == int(jt) and bool(tovf) == bool(jovf)
                td = tz.decompress_block(tw, to, B).numpy().view(np.uint64)
                if bool(tovf):
                    overflowed += 1
                    continue
                np.testing.assert_array_equal(td, np.asarray(jz.decompress_block(jw, jo, B)))
                np.testing.assert_array_equal(td, np.where(np.arange(B) < count, u, 0))
    assert overflowed > 0 if cascade[2] is False or cascade == (0, 0, True) else True


@pytest.mark.parametrize("name", ["int8", "uint8", "int16", "uint16", "int32", "uint32",
                                  "int64", "uint64"])
def test_bucket_codec_matches_dj_tpu(name):
    """compress_buckets / decompress_buckets on [4, 300] buckets of every
    integer width with ragged counts (one 0, one full): the same-width
    bits zero-extended, so the words equal dj_tpu's, and the decode of
    each bucket its valid prefix in the physical dtype."""
    rng = np.random.default_rng(len(name))
    d = np.dtype(name)
    n, b = 4, 300
    raw = rng.integers(0, 2**64, (n, b), dtype=np.uint64).view(np.int64)
    data = raw.astype(d) if d.itemsize < 8 else raw.view(d)
    data[1] = data[1, 0]  # one constant bucket
    data[2] = np.sort(data[2])
    counts = np.array([b, 0, 177, 5], np.int32)
    for cascade in ((1, 0, True), (0, 1, True), (1, 1, False), (0, 0, True)):
        cap = jz.HEADER_WORDS + 2 * b + 8  # RLE without bitpack: values and lengths
        jw, jt, jovf = jz.compress_buckets(jnp.asarray(data), d.itemsize, _j_opts(cascade), cap,
                                           jnp.asarray(counts))
        tw, tt, tovf = tz.compress_buckets(torch.from_numpy(data.copy()), d.itemsize,
                                           _t_opts(cascade), cap, torch.from_numpy(counts))
        np.testing.assert_array_equal(tw.numpy().view(np.uint64), np.asarray(jw))
        assert tt.tolist() == np.asarray(jt).tolist()
        assert tovf.tolist() == np.asarray(jovf).tolist() == [False] * n
        tdec = tz.decompress_buckets(tw, d.itemsize, _t_opts(cascade), b,
                                     tj.dtypes.by_name(name).torch_dtype)
        jdec = jz.decompress_buckets(jw, d.itemsize, _j_opts(cascade), b, d)
        np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
        want = np.where(np.arange(b)[None, :] < counts[:, None], data, 0)
        np.testing.assert_array_equal(tdec.numpy(), want)


def test_block_overflow_flagged_as_dj_tpu():
    """dj_tpu's overflow case (tests/test_compression.py:74-81): 256
    incompressible values into 16 words set the bit, with the same
    total and the same truncated words."""
    x = np.random.default_rng(1).integers(-(2**62), 2**62, 256)
    cap = jz.HEADER_WORDS + 16
    jw, jt, jovf = jz.compress_block(jnp.asarray(x.astype(np.uint64)),
                                     jz.CascadedOptions(0, 0, True), cap)
    tw, tt, tovf = tz.compress_block(torch.from_numpy(x), tz.CascadedOptions(0, 0, True), cap)
    assert bool(tovf) and bool(jovf) and int(tt) == int(jt) > cap
    np.testing.assert_array_equal(tw.numpy().view(np.uint64), np.asarray(jw))


def test_rle_decode_runs_expand_ranks(monkeypatch):
    """The RLE decode of n buckets is one expand_ranks call over their
    n * B ends; the other cascades make none."""
    calls = []
    real = expand.expand_ranks_plain
    monkeypatch.setattr(expand, "expand_ranks_plain",
                        lambda c, n_out: calls.append((c.shape[0], n_out)) or real(c, n_out))
    x = torch.from_numpy(np.repeat(np.arange(30), 10).reshape(3, 100))
    for cascade, want in (((1, 1, True), [(300, 300)]), ((0, 1, True), [])):
        calls.clear()
        w, _, _ = tz.compress_buckets(x, 8, _t_opts(cascade), 300)
        assert torch.equal(tz.decompress_buckets(w, 8, _t_opts(cascade), 100, torch.int64), x)
        assert calls == want


def test_size_model_matches_the_codec_and_dj_tpu():
    """_simulate_compressed_words equals the codec's total and dj_tpu's
    model (tests/test_compression.py:104-119)."""
    rng = np.random.default_rng(3)
    for x in [np.repeat(rng.integers(0, 9, 32), 8),
              np.cumsum(rng.integers(0, 5, 256)).astype(np.int64),
              rng.integers(0, 2**40, 256),
              rng.integers(0, 2**64, 256, dtype=np.uint64).view(np.int64)]:
        for cascade in ((1, 0, True), (0, 1, True), (1, 1, True), (0, 0, True)):
            host = tz._simulate_compressed_words(x, _t_opts(cascade))
            assert host == jz._simulate_compressed_words(x, _j_opts(cascade))
            _, total, _ = tz.compress_block(torch.from_numpy(x), _t_opts(cascade),
                                            tz.HEADER_WORDS + x.size + 8)
            assert host == int(total), (cascade, host, int(total))


def _selector_inputs() -> list:
    """The selector inputs of tests/test_compression.py:84-101 and
    :251-291, and a few more widths."""
    rng = np.random.default_rng(5)
    return [
        rng.integers(0, 16, 65536),
        np.full(65536, 42, np.int64),
        np.random.default_rng(2).integers(-(2**62), 2**62, 65536),
        np.cumsum(np.ones(65536, np.int64) * 3),
        np.arange(3_000_000, dtype=np.int64) // 7,
        np.arange(1000, dtype=np.int64),
        np.arange(1_000_000, dtype=np.int64) * 3,
        rng.integers(0, 400_000, 200_000).astype(np.int32),
        rng.integers(0, 2**16, 150_000, dtype=np.uint16),
        rng.integers(-100, 100, 5000).astype(np.int8),
    ]


def test_selector_matches_dj_tpu_exactly():
    """select_cascaded_options: the same cascade and the same float
    wire_factor, on the full column and on selector_sample of its torch
    tensor, which crosses as at most 100 x 1024 elements (800 KB of
    int64) and picks what the full column picks."""
    for x in _selector_inputs():
        jo, jwf = jz.select_cascaded_options(x)
        to, twf = tz.select_cascaded_options(x)
        assert (to.num_rles, to.num_deltas, to.use_bp) == (jo.num_rles, jo.num_deltas, jo.use_bp)
        assert twf == jwf
        sample = tz.selector_sample(torch.from_numpy(x))
        assert isinstance(sample, np.ndarray)
        assert sample.size <= 100 * 1024 and sample.nbytes <= 100 * 1024 * 8
        np.testing.assert_array_equal(sample, np.asarray(jz.selector_sample(jnp.asarray(x))))
        assert tz.select_cascaded_options(sample) == (to, twf)
    assert tz.selector_sample(torch.arange(1000)).size == 1000


def _mixed_table():
    """Columns of every kind the policy treats apart: compressible ints,
    an incompressible int, a float and a string."""
    rng = np.random.default_rng(11)
    n = 5000
    arrays = [rng.integers(0, 1000, n), np.arange(n, dtype=np.int64) // 3,
              rng.integers(-(2**62), 2**62, n), rng.standard_normal(n),
              (rng.integers(0, 60, n) + 60000).astype(np.uint16),
              [b"x" * int(k) for k in rng.integers(0, 12, n)]]
    names = ["int64", "int64", "int64", "float64", "uint16", "string"]
    return _as_tables(arrays, names)


def _same_tree(t, j):
    if isinstance(t, tuple):
        assert isinstance(j, tuple) and len(t) == len(j)
        for a, b in zip(t, j):
            _same_tree(a, b)
        return
    assert (t.method, t.wire_factor) == (j.method, j.wire_factor)
    assert (t.cascaded.num_rles, t.cascaded.num_deltas, t.cascaded.use_bp) == \
        (j.cascaded.num_rles, j.cascaded.num_deltas, j.cascaded.use_bp)
    _same_tree(t.children, j.children)


def test_options_trees_match_dj_tpu():
    """The auto and none trees field for field: ints compress, the
    incompressible int and the float stay raw, the string compresses
    its sizes child and never its chars; convert reads dj_tpu's tree
    into the same options."""
    jt, tt = _mixed_table()
    jauto = jz.generate_auto_select_compression_options(jt)
    tauto = tj.generate_auto_select_compression_options(tt)
    _same_tree(tauto, jauto)
    assert [o.method for o in tauto] == ["cascaded", "cascaded", "none", "none", "cascaded",
                                         "none"]
    assert tauto[5].children[0].method == "cascaded" and tauto[5].children[1].method == "none"
    _same_tree(tj.generate_none_compression_options(tt),
               jz.generate_none_compression_options(jt))
    assert convert.compression_options_from(jauto) == tauto
    assert convert.compression_options_from(None) is None


def test_broadcast_is_the_identity_in_one_process():
    _, tt = _mixed_table()
    opts = tj.generate_auto_select_compression_options(tt)
    assert tj.broadcast_compression_options(opts) is opts
    assert tz._decode(tz._encode(opts[5]), 0) == (opts[5], len(tz._encode(opts[5])))


def test_broadcast_gives_every_process_rank_0s_tree(tmp_path):
    """A gloo world of 2 processes (tests/torch_world_worker.py, case
    "compress"): each rank samples its own shard, so the trees differ
    before the broadcast; after it both hold rank 0's, and a shuffle_on
    over the world with it equals the world in one process's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    worker = ROOT / "tests" / "torch_world_worker.py"
    outs = cs.spawn_world(2, [str(worker), json.dumps({"cases": ["compress"]}), str(tmp_path)],
                          timeout=120, env={"OMP_NUM_THREADS": "1"}, cwd=ROOT)
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r}: {out[-2000:]}\n{err[-4000:]}"
    res = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())["compress"] for r in range(2)]
    assert res[0]["local"] != res[1]["local"]
    assert res[0]["agreed"] == res[1]["agreed"] == res[0]["local"]
    spec_w = importlib.util.spec_from_file_location("torch_world_worker", worker)
    W = importlib.util.module_from_spec(spec_w)
    spec_w.loader.exec_module(W)
    want = W.compress_shuffle(tj.make_topology(["cpu"] * 2), res[0]["agreed"])
    for r in range(2):
        got = res[r]["shuffle"]
        assert got["counts"] == [want["counts"][r]] and got["rows"] == [want["rows"][r]]
        assert got["overflow"] == want["overflow"] and got["stats"] == want["stats"]
    assert not any(want["overflow"]) and all(v > 0 for v in want["stats"]["comp_actual_bytes"])


# --- the codec on the wire -----------------------------------------------


def _as_tables(arrays, names):
    """(dj_tpu table, port table): a string entry is a list of bytes."""
    jcols, tcols = [], []
    for a, nm in zip(arrays, names):
        if nm == "string":
            jcols.append(jT.from_strings(a))
            tcols.append(tj.from_strings(a, device="cpu"))
        else:
            jcols.append(jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(nm)))
            tcols.append(tj.Column(torch.from_numpy(np.asarray(a)), tj.dtypes.by_name(nm)))
    return jT.Table(tuple(jcols)), tj.Table(tuple(tcols))


def _shard_rows(table, counts):
    """Each shard's valid rows (strings as bytes), sorted."""
    counts = np.asarray(counts).tolist()
    w = len(counts)
    fixed = [np.asarray(c.data) for c in table.columns if not hasattr(c, "chars")]
    cap = fixed[0].shape[0] // w
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


def _listed(d):
    return {k: np.asarray(v).tolist() for k, v in d.items()}


def _shuffle_arrays(w, strings=False, hot=False):
    """96 rows a rank: a key in [0, 1e6), a row id, a small-range int32,
    a float; with ``strings`` a string column, with ``hot`` one row in
    three on one key."""
    rng = np.random.default_rng(70 + w)
    n = 96 * w
    keys = rng.integers(0, 10**6, n)
    if hot:
        keys[::3] = 424242
    arrays = [keys, np.arange(n, dtype=np.int64), rng.integers(0, 50, n).astype(np.int32),
              rng.standard_normal(n).astype(np.float32)]
    if strings:
        arrays.append([b"s" * int(k % 9) for k in keys])
    names = ["int64", "int64", "int32", "float32"] + (["string"] if strings else [])
    return arrays, names


def _compressed_shuffle(w, intra, arrays, names, axes, opts=None, wire_factor=None, **kw):
    """shuffle_on in both packages over ``axes`` in turn with the auto
    options of the table (every cascaded slot at ``wire_factor`` when
    given): the last call's results, (dj_tpu, port)."""
    jtopo = jmake_topology(jax.devices()[:w], intra_size=intra)
    ttopo = tj.make_topology(["cpu"] * w, intra_size=intra)
    jt, tt = _as_tables(arrays, names)
    jopts = jz.generate_auto_select_compression_options(jt) if opts is None else opts
    if wire_factor is not None:
        jopts = _with_wire_factor(jopts, wire_factor)
    topts = convert.compression_options_from(jopts)
    (jt, jc), (tt, tc) = jshard(jtopo, jt), tj.shard_table(ttopo, tt)
    for axis in axes:
        jg = None if axis is None else jtopo.group(axis)
        tg = None if axis is None else ttopo.group(axis)
        akw = {"seed": tdist.INTER_DOMAIN_SEED, **kw} if axis == "inter" else kw
        jres = dj_tpu.shuffle_on(jtopo, jt, jc, [0], group=jg, compression=jopts, **akw)
        tres = tj.shuffle_on(ttopo, tt, tc, [0], group=tg, compression=topts, **akw)
        (jt, jc), (tt, tc) = jres[:2], tres[:2]
    return jres, tres, jopts


def _with_wire_factor(opts, wf):
    import dataclasses

    def one(o):
        ch = tuple(one(c) for c in o.children)
        if o.method == jz.METHOD_CASCADED:
            return dataclasses.replace(o, wire_factor=wf, children=ch)
        return dataclasses.replace(o, children=ch)

    return tuple(one(o) for o in opts)


def _assert_same_shuffle(jres, tres, rows=True):
    assert tres[1].tolist() == np.asarray(jres[1]).tolist()
    assert tres[2].tolist() == np.asarray(jres[2]).tolist()
    for jx, tx in zip(jres[3:], tres[3:]):  # the stats and split dicts
        assert set(tx) == set(jx)
        for k in jx:
            assert tx[k].dtype == (torch.float32 if k.startswith("comp") else torch.bool), k
            assert tx[k].tolist() == np.asarray(jx[k]).tolist(), k
    if rows:
        assert _shard_rows(tres[0], tres[1]) == _shard_rows(jres[0], jres[1])


@pytest.mark.parametrize("strings", [False, True])
@pytest.mark.parametrize("how", ["flat", "per_axis"])
@pytest.mark.parametrize("w", [4, 8])
def test_compressed_shuffle_on_matches_dj_tpu(w, how, strings):
    """shuffle_on with the auto options over the world, or over 'inter'
    then 'intra' at intra 2: counts, overflow, the split bits, the three
    counters (nonzero, float32, exactly dj_tpu's) and each shard's rows;
    with a string column its sizes ride the codec."""
    intra, axes = (None, [None]) if how == "flat" else (2, ["inter", "intra"])
    arrays, names = _shuffle_arrays(w, strings)
    jres, tres, opts = _compressed_shuffle(w, intra, arrays, names, axes, with_stats=True,
                                           with_split_overflow=True, bucket_factor=3.0)
    assert opts[0].method == "cascaded" and opts[3].method == "none"
    if strings:
        assert opts[4].children[0].method == "cascaded"
    _assert_same_shuffle(jres, tres)
    assert not tres[2].any()
    stats = tres[3]
    assert all(bool((stats[k] > 0).all()) for k in tshuffle.STAT_KEYS)
    assert bool((stats["comp_actual_bytes"] <= stats["comp_wire_bytes"]).all())


@pytest.mark.parametrize("how", ["flat", "inter"])
def test_tight_wire_sets_the_bucket_bit_as_dj_tpu(how):
    """A wire_factor of 0.02 on every cascaded slot: the wire overflows
    on the same shards in both packages, as a bucket overflow, with the
    same counters."""
    intra, axes = (None, [None]) if how == "flat" else (2, ["inter"])
    arrays, names = _shuffle_arrays(4)
    jres, tres, _ = _compressed_shuffle(4, intra, arrays, names, axes, wire_factor=0.02,
                                        with_stats=True, with_split_overflow=True)
    _assert_same_shuffle(jres, tres, rows=False)
    assert tres[4]["bucket"].any() and not tres[4]["out"].any()


@pytest.mark.parametrize("axis", [None, "inter"])
def test_compressed_shuffle_on_auto_heals_as_dj_tpu(axis, monkeypatch):
    """shuffle_on_auto from 1.2 / 1.2 with one row in three on one key
    and a wire_factor of 0.2: the same attempts, final factors and rows
    as dj_tpu's."""
    intra = None if axis is None else 2
    jtopo = jmake_topology(jax.devices()[:4], intra_size=intra)
    ttopo = tj.make_topology(["cpu"] * 4, intra_size=intra)
    arrays, names = _shuffle_arrays(4, hot=True)
    jt, tt = _as_tables(arrays, names)
    jopts = _with_wire_factor(jz.generate_auto_select_compression_options(jt), 0.2)
    topts = convert.compression_options_from(jopts)
    (jt, jc), (tt, tc) = jshard(jtopo, jt), tj.shard_table(ttopo, tt)
    kw = lambda topo: {} if axis is None else {"group": topo.group(axis)}  # noqa: E731
    calls = {"j": 0, "t": 0}
    for key, mod in (("j", jshuffle), ("t", tshuffle)):
        orig = mod.shuffle_on

        def counted(*a, _fn=orig, _k=key, **k):
            calls[_k] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, "shuffle_on", counted)
    jres = jshuffle.shuffle_on_auto(jtopo, jt, jc, [0], compression=jopts, with_stats=True,
                                    **kw(jtopo))
    tres = tshuffle.shuffle_on_auto(ttopo, tt, tc, [0], compression=topts, with_stats=True,
                                    **kw(ttopo))
    monkeypatch.undo()
    assert calls["t"] == calls["j"] > 1
    assert tres[3:5] == tuple(jres[3:5]) and tres[3] > 1.2
    _assert_same_shuffle(jres[:3] + jres[5:], tres[:3] + tres[5:])


# --- the two-level join, compressed --------------------------------------


def _join_tables():
    """Probe (int64 key, int64 row, float32 payload) JOIN build (int64
    key, int64 row + 7), selectivity 0.3."""
    rng = np.random.default_rng(7)
    build, probe = host_build_probe_keys(3000, 4000, 0.3, rng, dtype=np.dtype("int64"))
    return ([build, np.arange(3000, dtype=np.int64) + 7],
            [probe, np.arange(4000, dtype=np.int64), rng.standard_normal(4000).astype(np.float32)])


class _World:
    """The join tables sharded over a two-level world of w ranks in both
    packages, with each side's auto options."""

    def __init__(self, w, intra, build, probe):
        self.jtopo = jmake_topology(jax.devices()[:w], intra_size=intra)
        self.ttopo = tj.make_topology(["cpu"] * w, intra_size=intra)
        self.j, self.t, self.opts = {}, {}, {}
        for side, arrays in (("build", build), ("probe", probe)):
            jt, tt = _as_tables(arrays, [a.dtype.name for a in arrays])
            self.opts[side] = jz.generate_auto_select_compression_options(jt)
            self.j[side] = jshard(self.jtopo, jt)
            self.t[side] = tj.shard_table(self.ttopo, tt)

    def config(self, **kw):
        return dj_tpu.JoinConfig(left_compression=self.opts["probe"],
                                 right_compression=self.opts["build"], **kw)

    def join(self, pkg, cfg, auto=False):
        topo, sides = (self.jtopo, self.j) if pkg is dj_tpu else (self.ttopo, self.t)
        if pkg is tj:
            cfg = convert.join_config_from(cfg)
        (l, lc), (r, rc) = sides["probe"], sides["build"]
        fn = pkg.distributed_inner_join_auto if auto else pkg.distributed_inner_join
        return fn(topo, l, lc, r, rc, [0], [0], cfg)


def _assert_same_join(got, want, rows=True):
    tout, tcounts, tinfo = got[:3]
    jout, jcounts, jinfo = want[:3]
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    assert list(tinfo) == list(jinfo)
    for k in jinfo:
        assert tinfo[k].dtype == (torch.float32 if k.startswith("pre_shuffle_comp")
                                  else torch.bool), k
    assert _listed(tinfo) == _listed(jinfo)
    if rows:
        assert _shard_rows(tout, tcounts) == _shard_rows(jout, jcounts)


@pytest.fixture(scope="module")
def join_world():
    build, probe = _join_tables()
    worlds = {}

    def get(w, intra):
        if (w, intra) not in worlds:
            worlds[(w, intra)] = _World(w, intra, build, probe)
        return worlds[(w, intra)]

    return get


@pytest.mark.parametrize("odf", [1, 4])
@pytest.mark.parametrize("w,intra", TOPOLOGIES)
def test_compressed_two_level_join_matches_dj_tpu(w, intra, odf, join_world):
    """Both sides' pre-shuffle through the codec: counts, every flag, the
    three pre_shuffle_comp_* counters (the two tables summed) and each
    shard's rows equal to dj_tpu's, and the join's exact count."""
    world = join_world(w, intra)
    cfg = world.config(over_decom_factor=odf)
    want, got = world.join(dj_tpu, cfg), world.join(tj, cfg)
    _assert_same_join(got, want)
    info = got[2]
    assert not any(bool(v.any()) for k, v in info.items() if not k.startswith("pre_shuffle_comp"))
    assert all(bool((info[f"pre_shuffle_{k}"] > 0).all()) for k in tshuffle.STAT_KEYS)
    build, probe = _join_tables()
    assert int(got[1].sum()) == int(np.isin(probe[0], build[0]).sum())


def test_compression_keys_follow_dj_tpus_truthiness(join_world):
    """Only one side compressed still adds the counters; an empty options
    tuple adds none, as in dj_tpu; a flat topology reports zeros."""
    world = join_world(4, 2)
    cfg = dj_tpu.JoinConfig(left_compression=world.opts["probe"])
    _assert_same_join(world.join(tj, cfg), world.join(dj_tpu, cfg))
    for kw in ({"left_compression": world.opts["probe"]}, {"right_compression": ()},
               {"left_compression": ()}, {}):
        cfg = dj_tpu.JoinConfig(**kw)
        tcfg = convert.join_config_from(cfg)
        assert tdist._flag_keys(tcfg) == jdist._flag_keys(cfg)
        assert tdist._prep_flag_keys(tcfg) == jdist._prep_flag_keys(cfg)
        assert tdist._prepared_flag_keys(tcfg) == jdist._prepared_flag_keys(cfg)
    build, probe = _join_tables()
    flat = _World(4, None, build, probe)
    cfg = flat.config()
    got = flat.join(tj, cfg)
    _assert_same_join(got, flat.join(dj_tpu, cfg))
    assert all(got[2][f"pre_shuffle_{k}"].tolist() == [0.0] * 4 for k in tshuffle.STAT_KEYS)


def test_tight_wire_in_the_pre_shuffle_heals_as_dj_tpu(join_world):
    """A wire_factor of 0.05 on both sides fires pre_shuffle_overflow;
    distributed_inner_join_auto grows the same factors in the same
    attempts as dj_tpu's and ends with the same rows."""
    world = join_world(4, 2)
    cfg = dj_tpu.JoinConfig(left_compression=_with_wire_factor(world.opts["probe"], 0.05),
                            right_compression=_with_wire_factor(world.opts["build"], 0.05))
    got, want = world.join(tj, cfg), world.join(dj_tpu, cfg)
    _assert_same_join(got, want, rows=False)
    assert got[2]["pre_shuffle_overflow"].any()
    attempts = {}
    for pkg, mod in ((dj_tpu, jdist), (tj, tdist)):
        orig = mod.distributed_inner_join
        n = []

        def counted(*a, _fn=orig, _n=n, **k):
            _n.append(1)
            return _fn(*a, **k)

        mod.distributed_inner_join = counted
        try:
            attempts[pkg.__name__] = (world.join(pkg, cfg, auto=True), len(n))
        finally:
            mod.distributed_inner_join = orig
    (jres, jn), (tres, tn) = attempts["dj_tpu"], attempts["dj_tpu_torch"]
    assert tn == jn > 1
    _assert_same_join(tres, jres)
    for f in tdist._CONFIG_FACTOR_FIELDS:
        assert getattr(tres[3], f) == getattr(jres[3], f), f


def test_compressed_prepared_side_matches_dj_tpu(monkeypatch):
    """prepare_join_side with right_compression (the build side's
    pre-shuffle compressed) equal to dj_tpu's batch for batch, and a
    query with left_compression under each merge tier equal to dj_tpu's;
    the info keys are _prep_flag_keys' and _prepared_flag_keys'."""
    rng = np.random.default_rng(5)
    nb, nl = 600, 900
    span = 3 * nb
    bk = np.concatenate([[0, span - 1], rng.permutation(np.arange(1, span - 1))[: nb - 2]])
    build = [bk.astype(np.int64), np.arange(nb, dtype=np.int64) + 10**6]
    probe = [rng.integers(0, span, nl).astype(np.int64), np.arange(nl, dtype=np.int64)]
    world = _World(4, 2, build, probe)
    cfg = world.config()
    tcfg = convert.join_config_from(cfg)
    assert tdist._prep_flag_keys(tcfg) == jdist._prep_flag_keys(cfg)
    assert tdist._prepared_flag_keys(tcfg) == jdist._prepared_flag_keys(cfg)
    jr, jrc = world.j["build"]
    tr, trc = world.t["build"]
    try:
        jprep = jdist.prepare_join_side(world.jtopo, jr, jrc, [0], cfg, tier="shuffle",
                                        left_capacity=nl)
        tprep = tj.prepare_join_side(world.ttopo, tr, trc, [0], tcfg, left_capacity=nl)
        assert tuple(tprep.sizing) == tuple(jprep.sizing)
        for (tw, tp, tc), (jw, jp, jc) in zip(tprep.batches, jprep.batches):
            assert tc.tolist() == np.asarray(jc).tolist()
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int64))
        (jl, jlc), (tl, tlc) = world.j["probe"], world.t["probe"]
        want = dj_tpu.distributed_inner_join(world.jtopo, jl, jlc, jprep, None, [0], None, cfg)
        assert int(np.asarray(want[1]).sum()) == int(np.isin(probe[0], build[0]).sum())
        assert list(want[2]) == list(tdist._prepared_flag_keys(tcfg))
        for tier in ("sort", "merge", "probe"):
            monkeypatch.setenv("DJT_JOIN_MERGE", tier)
            got = tj.distributed_inner_join(world.ttopo, tl, tlc, tprep, None, [0], None, tcfg)
            _assert_same_join(got, want)
            assert bool((got[2]["pre_shuffle_comp_actual_bytes"] > 0).all())
    finally:
        jdist._build_prepared_query_fn.cache_clear()


def test_warmup_compression_runs_on_the_cpu():
    tj.warmup_compression(device="cpu")
    tj.warmup_compression(itemsize=4, bucket_rows=100, device="cpu")


def test_chip_smoke_compressed_phases_rehearse_on_cpu(monkeypatch, capsys):
    """chip_smoke's phase 4g (the codec card-vs-plain at a small bucket),
    4e compressed and 4f compressed at 8000 rows on CPU tables: the
    card's calls stubbed, the kernels' wrappers made to count their
    plain calls, every check of the phases run as on the card."""
    import importlib.util
    import types

    from dj_tpu_torch.ops import join as tjoin, merge, scan

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name, fn in (("synchronize", lambda *a, **k: None),
                     ("reset_peak_memory_stats", lambda *a, **k: None),
                     ("max_memory_allocated", lambda *a, **k: 0),
                     ("memory_allocated", lambda *a, **k: 0),
                     ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    counters = [("join_scans", scan, "launches"), ("merge_sorted_u64", merge, "launches")] + [
        (name, expand, c) for name, c in cs.EXPAND_COUNTERS.items()]
    for name, module, counter in counters:
        real = getattr(tjoin, name)

        def counted(*a, _real=real, _m=module, _c=counter, **k):
            setattr(_m, _c, getattr(_m, _c) + 1)
            return _real(*a, **k)

        monkeypatch.setattr(tjoin, name, counted)
    real_ranks = tz.expand_ranks

    def ranks_counted(*a, **k):
        # On the card only the card's calls launch: 4g's CPU references
        # run in worker threads.
        if threading.current_thread() is threading.main_thread():
            expand.ranks_launches += 1
        return real_ranks(*a, **k)

    monkeypatch.setattr(tz, "expand_ranks", ranks_counted)
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, reps: fn() is None or 0.0)
    cpu = torch.device("cpu")
    codec = cs.check_codec(cpu, 4, 3000, 0, "cpu", time_rows=2000)
    assert codec["cascades"] == 8 and codec["max_abs_err"] == 0
    assert codec["expand_ranks_launches"] > 0
    rows = 8000
    gen = torch.Generator().manual_seed(0)
    build, probe, expected = tj.generate_build_probe_tables(
        gen, rows, rows, 0.3, 2 * rows, True, return_expected_matches=True)
    one = tj.make_topology(["cpu"])
    (l1, lc1), (r1, rc1) = tj.shard_table(one, probe), tj.shard_table(one, build)
    ref = cs.sorted_rows(*tj.distributed_inner_join(one, l1, lc1, r1, rc1, [0], [0])[:2])
    dj = types.SimpleNamespace(**{k: getattr(tj, k) for k in tj.__all__})
    launches = cs.run_two_level_compressed(dj, cpu, build, probe, int(expected), ref, rows, "cpu")
    assert launches["compressed"][1]["expand_ranks"] == 0  # FoR alone: no RLE decode
    assert launches["compressed"][1]["join_scans"] == cs.WORLD
    shuffled = cs.run_shuffle_on(dj, cpu, rows, 0, "cpu")
    cs.run_shuffle_on_compressed(dj, cpu, rows, 0, "cpu", shuffled)
    out = capsys.readouterr().out
    for line in ("[codec]", "[codec_time]", "[two_level_compressed]",
                 "[two_level_compressed_auto]", "[two_level_compressed_prepared]",
                 "[shuffle_on_compressed]", "[shuffle_on_compressed_auto]"):
        assert line in out

"""dj_tpu_torch's in-process world and bucketed shuffle vs numpy and dj_tpu.

The InProcessCommunicator's collectives at 2, 3, 4 and 8 ranks against
numpy; ``bucketize``, ``compact`` and ``interval_of_arange`` against
dj_tpu's, element for element; ``shuffle_tables`` at 2, 4 and 8 ranks,
fused and not, on tables of every fixed-width dtype, against dj_tpu's
under ``shard_map`` on the 8-device CPU mesh, leaf for leaf (data with
its padding, totals, counts and both overflow bits); ``shard_table`` at a
world of 3 against dj_tpu's; and ``run_spmd``'s failure handling.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import search as jsearch
from dj_tpu.core import table as jT
from dj_tpu.parallel import all_to_all as ja2a
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.utils import compat
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.core import search as tsearch
from dj_tpu_torch.parallel import all_to_all as ta2a
from dj_tpu_torch.parallel import spmd
from dj_tpu_torch.parallel.communicator import WorldAborted


def _rank_threads():
    return [t for t in threading.enumerate() if t.name.startswith("dj_tpu_torch-rank-")]


def _ranked(a: np.ndarray) -> torch.Tensor:
    """A [w, ...] array as run_spmd's sharded argument: rank r gets a[r]."""
    return torch.from_numpy(a).reshape((-1,) + a.shape[2:]) if a.ndim > 2 else torch.from_numpy(a)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_in_process_collectives_match_numpy(n):
    rng = np.random.default_rng(n)
    topo = tj.make_topology(["cpu"] * n)
    x = rng.integers(-(2**40), 2**40, (n, n, 5, 3))  # rank r sends x[r, p] to peer p
    g = rng.integers(-100, 100, (n, 9)).astype(np.int32)
    f = rng.standard_normal((n, 4))

    def body(comm, xr, gr, fr):
        assert comm.size == n and xr.shape == (n, 5, 3)
        return (
            comm.all_to_all(xr),
            comm.all_gather(gr[0]),
            comm.all_reduce_max(fr[0])[None],
            comm.all_reduce_sum(gr[0])[None],
            comm.communicate_sizes(gr[0, :n])[None],
            torch.tensor([comm.rank()]),
        )

    a2a, gathered, mx, sm, sizes, ranks = spmd.run_spmd(topo, body, _ranked(x), _ranked(g), _ranked(f))
    np.testing.assert_array_equal(a2a.reshape(n, n, 5, 3).numpy(), x.swapaxes(0, 1))
    np.testing.assert_array_equal(gathered.reshape(n, n, 9).numpy(), np.broadcast_to(g, (n, n, 9)))
    np.testing.assert_array_equal(mx.numpy(), np.broadcast_to(f.max(0), (n, 4)))
    np.testing.assert_array_equal(sm.numpy(), np.broadcast_to(g.sum(0), (n, 9)))
    assert sm.dtype == sizes.dtype == torch.int32
    np.testing.assert_array_equal(sizes.numpy(), g[:, :n].T)
    assert ranks.tolist() == list(range(n))
    assert not _rank_threads()


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_in_process_exchange_matches_numpy(n, fuse):
    """exchange of mixed-dtype buffers: each result is its buffer's
    all_to_all (the transpose of the rank and peer axes)."""
    rng = np.random.default_rng(10 + n)
    topo = tj.make_topology(["cpu"] * n)
    bufs = [
        rng.integers(-(2**62), 2**62, (n, n, 6)),
        rng.integers(-(2**31), 2**31, (n, n, 4, 3)).astype(np.int32),
        rng.integers(0, 2**62, (n, n, 2)),
        rng.standard_normal((n, n, 5)).astype(np.float32),
        rng.integers(0, 2**15, (n, n, 1)).astype(np.int32),
    ]

    def body(comm, *rank_bufs):
        assert comm.fuse_columns is fuse
        return tuple(comm.exchange(rank_bufs))

    outs = spmd.run_spmd(topo, body, *[_ranked(b) for b in bufs], fuse_columns=fuse)
    for b, o in zip(bufs, outs):
        assert o.dtype == torch.from_numpy(b).dtype
        np.testing.assert_array_equal(o.reshape(b.shape).numpy(), b.swapaxes(0, 1))


@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("dtype", [np.int64, np.int8, np.int32])
def test_bucketize_compact_match_dj_tpu(dtype, k):
    """Counts past the bucket and rows past the data's end fill with 0 in
    bucketize; counts past the bucket read on in compact, and slots past
    the total are 0, both as in dj_tpu."""
    rng = np.random.default_rng(k * 7 + np.dtype(dtype).itemsize)
    info = np.iinfo(dtype)
    shape = (50,) if k == 0 else (50, k)
    data = rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)
    starts = np.array([0, 3, 20, 45, 49], np.int32)
    counts = np.array([3, 0, 25, 9, 1], np.int32)  # 25 > bucket; 45 + 9 > 50
    for bucket in (1, 8, 30):
        want = ja2a.bucketize(jnp.asarray(data), jnp.asarray(starts), jnp.asarray(counts), bucket)
        got = ta2a.bucketize(torch.from_numpy(data), torch.from_numpy(starts),
                             torch.from_numpy(counts), bucket)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    buckets = rng.integers(info.min, info.max, (4, 6) + shape[1:], dtype=dtype, endpoint=True)
    for recv in ([6, 0, 2, 5], [0, 0, 0, 0], [7, 1, 6, 6]):  # 7 > bucket reads on
        recv = np.array(recv, np.int32)
        for out_cap in (1, 10, 30):
            want, wtotal = ja2a.compact(jnp.asarray(buckets), jnp.asarray(recv), out_cap)
            got, gtotal = ta2a.compact(torch.from_numpy(buckets), torch.from_numpy(recv), out_cap)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert int(gtotal) == int(wtotal) and gtotal.dtype == torch.int32


@pytest.mark.parametrize("sizes,length", [([0, 3, 0, 5, 2], 13), ([4], 9), ([0, 0, 7], 5),
                                          ([1, 1, 1, 1, 1, 1, 1, 1], 3)])
def test_interval_of_arange_matches_dj_tpu(sizes, length):
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n = len(sizes)
    want = jsearch.interval_of_arange(jnp.asarray(offsets), length, n)
    got = tsearch.interval_of_arange(torch.from_numpy(offsets), length, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# Every fixed-width dtype a Column takes.
DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32", "float32", "float64", "int64",
          "uint64")


def _bits(rng, name, size):
    """Random bit patterns of ``name``'s width: negative and top-bit-set
    values, values past the signed range, any float bits."""
    d = np.dtype(dj_tpu.dtypes.by_name(name).physical)
    u = np.dtype(f"uint{8 * d.itemsize}")
    return rng.integers(0, np.iinfo(u).max, size, dtype=u, endpoint=True).view(d)


def _as_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(f"uint{8 * a.dtype.itemsize}")


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_shuffle_tables_match_dj_tpu(n, fuse):
    """Two tables through one epoch (every fixed-width dtype on the
    left, three columns on the right) against dj_tpu's shuffle_tables
    under shard_map on n devices, leaf for leaf. Rank 0 sends most of its
    left rows to peer 1 (bucket_overflow), and the right output capacity
    is a third of its input's (out_overflow)."""
    _shuffle_parity(n, fuse, dj_tpu.XlaCommunicator, tj.XlaCommunicator, {})


@pytest.mark.parametrize("backend", ["ring", "buffered"])
@pytest.mark.parametrize("n", [2, 4])
def test_shuffle_tables_ring_buffered_match_dj_tpu(n, backend):
    """The same epoch under dj_tpu's RingCommunicator and
    BufferedCommunicator (chunks of 5 rows, so every bucket splits)
    against the port's, each with its backend's own fuse default."""
    jcls, tcls, kw = {
        "ring": (dj_tpu.RingCommunicator, tj.RingCommunicator, {}),
        "buffered": (dj_tpu.BufferedCommunicator, tj.BufferedCommunicator, {"chunk_rows": 5}),
    }[backend]
    _shuffle_parity(n, False, jcls, tcls, kw)


def _shuffle_parity(n, fuse, jcls, tcls, kw):
    rng = np.random.default_rng(100 + n + fuse)
    l_cap, r_cap = 48, 30
    bl, br = l_cap * 3 // (2 * n), r_cap * 3 // n
    right_names = ("int64", "uint32", "float32")
    left_cols = [_bits(rng, nm, n * l_cap) for nm in DTYPES]
    right_cols = [_bits(rng, nm, n * r_cap) for nm in right_names]

    def parts(cap, skew):
        starts, counts = [], []
        for r in range(n):
            p = np.full(n, 1.0 / n)
            if skew and r == 0:
                p = np.full(n, 0.02 / (n - 1))
                p[1] = 0.98
            c = rng.multinomial(cap - int(rng.integers(0, 4)), p).astype(np.int32)
            counts.append(c)
            starts.append(np.concatenate([[0], np.cumsum(c)[:-1]]).astype(np.int32))
        return np.concatenate(starts), np.concatenate(counts)

    ls, lc = parts(l_cap, True)
    rs, rc = parts(r_cap, False)
    out_caps = [n * bl, r_cap // 3]

    jtopo = jmake_topology(jax.devices()[:n])
    jcomm = jcls(jtopo.world_group(), fuse_columns=fuse, **kw)
    spec = jtopo.row_spec()

    def jtable(cols, names):
        return jT.Table(tuple(jT.Column(jnp.asarray(c), dj_tpu.dtypes.by_name(nm))
                              for c, nm in zip(cols, names)))

    @jax.jit
    @functools.partial(compat.shard_map, mesh=jtopo.mesh, in_specs=(spec,) * 6, out_specs=spec)
    def jrun(lt, rt, a, b, c, d):
        res = ja2a.shuffle_tables(jcomm, [lt, rt], [a, c], [b, d], [bl, br], out_caps)
        return tuple(
            (t.with_count(None), t.count()[None], tot[None], ovf[None],
             st[ja2a.OVF_BUCKET][None], st[ja2a.OVF_OUT][None])
            for t, tot, ovf, st in res
        )

    want = jrun(jtable(left_cols, DTYPES), jtable(right_cols, right_names),
                *(jnp.asarray(v) for v in (ls, lc, rs, rc)))

    ttopo = tj.make_topology(["cpu"] * n)

    def body(comm, lt, rt, a, b, c, d):
        res = ta2a.shuffle_tables(comm, [lt, rt], [a, c], [b, d], [bl, br], out_caps)
        return tuple(
            (t.with_count(None), t.count().reshape(1), tot.reshape(1), ovf.reshape(1),
             st[ta2a.OVF_BUCKET].reshape(1), st[ta2a.OVF_OUT].reshape(1))
            for t, tot, ovf, st in res
        )

    got = spmd.run_spmd(
        ttopo, body,
        convert.table_from_numpy(left_cols, DTYPES, device="cpu"),
        convert.table_from_numpy(right_cols, right_names, device="cpu"),
        *(torch.from_numpy(v) for v in (ls, lc, rs, rc)),
        communicator_cls=functools.partial(tcls, **kw), fuse_columns=fuse,
    )
    for t, names in ((0, DTYPES), (1, right_names)):
        gtab, *gvec = got[t]
        wtab, *wvec = want[t]
        for i, nm in enumerate(names):
            g, w = gtab.columns[i].data, wtab.columns[i].data
            assert str(g.dtype).removeprefix("torch.") == nm
            np.testing.assert_array_equal(_as_bits(g.numpy()), _as_bits(w), err_msg=f"{t} {nm}")
        for name, g, w in zip(("count", "total", "overflow", OVF_B, OVF_O), gvec, wvec):
            assert g.tolist() == np.asarray(w).tolist(), (t, name)
    assert got[0][4].tolist()[0] and not all(got[0][4].tolist())  # bucket_overflow on rank 0
    assert all(got[1][5].tolist())  # out_overflow on every rank


OVF_B, OVF_O = ta2a.OVF_BUCKET, ta2a.OVF_OUT


def test_shard_table_matches_dj_tpu():
    """A world of 3 over 10 rows: shards of 4, 3 and 3 rows, padded to a
    common capacity, as in dj_tpu; unshard_table inverts it."""
    rng = np.random.default_rng(3)
    names = ("int64", "uint16", "float32")
    cols = [_bits(rng, nm, 10) for nm in names]
    jt = jT.Table(tuple(jT.Column(jnp.asarray(c), dj_tpu.dtypes.by_name(nm))
                        for c, nm in zip(cols, names)))
    jtopo = jmake_topology(jax.devices()[:3])
    ttopo = tj.make_topology(["cpu"] * 3)
    tt = convert.table_from_numpy(cols, names, device="cpu")
    for cap in (None, 6):
        js, jc = jshard(jtopo, jt, capacity_per_shard=cap)
        ts, tc = tj.shard_table(ttopo, tt, capacity_per_shard=cap)
        assert tc.tolist() == np.asarray(jc).tolist() == [4, 3, 3]
        for g, w in zip(ts.columns, js.columns):
            np.testing.assert_array_equal(_as_bits(g.data.numpy()), _as_bits(w.data))
        back = tj.unshard_table(ts, tc)
        for g, c in zip(back.columns, cols):
            np.testing.assert_array_equal(_as_bits(g.data.numpy()), _as_bits(c))
    with pytest.raises(ValueError, match="capacity 3 < needed 4"):
        tj.shard_table(ttopo, tt, capacity_per_shard=3)


def test_run_spmd_reraises_a_rank_failure():
    """A rank that raises aborts the world: the ranks waiting at the next
    collective wake, and the caller gets the failing rank's exception."""
    topo = tj.make_topology(["cpu"] * 4)

    def body(comm, x):
        comm.all_gather(x)
        if comm.rank() == 2:
            raise ValueError("rank two failed")
        comm.all_gather(x)
        return x

    with pytest.raises(ValueError, match="rank two failed") as err:
        spmd.run_spmd(topo, body, torch.zeros(4))
    assert "raised on rank 2 of 4" in err.value.__notes__
    assert not _rank_threads()


def test_run_spmd_raises_when_a_collective_cannot_complete():
    """A rank that returns while its peers wait at a collective."""
    topo = tj.make_topology(["cpu"] * 3)

    def body(comm, x):
        if comm.rank() != 1:
            comm.all_reduce_sum(x)
        return x

    with pytest.raises(RuntimeError, match=r"returned") as err:
        spmd.run_spmd(topo, body, torch.zeros(3))
    assert not isinstance(err.value, WorldAborted)
    assert not _rank_threads()


@pytest.mark.parametrize("w", [1, 2])
def test_record_phases_times_each_part(w):
    """Each rank's time by phase: the shuffle's three parts (bucketize,
    the exchange's copies, compact) apart from the partition and the
    join; one rank's world copies its one peer's rows in dj_exchange."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 500, 400)
    t = convert.table_from_numpy([keys, np.arange(400)], ["int64", "int64"], device="cpu")
    topo = tj.make_topology(["cpu"] * w)
    s, c = tj.shard_table(topo, t)
    with spmd.record_phases() as runs:
        tj.distributed_inner_join(topo, s, c, s, c, [0], [0], tj.JoinConfig(over_decom_factor=2))
    tj.distributed_inner_join(topo, s, c, s, c, [0], [0])  # outside the block: not timed
    assert len(runs) == 1 and len(runs[0]) == w
    want = {"dj_partition", "dj_join", "dj_concat"}
    want |= {"a2a_bucketize", "a2a_exchange", "a2a_compact"} if w > 1 else {"dj_exchange"}
    for phases in runs[0]:
        assert want <= set(phases) and all(v >= 0 for v in phases.values())


def test_make_topology_limits():
    assert tj.make_topology(["cpu"] * 5).world_size == 5
    with pytest.raises(NotImplementedError, match="process world"):
        tj.make_topology(["cpu", "cuda:0"])
    two = tj.make_topology(["cpu"] * 2, intra_size=1)
    assert two.is_hierarchical and two.axis_names == ("inter", "intra")
    assert (two.group("inter").size, two.group("intra").size) == (2, 1)
    with pytest.raises(ValueError, match="not divisible"):
        tj.make_topology(["cpu"] * 6, intra_size=4)


@pytest.mark.parametrize("w", [1, 2])
def test_pipeline_issues_next_exchange_before_the_join(w, monkeypatch):
    """Batch b+1's exchange is issued before batch b's join (dj_tpu's
    software pipeline), on the unprepared join and the prepared query;
    the rows are those of dj_tpu's serial reference, the world in one
    rank at odf 1."""
    from dj_tpu_torch.parallel.communicator import Communicator

    order = []
    real = Communicator.phase

    def phase(self, label):
        if self.rank() == 0 and label in ("dj_exchange", "dj_join"):
            order.append(label)
        real(self, label)

    monkeypatch.setattr(Communicator, "phase", phase)
    rng = np.random.default_rng(11)
    keys = rng.permutation(3000)[:1200]
    t = convert.table_from_numpy([keys, np.arange(1200)], ["int64", "int64"], device="cpu")
    topo = tj.make_topology(["cpu"] * w)
    s, c = tj.shard_table(topo, t)
    want = tj.distributed_inner_join(tj.make_topology(["cpu"]), *tj.shard_table(
        tj.make_topology(["cpu"]), t), *tj.shard_table(tj.make_topology(["cpu"]), t), [0], [0])
    order.clear()
    cfg = tj.JoinConfig(over_decom_factor=3, key_range=(0, 3000))
    out, counts, _ = tj.distributed_inner_join(topo, s, c, s, c, [0], [0], cfg)
    pipelined = ["dj_exchange", "dj_exchange", "dj_join", "dj_exchange", "dj_join", "dj_join"]
    assert order == pipelined
    got = sorted(map(tuple, np.stack([col.data.numpy() for col in
                                      tj.unshard_table(out, counts).columns], 1).tolist()))
    ref = sorted(map(tuple, np.stack([col.data.numpy() for col in
                                      tj.unshard_table(want[0], want[1]).columns], 1).tolist()))
    assert got == ref and len(got) == 1200
    prep = tj.prepare_join_side(topo, s, c, [0], cfg)
    order.clear()
    tj.distributed_inner_join(topo, s, c, prep, None, [0], None, cfg)
    assert order == pipelined


# --- string columns through the world --------------------------------------


def _rank_strings(rng, n, cap, max_len):
    """A sharded string column of n ranks (cap rows a rank, random
    lengths and bytes), as shard_table lays it out: offsets [n * (cap +
    1)], chars [n * ccap]; and the per-rank byte counts."""
    ccap = cap * max_len
    offs, chars = [], []
    for _ in range(n):
        sz = rng.integers(0, max_len + 1, cap)
        o = np.concatenate([[0], np.cumsum(sz)]).astype(np.int32)
        c = np.zeros(ccap, np.uint8)
        c[: o[-1]] = rng.integers(0, 256, o[-1])
        offs.append(o)
        chars.append(c)
    return np.concatenate(offs), np.concatenate(chars)


@pytest.mark.parametrize("case", ["default", "char_bucket", "char_out"])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_string_shuffle_matches_dj_tpu(n, fuse, case):
    """Two tables with string columns through one epoch (the sizes in
    the 4-byte class, the chars in their own buffers) against dj_tpu's
    shuffle_tables under shard_map, leaf for leaf: keys, offsets, every
    byte of chars, counts, totals and both overflow bits. "char_bucket"
    gives the right table's strings a char bucket of 8 bytes (a
    bucket_overflow), "char_out" the left's an output of 16 bytes (an
    out_overflow); the row buckets fit in both."""
    rng = np.random.default_rng(200 + 3 * n + fuse)
    l_cap, r_cap = 24, 18
    bl, br = l_cap, r_cap  # a whole rank's rows fit one bucket
    lkeys = rng.integers(-(2**62), 2**62, n * l_cap)
    l_str = _rank_strings(rng, n, l_cap, 9)
    r_str = _rank_strings(rng, n, r_cap, 13)
    rpay = rng.integers(0, 2**31, n * r_cap).astype(np.int32)

    def parts(cap):
        starts, counts = [], []
        for _ in range(n):
            c = rng.multinomial(cap - int(rng.integers(0, 3)), np.full(n, 1.0 / n)).astype(np.int32)
            counts.append(c)
            starts.append(np.concatenate([[0], np.cumsum(c)[:-1]]).astype(np.int32))
        return np.concatenate(starts), np.concatenate(counts)

    ls, lc = parts(l_cap)
    rs, rc = parts(r_cap)
    cbb = [None, {0: 8}] if case == "char_bucket" else None
    cob = [{1: 16}, None] if case == "char_out" else None
    out_caps = [n * bl, n * br]

    jtopo = jmake_topology(jax.devices()[:n])
    jcomm = dj_tpu.XlaCommunicator(jtopo.world_group(), fuse_columns=fuse)
    spec = jtopo.row_spec()

    @jax.jit
    @functools.partial(compat.shard_map, mesh=jtopo.mesh, in_specs=(spec,) * 6, out_specs=spec)
    def jrun(lt, rt, a, b, c, d):
        res = ja2a.shuffle_tables(jcomm, [lt, rt], [a, c], [b, d], [bl, br], out_caps,
                                  char_bucket_bytes=cbb, char_out_bytes=cob)
        return tuple(
            (t.with_count(None), t.count()[None], tot[None], ovf[None],
             st[ja2a.OVF_BUCKET][None], st[ja2a.OVF_OUT][None])
            for t, tot, ovf, st in res
        )

    jl = jT.Table((jT.Column(jnp.asarray(lkeys), dj_tpu.dtypes.int64),
                   jT.StringColumn(*map(jnp.asarray, l_str))))
    jr = jT.Table((jT.StringColumn(*map(jnp.asarray, r_str)),
                   jT.Column(jnp.asarray(rpay), dj_tpu.dtypes.int32)))
    want = jrun(jl, jr, *(jnp.asarray(v) for v in (ls, lc, rs, rc)))

    def body(comm, lt, rt, a, b, c, d):
        res = ta2a.shuffle_tables(comm, [lt, rt], [a, c], [b, d], [bl, br], out_caps,
                                  char_bucket_bytes=cbb, char_out_bytes=cob)
        return tuple(
            (t.with_count(None), t.count().reshape(1), tot.reshape(1), ovf.reshape(1),
             st[OVF_B].reshape(1), st[OVF_O].reshape(1))
            for t, tot, ovf, st in res
        )

    tl = convert.table_from_numpy([lkeys, l_str], ["int64", "string"], device="cpu")
    tr = convert.table_from_numpy([r_str, rpay], ["string", "int32"], device="cpu")
    got = spmd.run_spmd(tj.make_topology(["cpu"] * n), body, tl, tr,
                        *(torch.from_numpy(v) for v in (ls, lc, rs, rc)), fuse_columns=fuse)
    for t in range(2):
        gtab, *gvec = got[t]
        wtab, *wvec = want[t]
        for g, w in zip(gtab.columns, wtab.columns):
            if isinstance(g, tj.StringColumn):
                np.testing.assert_array_equal(g.offsets.numpy(), np.asarray(w.offsets))
                np.testing.assert_array_equal(g.chars.numpy(), np.asarray(w.chars))
            else:
                np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        for name, g, w in zip(("count", "total", "overflow", OVF_B, OVF_O), gvec, wvec):
            assert g.tolist() == np.asarray(w).tolist(), (t, name)
    bucket_bits = got[1][4].tolist() + got[0][4].tolist()
    out_bits = got[0][5].tolist() + got[1][5].tolist()
    assert any(bucket_bits) == (case == "char_bucket")
    assert any(out_bits) == (case == "char_out")


def _string_world_tables(rng, key_kind):
    """Probe (key, row id, string payload) and build (key, build
    string): int64 keys with string payloads both sides, or string keys
    ("key-<k>") with a string payload on the probe side."""
    nb, npr = 600, 800
    bk = rng.permutation(np.arange(2 * nb))[:nb]
    pk = np.where(rng.random(npr) < 0.5, bk[rng.integers(0, nb, npr)],
                  rng.integers(2 * nb, 4 * nb, npr))
    pstr = [bytes([97 + int(k) % 26]) * (int(k) % 7 + 1) for k in pk]
    bstr = [b"b%d" % k for k in bk]
    if key_kind == "string":
        probe = [[b"key-%d" % k for k in pk], np.arange(npr, dtype=np.int64), pstr]
        build = [[b"key-%d" % k for k in bk], bk * 10 + 3]
        return probe, ["string", "int64", "string"], build, ["string", "int64"]
    probe = [pk, np.arange(npr, dtype=np.int64), pstr]
    build = [bk, bstr]
    return probe, ["int64", "int64", "string"], build, ["int64", "string"]


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


def _shard_string_rows(table, counts, to_strings):
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


@pytest.mark.parametrize("key_kind", ["int64", "string"])
@pytest.mark.parametrize("odf", [1, 2])
@pytest.mark.parametrize("w", [1, 4])
def test_string_distributed_join_matches_dj_tpu(w, odf, key_kind):
    """String payloads on both sides, or a string key, through the
    partition, the two-buffer shuffle, the join and the concatenation:
    counts, every flag and each shard's rows (strings included) equal to
    dj_tpu's, shard for shard; string-key rows sit on the shard of their
    key's _string_hash."""
    from dj_tpu_torch.ops import hashing as thash
    from dj_tpu_torch.parallel.dist_join import MAIN_JOIN_SEED

    rng = np.random.default_rng(40 + w + odf)
    probe, pnames, build, bnames = _string_world_tables(rng, key_kind)
    jp, tp = _as_tables(probe, pnames)
    jb, tb = _as_tables(build, bnames)
    jtopo, ttopo = jmake_topology(jax.devices()[:w]), tj.make_topology(["cpu"] * w)
    cfg = dj_tpu.JoinConfig(over_decom_factor=odf, bucket_factor=4.0, join_out_factor=2.0,
                            char_out_factor=2.0)
    jout, jcounts, jinfo = dj_tpu.distributed_inner_join(
        jtopo, *jshard(jtopo, jp), *jshard(jtopo, jb), [0], [0], cfg)
    tout, tcounts, tinfo = tj.distributed_inner_join(
        ttopo, *tj.shard_table(ttopo, tp), *tj.shard_table(ttopo, tb), [0], [0],
        convert.join_config_from(cfg))
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        assert tinfo[k].tolist() == np.asarray(jinfo[k]).tolist(), k
        assert not tinfo[k].any(), k
    assert _shard_string_rows(tout, tcounts, tj.to_strings) == \
        _shard_string_rows(jout, jcounts, jT.to_strings)
    pkeys = probe[0] if key_kind == "int64" else [int(s[4:]) for s in probe[0]]
    assert int(tcounts.sum()) == int(np.isin(pkeys, np.asarray(
        build[0] if key_kind == "int64" else [int(s[4:]) for s in build[0]])).sum())
    if key_kind == "string" and w > 1:
        cap = tout.capacity // w
        ocap = tout.columns[0].chars.shape[0] // w
        for r, n in enumerate(tcounts.tolist()):
            col = tj.StringColumn(tout.columns[0].offsets[r * (cap + 1):(r + 1) * (cap + 1)],
                                  tout.columns[0].chars[r * ocap:(r + 1) * ocap])
            h = thash._string_hash(col, MAIN_JOIN_SEED)[:n]
            assert bool((h % (w * odf) % w == r).all())


def test_string_shard_table_matches_dj_tpu():
    """A world of 3 over 10 rows with a string column: offsets rebased
    per shard and held past its rows, chars padded to the largest
    shard's bytes or a declared capacity; unshard_table inverts it."""
    rng = np.random.default_rng(9)
    strs = [rng.integers(0, 256, int(k)).astype(np.uint8).tobytes()
            for k in rng.integers(0, 6, 10)]
    keys = np.arange(10, dtype=np.int64)
    jt, tt = _as_tables([keys, strs], ["int64", "string"])
    jtopo, ttopo = jmake_topology(jax.devices()[:3]), tj.make_topology(["cpu"] * 3)
    for cap, ccap in ((None, None), (6, 40)):
        js, jc = jshard(jtopo, jt, capacity_per_shard=cap, char_capacity_per_shard=ccap)
        ts, tc = tj.shard_table(ttopo, tt, capacity_per_shard=cap, char_capacity_per_shard=ccap)
        assert tc.tolist() == np.asarray(jc).tolist() == [4, 3, 3]
        np.testing.assert_array_equal(ts.columns[1].offsets.numpy(), np.asarray(js.columns[1].offsets))
        np.testing.assert_array_equal(ts.columns[1].chars.numpy(), np.asarray(js.columns[1].chars))
        back = tj.unshard_table(ts, tc)
        assert tj.to_strings(back.columns[1]) == strs
    with pytest.raises(ValueError, match="char capacity 1 <"):
        tj.shard_table(ttopo, tt, char_capacity_per_shard=1)

"""One process of a dj_tpu_torch process world, for the tests.

Run as ``python tests/torch_world_worker.py <spec json> <out dir>`` with
the DJT_* variables of a process world (``chip_smoke.spawn_world`` sets
them). The process joins a gloo world of CPU ranks, runs the cases the
spec names and pickles its rank's results to ``<out dir>/rank<r>.pkl``;
``tests/test_torch_process_world.py`` reads them. It imports torch,
numpy and dj_tpu_torch only: a spawned child must not load JAX. The
inputs come from the functions below, made from fixed seeds with numpy,
so the test builds the same ones for dj_tpu and for a world in one
process.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import pickle
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import dj_tpu_torch as dj  # noqa: E402
from dj_tpu_torch import convert  # noqa: E402
from dj_tpu_torch.data.generator import host_build_probe_keys  # noqa: E402
from dj_tpu_torch.parallel import all_to_all as a2a  # noqa: E402
from dj_tpu_torch.parallel import spmd  # noqa: E402

# Every fixed-width dtype a Column takes.
DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32", "float32", "float64", "int64",
          "uint64")
BACKENDS = {"xla": dj.XlaCommunicator, "buffered": dj.BufferedCommunicator,
            "ring": dj.RingCommunicator}
CHUNK_ROWS = 2  # the Buffered backend's chunk in the collective cases
# The backends of the collective cases: Buffered cut into CHUNK_ROWS rows.
SMALL_BACKENDS = {**BACKENDS, "buffered": functools.partial(dj.BufferedCommunicator,
                                                            chunk_rows=CHUNK_ROWS)}
# (backend, fuse_columns) of the shuffle case; None is the backend's default.
SHUFFLE_RUNS = (("xla", True), ("xla", False), ("ring", None), ("buffered", None))
# (odf, DJT_JOIN_EXPAND mode, backend) of the join case.
JOIN_RUNS = tuple((odf, mode, "xla") for odf in (1, 4) for mode in ("vmeta", "ranks")) + tuple(
    (odf, "vmeta", b) for odf in (1, 4) for b in ("ring", "buffered"))
TIERS = ("sort", "merge", "probe")


def bits(rng, name: str, size) -> np.ndarray:
    """Random bit patterns of ``name``'s width (negative, top-bit-set,
    any float bits)."""
    d = np.dtype(dj.dtypes.by_name(name).physical)
    u = np.dtype(f"uint{8 * d.itemsize}")
    return rng.integers(0, np.iinfo(u).max, size, dtype=u, endpoint=True).view(d)


def collective_inputs(n: int) -> dict:
    """[n, ...] arrays, rank r's part at index r: ``x`` rank r sends x[r, p]
    to peer p; the others feed all_gather and all_reduce."""
    rng = np.random.default_rng(n)
    return {
        "x": rng.integers(-(2**40), 2**40, (n, n, 5, 3)),
        "u64": bits(rng, "uint64", (n, n, 4)),
        "i16": bits(rng, "int16", (n, n, 3, 2)),
        "b": rng.random((n, n, 7)) < 0.5,
        "g": rng.integers(-100, 100, (n, 9)).astype(np.int32),
        "f": rng.standard_normal((n, 4)),
        "u64r": bits(rng, "uint64", (n, 6)),
    }


def exchange_buffers(n: int) -> list:
    rng = np.random.default_rng(10 + n)
    return [
        rng.integers(-(2**62), 2**62, (n, n, 6)),
        rng.integers(-(2**31), 2**31, (n, n, 4, 3)).astype(np.int32),
        bits(rng, "uint64", (n, n, 2)),
        rng.standard_normal((n, n, 5)).astype(np.float32),
        bits(rng, "uint16", (n, n, 3)),
        rng.random((n, n, 1)) < 0.5,
        rng.integers(0, 2**15, (n, n, 1)).astype(np.int32),
    ]


def shuffle_inputs(n: int) -> dict:
    """Two tables through one epoch: every fixed-width dtype on the left,
    three columns on the right; rank 0 sends most of its left rows to
    peer 1 (bucket_overflow) and the right output capacity is a third of
    its input's (out_overflow)."""
    rng = np.random.default_rng(100 + n)
    l_cap, r_cap = 48, 30
    right_names = ("int64", "uint32", "float32")

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

    left = [bits(rng, nm, n * l_cap) for nm in DTYPES]
    right = [bits(rng, nm, n * r_cap) for nm in right_names]
    ls, lc = parts(l_cap, True)
    rs, rc = parts(r_cap, False)
    bl, br = l_cap * 3 // (2 * n), r_cap * 3 // n
    return {"left": left, "right": right, "right_names": right_names, "ls": ls, "lc": lc,
            "rs": rs, "rc": rc, "bucket_rows": [bl, br], "out_caps": [n * bl, r_cap // 3]}


def join_tables():
    """Probe (int64 key, int64 row, float32 payload) JOIN build (int64
    key, int64 row + 7), selectivity 0.3."""
    rng = np.random.default_rng(7)
    build, probe = host_build_probe_keys(3000, 4000, 0.3, rng, dtype=np.dtype("int64"))
    return ([build, np.arange(3000, dtype=np.int64) + 7],
            [probe, np.arange(4000, dtype=np.int64), rng.standard_normal(4000).astype(np.float32)])


def prepared_tables(seed: int, nb: int = 2400, nl: int = 3600):
    """Build keys unique in [0, 3 nb) with both ends present."""
    rng = np.random.default_rng(seed)
    span = 3 * nb
    build = np.concatenate([[0, span - 1], rng.permutation(np.arange(1, span - 1))[: nb - 2]])
    probe = rng.integers(0, span, nl)
    return ([build.astype(np.int64), np.arange(nb, dtype=np.int64) + 10**6],
            [probe.astype(np.int64), np.arange(nl, dtype=np.int64)])


# The auto case: duplicate keys overflow join_out_factor 1; the prepared
# side's probe keys reach past its build keys.
AUTO_CONFIG = dict(over_decom_factor=1, bucket_factor=8.0, join_out_factor=1.0)
PREPARED_AUTO_CONFIG = dict(over_decom_factor=2, bucket_factor=4.0, join_out_factor=4.0)
FACTOR_FIELDS = ("bucket_factor", "join_out_factor", "char_out_factor")


def auto_tables():
    """(build, probe) of the auto join: 8 keys, 1024 rows each side."""
    rng = np.random.default_rng(11)
    return ([rng.integers(0, 8, 1024), np.arange(1024, dtype=np.int64)],
            [rng.integers(0, 8, 1024), np.arange(1024, dtype=np.int64) + 5])


def prepared_auto_tables():
    """(build, probe): build keys in [0, 100), probe keys in [0, 4000)."""
    rng = np.random.default_rng(12)
    return ([rng.integers(0, 100, 1024), np.arange(1024, dtype=np.int64)],
            [rng.integers(0, 4000, 1024), np.arange(1024, dtype=np.int64)])


def key_tables() -> dict:
    """name -> (build arrays, names, probe arrays, names, key columns) of
    the keys case: float64 keys with -0.0, NaN, +-inf and subnormals; two
    int32 key columns (a probed range packs them); an int16 probe key
    against an int64 build key; uint64 keys past 2^63."""
    rng = np.random.default_rng(21)
    tiny = np.finfo(np.float64).smallest_subnormal
    pool = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, tiny, -tiny, 1.5, -2.5, 7.0])
    out = {"float64": ([pool[rng.integers(0, 10, 700)]], ["float64"],
                       [pool[rng.integers(0, 10, 900)]], ["float64"], [0])}
    b = rng.integers(0, 5000, 800)
    p = rng.integers(0, 5000, 1000)
    out["two_int32"] = ([(b >> 6).astype(np.int32), (b & 63).astype(np.int32)], ["int32"] * 2,
                        [(p >> 6).astype(np.int32), (p & 63).astype(np.int32)], ["int32"] * 2,
                        [0, 1])
    out["int16_int64"] = ([rng.integers(-300, 300, 800)], ["int64"],
                          [rng.integers(-300, 300, 1000).astype(np.int16)], ["int16"], [0])
    out["uint64"] = ([b.astype(np.uint64) + np.uint64(2**63)], ["uint64"],
                     [p.astype(np.uint64) + np.uint64(2**63)], ["uint64"], [0])
    for name, (ba, bn, pa, pn, on) in out.items():
        out[name] = (ba + [np.arange(len(ba[0]), dtype=np.int64)], bn + ["int64"],
                     pa + [np.arange(len(pa[0]), dtype=np.int64) + 10**6], pn + ["int64"], on)
    return out


KEYS_CONFIG = dict(over_decom_factor=2, bucket_factor=8.0, join_out_factor=64.0)


GENERATE = dict(build_nrows_per_shard=400, probe_nrows_per_shard=600, selectivity=0.3,
                rand_max_per_shard=999, uniq_build_tbl_keys=True, seed=5)
# Overflows on some ranks and not on others, at worlds of 2 and 4.
FLAGS_CONFIG = dict(over_decom_factor=2, bucket_factor=1.0, join_out_factor=0.3)


def str_arrays(strings) -> tuple:
    """(offsets, chars) numpy pair of a list of byte strings."""
    offsets = np.zeros(len(strings) + 1, np.int32)
    np.cumsum([len(x) for x in strings], out=offsets[1:])
    chars = np.frombuffer(b"".join(strings), np.uint8).copy()
    return offsets, chars if chars.size else np.zeros(1, np.uint8)


def string_tables() -> dict:
    """name -> (build arrays, names, probe arrays, names) of the strings
    case: "payload", int64 keys with a string payload on both sides
    (non-ASCII bytes, empty strings); "key", string keys ("key-<k>")
    with an int64 payload each; "auto", each build key probed 3 times,
    so the build side's strings triple in the output."""
    rng = np.random.default_rng(31)
    nb, npr = 500, 700
    bk = rng.permutation(np.arange(2 * nb))[:nb]
    pk = np.where(rng.random(npr) < 0.5, bk[rng.integers(0, nb, npr)],
                  rng.integers(2 * nb, 4 * nb, npr))
    pstr = [bytes([97 + int(k) % 26]) * (int(k) % 7) for k in pk]
    bstr = [("b%d-é" % k).encode() for k in bk]
    rows = np.arange(npr, dtype=np.int64)
    return {
        "payload": ([bk, str_arrays(bstr)], ["int64", "string"],
                    [pk, rows, str_arrays(pstr)], ["int64", "int64", "string"]),
        "key": ([str_arrays([b"key-%d" % k for k in bk]), bk * 10 + 3], ["string", "int64"],
                [str_arrays([b"key-%d" % k for k in pk]), rows], ["string", "int64"]),
        "auto": ([bk, str_arrays(bstr)], ["int64", "string"],
                 [np.repeat(bk, 3), np.arange(3 * nb, dtype=np.int64)], ["int64", "int64"]),
    }


STRINGS_CONFIG = dict(over_decom_factor=2, bucket_factor=4.0, join_out_factor=2.0,
                      char_out_factor=2.0)
STRINGS_AUTO_CONFIG = dict(over_decom_factor=2, bucket_factor=2.0, join_out_factor=4.0)


def shard_rows(table, counts) -> list:
    """Each shard's valid rows, sorted (one shard in a process world)."""
    counts = np.asarray(counts).tolist()
    w = len(counts)
    cap = next(np.asarray(c.data).shape[0] for c in table.columns if not hasattr(c, "chars")) // w
    shards = []
    for r, k in enumerate(counts):
        cols = []
        for c in table.columns:
            if hasattr(c, "chars"):  # a string column, rows as bytes
                offs = np.asarray(c.offsets)[r * (cap + 1) : r * (cap + 1) + k + 1]
                ccap = np.asarray(c.chars).shape[0] // w
                chars = np.asarray(c.chars)[r * ccap : (r + 1) * ccap]
                cols.append([chars[a:b].tobytes() for a, b in zip(offs[:-1], offs[1:])])
            else:
                cols.append(np.asarray(c.data)[r * cap : r * cap + k].tolist())
        shards.append(sorted(zip(*cols)))
    return shards


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _join_result(res) -> dict:
    out, counts, info = res
    return {"rows": shard_rows(out, counts), "counts": counts.tolist(),
            "flags": {k: v.tolist() for k, v in info.items()}}


def case_collectives(topo):
    n, r = topo.world_size, topo.rank
    inp = collective_inputs(n)
    t = {k: torch.from_numpy(v[r]) for k, v in inp.items()}
    out = {}
    for name, cls in SMALL_BACKENDS.items():
        def body(comm):
            return {
                "x": comm.all_to_all(t["x"]), "u64": comm.all_to_all(t["u64"]),
                "i16": comm.all_to_all(t["i16"]), "b": comm.all_to_all(t["b"]),
                "sizes": comm.communicate_sizes(t["g"][:n]),
            }

        res = spmd.run_spmd(topo, body, communicator_cls=cls)
        out[name] = {k: _np(v) for k, v in res.items()}

    def body(comm):
        tr = comm.transport
        return {
            "gather_g": comm.all_gather(t["g"]), "gather_u64": comm.all_gather(t["u64r"]),
            "gather_b": comm.all_gather(t["b"][0]),
            "max_f": comm.all_reduce_max(t["f"]), "sum_g": comm.all_reduce_sum(t["g"]),
            "max_u64": comm.all_reduce_max(t["u64r"]), "sum_u64": comm.all_reduce_sum(t["u64r"]),
            "shift": [tr.shift_start(t["x"][0], s).wait() for s in range(n)],
            "rank": comm.rank(), "transport": tr.name,
        }

    res = spmd.run_spmd(topo, body)
    out["plain"] = {k: ([_np(e) for e in v] if isinstance(v, list) else _np(v))
                    for k, v in res.items()}
    return out


def case_exchange(topo):
    n, r = topo.world_size, topo.rank
    bufs = [torch.from_numpy(b[r]) for b in exchange_buffers(n)]
    out = {}
    for name, cls in SMALL_BACKENDS.items():
        for fuse in (True, False):
            def body(comm):
                got = comm.exchange(bufs)
                started = comm.exchange_start(bufs)
                return got, started.wait()

            got, started = spmd.run_spmd(topo, body, communicator_cls=cls, fuse_columns=fuse)
            out[(name, fuse)] = ([g.numpy() for g in got], [s.numpy() for s in started])
    return out


def case_shuffle(topo):
    n = topo.world_size
    inp = shuffle_inputs(n)
    lt = convert.table_from_numpy(inp["left"], DTYPES, device="cpu")
    rt = convert.table_from_numpy(inp["right"], inp["right_names"], device="cpu")
    blk = {k: torch.from_numpy(inp[k].reshape(n, -1)[topo.rank].copy())
           for k in ("ls", "lc", "rs", "rc")}

    def block(t, cap):
        r = topo.rank
        return dj.Table(tuple(dj.Column(c.data[r * cap : (r + 1) * cap], c.dtype)
                              for c in t.columns))

    lt, rt = block(lt, 48), block(rt, 30)
    out = {}
    for name, fuse in SHUFFLE_RUNS:
        def body(comm):
            res = a2a.shuffle_tables(comm, [lt, rt], [blk["ls"], blk["rs"]],
                                     [blk["lc"], blk["rc"]], inp["bucket_rows"], inp["out_caps"])
            return tuple(
                ([c.data.numpy() for c in t.columns], int(t.count()), int(tot), bool(ovf),
                 bool(st[a2a.OVF_BUCKET]), bool(st[a2a.OVF_OUT]))
                for t, tot, ovf, st in res)

        out[(name, fuse)] = spmd.run_spmd(topo, body, communicator_cls=BACKENDS[name],
                                          fuse_columns=fuse)
    return out


def _sharded(topo, arrays):
    names = [a.dtype.name for a in arrays]
    return dj.shard_table(topo, convert.table_from_numpy(arrays, names, device="cpu"))


def case_join(topo):
    build, probe = join_tables()
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    out = {}
    for odf, mode, backend in JOIN_RUNS:
        os.environ["DJT_JOIN_EXPAND"] = mode
        cfg = dj.JoinConfig(over_decom_factor=odf, communicator_cls=BACKENDS[backend])
        out[(odf, mode, backend)] = _join_result(
            dj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0], cfg))
    os.environ.pop("DJT_JOIN_EXPAND")
    cfg = dj.JoinConfig(**FLAGS_CONFIG)
    out["flags"] = _join_result(dj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0], cfg))
    return out


def case_prepared(topo):
    out = {}
    for odf in (1, 4):
        build, probe = prepared_tables(odf)
        (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
        cfg = dj.JoinConfig(over_decom_factor=odf)
        prep = dj.prepare_join_side(topo, tr, trc, [0], cfg, left_capacity=len(probe[0]))
        batches = [(w.numpy(), [c.data.numpy() for c in p.columns], c.tolist())
                   for w, p, c in prep.batches]
        out[(odf, "prepare")] = {"plan": tuple(prep.plan), "sizing": tuple(prep.sizing),
                                 "key_range": prep.key_range, "batches": batches}
        for tier in TIERS:
            os.environ["DJT_JOIN_MERGE"] = tier
            out[(odf, tier)] = _join_result(
                dj.distributed_inner_join(topo, tl, tlc, prep, None, [0], None, cfg))
        os.environ.pop("DJT_JOIN_MERGE")
    return out


# The append case: odf 2, a declared range, slack for the appended rows.
APPEND_CONFIG = dict(over_decom_factor=2, bucket_factor=4.0, join_out_factor=4.0,
                     key_range=(0, 3 * 600 - 1))
APPEND_ROWS = 48  # appended rows, all on rank 0


def append_rows() -> list:
    """Rank 0's appended rows: keys new to ``prepared_tables(5, 600,
    900)``'s build side and some of its keys."""
    build, _ = prepared_tables(5, 600, 900)
    rng = np.random.default_rng(13)
    new = np.setdiff1d(np.arange(3 * 600), build[0])[: APPEND_ROWS - 8]
    keys = rng.permutation(np.concatenate([new, build[0][:8]])).astype(np.int64)
    return [keys, np.arange(APPEND_ROWS, dtype=np.int64) + 2 * 10**6]


def append_blocks(topo, rank: int):
    """(rows, counts) of the appended rows as a rank's block: the rows on
    rank 0, an empty block of the same capacity on the others."""
    rows = convert.table_from_numpy(append_rows(), ["int64", "int64"], device="cpu")
    n = APPEND_ROWS if rank == 0 else 0
    return rows.with_count(None), torch.tensor([n], dtype=torch.int32)


def append_result(topo, prep, rows, counts, left, lcounts) -> dict:
    """append_to_prepared's batches, flags and touched batches, then a
    query under each merge tier."""
    cfg = dj.JoinConfig(**APPEND_CONFIG)
    new, info = dj.append_to_prepared(topo, prep, rows, counts)
    out = {"touched": info["touched"], "r_cap": new.r_cap,
           "flags": {k: v.tolist() for k, v in info.items() if k != "touched"},
           "batches": [(w.numpy(), [c.data.numpy() for c in p.columns], c.tolist())
                       for w, p, c in new.batches],
           "source_rows": shard_rows(new.right, new.right_counts)}
    for tier in TIERS:
        os.environ["DJT_JOIN_MERGE"] = tier
        out[tier] = _join_result(dj.distributed_inner_join(topo, left, lcounts, new, None, [0],
                                                           None, cfg))
    os.environ.pop("DJT_JOIN_MERGE")
    return out


def case_append(topo):
    """Only rank 0 appends rows: every process merges the same batches."""
    build, probe = prepared_tables(5, 600, 900)
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    cfg = dj.JoinConfig(**APPEND_CONFIG)
    prep = dj.prepare_join_side(topo, tr, trc, [0], cfg, left_capacity=len(probe[0]))
    return append_result(topo, prep, *append_blocks(topo, topo.rank), tl, tlc)


def case_generate(topo):
    b, bc, p, pc = dj.generate_tables_distributed(topo, **GENERATE)
    return {"build": [c.data.numpy() for c in b.columns], "build_counts": bc.tolist(),
            "probe": [c.data.numpy() for c in p.columns], "probe_counts": pc.tolist()}


def _counted_auto(topo, *args, **kw):
    """distributed_inner_join_auto's result and the attempts it ran."""
    from dj_tpu_torch.parallel import dist_join

    attempts = []
    names = ("distributed_inner_join", "_distributed_inner_join_prepared")
    orig = {n: getattr(dist_join, n) for n in names}
    for n, fn in orig.items():
        setattr(dist_join, n, lambda *a, _fn=fn, **k: attempts.append(1) or _fn(*a, **k))
    try:
        res = dj.distributed_inner_join_auto(topo, *args, **kw)
    finally:
        for n, fn in orig.items():
            setattr(dist_join, n, fn)
    out = _join_result(res[:3])
    out["factors"] = {f: getattr(res[3], f) for f in FACTOR_FIELDS}
    out["attempts"] = len(attempts)
    if len(res) == 5:
        out["key_range"] = res[4].key_range
    return out


def case_auto(topo):
    """The heal in a process world: the duplicate blow-up twice (the
    second call a ledger hit), then a prepared side re-prepared for the
    probe keys outside it."""
    build, probe = auto_tables()
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    cfg = dj.JoinConfig(**AUTO_CONFIG)
    out = {"first": _counted_auto(topo, tl, tlc, tr, trc, [0], [0], cfg, growth=8.0),
           "second": _counted_auto(topo, tl, tlc, tr, trc, [0], [0], cfg, growth=8.0)}
    build, probe = prepared_auto_tables()
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    cfg = dj.JoinConfig(**PREPARED_AUTO_CONFIG)
    prep = dj.prepare_join_side(topo, tr, trc, [0], cfg)
    out["prepared"] = _counted_auto(topo, tl, tlc, prep, None, [0], None, cfg)
    out["prepared"]["old_key_range"] = prep.key_range
    return out


def case_fault(topo):
    """A fault armed through DJT_FAULT in every process (the spawning
    test sets join.join_overflow@call=1): the auto join's attempts, heal
    and fault events, pins and rows, then the same join with nothing
    armed (the ledger now starts it at the healed factor)."""
    from dj_tpu_torch import obs
    from dj_tpu_torch.resilience import errors, faults

    build, probe = join_tables()
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    cfg = dj.JoinConfig(over_decom_factor=2, bucket_factor=4.0, join_out_factor=4.0)
    obs.enable()
    obs.drain()
    faulted = _counted_auto(topo, tl, tlc, tr, trc, [0], [0], cfg)
    events = [{k: v for k, v in e.items() if k not in ("seq", "ts")} for e in obs.drain()
              if e["type"] in ("fault", "degrade", "heal")]
    faults.configure("")  # an empty spec arms nothing
    clean = _counted_auto(topo, tl, tlc, tr, trc, [0], [0], cfg)
    return {"attempts": faulted["attempts"], "clean_attempts": clean["attempts"],
            "rows": faulted["rows"], "clean_rows": clean["rows"], "flags": faulted["flags"],
            "events": events, "pinned": errors.pinned_tiers()}


def case_peer_fails(topo):
    """Under an active tier (the spawning test sets DJT_PLAN_ADAPT=1),
    rank 1's first join attempt raises before its ranks start, while
    rank 0 goes on into the join's collectives. In a process world the
    ladder retries only an injected fault: rank 1 reports its failure
    with no pin and no degrade event, and rank 0 fails in its collective
    instead of pairing it with a retry."""
    from dj_tpu_torch.parallel import dist_join
    from dj_tpu_torch.resilience import errors

    build, probe = join_tables()
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    dj.obs.enable()
    dj.obs.drain()
    if topo.rank != 1:
        return _join_result(dj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0]))
    real, calls = dist_join._run_join, []

    def fails_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("rank 1 fails on purpose")
        return real(*a, **k)

    dist_join._run_join = fails_once
    try:
        dj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0])
        raised = None
    except RuntimeError as e:
        raised = str(e)
    return {"raised": raised, "calls": len(calls), "pinned": errors.pinned_tiers(),
            "degrades": [e for e in dj.obs.drain() if e["type"] == "degrade"]}


def case_keys(topo):
    """The distributed join on each of key_tables()'s key kinds; a kind
    the join refuses (keys of two widths) gives {"raised": message}."""
    out = {}
    for name, (ba, bn, pa, pn, on) in key_tables().items():
        (tl, tlc) = dj.shard_table(topo, convert.table_from_numpy(pa, pn, device="cpu"))
        (tr, trc) = dj.shard_table(topo, convert.table_from_numpy(ba, bn, device="cpu"))
        try:
            out[name] = _join_result(dj.distributed_inner_join(topo, tl, tlc, tr, trc, on, on,
                                                               dj.JoinConfig(**KEYS_CONFIG)))
        except ValueError as e:
            out[name] = {"raised": str(e)}
    return out


def case_strings(topo):
    """String payloads and string keys through the join under the
    default, Ring and Buffered backends (chars as uint8 on the wire;
    Buffered cuts every bucket into CHUNK_ROWS rows, or bytes), then the
    char_overflow heal."""
    out = {}
    tables = string_tables()
    for name in ("payload", "key"):
        ba, bn, pa, pn = tables[name]
        (tl, tlc) = dj.shard_table(topo, convert.table_from_numpy(pa, pn, device="cpu"))
        (tr, trc) = dj.shard_table(topo, convert.table_from_numpy(ba, bn, device="cpu"))
        for backend in ("xla", "ring", "buffered"):
            cfg = dj.JoinConfig(**STRINGS_CONFIG, communicator_cls=SMALL_BACKENDS[backend])
            out[(name, backend)] = _join_result(
                dj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0], cfg))
    ba, bn, pa, pn = tables["auto"]
    (tl, tlc) = dj.shard_table(topo, convert.table_from_numpy(pa, pn, device="cpu"))
    (tr, trc) = dj.shard_table(topo, convert.table_from_numpy(ba, bn, device="cpu"))
    out["auto"] = _counted_auto(topo, tl, tlc, tr, trc, [0], [0],
                                dj.JoinConfig(**STRINGS_AUTO_CONFIG))
    return out


def plan_tables() -> tuple:
    """(build arrays, names, probe arrays, names) of the plan_adapt case:
    unique int64 build keys with a string payload; 65% of the probe rows
    on one build key, the hot destination about 3x its batch's mean at
    a world of 4."""
    rng = np.random.default_rng(41)
    nb, npr = 800, 1200
    bk = rng.permutation(np.arange(3 * nb))[:nb]
    pk = rng.integers(0, 3 * nb, npr)
    pk[: 13 * npr // 20] = bk[11]
    return ([bk, str_arrays([b"c%d" % (k % 31) for k in bk])], ["int64", "string"],
            [pk, np.arange(npr, dtype=np.int64)], ["int64", "int64"])


# (plan, DJT_* knobs) of the plan_adapt case, each under DJT_PLAN_ADAPT=1.
PLAN_RUNS = (("broadcast", {}), ("salted", {"DJT_BROADCAST_BYTES": "0"}))
PLAN_CONFIG = dict(over_decom_factor=1, bucket_factor=4.0, join_out_factor=2.0,
                   char_out_factor=2.0)


def case_plan_adapt(topo):
    """The broadcast and the salted plan: every process decides on its
    own from the gathered counts and the global side's bytes, then
    joins; each run gives this process's decision and its shard."""
    from dj_tpu_torch.parallel import dist_join

    ba, bn, pa, pn = plan_tables()
    (tl, tlc) = dj.shard_table(topo, convert.table_from_numpy(pa, pn, device="cpu"))
    (tr, trc) = dj.shard_table(topo, convert.table_from_numpy(ba, bn, device="cpu"))
    cfg = dj.JoinConfig(**PLAN_CONFIG)
    out = {}
    for plan, knobs in PLAN_RUNS:
        dj.resilience.ledger.reset()
        os.environ.update(DJT_PLAN_ADAPT="1", **knobs)
        d = dist_join._resolve_plan_decision(topo, tl, tlc, tr, trc, (0,), (0,), cfg)
        out[plan] = {"decision": (d.tier, d.salt, d.replicas, d.ratio, d.source),
                     **_join_result(dj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0],
                                                              cfg))}
        for k in ("DJT_PLAN_ADAPT", *knobs):
            os.environ.pop(k)
    dj.resilience.ledger.reset()
    return out


def pipeline_tables() -> dict:
    """name -> (arrays, names) of the pipeline case: TPC-H Q3's shape
    (customer with a string segment, orders with a string priority,
    lineitem), orders2 keyed on the orderkey (the local chain's right
    side, shuffled by the main seed in the case), a build side ``dim``
    on the custkey and two probe sides of it for the coalesced call."""
    rng = np.random.default_rng(61)
    n_cust, n_ord, n_li = 64, 256, 1024
    okeys = np.arange(n_ord, dtype=np.int64)
    ocust = rng.integers(0, n_cust, n_ord).astype(np.int64)
    out = {
        "cust": ([np.arange(n_cust, dtype=np.int64),
                  str_arrays([b"SEG-%d" % s for s in rng.integers(0, 5, n_cust)])],
                 ["int64", "string"]),
        "orders": ([okeys, ocust, str_arrays([b"%d-PRI" % p for p in rng.integers(0, 5, n_ord)])],
                   ["int64", "int64", "string"]),
        "li": ([rng.integers(0, n_ord, n_li).astype(np.int64),
                np.arange(n_li, dtype=np.int64) * 7], ["int64", "int64"]),
        "orders2": ([okeys.copy(), ocust * 10 + 1], ["int64", "int64"]),
        "dim": ([rng.permutation(3 * n_cust)[:2 * n_cust].astype(np.int64),
                 np.arange(2 * n_cust, dtype=np.int64)], ["int64", "int64"]),
    }
    for q in range(2):
        out[f"q{q}"] = ([rng.integers(0, 3 * n_cust, 300).astype(np.int64),
                         np.arange(300, dtype=np.int64) + 1000 * q], ["int64", "int64"])
    return out


PIPELINE_CONFIG = dict(join_out_factor=8.0, bucket_factor=4.0, char_out_factor=32.0)
# (name, stages as (right, left_on, right_on, JoinStage fields)) of the
# pipeline case: Q3 (a shuffle stage, then customer broadcast) and the
# shuffle-then-local chain.
PIPELINES = (
    ("q3", (("orders", (0,), (0,), {"mode": "shuffle"}), ("cust", (2,), (0,), {}))),
    ("local", (("orders", (0,), (0,), {"mode": "shuffle"}),
               ("orders2", (0,), (0,), {"right_partitioned": True}))),
)
COALESCED_CONFIG = dict(key_range=(0, 191), bucket_factor=4.0, join_out_factor=4.0)


def case_pipeline(topo):
    """Both chains of PIPELINES: each process's plan (modes, ranges,
    range sources, output partitioning), its shard and its ``pipeline``
    events and counters (obs on for the chain); then K = 2 coalesced
    queries against a prepared ``dim``."""
    from dj_tpu_torch.parallel.dist_join import MAIN_JOIN_SEED

    t = {name: dj.shard_table(topo, convert.table_from_numpy(a, n, device="cpu"))
         for name, (a, n) in pipeline_tables().items()}
    res = dj.shuffle_on(topo, *t["orders2"], [0], seed=MAIN_JOIN_SEED, out_factor=4.0)
    t["orders2"] = res[:2]
    cfg = dj.JoinConfig(**PIPELINE_CONFIG)
    out = {}
    for name, specs in PIPELINES:
        stages = [dj.JoinStage(right=t[r][0], right_counts=t[r][1], left_on=lo, right_on=ro, **kw)
                  for r, lo, ro, kw in specs]
        plan = dj.plan_pipeline(topo, *t["li"], stages, cfg)
        dj.obs.reset(reenable=True)
        dj.obs.drain()
        o, c, infos = dj.distributed_join_pipeline(topo, *t["li"], stages, cfg, plan=plan)
        events = [{k: v for k, v in e.items() if k not in ("seq", "ts")}
                  for e in dj.obs.drain() if e["type"] == "pipeline"]
        counters = dj.obs.metrics_summary()["counters"]
        dj.obs.reset(reenable=False)
        out[name] = {"plan": [(sp.mode, sp.key_range, sp.range_source, sp.out_partitioned_by)
                              for sp in plan.stage_plans],
                     "rows": shard_rows(o, c), "counts": c.tolist(),
                     "flags": [{k: v.tolist() for k, v in i.items()} for i in infos],
                     "events": events, "counters": counters}
    ccfg = dj.JoinConfig(**COALESCED_CONFIG)
    prep = dj.prepare_join_side(topo, *t["dim"], [0], ccfg, left_capacity=300)
    per_query, _ = dj.distributed_inner_join_coalesced(
        topo, [t["q0"][0], t["q1"][0]], [t["q0"][1], t["q1"][1]], prep, [0], ccfg)
    out["coalesced"] = [_join_result(r) for r in per_query]
    return out


def case_ledger_split(topo):
    """Rank 0 starts from a ledger entry that widens bucket_factor, rank
    1 from none: their exchanges differ in size, and the world must fail
    within the collective timeout instead of hanging."""
    build, probe = auto_tables()
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    cfg = dj.JoinConfig(**AUTO_CONFIG)
    if topo.rank == 0:
        sig = dj.resilience.plan_signature(topo, tl, tr, [0], [0], cfg)
        dj.resilience.ledger.update(sig, factors={"bucket_factor": 64.0})
    return _join_result(dj.distributed_inner_join_auto(topo, tl, tlc, tr, trc, [0], [0], cfg)[:3])


def case_fail(topo):
    """Rank 1 raises before the join; its peers wait in the join's
    collectives until the world fails them."""
    build, probe = join_tables()
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    if topo.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return _join_result(dj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0]))


# The two_level case: (backend, pre_shuffle_out_factor) of its joins at
# intra 2; 0.5 fires pre_shuffle_overflow.
TWO_LEVEL_JOINS = (("xla", 1.5), ("ring", 1.5), ("buffered", 1.5), ("xla", 0.5))
TWO_LEVEL_INTRA = 2


def two_level_shuffle_table(w: int) -> list:
    """The shuffle_on table of the two_level case: 96 rows a rank, one
    row in three on one key."""
    rng = np.random.default_rng(60 + w)
    keys = rng.integers(0, 10**6, 96 * w)
    keys[::3] = 424242
    return [keys, np.arange(96 * w, dtype=np.int64)]


def case_two_level(topo, make=None):
    """The world at intra 2 (each process's subgroups made by
    make_topology): the join under each backend, the tight
    pre-shuffle's flags, its auto heal, and shuffle_on per axis.
    ``make`` builds the topology (the test passes the world in one
    process's)."""
    topo = (make or dj.make_topology)(["cpu"], intra_size=TWO_LEVEL_INTRA)
    build, probe = join_tables()
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    out = {"axes": topo.axis_names, "groups": [topo.group(a).size for a in topo.axis_names]}
    for backend, psof in TWO_LEVEL_JOINS:
        cfg = dj.JoinConfig(communicator_cls=SMALL_BACKENDS[backend], pre_shuffle_out_factor=psof)
        res = _join_result(dj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0], cfg))
        if psof < 1:
            res.pop("rows")  # a fired flag leaves the rows unspecified
        out[(backend, psof)] = res
    res = dj.distributed_inner_join_auto(topo, tl, tlc, tr, trc, [0], [0],
                                         dj.JoinConfig(pre_shuffle_out_factor=0.5))
    out["auto"] = _join_result(res[:3])
    out["auto"]["factors"] = {f: getattr(res[3], f)
                              for f in ("pre_shuffle_out_factor",) + FACTOR_FIELDS}
    t, c = _sharded(topo, two_level_shuffle_table(topo.world_size))
    for axis, seed in zip(topo.axis_names, (87654321, 0)):
        t, c, ovf, split = dj.shuffle_on(topo, t, c, [0], group=topo.group(axis), seed=seed,
                                         with_split_overflow=True)
        out[("shuffle", axis)] = {"rows": shard_rows(t, c), "counts": c.tolist(),
                                  "overflow": ovf.tolist(),
                                  "split": {k: v.tolist() for k, v in split.items()}}
    return out


def compress_table(w: int) -> list:
    """The compress case's table: 200 rows a rank of (key, small int,
    row id), its key range ten times wider on every rank but the first,
    so that each rank's sampled options differ."""
    rng = np.random.default_rng(80 + w)
    keys = np.concatenate([rng.integers(0, 1000 * (10 if r else 1), 200) for r in range(w)])
    return [keys, rng.integers(0, 50, 200 * w).astype(np.int32),
            np.arange(200 * w, dtype=np.int64)]


def compress_shuffle(topo, opts) -> dict:
    """shuffle_on of the compress table over the world with ``opts``."""
    t, c = _sharded(topo, compress_table(topo.world_size))
    t, c, ovf, stats = dj.shuffle_on(topo, t, c, [0], compression=opts, with_stats=True,
                                     bucket_factor=3.0)
    return {"rows": shard_rows(t, c), "counts": c.tolist(), "overflow": ovf.tolist(),
            "stats": {k: v.tolist() for k, v in stats.items()}}


def case_compress(topo):
    """Each rank's auto options from its own block, then
    broadcast_compression_options (rank 0's tree on every rank) and a
    compressed shuffle_on with the agreed options."""
    t, _ = _sharded(topo, compress_table(topo.world_size))
    local = dj.generate_auto_select_compression_options(t)
    agreed = dj.broadcast_compression_options(local)
    return {"local": local, "agreed": agreed, "shuffle": compress_shuffle(topo, agreed)}


def case_fleet(topo):
    """obs.fleet_snapshot after one join with obs on: every process's
    row, gathered over gloo (rank 1 also observes a 5 s dispatch phase,
    so it is the straggler)."""
    from dj_tpu_torch import obs

    build, probe = join_tables()
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    obs.reset(reenable=True)
    dj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0])
    if topo.rank == 1:
        obs.roofline.observe_phase("dispatch", 5.0)
    own = obs.skew.wire_matrix()
    snap = obs.fleet_snapshot(topo)
    out = {"snapshot": snap, "own_wire": own, "view": obs.skew.fleet_view(),
           "summary": obs.skew.rank_skew_summary(),
           "sent": sum(obs.counter_series("dj_collective_bytes_total").values())}
    obs.reset(reenable=False)
    return out


def case_autotune(topo):
    """The chain's tuner (``DJT_AUTOTUNE=1``, odf 1 and 2) in a world of
    processes. Each probe reports its seconds plus 1 s on rank 0's odf 1
    and on rank 1's odf 2, so each process alone would pick another
    winner (``local_pick``) and only the processes' agreement gives one
    plan. Then a second call (no event), and a call after rank 1 forgot
    its ledger while rank 0 kept it: both replay rank 0's record. Each
    call's rows are this process's shard; the untuned chain's come
    first."""
    from dj_tpu_torch import obs
    from dj_tpu_torch.parallel import autotune
    from dj_tpu_torch.parallel import dist_join as tdist

    build, probe = join_tables()
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    b2, b2c, _ = dj.shuffle_on(topo, tr, trc, [0], seed=tdist.MAIN_JOIN_SEED, out_factor=2.5)
    stages = [dj.JoinStage(right=tr, right_counts=trc, left_on=(0,), right_on=(0,),
                           mode="shuffle"),
              dj.JoinStage(right=b2, right_counts=b2c, left_on=(0,), right_on=(0,),
                           right_partitioned=True)]
    cfg = dj.JoinConfig(join_out_factor=2.0)
    out = {"untuned": shard_rows(*dj.distributed_join_pipeline_auto(topo, tl, tlc, stages,
                                                                    cfg)[:2])}
    real, local = tdist.price_plan_candidate, {}

    def skewed(*a, **k):
        price, run = real(*a, **k)
        odf = a[7].over_decom_factor

        def timed():
            s = run() + (1.0 if (odf == 1) == (topo.rank == 0) else 0.0)
            local[odf] = s
            return s

        return price, timed

    tdist.price_plan_candidate = skewed
    os.environ.update(DJT_AUTOTUNE="1", DJT_AUTOTUNE_ODF="1,2")
    try:
        obs.reset(reenable=True)
        obs.drain()
        for call in ("tuned", "again", "replayed"):
            if call == "replayed":
                autotune._clear()
                if topo.rank == 1:
                    dj.resilience.ledger.reset()
            o, c, _, cfgs = dj.distributed_join_pipeline_auto(topo, tl, tlc, stages, cfg)
            out[call] = {"rows": shard_rows(o, c), "odf": [g.over_decom_factor for g in cfgs],
                         "events": [{k: v for k, v in e.items() if k not in ("seq", "ts")}
                                    for e in obs.drain() if e["type"] == "tune"]}
        out["local_pick"] = min(local, key=local.get)
    finally:
        tdist.price_plan_candidate = real
        for name in ("DJT_AUTOTUNE", "DJT_AUTOTUNE_ODF"):
            os.environ.pop(name)
        obs.reset(reenable=False)
        dj.resilience.ledger.reset()
    return out


# The per-world output directory (main's), shared by the world's processes.
OUT_DIR = None
INDEX_CONFIG = dict(key_range=(0, 7199))


def case_index(topo):
    """The join-index cache in a world of processes sharing one
    DJT_FLEET_DIR and manifest: a miss (process 0 takes the lease and
    writes the manifest's line) and its query, a hit of the same side,
    each process's budget row under the world's owner, a second cache
    over the same manifest (the world's own record replays: no process
    defers to its own world), then DJT_FAULT=fleet.lease_acquire@call=1
    armed in every process: process 0 consults the site, every process
    pins the fleet tier and the side builds locally."""
    from dj_tpu_torch import obs
    from dj_tpu_torch.cache import IndexConfig, JoinIndexCache
    from dj_tpu_torch.fleet import budget, identity
    from dj_tpu_torch.resilience import errors, faults

    shared = pathlib.Path(OUT_DIR)
    manifest = str(shared / "index_manifest.jsonl")
    os.environ["DJT_FLEET_DIR"] = str(shared / "fleet")
    build, probe = prepared_tables(5)
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    cfg = dj.JoinConfig(**INDEX_CONFIG)
    obs.reset(reenable=True)
    obs.drain()

    def get(cache, **kw):
        return cache.get_or_prepare(topo, tr, trc, [0], cfg, tenant="t", name="n",
                                    left_capacity=3600, **kw)

    def run(side):
        return _join_result(dj.distributed_inner_join(topo, tl, tlc, side, None, [0], None, cfg))

    out = {"pid": os.getpid()}
    try:
        cache = JoinIndexCache(IndexConfig(manifest_path=manifest))
        lease = get(cache)
        out["miss"] = run(lease.prepared)
        with get(cache) as hit:
            out["same_side"] = hit.prepared is lease.prepared
        lease.release()
        out["identity"] = identity()
        budget.publish(100.0, 50.0)
        torch.distributed.barrier()
        out["budget_rows"] = sorted(os.listdir(shared / "fleet" / "budget"))
        out["peer_bytes"] = budget.peer_bytes()
        with get(JoinIndexCache(IndexConfig(manifest_path=manifest))) as again:
            out["replayed"] = run(again.prepared)
        torch.distributed.barrier()
        with open(manifest) as f:
            out["manifest"] = [json.loads(x) for x in f]
        out["leases_left"] = os.listdir(shared / "fleet" / "leases")
        faults.configure("fleet.lease_acquire@call=1")
        with get(JoinIndexCache()) as local:
            out["faulted"] = run(local.prepared)
        out["pins"] = sorted(errors.pinned_tiers())
        out["events"] = [{k: v for k, v in e.items() if k not in ("seq", "ts")}
                         for e in obs.drain() if e["type"] in ("index", "fleet", "degrade")]
        out["counters"] = {n: obs.counter_value(n) for n in
                           ("dj_index_hit_total", "dj_index_miss_total",
                            "dj_fleet_replay_total", "dj_fleet_peer_defer_total")}
    finally:
        faults.reset()
        errors.reset_pins()
        dj.cache.reset()
        dj.fleet.reset()
        dj.resilience.ledger.reset()
        obs.reset(reenable=False)
        os.environ.pop("DJT_FLEET_DIR", None)
    return out


SERVE_CONFIG = dict(over_decom_factor=2, bucket_factor=4.0, join_out_factor=4.0,
                    key_range=(0, 7199))


class _Dev:
    """A card whose allocator holds the whole budget (the measured gate)."""

    id = 0

    def memory_stats(self):
        return {"bytes_in_use": int(16e9), "peak_bytes_in_use": int(16e9),
                "bytes_limit": int(80e9)}


def case_serve(topo):
    """The query scheduler in a world of processes: each decision that
    depends on one process's clock, allocator, fleet view or config is
    taken once for the world. worker=True raises; a measured reject on
    process 1 alone and peer bytes on process 0 alone reject on both,
    with the rejecting process's evidence; a deadline that expired on one
    process's clock only follows process 0's (dispatched, then shed); the
    heal deadline follows process 0's clock; process 0's coalescing
    choice dispatches the group on both; every row on its shard."""
    from dj_tpu_torch import obs
    from dj_tpu_torch.obs import truth
    from dj_tpu_torch.parallel import dist_join
    from dj_tpu_torch.resilience import errors, faults
    from dj_tpu_torch.serve import QueryScheduler, ServeConfig, scheduler

    rank = topo.rank
    build, probe = prepared_tables(5)
    (tl, tlc), (tr, trc) = _sharded(topo, probe), _sharded(topo, build)
    cfg = dj.JoinConfig(**SERVE_CONFIG)
    obs.reset(reenable=True)
    obs.drain()
    out = {}

    def err(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            return e
        return None

    try:
        e = err(lambda: QueryScheduler(ServeConfig(), worker=True))
        out["worker"] = [type(e).__name__, "pump()" in str(e)]
        # A measured reject on process 1 alone.
        with QueryScheduler(ServeConfig(), worker=False) as s:
            real = truth._device_list
            if rank == 1:
                os.environ["DJT_SERVE_MEASURED_HBM"] = "1"
                truth._device_list = lambda: [_Dev()]
            try:
                e = err(lambda: s.submit(topo, tl, tlc, tr, trc, [0], [0], cfg))
            finally:
                truth._device_list = real
                os.environ.pop("DJT_SERVE_MEASURED_HBM", None)
            out["measured"] = [type(e).__name__, (e.measured or {}).get("bytes_in_use"),
                               s.queue_depth]
            # Live peer bytes on process 0 alone.
            real_peer = scheduler._fleet.peer_bytes_guarded
            if rank == 0:
                scheduler._fleet.peer_bytes_guarded = lambda: 1e15
            try:
                e = err(lambda: s.submit(topo, tl, tlc, tr, trc, [0], [0], cfg))
            finally:
                scheduler._fleet.peer_bytes_guarded = real_peer
            out["peer"] = [type(e).__name__, e.reserved_bytes, s.queue_depth]
        # A queued deadline that expired on one process's clock only.
        for late in (1, 0):
            with QueryScheduler(ServeConfig(), worker=False) as s:
                t = s.submit(topo, tl, tlc, tr, trc, [0], [0], cfg, deadline_s=0.3)
                if rank == late:
                    time.sleep(0.6)
                e = err(lambda: t.result(timeout=60))
                out[f"late{late}"] = ([type(e).__name__, e.where] if e is not None
                                      else _join_result(t.result()[:3]))
        # The heal deadline: every attempt overflows; process 1 lags 0.5 s
        # after each attempt, so its clock alone would shed one check
        # before process 0's.
        faults.configure(",".join(f"join.join_overflow@call={i}" for i in range(1, 9)))
        real_spmd = dist_join.run_spmd

        def lagging(*a, **k):
            res = real_spmd(*a, **k)
            time.sleep(0.5)
            return res

        if rank == 1:
            dist_join.run_spmd = lagging
        try:
            with QueryScheduler(ServeConfig(), worker=False) as s:
                t = s.submit(topo, tl, tlc, tr, trc, [0], [0], cfg, deadline_s=0.3)
                e = err(lambda: t.result(timeout=60))
        finally:
            dist_join.run_spmd = real_spmd
            faults.reset()
        out["healing"] = [type(e).__name__, e.where,
                          len([x for x in obs.events("heal")])]
        dj.resilience.ledger.reset()
        # Coalescing chosen by process 0: process 1 alone would not group.
        prep = dj.prepare_join_side(topo, tr, trc, [0], cfg, left_capacity=3600)
        with QueryScheduler(ServeConfig(coalesce=rank == 0), worker=False) as s:
            ts = [s.submit(topo, tl, tlc, prep, None, [0], None, cfg) for _ in range(2)]
            res = [t.result(timeout=60) for t in ts]
            out["coalesced"] = [t.coalesced for t in ts]
            out["group"] = [_join_result(r[:3]) for r in res]
        out["events"] = [{k: v for k, v in x.items()
                          if k not in ("seq", "ts", "queued_s", "run_s", "total_s", "query_id",
                                       "members", "elapsed_s", "t")}
                         for x in obs.drain()
                         if x["type"] in ("admission", "shed", "coalesce", "serve")]
        out["pins"] = sorted(errors.pinned_tiers())
    finally:
        faults.reset()
        errors.reset_pins()
        dj.serve.reset()
        dj.resilience.ledger.reset()
        obs.reset(reenable=False)
    return out


CASES = {"collectives": case_collectives, "exchange": case_exchange, "shuffle": case_shuffle,
         "join": case_join, "prepared": case_prepared, "generate": case_generate,
         "auto": case_auto, "keys": case_keys, "fail": case_fail,
         "ledger_split": case_ledger_split, "strings": case_strings,
         "two_level": case_two_level, "compress": case_compress, "append": case_append,
         "fault": case_fault, "peer_fails": case_peer_fails,
         "plan_adapt": case_plan_adapt, "pipeline": case_pipeline, "fleet": case_fleet,
         "autotune": case_autotune, "index": case_index, "serve": case_serve}


def main(spec_json: str, out_dir: str) -> int:
    global OUT_DIR
    OUT_DIR = out_dir
    spec = json.loads(spec_json)
    torch.set_num_threads(1)
    dj.init_distributed(device="cpu")
    try:
        topo = dj.make_topology(["cpu"])
        results = {"rank": topo.rank, "world": topo.world_size}
        for case in spec["cases"]:
            results[case] = CASES[case](topo)
        with open(pathlib.Path(out_dir) / f"rank{topo.rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))

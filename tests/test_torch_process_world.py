"""dj_tpu_torch's process world (one rank per process, torch.distributed
over gloo) vs numpy, dj_tpu and the world in one process.

Worlds of 2 and 4 CPU processes are started once per module with
``chip_smoke.spawn_world``; each process runs ``tests/torch_world_worker.py``
(torch, numpy and dj_tpu_torch only, since a spawned child must not load
JAX) and pickles its rank's results, and each test below reads them:
the collectives and ``exchange`` under the three backends against numpy;
``distributed_inner_join_auto`` (a heal, a ledger hit, a prepared
re-prepare) against dj_tpu at a world of 2, and a world whose processes
start from different ledger entries failing instead of hanging;
``shuffle_tables`` leaf for leaf against dj_tpu's on the CPU mesh, for
every fixed-width dtype; joins shard for shard against dj_tpu at odf 1
and 4 (vmeta and ranks, and under Ring and Buffered); the prepared side
at a world of 4 in each tier; ``generate_tables_distributed`` against
the world in one process; the flag matrix on every process; and a rank
that raises failing its world within the time limit. Then chip_smoke's
own process-world helpers, rehearsed with gloo at a tiny size.
"""

import concurrent.futures
import functools
import importlib.util
import json
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import table as jT
from dj_tpu.parallel import all_to_all as ja2a
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.utils import compat
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.data import generator as tgen
from dj_tpu_torch.parallel import dist_join as tdist

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(__file__).resolve().parent / "torch_world_worker.py"
TIMEOUT_S = 120  # a world that runs longer is killed and fails its tests
ENV = {"OMP_NUM_THREADS": "1"}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load("torch_world_worker", WORKER)
chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")

WORLDS = (2, 4)
CASES = {2: ["collectives", "exchange", "shuffle", "join", "generate", "auto", "keys", "strings",
             "append", "fleet", "autotune", "index", "serve", "blackbox"],
         4: ["collectives", "exchange", "shuffle", "join", "prepared", "generate", "two_level",
             "plan_adapt", "pipeline"]}


class _Worlds:
    """The spawned worlds, each read once on first use."""

    def __init__(self, tmp_path_factory):
        self.pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS) + 2)
        self.runs = {}
        for key, w, spec, env in [(w, w, {"cases": CASES[w]}, ENV) for w in WORLDS] + [
                (case, 2, {"cases": [case]}, {**ENV, "DJT_COLLECTIVE_TIMEOUT_S": "30"})
                for case in ("fail", "ledger_split")]:
            d = tmp_path_factory.mktemp(f"world_{key}")
            fut = self.pool.submit(chip_smoke.spawn_world, w,
                                   [str(WORKER), json.dumps(spec), str(d)],
                                   timeout=TIMEOUT_S, env=env, cwd=ROOT)
            self.runs[key] = (d, fut)
        self._loaded = {}

    def outcome(self, key):
        return self.runs[key][1].result()

    def results(self, w) -> list:
        if w not in self._loaded:
            d, fut = self.runs[w]
            for r, (rc, out, err) in enumerate(fut.result()):
                assert rc == 0, f"rank {r} of {w} ended with {rc}:\n{out[-2000:]}\n{err[-4000:]}"
            self._loaded[w] = [pickle.loads((d / f"rank{r}.pkl").read_bytes()) for r in range(w)]
        return self._loaded[w]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ws = _Worlds(tmp_path_factory)
    yield ws
    ws.pool.shutdown(wait=True)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(f"uint{8 * a.dtype.itemsize}") if a.dtype != np.bool_ else a


@pytest.mark.parametrize("w", WORLDS)
def test_process_world_collectives_match_numpy(w, worlds):
    inp = W.collective_inputs(w)
    x = inp["x"]
    for r, res in enumerate(worlds.results(w)):
        assert (res["rank"], res["world"]) == (r, w)
        got = res["collectives"]
        for backend in W.BACKENDS:
            g = got[backend]
            for k in ("x", "u64", "i16", "b"):
                np.testing.assert_array_equal(_bits(g[k]), _bits(inp[k][:, r]),
                                              err_msg=f"{backend} {k}")
            np.testing.assert_array_equal(g["sizes"], inp["g"][:, r])
        p = got["plain"]
        assert p["rank"] == r and p["transport"] == "gloo"
        np.testing.assert_array_equal(p["gather_g"], inp["g"])
        np.testing.assert_array_equal(_bits(p["gather_u64"]), _bits(inp["u64r"]))
        np.testing.assert_array_equal(p["gather_b"], inp["b"][:, 0])
        np.testing.assert_array_equal(p["max_f"], inp["f"].max(0))
        np.testing.assert_array_equal(p["sum_g"], inp["g"].sum(0, dtype=np.int32))
        np.testing.assert_array_equal(p["max_u64"], inp["u64r"].max(0))
        np.testing.assert_array_equal(p["sum_u64"], inp["u64r"].sum(0, dtype=np.uint64))
        for s in range(w):
            np.testing.assert_array_equal(p["shift"][s], x[(r - s) % w, 0])


@pytest.mark.parametrize("w", WORLDS)
def test_process_world_exchange_matches_numpy(w, worlds):
    """exchange and exchange_start of mixed-dtype buffers (uint64, uint16
    and bool among them) under each backend, fused and not: each result
    is its buffer's all_to_all."""
    bufs = W.exchange_buffers(w)
    for r, res in enumerate(worlds.results(w)):
        for (backend, fuse), (got, started) in res["exchange"].items():
            for b, g, s in zip(bufs, got, started):
                assert g.dtype == b.dtype == s.dtype
                np.testing.assert_array_equal(_bits(g), _bits(b[:, r]),
                                              err_msg=f"{backend} fuse={fuse}")
                np.testing.assert_array_equal(_bits(s), _bits(b[:, r]))


@functools.lru_cache(maxsize=None)
def _jax_shuffle(n):
    """dj_tpu's shuffle_tables of W.shuffle_inputs(n) on n devices of the
    CPU mesh: per table, (column arrays, counts, totals, overflow,
    bucket overflow, out overflow)."""
    inp = W.shuffle_inputs(n)
    jtopo = jmake_topology(jax.devices()[:n])
    jcomm = dj_tpu.XlaCommunicator(jtopo.world_group())
    spec = jtopo.row_spec()

    def jtable(cols, names):
        return jT.Table(tuple(jT.Column(jnp.asarray(c), dj_tpu.dtypes.by_name(nm))
                              for c, nm in zip(cols, names)))

    @jax.jit
    @functools.partial(compat.shard_map, mesh=jtopo.mesh, in_specs=(spec,) * 6, out_specs=spec)
    def jrun(lt, rt, a, b, c, d):
        res = ja2a.shuffle_tables(jcomm, [lt, rt], [a, c], [b, d], inp["bucket_rows"],
                                  inp["out_caps"])
        return tuple(
            (t.with_count(None), t.count()[None], tot[None], ovf[None],
             st[ja2a.OVF_BUCKET][None], st[ja2a.OVF_OUT][None])
            for t, tot, ovf, st in res
        )

    out = jrun(jtable(inp["left"], W.DTYPES), jtable(inp["right"], inp["right_names"]),
               *(jnp.asarray(inp[k]) for k in ("ls", "lc", "rs", "rc")))
    return [([np.asarray(c.data) for c in t.columns], *(np.asarray(v) for v in vec))
            for t, *vec in out]


@pytest.mark.parametrize("w", WORLDS)
def test_process_world_shuffle_matches_dj_tpu(w, worlds):
    """Each rank's shuffle_tables result, leaf for leaf (data with its
    padding, count, total and both overflow bits), equals shard r of
    dj_tpu's, under each backend."""
    want = _jax_shuffle(w)
    for r, res in enumerate(worlds.results(w)):
        for run, got in res["shuffle"].items():
            for t, (cols, count, total, ovf, b_ovf, o_ovf) in enumerate(got):
                wcols, wcount, wtotal, wovf, wb, wo = want[t]
                for g, c in zip(cols, wcols):
                    cap = c.shape[0] // w
                    np.testing.assert_array_equal(_bits(g), _bits(c[r * cap : (r + 1) * cap]),
                                                  err_msg=f"{run} table {t}")
                assert (count, total, ovf, b_ovf, o_ovf) == (
                    wcount[r], wtotal[r], wovf[r], wb[r], wo[r]), (run, t)
    bucket_ovf = [res["shuffle"][("xla", True)][0][4] for res in worlds.results(w)]
    assert bucket_ovf[0] and not all(bucket_ovf)  # rank 0's bucket overflow only


class _JaxWorld:
    def __init__(self, w, build, probe):
        self.jtopo = jmake_topology(jax.devices()[:w])
        self.j = {}
        for side, arrays in (("build", build), ("probe", probe)):
            jt = dj_tpu.from_arrays(*[jnp.asarray(a) for a in arrays],
                                    dtypes=[dj_tpu.dtypes.by_name(a.dtype.name) for a in arrays])
            self.j[side] = jshard(self.jtopo, jt)


@functools.lru_cache(maxsize=None)
def _jax_join(w, odf):
    world = _JaxWorld(w, *W.join_tables())
    (jl, jlc), (jr, jrc) = world.j["probe"], world.j["build"]
    out = dj_tpu.distributed_inner_join(world.jtopo, jl, jlc, jr, jrc, [0], [0],
                                        dj_tpu.JoinConfig(over_decom_factor=odf))
    return W._join_result((convert.table_from_numpy(
        [np.asarray(c.data) for c in out[0].columns], [c.dtype.name for c in out[0].columns],
        device="cpu"), torch.from_numpy(np.asarray(out[1])),
        {k: torch.from_numpy(np.asarray(v)) for k, v in out[2].items()}))


def _assert_shards(w, results, key, want):
    """Rank r's counts, rows and the whole flag matrix equal shard r of
    ``want``'s."""
    for r, res in enumerate(results):
        got = res[key[0]][key[1]] if isinstance(key, tuple) else res[key]
        assert got["counts"] == [want["counts"][r]], (key, r)
        assert got["rows"] == [want["rows"][r]], (key, r)
        assert got["flags"] == want["flags"], (key, r)


@pytest.mark.parametrize("odf,mode,backend", W.JOIN_RUNS)
@pytest.mark.parametrize("w", WORLDS)
def test_process_world_join_matches_dj_tpu(w, odf, mode, backend, worlds):
    want = _jax_join(w, odf)
    assert not any(any(v) for v in want["flags"].values())
    _assert_shards(w, worlds.results(w), ("join", (odf, mode, backend)), want)


@pytest.fixture
def jax_query_cache_clear():
    yield
    jdist._build_prepared_query_fn.cache_clear()


@pytest.mark.parametrize("odf", [1, 4])
def test_process_world_prepared_matches_dj_tpu(odf, worlds, jax_query_cache_clear):
    """A world of 4 processes: each rank's prepared batches equal shard r
    of dj_tpu's shuffle tier, and each merge tier's query its rows."""
    build, probe = W.prepared_tables(odf)
    world = _JaxWorld(4, build, probe)
    cfg = dj_tpu.JoinConfig(over_decom_factor=odf)
    jr, jrc = world.j["build"]
    jprep = jdist.prepare_join_side(world.jtopo, jr, jrc, [0], cfg, tier="shuffle",
                                    left_capacity=len(probe[0]))
    jl, jlc = world.j["probe"]
    jout = dj_tpu.distributed_inner_join(world.jtopo, jl, jlc, jprep, None, [0], None, cfg)
    want = W._join_result((
        convert.table_from_numpy([np.asarray(c.data) for c in jout[0].columns],
                                 [c.dtype.name for c in jout[0].columns], device="cpu"),
        torch.from_numpy(np.asarray(jout[1])),
        {k: torch.from_numpy(np.asarray(v)) for k, v in jout[2].items()}))
    results = worlds.results(4)
    for r, res in enumerate(results):
        got = res["prepared"][(odf, "prepare")]
        assert got["plan"] == tuple(jprep.plan) and got["sizing"] == tuple(jprep.sizing)
        assert got["key_range"] == tuple(jprep.key_range)
        for (tw, tp, tc), (jw, jp, jc) in zip(got["batches"], jprep.batches):
            assert tc == [np.asarray(jc).tolist()[r]]
            cap = tw.shape[0]
            np.testing.assert_array_equal(tw, np.asarray(jw).view(np.int64)[r * cap : (r + 1) * cap])
            for g, c in zip(tp, jp.columns):
                pc = g.shape[0]
                np.testing.assert_array_equal(g, np.asarray(c.data)[r * pc : (r + 1) * pc])
    for tier in W.TIERS:
        _assert_shards(4, results, ("prepared", (odf, tier)), want)


@pytest.mark.parametrize("w", WORLDS)
def test_process_world_generate_matches_the_world_in_one_process(w, worlds):
    """generate_tables_distributed gives each process the block that rank
    r gets in a world in one process, for the same seed; the join's total
    is the sum of the ranks' exact expected counts."""
    topo = tj.make_topology(["cpu"] * w)
    b, bc, p, pc = tj.generate_tables_distributed(topo, **W.GENERATE)
    nb, npr = W.GENERATE["build_nrows_per_shard"], W.GENERATE["probe_nrows_per_shard"]
    for r, res in enumerate(worlds.results(w)):
        got = res["generate"]
        assert got["build_counts"] == [nb] and got["probe_counts"] == [npr]
        for g, c in zip(got["build"], b.columns):
            np.testing.assert_array_equal(g, c.data[r * nb : (r + 1) * nb].numpy())
        for g, c in zip(got["probe"], p.columns):
            np.testing.assert_array_equal(g, c.data[r * npr : (r + 1) * npr].numpy())
    expected = 0
    for r in range(w):
        gen = torch.Generator().manual_seed(tgen.rank_seed(W.GENERATE["seed"], r))
        expected += int(tj.generate_build_probe_tables(
            gen, nb, npr, W.GENERATE["selectivity"], W.GENERATE["rand_max_per_shard"], True,
            return_expected_matches=True)[2])
    _, counts, info = tj.distributed_inner_join(topo, p, pc, b, bc, [0], [0])
    assert int(counts.sum()) == expected > 0
    assert not any(bool(v.any()) for v in info.values())
    keys_b, keys_p = b.columns[0].data.numpy(), p.columns[0].data.numpy()
    assert int(np.isin(keys_p, keys_b).sum()) == expected
    assert np.unique(b.columns[1].data.numpy()).size == w * nb  # global row ids


@pytest.mark.parametrize("w", WORLDS)
def test_process_world_flag_matrix_is_the_same_on_every_process(w, worlds):
    """A join whose flags fire on some ranks only: every process holds
    the whole [w] flag vectors, equal to the world in one process's."""
    topo = tj.make_topology(["cpu"] * w)
    build, probe = W.join_tables()
    (tl, tlc), (tr, trc) = W._sharded(topo, probe), W._sharded(topo, build)
    want = W._join_result(tj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0],
                                                    tj.JoinConfig(**W.FLAGS_CONFIG)))
    mixed = [v for v in want["flags"].values() if any(v) and not all(v)]
    assert mixed, want["flags"]
    _assert_shards(w, worlds.results(w), ("join", "flags"), want)


@functools.lru_cache(maxsize=None)
def _two_level_in_one_process():
    """The two_level case on a world of 4 ranks in this process: rank r's
    results, shard r of each."""
    topo = tj.make_topology(["cpu"] * 4, intra_size=W.TWO_LEVEL_INTRA)
    return W.case_two_level(topo, make=lambda devices, intra_size: tj.make_topology(
        devices * 4, intra_size=intra_size))


def _shard(res: dict, r: int) -> dict:
    """Shard r's part of one result of the world in one process."""
    return {k: ([v[r]] if k in ("rows", "counts") else v) for k, v in res.items()}


def test_process_world_two_level_matches_the_world_in_one_process(worlds):
    """Four gloo processes at intra 2, every 'inter' and 'intra'
    subgroup a torch.distributed group: the join under the default, Ring
    and Buffered backends, the tight pre-shuffle's flag matrix, its auto
    heal (factors included) and shuffle_on over 'inter' then 'intra'
    give each process shard r of the world in one process, and every
    process the whole flag matrix."""
    want = _two_level_in_one_process()
    assert want["axes"] == ("inter", "intra") and want["groups"] == [2, 2]
    assert all(want[("xla", 0.5)]["flags"]["pre_shuffle_overflow"])
    assert want["auto"]["factors"]["pre_shuffle_out_factor"] > 0.5
    for r, res in enumerate(worlds.results(4)):
        got = res["two_level"]
        assert (got["axes"], got["groups"]) == (want["axes"], want["groups"])
        for key, wres in want.items():
            if key in ("axes", "groups"):
                continue
            assert got[key] == _shard(wres, r), (key, r)
        for axis in ("inter", "intra"):
            assert got[("shuffle", axis)]["overflow"] == [False] * 4


def test_process_world_append_from_one_process(worlds):
    """Two gloo processes, rows appended on process 0 only: the touched
    batches (the gathered per-batch counts), flags, merged batches,
    combined source and each tier's query after the append give each
    process shard r of the same append in a world of 2 in one process."""
    topo = tj.make_topology(["cpu"] * 2)
    build, probe = W.prepared_tables(5, 600, 900)
    (tl, tlc), (tr, trc) = (tj.shard_table(topo, convert.table_from_numpy(
        t, ["int64"] * 2, device="cpu")) for t in (probe, build))
    prep = tj.prepare_join_side(topo, tr, trc, [0], tj.JoinConfig(**W.APPEND_CONFIG),
                                left_capacity=len(probe[0]))
    blocks = [W.append_blocks(topo, r) for r in range(2)]
    rows = tj.Table(tuple(tj.Column(torch.cat([b[0].columns[i].data for b in blocks]),
                                    blocks[0][0].columns[i].dtype) for i in range(2)))
    want = W.append_result(topo, prep, rows, torch.cat([b[1] for b in blocks]), tl, tlc)
    assert want["touched"] == (0, 1) and not any(any(v) for v in want["flags"].values())
    for r, res in enumerate(worlds.results(2)):
        got = res["append"]
        assert got["touched"] == want["touched"] and got["r_cap"] == want["r_cap"]
        assert got["flags"] == want["flags"]
        assert got["source_rows"] == [want["source_rows"][r]]
        for (gw, gp, gc), (ww, wp, wc) in zip(got["batches"], want["batches"]):
            R = gw.shape[0]
            np.testing.assert_array_equal(gw, ww[r * R:(r + 1) * R])
            assert gc == [wc[r]]
            for g, w_ in zip(gp, wp):
                np.testing.assert_array_equal(g[:gc[0]], w_[r * R:r * R + gc[0]])
        for tier in ("sort", "merge", "probe"):
            assert got[tier] == _shard(want[tier], r), (tier, r)


def test_a_rank_that_raises_fails_its_world(worlds):
    """Rank 1 raises before the join; rank 0, waiting in the join's first
    collective, fails too, and both processes end within the time limit
    (spawn_world raises past it) instead of hanging."""
    (rc0, _, err0), (rc1, _, err1) = worlds.outcome("fail")
    assert rc1 != 0 and "rank 1 fails on purpose" in err1
    assert rc0 != 0 and "Traceback" in err0


def _jax_auto(build, probe, cfg, prepared: bool, **kw):
    """dj_tpu's auto join on 2 devices: (result dict, attempts, config,
    prepared side or None)."""
    world = _JaxWorld(2, [np.asarray(a) for a in build], [np.asarray(a) for a in probe])
    (jl, jlc), (jr, jrc) = world.j["probe"], world.j["build"]
    attempts = []
    name = "_distributed_inner_join_prepared" if prepared else "distributed_inner_join"
    orig = getattr(jdist, name)
    setattr(jdist, name, lambda *a, **k: attempts.append(1) or orig(*a, **k))
    try:
        if prepared:
            prep = jdist.prepare_join_side(world.jtopo, jr, jrc, [0], cfg, tier="shuffle")
            res = dj_tpu.distributed_inner_join_auto(world.jtopo, jl, jlc, prep, None, [0], None,
                                                     cfg, **kw)
        else:
            prep = None
            res = dj_tpu.distributed_inner_join_auto(world.jtopo, jl, jlc, jr, jrc, [0], [0], cfg,
                                                     **kw)
    finally:
        setattr(jdist, name, orig)
    out = W._join_result((
        convert.table_from_numpy([np.asarray(c.data) for c in res[0].columns],
                                 [c.dtype.name for c in res[0].columns], device="cpu"),
        torch.from_numpy(np.asarray(res[1])),
        {k: torch.from_numpy(np.asarray(v)) for k, v in res[2].items()}))
    return out, len(attempts), res[3], (prep, res[4]) if prepared else None


def test_process_world_auto_heals_as_dj_tpu(worlds):
    """distributed_inner_join_auto in a gloo world of 2: each process
    takes the same heal as dj_tpu on 2 devices (the same attempts, final
    factors and shard rows), the second call is a ledger hit on attempt
    1, and the prepared side re-prepares under the same widened range."""
    from dj_tpu.resilience import ledger as jledger

    results = worlds.results(2)
    want, n, cfg, _ = _jax_auto(*W.auto_tables(), dj_tpu.JoinConfig(**W.AUTO_CONFIG), False,
                                growth=8.0)
    assert n > 1 and not any(any(v) for v in want["flags"].values())
    factors = {f: getattr(cfg, f) for f in W.FACTOR_FIELDS}
    for key, attempts in (("first", n), ("second", 1)):
        _assert_shards(2, results, ("auto", key), want)
        for res in results:
            assert res["auto"][key]["attempts"] == attempts
            assert res["auto"][key]["factors"] == factors
    jledger.reset()
    want, n, cfg, (jprep, jused) = _jax_auto(
        *W.prepared_auto_tables(), dj_tpu.JoinConfig(**W.PREPARED_AUTO_CONFIG), True)
    _assert_shards(2, results, ("auto", "prepared"), want)
    for res in results:
        got = res["auto"]["prepared"]
        assert got["attempts"] == n == 2
        assert got["old_key_range"] == tuple(jprep.key_range)
        assert got["key_range"] == tuple(jused.key_range) != got["old_key_range"]


def _jax_keys_join(build, probe, on) -> dict:
    """dj_tpu's join of the keys case on 2 devices, as W._join_result."""
    world = _JaxWorld(2, build, probe)
    (jl, jlc), (jr, jrc) = world.j["probe"], world.j["build"]
    out = dj_tpu.distributed_inner_join(world.jtopo, jl, jlc, jr, jrc, on, on,
                                        dj_tpu.JoinConfig(**W.KEYS_CONFIG))
    return W._join_result((
        convert.table_from_numpy([np.asarray(c.data) for c in out[0].columns],
                                 [c.dtype.name for c in out[0].columns], device="cpu"),
        torch.from_numpy(np.array(out[1])),
        {k: torch.from_numpy(np.array(v)) for k, v in out[2].items()}))


@pytest.mark.parametrize("name", ["float64", "two_int32", "int16_int64", "uint64"])
def test_process_world_key_kinds_match(name, worlds):
    """A gloo world of 2 joins each key kind as dj_tpu does on 2 devices,
    shard for shard (NaN and subnormal float keys among them). dj_tpu
    cannot join a uint64 key, and a uint64 key hashes apart from its
    int64 image: the uint64 world is held to dj_tpu's join of the keys
    less 2^63 on the whole result (total, flags and the unsharded row
    multiset), and shard for shard to the port's world in one process.
    An int16 key against an int64 key hashes the two widths apart, so
    every process refuses it with a ValueError naming both dtypes."""
    ba, bn, pa, pn, on = W.key_tables()[name]
    results = worlds.results(2)
    if name == "int16_int64":
        for res in results:
            msg = res["keys"][name]["raised"]
            assert "int16 with int64" in msg and "key pair 0" in msg, msg
        return
    if name == "uint64":
        image = [(ba[0] ^ np.uint64(2**63)).view(np.int64)] + ba[1:]
        jwant = _jax_keys_join(image, [(pa[0] ^ np.uint64(2**63)).view(np.int64)] + pa[1:], on)
        assert not any(any(v) for v in jwant["flags"].values())
        got = sorted(r for res in results for r in res["keys"][name]["rows"][0])
        assert got == sorted((r[0] + 2**63,) + r[1:] for shard in jwant["rows"] for r in shard)
        assert sum(res["keys"][name]["counts"][0] for res in results) == sum(jwant["counts"])
        topo = tj.make_topology(["cpu"] * 2)
        (tl, tlc), (tr, trc) = (tj.shard_table(topo, convert.table_from_numpy(a, n, device="cpu"))
                                for a, n in ((pa, pn), (ba, bn)))
        want = W._join_result(tj.distributed_inner_join(topo, tl, tlc, tr, trc, on, on,
                                                        tj.JoinConfig(**W.KEYS_CONFIG)))
    else:
        want = _jax_keys_join(ba, pa, on)
    assert sum(want["counts"]) > 0 and not any(any(v) for v in want["flags"].values())
    for r, res in enumerate(results):
        got = res["keys"][name]
        assert got["counts"] == [want["counts"][r]] and got["flags"] == want["flags"]
        assert repr(got["rows"]) == repr([want["rows"][r]])


def _jax_string_join(build, bnames, probe, pnames, cfg, auto=False):
    """dj_tpu's join (or auto join) of a strings case on 2 devices, as
    W._join_result, with the attempts and final factors of the auto."""
    jtopo = jmake_topology(jax.devices()[:2])

    def table(arrays, names):
        return jT.Table(tuple(
            jT.StringColumn(jnp.asarray(a[0]), jnp.asarray(a[1])) if n == "string"
            else jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(n)) for a, n in zip(arrays, names)))

    (jl, jlc), (jr, jrc) = jshard(jtopo, table(probe, pnames)), jshard(jtopo, table(build, bnames))
    attempts, factors = [], None
    if auto:
        orig = jdist.distributed_inner_join
        jdist.distributed_inner_join = lambda *a, **k: attempts.append(1) or orig(*a, **k)
        try:
            res = dj_tpu.distributed_inner_join_auto(jtopo, jl, jlc, jr, jrc, [0], [0], cfg)
        finally:
            jdist.distributed_inner_join = orig
        factors = {f: getattr(res[3], f) for f in W.FACTOR_FIELDS}
    else:
        res = dj_tpu.distributed_inner_join(jtopo, jl, jlc, jr, jrc, [0], [0], cfg)
    out = {"rows": W.shard_rows(res[0], np.asarray(res[1])), "counts": np.asarray(res[1]).tolist(),
           "flags": {k: np.asarray(v).tolist() for k, v in res[2].items()}}
    return out, len(attempts), factors


@pytest.mark.parametrize("backend", ["xla", "ring", "buffered"])
@pytest.mark.parametrize("name", ["payload", "key"])
def test_process_world_strings_match_dj_tpu(name, backend, worlds):
    """A gloo world of 2 joins string payloads and string keys as dj_tpu
    does on 2 devices, shard for shard (rows with their strings, counts,
    every flag), under the default, the Ring and the Buffered backend."""
    ba, bn, pa, pn = W.string_tables()[name]
    want, _, _ = _jax_string_join(ba, bn, pa, pn, dj_tpu.JoinConfig(**W.STRINGS_CONFIG))
    assert sum(want["counts"]) > 0 and not any(any(v) for v in want["flags"].values())
    _assert_shards(2, worlds.results(2), ("strings", (name, backend)), want)


def test_process_world_char_overflow_heal_matches_dj_tpu(worlds):
    """The char_overflow heal in a gloo world of 2: the same attempts,
    final factors and shard rows as dj_tpu's auto join on 2 devices."""
    ba, bn, pa, pn = W.string_tables()["auto"]
    want, n, factors = _jax_string_join(ba, bn, pa, pn, dj_tpu.JoinConfig(**W.STRINGS_AUTO_CONFIG),
                                        auto=True)
    assert n > 1 and factors["char_out_factor"] > 1.0
    _assert_shards(2, worlds.results(2), ("strings", "auto"), want)
    for res in worlds.results(2):
        assert res["strings"]["auto"]["attempts"] == n
        assert res["strings"]["auto"]["factors"] == factors


@pytest.mark.parametrize("plan,knobs", W.PLAN_RUNS)
def test_process_world_plan_adapt_matches_dj_tpu(plan, knobs, worlds, monkeypatch):
    """A gloo world of 4 under DJT_PLAN_ADAPT=1: every process reaches
    dj_tpu's decision (the broadcast plan by fit; the salted plan under
    DJT_BROADCAST_BYTES=0, 65% of the probe rows on one key) from
    its own block, and its shard equals dj_tpu's on 4 devices, the
    build side's strings byte for byte."""
    ba, bn, pa, pn = W.plan_tables()
    jtopo = jmake_topology(jax.devices()[:4])

    def table(arrays, names):
        return jT.Table(tuple(
            jT.StringColumn(jnp.asarray(a[0]), jnp.asarray(a[1])) if n == "string"
            else jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(n)) for a, n in zip(arrays, names)))

    (jl, jlc), (jr, jrc) = jshard(jtopo, table(pa, pn)), jshard(jtopo, table(ba, bn))
    monkeypatch.setenv("DJ_PLAN_ADAPT", "1")
    for k, v in knobs.items():
        monkeypatch.setenv(k.replace("DJT_", "DJ_"), v)
    cfg = dj_tpu.JoinConfig(**W.PLAN_CONFIG)
    d = jdist._resolve_plan_decision(jtopo, jl, jlc, jr, jrc, (0,), (0,), cfg)
    assert d.tier == plan and (plan == "broadcast" or d.replicas == 3)
    res = dj_tpu.distributed_inner_join(jtopo, jl, jlc, jr, jrc, [0], [0], cfg)
    want = {"rows": W.shard_rows(res[0], np.asarray(res[1])), "counts": np.asarray(res[1]).tolist(),
            "flags": {k: np.asarray(v).tolist() for k, v in res[2].items()}}
    assert not any(any(v) for v in want["flags"].values())
    results = worlds.results(4)
    for res in results:
        assert res["plan_adapt"][plan]["decision"] == (d.tier, tuple(d.salt), d.replicas, d.ratio,
                                                        d.source)
    _assert_shards(4, results, ("plan_adapt", plan), want)


@functools.lru_cache(maxsize=None)
def _jax_pipeline():
    """dj_tpu's plans and results of the pipeline case on 4 devices."""
    jtopo = jmake_topology(jax.devices()[:4])

    def table(arrays, names):
        return jT.Table(tuple(
            jT.StringColumn(jnp.asarray(a[0]), jnp.asarray(a[1])) if n == "string"
            else jT.Column(jnp.asarray(a), dj_tpu.dtypes.by_name(n)) for a, n in zip(arrays, names)))

    t = {name: jshard(jtopo, table(a, n)) for name, (a, n) in W.pipeline_tables().items()}
    t["orders2"] = dj_tpu.shuffle_on(jtopo, *t["orders2"], [0], seed=tdist.MAIN_JOIN_SEED,
                                     out_factor=4.0)[:2]
    cfg = dj_tpu.JoinConfig(**W.PIPELINE_CONFIG)

    def result(out, counts, info):
        return {"rows": W.shard_rows(out, np.asarray(counts)), "counts": np.asarray(counts).tolist(),
                "flags": {k: np.asarray(v).tolist() for k, v in info.items()}}

    want = {}
    for name, specs in W.PIPELINES:
        stages = [dj_tpu.JoinStage(right=t[r][0], right_counts=t[r][1], left_on=lo, right_on=ro,
                                   **kw) for r, lo, ro, kw in specs]
        plan = dj_tpu.plan_pipeline(jtopo, *t["li"], stages, cfg)
        o, c, infos = dj_tpu.distributed_join_pipeline(jtopo, *t["li"], stages, cfg, plan=plan)
        want[name] = {"plan": [(sp.mode, sp.key_range, sp.range_source, sp.out_partitioned_by)
                               for sp in plan.stage_plans],
                      "rows": W.shard_rows(o, np.asarray(c)), "counts": np.asarray(c).tolist(),
                      "flags": [{k: np.asarray(v).tolist() for k, v in i.items()} for i in infos]}
    ccfg = dj_tpu.JoinConfig(**W.COALESCED_CONFIG)
    prep = dj_tpu.prepare_join_side(jtopo, *t["dim"], [0], ccfg, left_capacity=300)
    per_query, _ = dj_tpu.distributed_inner_join_coalesced(
        jtopo, [t["q0"][0], t["q1"][0]], [t["q0"][1], t["q1"][1]], prep, [0], ccfg)
    want["coalesced"] = [result(*r) for r in per_query]
    return want


@pytest.mark.parametrize("chain", [name for name, _ in W.PIPELINES])
def test_process_world_pipeline_matches_dj_tpu(chain, worlds):
    """A gloo world of 4 runs Q3 (shuffle, then customer broadcast) and
    the shuffle-then-local chain: every process plans each stage alike
    (modes, derived ranges, sources, partitioning), as dj_tpu plans on 4
    devices, and its shard equals dj_tpu's shard r, strings byte for
    byte. Every process records the same ``pipeline`` events (one a
    stage, its mode the plan's) and counters: the fields come from the
    plan, which each process makes alike."""
    want = _jax_pipeline()[chain]
    assert [p[0] for p in want["plan"]] == (["shuffle", "broadcast"] if chain == "q3"
                                            else ["shuffle", "local"])
    results = worlds.results(4)
    for r, res in enumerate(results):
        got = res["pipeline"][chain]
        assert got["plan"] == want["plan"], r
        assert got["counts"] == [want["counts"][r]] and got["rows"] == [want["rows"][r]], r
        assert got["flags"] == want["flags"], r
        assert got["events"] == results[0]["pipeline"][chain]["events"], r
        assert got["counters"] == results[0]["pipeline"][chain]["counters"], r
    first = results[0]["pipeline"][chain]
    assert [e["mode"] for e in first["events"]] == [p[0] for p in want["plan"]]
    assert first["counters"]['dj_join_queries_total{path="pipeline"}'] == 1
    assert not any(any(v) for f in want["flags"] for v in f.values())


def test_process_world_coalesced_matches_dj_tpu(worlds):
    """K = 2 coalesced queries against a prepared side in a gloo world of
    4: each member's shard on each process equals dj_tpu's."""
    want = _jax_pipeline()["coalesced"]
    for q, wq in enumerate(want):
        assert not any(any(v) for v in wq["flags"].values())
        for r, res in enumerate(worlds.results(4)):
            got = res["pipeline"]["coalesced"][q]
            assert got["counts"] == [wq["counts"][r]] and got["rows"] == [wq["rows"][r]], (q, r)
            assert got["flags"] == wq["flags"], (q, r)


def test_process_world_fleet_snapshot_gathers_every_process(worlds):
    """obs.fleet_snapshot over gloo: one row a process, in rank order,
    on every process; each row's wire totals are that process's own
    matrix (each row of which sums to its collective bytes); the
    stragglers see rank 1's slow dispatch."""
    results = worlds.results(2)
    snaps = [res["fleet"]["snapshot"] for res in results]
    assert snaps[0]["ranks"] == snaps[1]["ranks"]
    rows = snaps[0]["ranks"]
    assert [row["rank"] for row in rows] == [0, 1]
    for row, res in zip(rows, results):
        fleet = res["fleet"]
        assert row["wire_row_totals"] == fleet["own_wire"]["row_totals"]
        assert row["wire_row_totals"] == [pytest.approx(fleet["sent"])] * 2
        assert fleet["view"] == fleet["snapshot"]
        assert fleet["summary"]["ranks"] == 2 and fleet["summary"]["gathered"] is True
    assert rows[0]["wire_total_bytes"] == rows[1]["wire_total_bytes"] > 0
    dispatch = snaps[0]["stragglers"]["dispatch"]
    assert dispatch["slowest_rank"] == 1 and dispatch["ratio"] > 1.0


def _union(results, call) -> list:
    return sorted(row for r in results for row in (r["autotune"][call]["rows"]
                                                   if call != "untuned"
                                                   else r["autotune"]["untuned"]))


def test_process_world_tuner_makes_one_decision(worlds):
    """Each process alone would pick another odf; the tuned chain runs
    one plan on both (the same tune event, evidence and odf), gives the
    untuned chain's rows, serves the decision again with no event, and
    after rank 1 forgot its ledger both replay rank 0's record."""
    results = worlds.results(2)
    a, b = (r["autotune"] for r in results)
    assert a["local_pick"] != b["local_pick"]
    assert a["tuned"]["events"] == b["tuned"]["events"]
    (event,) = a["tuned"]["events"]
    assert event["action"] == "tune" and event["candidates"] == 2
    assert a["tuned"]["odf"] == b["tuned"]["odf"]
    assert len(set(a["tuned"]["odf"])) == 1
    assert a["again"]["events"] == b["again"]["events"] == []
    assert [e["action"] for e in a["replayed"]["events"]] == ["replay"]
    assert a["replayed"]["events"] == b["replayed"]["events"]
    assert a["replayed"]["odf"] == b["replayed"]["odf"] == a["tuned"]["odf"]
    want = _union(results, "untuned")
    assert want and all(_union(results, call) == want for call in ("tuned", "again", "replayed"))


def test_a_ledger_split_world_fails_instead_of_hanging(worlds):
    """Two processes that start from different ledger entries size their
    exchanges differently: both end with an error within the time limit
    (spawn_world raises past it) instead of hanging. Under gloo the
    receiver of the larger bucket aborts on the size mismatch and its
    peer's read fails."""
    (rc0, _, err0), (rc1, _, err1) = worlds.outcome("ledger_split")
    assert rc0 != 0 and rc1 != 0
    assert "collective mismatch" in err0 + err1


def test_process_world_index_cache_decides_once_for_the_world(worlds):
    """Two gloo processes share a DJT_FLEET_DIR and a manifest: every
    process takes the same miss, hit and replay (the world's own record
    is never a live peer's, so no process defers to its own world), the
    leases, budget rows and manifest lines carry process 0's pid, each
    process's row is charged to no process of the world, the faulted
    gate pins the fleet tier on both, and every query's shard equals the
    world in one process's."""
    results = worlds.results(2)
    a, b = (r["index"] for r in results)
    owner = a["pid"]
    assert a["identity"] == b["identity"] and a["identity"]["pid"] == owner != b["pid"]
    assert a["events"] == b["events"] and a["counters"] == b["counters"]
    assert not [e for e in a["events"] if e.get("action") == "peer_defer"]
    assert [e.get("op") or e.get("action") or e["type"] for e in a["events"]] == [
        "miss", "insert", "hit", "miss", "replay", "insert", "miss", "degrade", "insert"]
    assert a["counters"] == {"dj_index_hit_total": 1.0, "dj_index_miss_total": 3.0,
                             "dj_fleet_replay_total": 1.0, "dj_fleet_peer_defer_total": 0.0}
    assert a["same_side"] and b["same_side"]
    assert a["budget_rows"] == b["budget_rows"] == [f"{owner}-r0.json", f"{owner}-r1.json"]
    assert a["peer_bytes"] == b["peer_bytes"] == 0.0
    assert a["manifest"] == b["manifest"] and len(a["manifest"]) == 2
    assert all(rec["pid"] == owner and rec["op"] == "insert" for rec in a["manifest"])
    assert a["leases_left"] == b["leases_left"] == []
    assert a["pins"] == b["pins"] == ["fleet"]
    w = W.prepared_tables(5)
    topo = tj.make_topology(["cpu"] * 2)
    (tl, tlc), (tr, trc) = (W._sharded(topo, t) for t in (w[1], w[0]))
    cfg = tj.JoinConfig(**W.INDEX_CONFIG)
    prep = tj.prepare_join_side(topo, tr, trc, [0], cfg, left_capacity=3600)
    want = W._join_result(tj.distributed_inner_join(topo, tl, tlc, prep, None, [0], None, cfg))
    assert not any(any(v) for v in want["flags"].values())
    for r, res in enumerate(results):
        for call in ("miss", "replayed", "faulted"):
            got = res["index"][call]
            assert got["rows"] == [want["rows"][r]] and got["flags"] == want["flags"], (r, call)


def test_process_world_scheduler_decides_once_for_the_world(worlds):
    """Two gloo processes serve the same queries, each decision taken
    once for the world (serve/scheduler.py's docstring): no case hangs,
    both processes see the same outcomes, the rejecting process's
    evidence, process 0's clock and process 0's dispatch group, and each
    served query's shard equals the world in one process's."""
    a, b = (r["serve"] for r in worlds.results(2))
    for k in ("worker", "measured", "peer", "late0", "healing", "coalesced", "events", "pins"):
        assert a[k] == b[k], k
    assert a["worker"] == ["ValueError", True]
    assert a["measured"] == ["AdmissionRejected", int(16e9), 0]
    assert a["peer"][0] == "AdmissionRejected" and a["peer"][1] >= 1e15 and a["peer"][2] == 0
    assert a["late0"] == ["DeadlineExceeded", "queued"]
    assert a["healing"][:2] == ["DeadlineExceeded", "healing"] and a["healing"][2] >= 1
    assert a["coalesced"] == [True, True]
    assert [e["size"] for e in a["events"] if e["type"] == "coalesce"] == [2]
    assert a["pins"] == []
    w = W.prepared_tables(5)
    topo = tj.make_topology(["cpu"] * 2)
    (tl, tlc), (tr, trc) = (W._sharded(topo, t) for t in (w[1], w[0]))
    cfg = tj.JoinConfig(**W.SERVE_CONFIG)
    want = W._join_result(tj.distributed_inner_join(topo, tl, tlc, tr, trc, [0], [0], cfg))
    prep = tj.prepare_join_side(topo, tr, trc, [0], cfg, left_capacity=3600)
    want_prep = W._join_result(tj.distributed_inner_join(topo, tl, tlc, prep, None, [0], None,
                                                         cfg))
    for r, res in enumerate((a, b)):
        assert isinstance(res["late1"], dict), res["late1"]
        assert res["late1"]["rows"] == [want["rows"][r]]
        for got in res["group"]:
            assert got["rows"] == [want_prep["rows"][r]]
            assert got["flags"] == want_prep["flags"]


def test_process_world_leaves_one_black_box_a_process(worlds):
    """Two gloo processes armed into one directory leave two bundles
    that do not overwrite each other: each named and stamped with its own
    rank, which the process group gives when DJT_PROCESS_ID is unset."""
    got = [r["blackbox"] for r in worlds.results(2)]
    paths = [pathlib.Path(g["path"]) for g in got]
    assert [pathlib.Path(g["armed"]) for g in got] == paths
    assert sorted(paths[0].parent.glob("blackbox-*.jsonl")) == sorted(paths)
    for r, (g, path) in enumerate(zip(got, paths)):
        assert path.name.startswith(f"blackbox-r{r}-p") and g["rank_from_group"] == r
        sections = {}
        for line in path.read_text().splitlines():
            obj = json.loads(line)
            sections[obj.pop("section")] = obj
        assert sections["meta"]["rank"] == r and sections["meta"]["reason"] == "case"
        assert [t["query_id"] for t in sections["traces"]["open"]] == [f"{r}:q-bb"]


def _counting(monkeypatch):
    """Make the kernel wrappers count their plain calls, as their CUDA
    launches count on the card: ops.join calls its kernels by name,
    StringColumn.take calls string_gather through its module."""
    from dj_tpu_torch.ops import KERNEL_COUNTERS, expand, join, merge, partition, scan, strings

    def wrap(name, mod, counter):
        owner = join if hasattr(join, name) else mod
        fn = getattr(owner, name)

        def counted(*a, **k):
            setattr(mod, counter, getattr(mod, counter) + 1)
            return fn(*a, **k)

        monkeypatch.setattr(owner, name, counted)

    mods = {"scan": scan, "merge": merge, "expand": expand, "strings": strings,
            "partition": partition}
    for name, (m, counter) in KERNEL_COUNTERS.items():
        wrap(name, mods[m], counter)


def test_chip_smoke_process_world_helpers_rehearse_with_gloo(monkeypatch):
    """chip_smoke's phases 6a and 6b at a tiny size on the CPU: a gloo
    world of one in this process (every path, the transport checks, the
    first join's wall without and after warmup_all_to_all) and four
    worker processes whose shard digests equal the world in one
    process's, the broadcast plan's and 4j's chain's among them."""
    rows = 4000
    gen = torch.Generator().manual_seed(0)
    build, probe, expected = tj.generate_build_probe_tables(
        gen, rows, rows, 0.3, 2 * rows, True, return_expected_matches=True)
    expected = int(expected)
    topo = tj.make_topology(["cpu"] * 4)
    (l, lc), (r, rc) = tj.shard_table(topo, probe), tj.shard_table(topo, build)
    out, counts, _ = tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0])
    digests = chip_smoke.shard_digests(out, counts)
    # The two-level half (6b at intra 2): the world in one process's
    # digests of the join and of 4f's shuffle per axis.
    two = tj.make_topology(["cpu"] * 4, intra_size=chip_smoke.INTRA)
    (l2, lc2), (r2, rc2) = tj.shard_table(two, probe), tj.shard_table(two, build)
    out2, counts2, _ = tj.distributed_inner_join(two, l2, lc2, r2, rc2, [0], [0])
    two_digests = chip_smoke.shard_digests(out2, counts2)
    t, c = tj.shard_table(two, chip_smoke.clickstream_table(tj, torch.device("cpu"), rows, 0))
    t, c = tj.shuffle_on(two, t, c, [0], group=two.group("inter"),
                         seed=tdist.INTER_DOMAIN_SEED)[:2]
    shuffle_digests = chip_smoke.shard_digests(*tj.shuffle_on(two, t, c, [0],
                                                              group=two.group("intra"))[:2])
    # The broadcast half (6b under DJT_PLAN_ADAPT=1): 4i(i)'s digests.
    monkeypatch.setenv("DJT_PLAN_ADAPT", "1")
    tj.resilience.ledger.reset()
    bc_digests = chip_smoke.shard_digests(*tj.distributed_inner_join(topo, l, lc, r, rc, [0],
                                                                     [0])[:2])
    tj.resilience.ledger.reset()
    monkeypatch.delenv("DJT_PLAN_ADAPT")
    assert bc_digests != digests
    # The chain half (6b's run of 4j's chain): the world in one process's
    # plan and digests.
    chain_want = chip_smoke.chain_in_one_process(tj, torch.device("cpu"), rows, 0)
    assert [p[0] for p in chain_want["plan"]] == ["shuffle", "local"]
    res = chip_smoke.run_process_world(4, "gloo", "cpu", rows, 0, reps=1, timeout=TIMEOUT_S,
                                       intra=chip_smoke.INTRA, shuffle_rows=rows, broadcast=True,
                                       chain_rows=rows)
    chip_smoke.check_chain_processes("rehearsal", res, chain_want)
    chip_smoke.check_process_world("rehearsal", res, digests, expected, 0)
    chip_smoke.check_broadcast_processes("rehearsal", res, bc_digests, expected, 0)
    chip_smoke.check_two_level_processes("rehearsal", res, two_digests, shuffle_digests, expected,
                                         0)
    assert [x["transport"] for x in res] == ["gloo"] * 4
    assert all("a2a_exchange" in x["phase_ms"] for x in res)
    assert all("dj_pre_shuffle/a2a_exchange" in x["two_level"]["phase_ms"] for x in res)

    one = tj.make_topology(["cpu"])
    (l1, lc1), (r1, rc1) = tj.shard_table(one, probe), tj.shard_table(one, build)
    ref = chip_smoke.sorted_rows(*tj.distributed_inner_join(one, l1, lc1, r1, rc1, [0], [0])[:2])
    _counting(monkeypatch)
    launches = chip_smoke.process_world_of_one(tj, torch.device("cpu"), "gloo", build, probe,
                                               expected, ref, rows, "cpu")
    assert launches["unprepared"][4]["join_scans"] == 4
    assert launches["prepared_probe"][1]["expand_ranks"] == 1
    assert not torch.distributed.is_initialized()
    warm = chip_smoke.first_join_with_warmup(tj, torch.device("cpu"), "gloo", build, probe, "cpu")
    assert warm["after_warmup"]["warmup_ms"] > 0 and warm["cold"]["warmup_ms"] is None
    assert not torch.distributed.is_initialized()

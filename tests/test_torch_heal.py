"""dj_tpu_torch's heal engine, capacity ledger and
distributed_inner_join_auto vs dj_tpu's.

Unit for unit: ``run_healed`` driven by the same scripted attempts in both
packages (capacity growth, poison repairs, terminal flags, structural
mismatches, both budget caps, deadlines) returns or raises the same;
the ledger's signatures, merges, replay of a torn file and plan
signatures are byte-equal. End to end, at a world of 1 and an in-process
world of 4 (dj_tpu on as many devices of the CPU mesh), each scenario of
``tests/test_retry.py`` and the prepared cases of ``tests/test_prepared.py``
run through both packages' ``distributed_inner_join_auto``: duplicate
blow-up, a skewed shuffle, a provisioned no-op, typed exhaustion of the
attempts and of the total growth, a declared range the data violates, a
prepared side re-prepared for probe keys outside it (and one healed
without re-preparing), and a ledger hit on the second call. Compared:
the counts, flags and per-shard rows, the final factors, the attempt
count and, for exhaustion, the error's fields. The port's ledger and
dj_tpu's are emptied around every test.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.core import table as jT
from dj_tpu.parallel import dist_join as jdist
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
from dj_tpu.resilience import heal as jheal
from dj_tpu.resilience import ledger as jledger
from dj_tpu.resilience.errors import CapacityExhausted as JCapacityExhausted
from dj_tpu.resilience.errors import PlanMismatch as JPlanMismatch
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.parallel import dist_join as tdist
from dj_tpu_torch.resilience import errors as terrors
from dj_tpu_torch.resilience import heal as theal
from dj_tpu_torch.resilience import ledger as tledger


@pytest.fixture(autouse=True)
def empty_port_ledger(monkeypatch):
    monkeypatch.delenv("DJT_LEDGER", raising=False)
    tledger.reset()
    yield
    tledger.reset()


# --- the engine, unit for unit ---------------------------------------


FACTORS = {"bucket_factor": 2.0, "join_out_factor": 1.0}
HEAL_MAP = {"shuffle_overflow": ("bucket_factor",), "join_overflow": ("join_out_factor",)}


def _drive(engine, script, budget, *, mismatch_exc=None, ledger_key=None):
    """Run ``engine.run_healed`` over scripted attempts. Each script entry
    is a flag dict, or "mismatch" (the attempt raises ``mismatch_exc``).
    Returns (outcome, trace): the outcome is ("ok", payload, attempt,
    flags) or ("raised", type name, message, fields); the trace lists
    the factors of each attempt and the repairs made."""
    state = {"f": dict(FACTORS)}
    trace = []

    def run_attempt(attempt):
        trace.append(("attempt", attempt, dict(state["f"])))
        step = script[min(attempt, len(script)) - 1]
        if step == "mismatch":
            raise mismatch_exc("structural")
        return f"payload{attempt}", {k: np.bool_(v) for k, v in step.items()}

    def poison(info, attempt):
        trace.append(("repair", attempt))

    def terminal(info):
        raise RuntimeError("terminal flag")

    try:
        payload, info, attempt = engine.run_healed(
            name="drive", stage="join", budget=budget, run_attempt=run_attempt,
            heal_map=HEAL_MAP, read_factors=lambda: dict(state["f"]),
            apply_factors=lambda grew: state["f"].update(grew),
            poison={"pack_range_overflow": poison},
            terminal={"surrogate_collision": terminal},
            mismatch_excs=(mismatch_exc,) if mismatch_exc else (),
            on_mismatch=(lambda e, a: trace.append(("reprepare", a))) if mismatch_exc else None,
            ledger_key=ledger_key,
        )
        return ("ok", payload, attempt, engine.summarize_flags(info)), trace
    except RuntimeError as e:
        fields = {k: getattr(e, k, None) for k in ("stage", "attempts", "flags", "factors")}
        return ("raised", type(e).__name__, str(e), fields), trace


SCRIPTS = {
    "clean": [{"join_overflow": False}],
    "grow_twice": [{"join_overflow": True}, {"join_overflow": True, "shuffle_overflow": True},
                   {"join_overflow": False}],
    "poison_then_grow": [{"pack_range_overflow": True, "join_overflow": True},
                         {"shuffle_overflow": True}, {}],
    "terminal_trusted": [{"surrogate_collision": True}],
    "terminal_under_overflow": [{"surrogate_collision": True, "join_overflow": True},
                                {"surrogate_collision": False}],
    "mismatch": ["mismatch", {"join_overflow": True}, {}],
    "attempt_cap": [{"join_overflow": True}],
    "poison_forever": [{"pack_range_overflow": True}],
}


@pytest.mark.parametrize("budget", [(8, 2.0, 4096.0), (3, 2.0, 4096.0), (8, 4.0, 16.0)])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_run_healed_matches_dj_tpu(script, budget):
    runs = []
    for engine, mexc in ((jheal, JPlanMismatch), (theal, terrors.PlanMismatch)):
        b = engine.HealBudget(*budget)
        runs.append(_drive(engine, SCRIPTS[script], b, mismatch_exc=mexc))
    (jout, jtrace), (tout, ttrace) = runs
    assert ttrace == jtrace
    assert tout == jout


def test_heal_budget_validation_matches_dj_tpu():
    for bad in ((0, 2.0, 4096.0), (8, 1.0, 4096.0), (8, 2.0, 0.5)):
        with pytest.raises(ValueError) as j:
            jheal.HealBudget(*bad).validate()
        with pytest.raises(ValueError) as t:
            theal.HealBudget(*bad).validate()
        assert str(t.value) == str(j.value)


def test_deadline_between_attempts_matches_dj_tpu():
    """An expired deadline_scope lets attempt 1 run and raises
    DeadlineExceeded (where="healing") before attempt 2, in both."""
    for engine in (jheal, theal):
        seen = []
        with engine.deadline_scope(0.0, 0.001):
            with pytest.raises(RuntimeError) as e:
                engine.run_healed(
                    name="d", stage="join", budget=engine.HealBudget(),
                    run_attempt=lambda a: seen.append(a) or (None, {"join_overflow": True}),
                    heal_map=HEAL_MAP, read_factors=lambda: dict(FACTORS),
                    apply_factors=lambda grew: None,
                )
        assert type(e.value).__name__ == "DeadlineExceeded"
        assert e.value.where == "healing" and e.value.deadline_s == 0.001 and seen == [1]
        engine.check_deadline("outside a scope")  # a no-op


def test_flag_fired_reads_tensors_arrays_and_bools():
    for v, want in ((torch.tensor([False, True]), True), (torch.zeros(3, dtype=torch.bool), False),
                    (np.array([False]), False), (True, True), (None, False)):
        assert theal.flag_fired(v) is want
        if not isinstance(v, torch.Tensor):
            assert jheal.flag_fired(v) is want


# --- the ledger, unit for unit ---------------------------------------


def test_ledger_merge_and_lookup_match_dj_tpu():
    sig = tledger.signature("join", w=4, odf=2, on=((0,), (1,)), table=("int64", "int32"))
    assert sig == jledger.signature("join", w=4, odf=2, on=((0,), (1,)),
                                    table=("int64", "int32"))
    assert jledger.consult(sig) is None and tledger.lookup(sig) is None
    for led in (jledger, tledger):
        led.update(sig, factors={"bucket_factor": 4.0, "join_out_factor": 2.0})
        led.update(sig, factors={"bucket_factor": 2.0, "join_out_factor": 8.0},
                   drop_declared_range=True)
        led.update("other|x=1", factors={"bucket_factor": 3.0})
    assert tledger.lookup(sig) == jledger.lookup(sig) == {
        "factors": {"bucket_factor": 4.0, "join_out_factor": 8.0}, "drop_declared_range": True}
    assert tledger.entries() == jledger.entries()
    learned = {"bucket_factor": 4.0, "join_out_factor": 0.5, "unknown": 9.0}
    current = {"bucket_factor": 2.0, "join_out_factor": 1.0}
    assert tledger.wider_factors(learned, current) == jledger.wider_factors(learned, current)
    tledger.reset()
    assert tledger.entries() == {}


def test_ledger_file_replays_and_skips_a_torn_tail(tmp_path, monkeypatch):
    """DJT_LEDGER appends one line per update and is replayed on first
    use after a reset, a torn last line skipped, as DJ_LEDGER is."""
    for led, var, name in ((jledger, "DJ_LEDGER", "j.jsonl"), (tledger, "DJT_LEDGER", "t.jsonl")):
        path = tmp_path / name
        monkeypatch.setenv(var, str(path))
        led.reset()
        led.update("a|w=1", factors={"bucket_factor": 4.0})
        led.update("a|w=1", factors={"bucket_factor": 2.0}, reprobe_declared_range=True)
        led.update("b|w=2", factors={"join_out_factor": 16.0})
        with open(path, "a") as f:
            f.write('{"sig": "c|w=1", "factors": {"bucket_fa')  # a writer died mid-line
        led.reset()
    lines = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()[:3]]
    assert [sorted(x) for x in lines] == [
        sorted(json.loads(x)) for x in (tmp_path / "j.jsonl").read_text().splitlines()[:3]]
    assert tledger.entries() == jledger.entries() and set(tledger.entries()) == {"a|w=1", "b|w=2"}
    monkeypatch.setenv("DJT_LEDGER", str(tmp_path / "missing" / "x.jsonl"))
    tledger.reset()
    tledger.update("d|w=1", factors={"bucket_factor": 2.0})  # an unwritable file is skipped
    assert tledger.lookup("d|w=1") == {"factors": {"bucket_factor": 2.0}}


# --- distributed_inner_join_auto end to end -----------------------------


class _World:
    """The same tables sharded over w ranks in both packages."""

    def __init__(self, w, probe_keys, build_keys):
        self.jtopo = jmake_topology(jax.devices()[:w])
        self.ttopo = tj.make_topology(["cpu"] * w)
        self.j, self.t = {}, {}
        for side, keys in (("probe", probe_keys), ("build", build_keys)):
            arrays = [np.asarray(keys, np.int64), np.arange(len(keys), dtype=np.int64)]
            jt = dj_tpu.from_arrays(*[jnp.asarray(a) for a in arrays])
            self.j[side] = jshard(self.jtopo, jt)
            self.t[side] = tj.shard_table(self.ttopo, convert.table_from_numpy(
                arrays, ["int64", "int64"], device="cpu"))

    def jprepare(self, cfg):
        jr, jrc = self.j["build"]
        return jdist.prepare_join_side(self.jtopo, jr, jrc, [0], cfg, tier="shuffle")

    def tprepare(self, cfg):
        tr, trc = self.t["build"]
        return tj.prepare_join_side(self.ttopo, tr, trc, [0], convert.join_config_from(cfg))

    def auto(self, cfg, jprep=None, tprep=None, **kw):
        """Both packages' auto join: ((result, counts, info, config[,
        side]), attempts) each, or the exception each raised."""
        out = []
        for pkg, mod, topo, sides, prep, conv in (
            (dj_tpu, jdist, self.jtopo, self.j, jprep, cfg),
            (tj, tdist, self.ttopo, self.t, tprep, convert.join_config_from(cfg)),
        ):
            (l, lc), (r, rc) = sides["probe"], sides["build"]
            attempts = []
            fn = mod._distributed_inner_join_prepared if prep is not None else mod.distributed_inner_join
            name = fn.__name__

            def counted(*a, _fn=fn, **k):
                attempts.append(1)
                return _fn(*a, **k)

            orig = getattr(mod, name)
            setattr(mod, name, counted)
            try:
                if prep is None:
                    res = pkg.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], conv, **kw)
                else:
                    res = pkg.distributed_inner_join_auto(topo, l, lc, prep, None, [0], None, conv,
                                                          **kw)
            except RuntimeError as e:
                res = e
            finally:
                setattr(mod, name, orig)
            out.append((res, len(attempts)))
        return out


def _shard_rows(table, counts):
    counts = np.asarray(counts).tolist()
    cols = [np.asarray(c.data) for c in table.columns]
    cap = cols[0].shape[0] // len(counts)
    return [sorted(zip(*[c[r * cap: r * cap + n].tolist() for c in cols]))
            for r, n in enumerate(counts)]


# The heal factors, the same in both packages.
FACTOR_FIELDS = ("pre_shuffle_out_factor", "bucket_factor", "join_out_factor", "char_out_factor")


def _assert_same(runs, want_total=None):
    """Both packages healed to the same result, config and attempts;
    returns the port's result tuple."""
    (jres, jn), (tres, tn) = runs
    assert not isinstance(jres, Exception), jres
    assert not isinstance(tres, Exception), tres
    assert tn == jn
    jout, jcounts, jinfo, jcfg = jres[:4]
    tout, tcounts, tinfo, tcfg = tres[:4]
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    assert {k: v.tolist() for k, v in tinfo.items()} == {
        k: np.asarray(v).tolist() for k, v in jinfo.items()}
    assert not any(v.any() for v in tinfo.values())
    assert _shard_rows(tout, tcounts) == _shard_rows(jout, jcounts)
    for f in FACTOR_FIELDS + ("over_decom_factor", "key_range"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    if want_total is not None:
        assert int(tcounts.sum()) == want_total
    return tres, tn


def _dups(n=1024, keys=8, seed=7):
    rng = np.random.default_rng(seed)
    p, b = rng.integers(0, keys, n), rng.integers(0, keys, n)
    return p, b, sum(int((p == k).sum()) * int((b == k).sum()) for k in range(keys))


WORLDS = (1, 4)


@pytest.mark.parametrize("w", WORLDS)
def test_auto_heals_duplicate_blowup(w):
    p, b, want = _dups()
    tight = dj_tpu.JoinConfig(over_decom_factor=1, bucket_factor=8.0, join_out_factor=1.0)
    res, n = _assert_same(_World(w, p, b).auto(tight, growth=8.0), want)
    assert n > 1 and res[3].join_out_factor > 1.0 and res[3].bucket_factor == 8.0


@pytest.mark.parametrize("w", WORLDS)
def test_auto_heals_skewed_shuffle(w):
    n = 1024
    tight = dj_tpu.JoinConfig(over_decom_factor=2, bucket_factor=1.3, join_out_factor=1.0)
    res, attempts = _assert_same(_World(w, np.full(n, 123), np.arange(n)).auto(tight), n)
    assert attempts > 1 and res[3].bucket_factor > 1.3


@pytest.mark.parametrize("w", WORLDS)
def test_auto_noop_when_provisioned(w):
    rng = np.random.default_rng(3)
    cfg = dj_tpu.JoinConfig(over_decom_factor=1, bucket_factor=4.0, join_out_factor=2.0)
    res, n = _assert_same(_World(w, rng.permutation(512), rng.permutation(512)).auto(cfg), 512)
    assert n == 1 and res[3] == convert.join_config_from(cfg)


def _assert_same_error(runs):
    (jerr, jn), (terr, tn) = runs
    assert isinstance(jerr, JCapacityExhausted) and isinstance(terr, terrors.CapacityExhausted)
    assert isinstance(terr, RuntimeError) and tn == jn
    for f in ("stage", "attempts", "flags"):
        assert getattr(terr, f) == getattr(jerr, f), f
    assert terr.factors == jerr.factors
    assert str(terr) == str(jerr)
    return terr


@pytest.mark.parametrize("w", WORLDS)
def test_auto_exhaustion_is_typed(w):
    p, b, _ = _dups()
    tight = dj_tpu.JoinConfig(over_decom_factor=1, bucket_factor=8.0, join_out_factor=1.0)
    err = _assert_same_error(_World(w, p, b).auto(tight, max_attempts=2))
    assert "capacity overflow persists after 2 attempts" in str(err)
    assert err.flags["join_overflow"] and err.factors["join_out_factor"] == 4.0


@pytest.mark.parametrize("w", WORLDS)
def test_auto_total_growth_cap(w):
    p, b, _ = _dups()
    tight = dj_tpu.JoinConfig(over_decom_factor=1, bucket_factor=8.0, join_out_factor=1.0)
    err = _assert_same_error(_World(w, p, b).auto(tight, growth=4.0, max_total_growth=8.0))
    assert "factor growth budget exhausted" in str(err) and err.attempts == 2


@pytest.mark.parametrize("w", WORLDS)
def test_auto_drops_a_violated_declared_range(w):
    """Keys spanning most of int64 under a declared (0, 99): the packed
    word overflows, the range is dropped and probed, the join is exact,
    and the ledger remembers to drop it on the next call."""
    keys = np.array([-(2**62), 2**62, 5, 5, 99, 0] * 40)
    wd = _World(w, keys, keys[::-1].copy())
    cfg = dj_tpu.JoinConfig(bucket_factor=4.0, join_out_factor=8.0, key_range=(0, 99))
    res, n = _assert_same(wd.auto(cfg))
    assert n >= 2 and res[3].key_range is None
    assert int(res[1].sum()) == sum(int((keys == k).sum()) ** 2 for k in set(keys.tolist()))
    _, n2 = _assert_same(wd.auto(cfg))
    assert n2 == 1


@pytest.mark.parametrize("w", WORLDS)
def test_auto_ledger_hit_on_the_second_call(w, tmp_path, monkeypatch):
    """The second call of a healed signature starts at the healed factors
    and succeeds on attempt 1; so does a fresh process state replaying
    DJT_LEDGER / DJ_LEDGER."""
    monkeypatch.setenv("DJT_LEDGER", str(tmp_path / "t.jsonl"))
    monkeypatch.setenv("DJ_LEDGER", str(tmp_path / "j.jsonl"))
    tledger.reset()
    jledger.reset()
    p, b, want = _dups()
    wd = _World(w, p, b)
    tight = dj_tpu.JoinConfig(over_decom_factor=1, bucket_factor=8.0, join_out_factor=1.0)
    first, n1 = _assert_same(wd.auto(tight, growth=8.0), want)
    second, n2 = _assert_same(wd.auto(tight, growth=8.0), want)
    assert n1 > 1 and n2 == 1 and second[3] == first[3]
    tledger.reset()
    jledger.reset()
    _, n3 = _assert_same(wd.auto(tight, growth=8.0), want)
    assert n3 == 1


def test_plan_signatures_match_dj_tpu():
    p, b, _ = _dups(64)
    for w in WORLDS:
        wd = _World(w, p, b)
        cfg = dj_tpu.JoinConfig(over_decom_factor=2)
        (jl, _), (jr, _) = wd.j["probe"], wd.j["build"]
        (tl, _), (tr, _) = wd.t["probe"], wd.t["build"]
        tcfg = convert.join_config_from(cfg)
        assert tledger.plan_signature(wd.ttopo, tl, tr, [0], [0], tcfg) == \
            jledger.plan_signature(wd.jtopo, jl, jr, [0], [0], cfg)
        assert tledger.plan_signature(wd.ttopo, None, tr, None, [0], tcfg) == \
            jledger.plan_signature(wd.jtopo, None, jr, None, [0], cfg)
        # A string column folds its per-shard char capacity into the shape
        # and renders as "str" in the schema.
        strs = [b"row-%d" % i for i in range(len(p))]
        js, _ = jshard(wd.jtopo, jT.Table((jT.Column(jnp.asarray(p), dj_tpu.dtypes.int64),
                                           jT.from_strings(strs))))
        ts, _ = tj.shard_table(wd.ttopo, tj.Table((
            tj.Column(torch.from_numpy(p), tj.dtypes.int64), tj.from_strings(strs, device="cpu"))))
        sig = tledger.plan_signature(wd.ttopo, ts, tr, [0], [0], tcfg)
        assert sig == jledger.plan_signature(wd.jtopo, js, jr, [0], [0], cfg)
        assert "'str'" in sig
        assert tledger.plan_signature(wd.ttopo, tl, ts, [0], [0], tcfg) == \
            jledger.plan_signature(wd.jtopo, jl, js, [0], [0], cfg)
        assert tledger.plan_signature(wd.ttopo, None, ts, None, [0], tcfg) == \
            jledger.plan_signature(wd.jtopo, None, js, None, [0], cfg)
        assert tledger.table_shape(ts, w)[1] == ts.columns[1].chars.shape[0] // w
    # A two-level topology keys on the world size alone, as dj_tpu's does:
    # its signatures are the flat world's of the same size.
    wd = _World(4, p, b)
    jtopo2 = jmake_topology(jax.devices()[:4], intra_size=2)
    ttopo2 = tj.make_topology(["cpu"] * 4, intra_size=2)
    (jl, _), (jr, _) = wd.j["probe"], wd.j["build"]
    (tl, _), (tr, _) = wd.t["probe"], wd.t["build"]
    sig2 = tledger.plan_signature(ttopo2, tl, tr, [0], [0], tcfg)
    assert sig2 == jledger.plan_signature(jtopo2, jl, jr, [0], [0], cfg)
    assert sig2 == tledger.plan_signature(wd.ttopo, tl, tr, [0], [0], tcfg)
    assert tledger.plan_signature(ttopo2, None, tr, None, [0], tcfg) == \
        jledger.plan_signature(jtopo2, None, jr, None, [0], cfg)


# --- the prepared auto path ---------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
def test_prepared_auto_reprepares_for_probe_keys_outside(w):
    rng = np.random.default_rng(12)
    build, probe = rng.integers(0, 100, 1024), rng.integers(0, 4000, 1024)
    wd = _World(w, probe, build)
    cfg = dj_tpu.JoinConfig(over_decom_factor=2, bucket_factor=4.0, join_out_factor=4.0)
    jprep, tprep = wd.jprepare(cfg), wd.tprepare(cfg)
    assert tprep.key_range == tuple(jprep.key_range) and tprep.key_range[0][1] < 4000
    res, n = _assert_same(wd.auto(cfg, jprep, tprep),
                          sum(int((build == k).sum()) for k in probe.tolist()))
    assert n == 2 and res[4] is not tprep and res[4].key_range[0][1] >= int(probe.max())


@pytest.mark.parametrize("w", WORLDS)
def test_prepared_auto_capacity_heal_keeps_the_side(w):
    p, b, want = _dups()
    wd = _World(w, p, b)
    tight = dj_tpu.JoinConfig(over_decom_factor=1, bucket_factor=8.0, join_out_factor=1.0)
    jprep, tprep = wd.jprepare(tight), wd.tprepare(tight)
    res, n = _assert_same(wd.auto(tight, jprep, tprep, growth=8.0), want)
    assert n > 1 and res[4] is tprep and res[3].join_out_factor > 1.0


@pytest.mark.parametrize("w", WORLDS)
def test_prepared_auto_heals_a_structural_mismatch(w):
    rng = np.random.default_rng(13)
    build = rng.permutation(4096)[:1024]
    wd = _World(w, build, build)
    cfg1 = dj_tpu.JoinConfig(over_decom_factor=1, bucket_factor=4.0, join_out_factor=4.0)
    jprep, tprep = wd.jprepare(cfg1), wd.tprepare(cfg1)
    cfg2 = dataclasses.replace(cfg1, over_decom_factor=2)
    res, n = _assert_same(wd.auto(cfg2, jprep, tprep), 1024)
    assert n == 2 and res[4] is not tprep and res[4].config.over_decom_factor == 2

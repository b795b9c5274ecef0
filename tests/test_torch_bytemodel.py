"""dj_tpu_torch.obs.bytemodel against dj_tpu.obs.bytemodel.

``hbm_model_bytes`` must return dj_tpu's integer for the same numbers
and the same plan, over a grid: every plan tier (shuffle, local,
broadcast, salted), prepared and not, each merge tier (the port's sort,
merge and probe, dj_tpu's xla, pallas and probe) and the probe tier's
expansions (segment, hist), every expansion mode, packed and carry
plans and dj_tpu's bucketed sort, odf 1, 2 and 4, salted replicas 1 and
3. The port's ``JoinPlan`` reaches dj_tpu's terms through
``model_plan``, held here to dj_tpu's ``effective_plan`` under the
matching knobs. ``prepared_side_bytes`` is held to dj_tpu's on the same
prepared table (a dj_tpu side and its conversion; a port side with a
string payload and its numpy mirror), ``pipeline_model_bytes`` to the
sum of its stages.
"""

import itertools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dj_tpu
from dj_tpu.obs import bytemodel as jbm
from dj_tpu.ops import join as jjoin
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from dj_tpu_torch.core.table import Column, StringColumn, Table
from dj_tpu_torch.obs import bytemodel as tbm
from dj_tpu_torch.ops import join as tjoin

MODES = tuple(tbm.EXPAND_NAMES)
ODFS = (1, 2, 4)
# (plan tier, prepared, merge tiers): every branch of the model.
TIERS = [("shuffle", False, ("sort",)), ("local", False, ("sort",)),
         ("broadcast", False, ("sort",)), ("salted", False, ("sort",)),
         ("shuffle", True, ("sort", "merge", "probe")),
         ("broadcast", True, ("sort", "merge", "probe")),
         ("salted", True, ("sort", "merge", "probe"))]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jplan(plan: tbm.ModelPlan):
    return jjoin.JoinPlan(plan.scans, plan.expand, plan.packed, plan.carry, plan.sort)


def _plans():
    """(port plan, dj_tpu plan) pairs: every mode packed and unpacked,
    carry (which the gates send to ranks or hist), and dj_tpu's
    bucketed sort as a ModelPlan."""
    out = []
    for mode, packed in itertools.product(MODES, (True, False)):
        p = tjoin.JoinPlan(mode, packed, False)
        out.append((p, _jplan(tbm.model_plan(p))))
    for mode in ("ranks", "hist"):
        p = tjoin.JoinPlan(mode, False, True)
        out.append((p, _jplan(tbm.model_plan(p))))
    bucketed = tbm.ModelPlan("pallas", "pallas-vmeta", True, False, "bucketed")
    out.append((bucketed, _jplan(bucketed)))
    return out


@pytest.mark.parametrize("tier, prepared, merges", TIERS,
                         ids=[f"{t}-{'prepared' if p else 'unprepared'}" for t, p, _ in TIERS])
def test_hbm_model_bytes_equals_dj_tpu(tier, prepared, merges, monkeypatch):
    rows, right_rows, world, matches = 1_000_003, 750_001, 4, 300_007
    tcfg = tj.JoinConfig(bucket_factor=2.0, join_out_factor=1.3)
    jcfg = dj_tpu.JoinConfig(bucket_factor=2.0, join_out_factor=1.3)
    checked = 0
    for merge in merges:
        expands = ("segment", "hist") if merge == "probe" else ("segment",)
        for expand, odf, reps, (tplan, jplan) in itertools.product(expands, ODFS, (1, 3),
                                                                   _plans()):
            monkeypatch.setenv("DJT_PROBE_EXPAND", expand)
            monkeypatch.setenv("DJ_PROBE_EXPAND", expand)
            kw = dict(plan_tier=tier, right_rows=right_rows, world=world, salt_replicas=reps)
            got = tbm.hbm_model_bytes(rows, odf, tcfg, matches, tplan, prepared, merge, **kw)
            want = jbm.hbm_model_bytes(rows, odf, jcfg, matches, jplan, prepared,
                                       tbm.MERGE_NAMES[merge], **kw)
            assert isinstance(got, int) and got == want, (merge, expand, odf, reps, tplan)
            checked += 1
    assert checked >= len(_plans()) * len(ODFS) * 2


@pytest.mark.parametrize("carry", [False, True])
def test_model_plan_follows_dj_tpu_gates(carry, monkeypatch):
    """The port's effective_plan, mapped by model_plan, is dj_tpu's
    effective_plan under the matching knobs (the scan kernel armed,
    DJ_JOIN_EXPAND the mode's name), for each mode and shape."""
    monkeypatch.setenv("DJ_JOIN_SCANS", "pallas")
    for mode, single, strings, n_pay in itertools.product(MODES, (True, False), (False, True),
                                                          (1, 4)):
        monkeypatch.setenv("DJT_JOIN_EXPAND", mode)
        monkeypatch.setenv("DJ_JOIN_EXPAND", tbm.EXPAND_NAMES[mode])
        kw = dict(single_int_key=single, has_strings=strings, carry_payloads=carry)
        got = tbm.model_plan(tjoin.effective_plan(n_pay, **kw))
        want = jjoin.effective_plan(n_payload=n_pay, **kw)
        assert tuple(got) == tuple(want), (mode, single, strings, n_pay)


def test_pipeline_model_bytes_is_the_sum_of_its_stages():
    cfg = tj.JoinConfig()
    jcfg = dj_tpu.JoinConfig()
    plan = tjoin.JoinPlan("vmeta", True, False)
    stages = [dict(rows=4096, odf=2, config=cfg, matches=5000, plan=plan),
              dict(rows=5000, odf=1, config=cfg, matches=5000, plan=plan, plan_tier="local"),
              dict(rows=5000, odf=1, config=cfg, matches=7000, plan=plan,
                   plan_tier="broadcast", right_rows=100, world=4)]
    got = tbm.pipeline_model_bytes(stages)
    assert got == sum(tbm.hbm_model_bytes(**kw) for kw in stages)
    jstages = [{**kw, "config": jcfg, "plan": _jplan(tbm.model_plan(plan))} for kw in stages]
    assert got == jbm.pipeline_model_bytes(jstages)


def test_prepared_side_bytes_of_a_dj_tpu_side_and_its_conversion():
    rng = np.random.default_rng(3)
    keys = rng.permutation(900)[:600].astype(np.int64)
    cols = [keys, np.arange(600, dtype=np.int64), rng.integers(0, 9, 600).astype(np.int32)]
    jtopo = jmake_topology(jax.devices()[:2])
    jt, jc = jshard(jtopo, dj_tpu.from_arrays(*[jnp.asarray(c) for c in cols]))
    jside = dj_tpu.prepare_join_side(jtopo, jt, jc, [0], dj_tpu.JoinConfig(over_decom_factor=2),
                                     tier="shuffle")
    tside = convert.prepared_side_from(jside, tj.make_topology(["cpu"] * 2))
    want = jbm.prepared_side_bytes(jside)
    assert tbm.prepared_side_bytes(tside) == want > 0


def _mirror(side):
    """A numpy mirror of a port PreparedSide's batches, duck-typed as
    dj_tpu's model reads them."""
    def col(c):
        if isinstance(c, StringColumn):
            return types.SimpleNamespace(offsets=c.offsets.numpy(), chars=c.chars.numpy())
        return types.SimpleNamespace(data=c.data.numpy())

    return types.SimpleNamespace(batches=[
        (w.numpy(), types.SimpleNamespace(columns=[col(c) for c in p.columns]), n.numpy())
        for w, p, n in side.batches])


def test_prepared_side_bytes_with_a_string_payload():
    rng = np.random.default_rng(4)
    n = 400
    strings = [bytes(rng.integers(97, 123, rng.integers(0, 9))) for _ in range(n)]
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in strings])]).astype(np.int32)
    table = Table((Column(torch.from_numpy(rng.permutation(n).astype(np.int64)), tj.dtypes.int64),
                   StringColumn(torch.from_numpy(offsets),
                                torch.from_numpy(np.frombuffer(b"".join(strings), np.uint8)
                                                 .copy()))))
    topo = tj.make_topology(["cpu"] * 2)
    t, c = tj.shard_table(topo, table)
    side = tj.prepare_join_side(topo, t, c, [0], tj.JoinConfig(over_decom_factor=2))
    got = tbm.prepared_side_bytes(side)
    assert got == jbm.prepared_side_bytes(_mirror(side))
    assert any(isinstance(col, StringColumn) for _, p, _ in side.batches for col in p.columns)

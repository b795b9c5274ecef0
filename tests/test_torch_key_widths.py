"""Keys of two element widths: the port refuses them on every entry that
takes two tables' key columns; dj_tpu loses rows without a flag.

``hash_partition`` hashes each key column at its own width, so equal
values of an int64 and an int32 (or uint32) key land on different ranks
and their rows go missing at any world above 1. The port raises a
ValueError naming both dtypes and the pair's columns, at every world
size and before any sizing, probe or plan: ``distributed_inner_join``,
``distributed_inner_join_auto`` (before its first attempt: no heal),
each stage mode of a pipeline (shuffle, local and broadcast, checked in
``plan_pipeline`` before the stage's range probe) and
``distributed_inner_join_coalesced_unprepared`` (per member). Pairs of one width (int64 with uint64, int32 with uint32) give
every row. dj_tpu's join at a world of 4 on the same input returns fewer
rows than a numpy oracle with no flag set: the test notices if that
reference defect is ever fixed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dj_tpu
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch.resilience import ledger as tledger

PAIRS = [("int64", "int32"), ("int32", "int64"), ("int64", "uint32")]
SAME_WIDTH = [("int64", "uint64"), ("int32", "uint32")]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in tj.knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    tledger.reset()
    was = tj.obs.enabled()
    tj.obs.reset(reenable=True)
    tj.obs.drain()
    yield
    tj.obs.reset(reenable=was)
    tj.obs.drain()
    tledger.reset()
    torch.set_num_threads(threads)


def _arrays(ldt, rdt):
    """The re-anchor's probe: left keys arange(700), right keys
    arange(90), with row-number payloads."""
    left = [np.arange(700).astype(ldt), np.arange(700, dtype=np.int64)]
    right = [np.arange(90).astype(rdt), np.arange(90, dtype=np.int64)]
    return left, right


def _port(w, ldt, rdt):
    topo = tj.make_topology(["cpu"] * w)
    (l, lc), (r, rc) = (tj.shard_table(topo, tj.from_arrays(*a, device="cpu"))
                        for a in _arrays(ldt, rdt))
    return topo, l, lc, r, rc


def _raises(ldt, rdt):
    return pytest.raises(ValueError, match=rf"key pair 0 \(left column 0, right column 0\) "
                                           rf"joins {ldt} with {rdt}")


ENTRIES = ["join", "auto", "pipeline_shuffle", "pipeline_local", "pipeline_broadcast",
           "coalesced_unprepared"]


def _call(entry, topo, l, lc, r, rc):
    cfg = tj.JoinConfig(join_out_factor=4.0)
    if entry == "join":
        return tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0], cfg)
    if entry == "auto":
        return tj.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], cfg)
    if entry.startswith("pipeline_"):
        mode = entry.removeprefix("pipeline_")
        stage = tj.JoinStage(right=r, right_counts=rc, left_on=[0], right_on=[0], mode=mode,
                             right_partitioned=mode == "local")
        return tj.distributed_join_pipeline(
            topo, l, lc, [stage], cfg, left_partitioned_by=[0] if mode == "local" else None)
    return tj.distributed_inner_join_coalesced_unprepared(topo, [l, l], [lc, lc], [r, r],
                                                          [rc, rc], [0], [0], cfg)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("ldt, rdt", PAIRS)
@pytest.mark.parametrize("w", [1, 4])
def test_the_port_refuses_keys_of_two_widths(w, ldt, rdt, entry):
    topo, l, lc, r, rc = _port(w, ldt, rdt)
    with _raises(ldt, rdt):
        _call(entry, topo, l, lc, r, rc)
    # Raised before any probe, plan, dispatch or heal.
    assert tj.obs.drain() == []
    assert tj.obs.metrics_summary()["counters"] == {}
    assert tledger.entries() == {}


@pytest.mark.parametrize("ldt, rdt", SAME_WIDTH)
@pytest.mark.parametrize("w", [1, 4])
def test_pairs_of_one_width_give_every_row(w, ldt, rdt):
    topo, l, lc, r, rc = _port(w, ldt, rdt)
    out, counts, info = tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0],
                                                  tj.JoinConfig(join_out_factor=4.0))
    assert int(counts.sum()) == 90 and not any(bool(v.any()) for v in info.values())
    rows = tj.unshard_table(out, counts)
    assert sorted(rows.columns[1].data.tolist()) == list(range(90))


def test_the_member_named_in_a_coalesced_refusal():
    topo, l, lc, r, rc = _port(4, "int64", "int64")
    _, _, _, r32, rc32 = _port(4, "int64", "int32")
    with pytest.raises(ValueError, match=r"member 1\).*int64 with int32"):
        tj.distributed_inner_join_coalesced_unprepared(topo, [l, l], [lc, lc], [r, r32],
                                                       [rc, rc32], [0], [0])


@pytest.mark.parametrize("ldt, rdt", PAIRS)
def test_dj_tpu_loses_rows_without_a_flag_at_a_world_of_4(ldt, rdt):
    """The reference defect the port's refusal closes: dj_tpu's join of
    the same input at a world of 4 returns fewer rows than a numpy
    oracle, with every flag clear."""
    left, right = _arrays(ldt, rdt)
    oracle = int(np.isin(left[0].astype(np.int64), right[0].astype(np.int64)).sum())
    assert oracle == 90
    topo = jmake_topology(jax.devices()[:4])
    (l, lc), (r, rc) = (jshard(topo, dj_tpu.from_arrays(*[jnp.asarray(a) for a in cols]))
                        for cols in (left, right))
    _, counts, info = dj_tpu.distributed_inner_join(topo, l, lc, r, rc, [0], [0],
                                                    dj_tpu.JoinConfig(join_out_factor=4.0))
    assert int(np.asarray(counts).sum()) < oracle
    assert not any(np.asarray(v).any() for v in info.values())


@pytest.mark.parametrize("w", [1, 4])
def test_a_later_pipeline_stage_is_checked_on_the_chain_columns(w):
    """Stage 1 joins a column that stage 0's right side brought in (int32)
    against an int64 key: refused, naming the stage and the chain's
    column index, before stage 1's range probe."""
    topo = tj.make_topology(["cpu"] * w)
    left = [np.arange(200, dtype=np.int64), np.arange(200, dtype=np.int64)]
    mid = [np.arange(90, dtype=np.int64), np.arange(90, dtype=np.int32)]
    last = [np.arange(50, dtype=np.int64), np.arange(50, dtype=np.int64)]
    (l, lc), (m, mc), (r, rc) = (tj.shard_table(topo, tj.from_arrays(*a, device="cpu"))
                                 for a in (left, mid, last))
    stages = [tj.JoinStage(right=m, right_counts=mc, left_on=[0], right_on=[0]),
              tj.JoinStage(right=r, right_counts=rc, left_on=[2], right_on=[0])]
    with pytest.raises(ValueError, match=r"stage 1: key pair 0 \(left column 2, right column "
                                         r"0\) joins int32 with int64"):
        tj.distributed_join_pipeline(topo, l, lc, stages, tj.JoinConfig(join_out_factor=4.0))
    stages[1] = tj.JoinStage(right=r, right_counts=rc, left_on=[1], right_on=[0])
    out, counts, infos = tj.distributed_join_pipeline(topo, l, lc, stages,
                                                      tj.JoinConfig(join_out_factor=4.0))
    assert int(counts.sum()) == 50

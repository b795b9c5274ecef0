"""dj_tpu_torch.obs.skew and the skew probe's sites, against dj_tpu's.

The same count matrix gives dj_tpu's ``skew`` events, ``dj_skew_*``
gauges and aggregates; ``probe_due`` samples as dj_tpu's; the per-link
wire matrix of a 4-rank join equals dj_tpu's and each row sums to the
rank's ``dj_collective_bytes_total``; with ``DJT_OBS_SKEW`` and
``DJT_PLAN_ADAPT`` both armed a query runs one partition-count pass
(shared by the observation and the plan decision) and records dj_tpu's
events; the prepared, coalesced and two-level sites; a failed probe
warns and never fails its query; ``fleet_snapshot`` of one process.
The gloo world of 2's ``fleet_snapshot`` is the ``fleet`` case of
``tests/test_torch_process_world.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dj_tpu
from dj_tpu.obs import skew as jskew
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch import obs as tobs
from dj_tpu_torch.obs import recorder as trecorder
from dj_tpu_torch.obs import skew as tskew
from dj_tpu_torch.parallel import dist_join as tdist
from dj_tpu_torch.resilience import ledger as tledger

DROP = ("seq", "ts")


@pytest.fixture
def port_obs(monkeypatch):
    """The port's obs on with a clean registry, ring, ledger and
    reset-class knobs, on one torch thread; restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in tj.knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    was = tobs.enabled()
    tobs.reset(reenable=True)
    tobs.drain()
    tledger.reset()
    yield tobs
    tledger.reset()
    tobs.reset(reenable=was)
    tobs.drain()
    torch.set_num_threads(threads)


def _events(obs, etype):
    return [{k: v for k, v in e.items() if k not in DROP} for e in obs.events(etype)]


def _gauges(obs, prefix):
    return {k: v for k, v in obs.metrics_summary()["gauges"].items() if k.startswith(prefix)}


def _arrays(seed, n=480, hi=900):
    rng = np.random.default_rng(seed)
    probe = [rng.integers(0, hi, n).astype(np.int64), np.arange(n, dtype=np.int64)]
    build = [np.arange(0, hi, 3, dtype=np.int64), np.arange(hi // 3, dtype=np.int64)]
    return probe, build


def _port(w, *arrays, intra=None):
    topo = tj.make_topology(["cpu"] * w, intra_size=intra)
    return topo, *(tj.shard_table(topo, tj.from_arrays(*a, device="cpu")) for a in arrays)


def _jax(w, *arrays):
    topo = jmake_topology(jax.devices()[:w])
    return topo, *(jshard(topo, dj_tpu.from_arrays(*[jnp.asarray(c) for c in a]))
                   for a in arrays)


def test_record_partition_skew_matches_dj_tpu(obs_capture, port_obs):
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 50, (4, 8))
    counts[:, 5] += 400  # one heavy destination in batch 1
    for obs, mod in ((obs_capture, jskew), (port_obs, tskew)):
        with obs.query_ctx("q-skew", "t"):
            mod.record_partition_skew(counts, 4, 2, stage="join")
            mod.record_partition_skew(counts[:, :4], 4, 1, stage="prepared", topk=2)
    want, got = _events(obs_capture, "skew"), _events(port_obs, "skew")
    assert len(got) == 3 and got == want
    assert got[1]["top"][0] == [1, int(counts[:, 5].sum())]
    assert _gauges(port_obs, "dj_skew_") == _gauges(obs_capture, "dj_skew_")
    assert tskew.summary() == jskew.summary() and tskew.summary()["batches"] == 3


def test_probe_due_samples_as_dj_tpu(monkeypatch):
    monkeypatch.setenv("DJ_OBS_SKEW_EVERY", "3")
    monkeypatch.setenv("DJT_OBS_SKEW_EVERY", "3")
    for mod in (jskew, tskew):
        mod._clear()
        monkeypatch.setattr(mod, "_PROBE_SEEN_MAX", 3)
    keys = [("a",)] * 7 + [("b",), ("c",), ("d",), ("a",), ("b",)]
    got = [tskew.probe_due(k) for k in keys]
    assert got == [jskew.probe_due(k) for k in keys]
    assert got[:7] == [True, False, False, True, False, False, True]
    assert got[-2] is True  # "a" was evicted by the FIFO: counted afresh
    assert list(tskew._probe_seen) == list(jskew._probe_seen)
    for mod in (jskew, tskew):
        mod._clear()


def test_wire_matrix_of_a_4_rank_join(obs_capture, port_obs):
    """Each row of the matrix sums to the rank's collective bytes, and
    the matrix is dj_tpu's for the same join."""
    probe, build = _arrays(1)
    topo, (l, lc), (r, rc) = _port(4, probe, build)
    tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0], tj.JoinConfig(over_decom_factor=2))
    wm = tskew.wire_matrix()
    sent = sum(tobs.counter_series("dj_collective_bytes_total").values())
    assert wm["n"] == 4 and sent > 0
    assert wm["row_totals"] == [pytest.approx(sent)] * 4
    assert wm["total_bytes"] == pytest.approx(4 * sent)
    jtopo, (jl, jlc), (jr, jrc) = _jax(4, probe, build)
    dj_tpu.distributed_inner_join(jtopo, jl, jlc, jr, jrc, [0], [0],
                                  dj_tpu.JoinConfig(over_decom_factor=2))
    assert wm == jskew.wire_matrix()


def _count_probes(monkeypatch):
    calls = []
    real = tdist._partition_probe_counts

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tdist, "_partition_probe_counts", counted)
    return calls


def test_one_count_pass_with_both_knobs_armed(obs_capture, port_obs, monkeypatch):
    """DJT_OBS_SKEW and DJT_PLAN_ADAPT share one lazy pass a query; the
    skew and plan_adapt events are dj_tpu's."""
    for prefix in ("DJ_", "DJT_"):
        for name, value in (("OBS_SKEW", "1"), ("PLAN_ADAPT", "1"), ("BROADCAST_BYTES", "0")):
            monkeypatch.setenv(prefix + name, value)
    calls = _count_probes(monkeypatch)
    probe, build = _arrays(2)
    probe[0][::3] = 3  # a third of the probe rows on one key: the plan salts
    topo, (l, lc), (r, rc) = _port(4, probe, build)
    cfg = tj.JoinConfig(over_decom_factor=2, bucket_factor=4.0, join_out_factor=4.0)
    with port_obs.query_ctx("q1", "t"):
        tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0], cfg)
    assert len(calls) == 1
    (decision,) = _events(port_obs, "plan_adapt")
    assert decision["tier"] == "salted" and decision["source"] == "probe"
    with port_obs.query_ctx("q2", "t"):  # the decision replays; the skew still probes
        tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0], cfg)
    assert len(calls) == 2
    jtopo, (jl, jlc), (jr, jrc) = _jax(4, probe, build)
    jcfg = dj_tpu.JoinConfig(over_decom_factor=2, bucket_factor=4.0, join_out_factor=4.0)
    for q in ("q1", "q2"):
        with obs_capture.query_ctx(q, "t"):
            dj_tpu.distributed_inner_join(jtopo, jl, jlc, jr, jrc, [0], [0], jcfg)
    got = _events(port_obs, "skew")
    assert len(got) == 4 and got == _events(obs_capture, "skew")
    assert _events(port_obs, "plan_adapt") == _events(obs_capture, "plan_adapt")
    assert _gauges(port_obs, "dj_skew_") == _gauges(obs_capture, "dj_skew_")


def test_skew_every_probes_once_in_four_calls(port_obs, monkeypatch):
    monkeypatch.setenv("DJT_OBS_SKEW", "1")
    monkeypatch.setenv("DJT_OBS_SKEW_EVERY", "4")
    calls = _count_probes(monkeypatch)
    probe, build = _arrays(3)
    topo, (l, lc), (r, rc) = _port(2, probe, build)
    for _ in range(4):
        tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0])
    assert len(calls) == 1 and len(port_obs.events("skew")) == 1
    tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0])
    assert len(calls) == 2


def test_prepared_coalesced_and_two_level_sites(port_obs, monkeypatch):
    monkeypatch.setenv("DJT_OBS_SKEW", "1")
    probe, build = _arrays(4)
    topo, (l, lc), (r, rc) = _port(2, probe, build)
    cfg = tj.JoinConfig(over_decom_factor=2, key_range=(0, 900))
    want = tskew.batch_skew(tdist._partition_probe_counts(topo, l, lc, (0,), 2), 2, 2)
    prep = tj.prepare_join_side(topo, r, rc, [0], cfg, left_capacity=480)
    tj.distributed_inner_join(topo, l, lc, prep, None, [0], None, cfg)
    evs = _events(port_obs, "skew")
    assert [e["stage"] for e in evs] == ["prepared"] * 2
    assert [e["rows"] for e in evs] == [b["rows"] for b in want]
    port_obs.drain()
    tj.distributed_inner_join_coalesced(topo, [l, l], [lc, lc], prep, [0], cfg)
    tj.distributed_inner_join_coalesced_unprepared(topo, [l, l], [lc, lc], [r, r], [rc, rc],
                                                   [0], [0], cfg)
    assert [e["stage"] for e in _events(port_obs, "skew")] == ["coalesced"] * 8
    port_obs.drain()
    monkeypatch.setenv("DJT_PREPARED_TIER", "broadcast")
    bprep = tj.prepare_join_side(topo, r, rc, [0], tj.JoinConfig(key_range=(0, 900)),
                                 left_capacity=480)
    assert bprep.tier == "broadcast"
    tj.distributed_inner_join(topo, l, lc, bprep, None, [0], None, tj.JoinConfig(key_range=(0, 900)))
    topo2, (l2, lc2), (r2, rc2) = _port(4, probe, build, intra=2)
    tj.distributed_inner_join(topo2, l2, lc2, r2, rc2, [0], [0])
    with trecorder.suppress_epochs():
        tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0])
    assert port_obs.events("skew") == []


def test_a_failed_probe_warns_and_the_query_runs(port_obs, monkeypatch):
    monkeypatch.setenv("DJT_OBS_SKEW", "1")

    def boom(*a, **k):
        raise RuntimeError("no counts")

    monkeypatch.setattr(tdist, "_partition_probe_counts", boom)
    probe, build = _arrays(5)
    topo, (l, lc), (r, rc) = _port(2, probe, build)
    out, counts, info = tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0])
    assert int(counts.sum()) == int(np.isin(probe[0], build[0]).sum())
    (warn,) = port_obs.events("warning")
    assert warn["name"] == "skew_probe_failed" and "no counts" in warn["detail"]
    assert port_obs.events("skew") == []


def test_fleet_snapshot_of_one_process(obs_capture, port_obs):
    for obs, mod in ((obs_capture, jskew), (port_obs, tskew)):
        obs.roofline.observe_phase("dispatch", 0.25)
        obs.inc("dj_heal_total", 2)
        mod._clear()
        assert mod.rank_skew_summary()["gathered"] is False
    got, want = tskew.fleet_snapshot(), jskew.fleet_snapshot()
    assert got == want
    (row,) = got["ranks"]
    assert row["rank"] == 0 and row["heal_total"] == 2 and "dispatch" in row["phase_seconds"]
    assert got["stragglers"]["dispatch"]["ratio"] == 1.0
    assert tskew.rank_skew_summary() == {"ranks": 1, "gathered": False,
                                         "phases": got["stragglers"]}
    assert tobs.gauge_value("dj_rank_skew_ratio", phase="dispatch") == 1.0
    assert tskew.fleet_view()["ranks"] == got["ranks"]
    big = {"rank": 0, "skew": {"top": list(range(3000))}, "phase_seconds": {}}
    assert tskew._fit_payload(big) == b'{"rank": 0, "phase_seconds": {}, "truncated": ["skew"]}'

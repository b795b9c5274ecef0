"""dj_tpu_torch.obs.trace: query contexts, spans, the timeline store and
its export, as dj_tpu's ``tests/test_trace.py`` pins them for dj_tpu.

``query_ctx`` stamps every event recorded inside it and builds the
query's timeline; an orphan span is named; a timeline outlives the
ring's eviction; the store is bounded in queries and in events a query;
``export_trace`` renders chrome and perfetto JSON whose spans nest. The
port's context is a ContextVar, so the ranks of a world of threads
record into the caller's query. Both packages' stores give the same
summaries and exports of the same records.
"""

import json

import numpy as np
import pytest
import torch

from dj_tpu.obs import trace as jtrace
import dj_tpu_torch as tj
from dj_tpu_torch import obs
from dj_tpu_torch.obs import trace


@pytest.fixture
def tobs():
    was = obs.enabled()
    obs.reset(reenable=True)
    obs.drain()
    yield obs
    obs.reset(reenable=was)
    obs.drain()


def test_ctx_stamps_events_and_builds_timeline(tobs):
    with tobs.query_ctx("q-a", "tenantX"):
        assert tobs.current_query() == ("q-a", "tenantX")
        with tobs.span("query"):
            tobs.record("heal", stage="join", attempt=1)
            with tobs.span("run"):
                tobs.record("collectives", launches=3, total_bytes=99)
    assert tobs.current_query() is None
    tobs.record("heal", stage="join", attempt=2)  # outside: on no timeline
    tr = tobs.query_trace("q-a")
    assert tr["tenant"] == "tenantX"
    assert [e["type"] for e in tr["events"]] == ["span", "heal", "span", "collectives", "span",
                                                  "span"]
    assert all(e["query_id"] == "q-a" for e in tr["events"])
    assert tr["complete"] and tr["orphans"] == []
    assert tr["spans"]["query"] == {"begin": 1, "end": 1}
    assert trace.event_count("q-a", "heal") == 1
    assert tobs.query_trace("never-seen") is None


def test_orphan_span_detected(tobs):
    with tobs.query_ctx("q-orphan"):
        tobs.span_begin("query")
        tobs.span_begin("run")
        tobs.span_end("query")
    tr = tobs.query_trace("q-orphan")
    assert tr["orphans"] == ["run"] and not tr["complete"]
    assert [t["query_id"] for t in tobs.blackbox_traces()["open"]] == []
    box = tobs.blackbox_traces()
    assert [t["query_id"] for t in box["closed"]] == ["q-orphan"]


def test_timeline_survives_ring_eviction(tobs):
    with tobs.query_ctx("q-keep"):
        with tobs.span("query"):
            tobs.record("heal", stage="join", attempt=1)
    for i in range(tobs.ring_capacity() + 10):
        tobs.record("t_spam", i=i)
    assert all(e["type"] == "t_spam" for e in tobs.events())
    tr = tobs.query_trace("q-keep")
    assert tr["complete"] and trace.event_count("q-keep", "heal") == 1


def test_trace_store_bounded(tobs, monkeypatch):
    monkeypatch.setattr(trace, "_TRACES_MAX", 3)
    for i in range(5):
        with tobs.query_ctx(f"q-{i}"):
            tobs.record("t_mark", i=i)
    assert tobs.query_trace("q-0") is None and tobs.query_trace("q-1") is None
    assert tobs.query_trace("q-4") is not None
    assert len(tobs.recent_traces(100)) == 3 and trace.trace_count() == 3
    monkeypatch.setattr(trace, "_EVENTS_PER_TRACE", 4)
    with tobs.query_ctx("q-fat"):
        for i in range(10):
            tobs.record("t_mark", i=i)
    tr = tobs.query_trace("q-fat")
    assert len(tr["events"]) == 4 and tr["dropped"] == 6


def _record_a_query(o, qid):
    with o.query_ctx(qid, "tenantY"):
        with o.span("query"):
            o.record("heal", stage="join", attempt=1, flags=["join_overflow"])
            with o.span("run"):
                o.roofline.observe_phase("dispatch", 0.004, model_bytes=1e6, kind="wire",
                                         stage="join")
                o.record("pipeline", stage=0, stages=2, mode="local")
        o.span_begin("late")  # left open


@pytest.mark.parametrize("fmt", ["chrome", "perfetto"])
def test_export_trace_matches_dj_tpu(fmt, tobs, obs_capture):
    """Both packages export the same trace of the same records, in both
    formats, apart from the times; its spans nest and the open one is a
    bare "B"."""
    exports = []
    for o in (obs_capture, tobs):
        _record_a_query(o, "7:42")
        ex = o.export_trace("7:42", fmt)
        json.loads(json.dumps(ex))
        exports.append(ex)
    tex = exports[1]
    assert tex["metadata"]["rank"] == 7 and tex["metadata"]["format"] == fmt
    slices = {e["name"]: e for e in tex["traceEvents"] if e["ph"] == "X" and e["cat"] == "span"}
    q, r = slices["query"], slices["run"]
    assert q["ts"] <= r["ts"] and r["ts"] + r["dur"] <= q["ts"] + q["dur"] + 1e-3
    assert [e["name"] for e in tex["traceEvents"] if e["ph"] == "B"] == ["late"]

    def shape(ex):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")} | (
            {"args": {k: v for k, v in e["args"].items()
                      if k not in ("seconds", "roofline_frac")}} if "args" in e else {})
            for e in ex["traceEvents"]]

    assert shape(exports[1]) == shape(exports[0])
    assert {k: v for k, v in tex["metadata"].items() if k != "epoch_ts"} == {
        k: v for k, v in exports[0]["metadata"].items() if k != "epoch_ts"}
    with pytest.raises(ValueError, match="unknown export format"):
        tobs.export_trace("7:42", "svg")
    assert tobs.export_trace("never") is None


def test_ranks_of_a_thread_world_record_into_the_callers_query(tobs):
    """run_spmd runs each rank in a copy of the caller's context: an event
    recorded inside a rank carries the query."""
    from dj_tpu_torch.parallel.spmd import run_spmd

    topo = tj.make_topology(["cpu"] * 4)

    def body(comm, x):
        tobs.record("t_rank", rank=comm.rank())
        return x + 1

    with tobs.query_ctx("q-ranks", "t"):
        out = run_spmd(topo, body, torch.zeros(8))
    assert torch.equal(out, torch.ones(8))
    tr = tobs.query_trace("q-ranks")
    assert sorted(e["rank"] for e in tr["events"]) == [0, 1, 2, 3]
    assert tobs.current_query() is None


def test_a_join_timeline_in_a_thread_world(tobs):
    """An auto join's timeline at a world of 4: the probe, dispatch and
    sync phases of each attempt, its collectives and its heal, in
    dj_tpu's order, and the export's phase slices."""
    rng = np.random.default_rng(2)
    topo = tj.make_topology(["cpu"] * 4)
    (l, lc), (r, rc) = (tj.shard_table(topo, tj.from_arrays(*cols, device="cpu")) for cols in (
        [rng.integers(0, 300, 400), np.arange(400)], [np.arange(300), np.arange(300)]))
    with tobs.query_ctx("q-join"):
        tj.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0],
                                       tj.JoinConfig(join_out_factor=0.4))
    tr = tobs.query_trace("q-join")
    kinds = [e["type"] if e["type"] != "phase" else e["phase"] for e in tr["events"]]
    assert kinds == ["probe", "collectives", "dispatch", "sync", "heal",
                     "probe", "collectives", "dispatch", "sync"]
    phases = [e for e in tobs.export_trace("q-join")["traceEvents"] if e.get("cat") == "phase"]
    assert [e["name"] for e in phases] == ["join:probe", "join:dispatch", "join:sync"] * 2
    fracs = [e["args"]["roofline_frac"] for e in phases if e["args"]["roofline_frac"] is not None]
    assert len(fracs) == 2 and all(0 < f <= 1.05 for f in fracs)


def test_query_ctx_nests_and_clear_keeps_the_context(tobs):
    with tobs.query_ctx("outer", "a"):
        with tobs.query_ctx("inner", "b"):
            tobs.record("t_in")
        tobs.record("t_out")
        trace.clear()
        tobs.record("t_after")
    assert [e["type"] for e in tobs.query_trace("outer")["events"]] == ["t_after"]
    assert tobs.query_trace("inner") is None
    assert jtrace.current_query() is None  # dj_tpu's context is its own

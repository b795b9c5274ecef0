"""The phase clock's span tree (``parallel.spmd.record_phases``,
``utils.timing.span``): one record entry per top-level call, its root
``dj_call`` (``serve_run`` for a served dispatch) with the host stages
outside the ranks and ``untraced`` in rank 0's dict, and the local
join's passes as children of the phase they run in. With nothing
recording a span is its ``annotate`` range alone: no clock stamp, no
CUDA event, no synchronize. The scheduler's ``run`` phase takes the
device time of its ``serve_run`` events through ``obs.roofline``.
"""

import time

import numpy as np
import pytest
import torch

import dj_tpu_torch as tj
from dj_tpu_torch import obs
from dj_tpu_torch.obs import roofline
from dj_tpu_torch.parallel import spmd
from dj_tpu_torch.parallel.communicator import PhaseClock
from dj_tpu_torch.serve import scheduler as sched_mod
from dj_tpu_torch.utils import timing

N = 600
JOIN_CHILDREN = ("pack", "sort", "expand", "take")
# The spans each payload or key kind adds to the local join's four.
KIND_SPANS = {"int": (), "string_payload": ("strings",),
              "string_key": ("strings", "string_hash", "verify")}


@pytest.fixture(autouse=True)
def _quiet():
    tj.resilience.ledger.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    tj.resilience.ledger.reset()


def _words(keys) -> list:
    return [f"k{int(k):05d}-{'x' * (int(k) % 7)}".encode() for k in keys]


def _sides(kind: str, seed: int = 3):
    """(left, right) unsharded tables: left keys drawn from [0, N), right
    keys a permutation of them (each left row matches at most one), a
    payload on both sides; ``kind`` puts a string in the left payload or
    makes the key a string."""
    rng = np.random.default_rng(seed)
    lk, rk = rng.integers(0, N, N), rng.permutation(N)
    i64 = tj.dtypes.int64

    def col(a):
        return tj.Column(torch.from_numpy(np.asarray(a, np.int64)), i64)

    if kind == "string_key":
        left = tj.Table((tj.from_strings(_words(lk), device="cpu"), col(np.arange(N))))
        right = tj.Table((tj.from_strings(_words(rk), device="cpu"), col(np.arange(N))))
    else:
        pay = tj.from_strings(_words(lk), device="cpu") if kind == "string_payload" else col(lk)
        left = tj.Table((col(lk), pay))
        right = tj.Table((col(rk), col(np.arange(N))))
    return left, right


def _join(topo, left, right, **cfg):
    (l, lc), (r, rc) = tj.shard_table(topo, left), tj.shard_table(topo, right)
    return tj.distributed_inner_join(topo, l, lc, r, rc, [0], [0],
                                     tj.JoinConfig(char_out_factor=4.0, **cfg))


def _children_within_parents(ranks: list) -> None:
    """Each span key reads at most its parent: a phase's children the
    phase, every top-level key of rank 0 the root."""
    for phases in ranks:
        for key, ms in phases.items():
            parent = key.rsplit("/", 1)[0] if "/" in key else None
            if parent is not None and parent in phases and timing.is_span_key(key):
                assert ms <= phases[parent], (key, ms, parent, phases[parent])
    root = ranks[0]
    for key, ms in root.items():
        if key != "dj_call" and "/" not in key:
            assert ms <= root["dj_call"], (key, ms, root["dj_call"])
    assert root["untraced"] >= 0.0


@pytest.mark.parametrize("kind", sorted(KIND_SPANS))
@pytest.mark.parametrize("w", [1, 2])
def test_a_join_records_one_span_tree(w, kind):
    topo = tj.make_topology(["cpu"] * w)
    left, right = _sides(kind)
    with spmd.record_phases() as runs:
        _join(topo, left, right)
    assert len(runs) == 1 and len(runs[0]) == w
    root = runs[0][0]
    assert {"dj_call", "dj_range_probe", "dj_flags", "untraced"} <= set(root)
    for phases in runs[0]:
        want = {f"dj_join/{c}" for c in JOIN_CHILDREN + KIND_SPANS[kind]}
        assert want <= set(phases), sorted(phases)
        assert "dj_call" not in phases or phases is root
    _children_within_parents(runs[0])
    # The root's own keys are rank 0's alone.
    assert all("dj_call" not in r and "untraced" not in r for r in runs[0][1:])


@pytest.mark.parametrize("w", [1, 2])
def test_one_record_a_call_and_the_untraced_share_is_the_rest(w):
    topo = tj.make_topology(["cpu"] * w)
    left, right = _sides("int")
    with spmd.record_phases() as runs:
        _join(topo, left, right, over_decom_factor=2)
        _join(topo, left, right)
        (l, lc), (r, rc) = tj.shard_table(topo, left), tj.shard_table(topo, right)
        tj.distributed_inner_join_auto(topo, l, lc, r, rc, [0], [0], tj.JoinConfig())
    assert len(runs) == 3
    for ranks in runs:
        root = ranks[0]
        top = sum(ms for k, ms in root.items()
                  if not timing.is_span_key(k) or k in ("dj_range_probe", "dj_flags"))
        # The root covers its phases (rank 0's alone in one rank's world).
        if w == 1:
            assert top <= root["dj_call"] + 1e-6
            assert root["untraced"] <= root["dj_call"] - top + 1e-6


def test_a_prepared_and_a_coalesced_query_record_one_entry_each():
    topo = tj.make_topology(["cpu"])
    left, right = _sides("int")
    (l, lc), (r, rc) = tj.shard_table(topo, left), tj.shard_table(topo, right)
    prep = tj.prepare_join_side(topo, r, rc, [0], tj.JoinConfig(), left_capacity=l.capacity)
    with spmd.record_phases() as runs:
        tj.distributed_inner_join(topo, l, lc, prep, None, [0], None)
        tj.distributed_inner_join_coalesced(topo, [l, l], [lc, lc], prep, [0])
    assert len(runs) == 2
    for ranks in runs:
        assert {"dj_call", "dj_join", "dj_join/pack", "dj_join/sort", "dj_join/expand",
                "dj_join/take", "untraced"} <= set(ranks[0])
        _children_within_parents(ranks)


def test_a_prepare_outside_a_call_is_an_entry_of_its_own():
    topo = tj.make_topology(["cpu"])
    _, right = _sides("string_payload")
    right = tj.Table((right.columns[0], tj.from_strings(_words(range(N)), device="cpu")))
    r, rc = tj.shard_table(topo, right)
    with spmd.record_phases() as runs:
        tj.prepare_join_side(topo, r, rc, [0], tj.JoinConfig())
    assert len(runs) == 1
    assert {"dj_prepare", "dj_prepare/pack", "dj_prepare/sort",
            "dj_prepare/strings"} <= set(runs[0][0])
    assert "dj_call" not in runs[0][0]


def test_a_served_query_runs_from_dispatch_to_its_answer():
    topo = tj.make_topology(["cpu"])
    left, right = _sides("int")
    (l, lc), (r, rc) = tj.shard_table(topo, left), tj.shard_table(topo, right)
    with tj.QueryScheduler(tj.ServeConfig(), worker=False) as s:
        with spmd.record_phases() as runs:
            out = s.submit(topo, l, lc, r, rc, [0], [0], tj.JoinConfig()).result(timeout=300)
    assert int(out[1].sum()) > 0
    assert len(runs) == 1
    root = runs[0][0]
    assert {"serve_run", "dj_call", "dj_join", "dj_join/sort", "untraced"} <= set(root)
    assert root["serve_run"] >= root["dj_join"]
    assert root["serve_run"] >= root["dj_call"]


class _Counted:
    def __init__(self):
        self.n = 0

    def __call__(self, *a, **k):
        self.n += 1


@pytest.mark.parametrize("w", [1, 2])
def test_no_record_no_stamp_no_event_one_range_a_span(w, monkeypatch):
    stamps, events, syncs = _Counted(), _Counted(), _Counted()
    real_stamp = PhaseClock._stamp

    def stamp(self):
        stamps()
        return real_stamp(self)

    monkeypatch.setattr(PhaseClock, "_stamp", stamp)
    monkeypatch.setattr(torch.cuda, "Event", events)
    monkeypatch.setattr(torch.cuda, "synchronize", syncs)
    ranges, entered = [], _Counted()
    real_annotate, real_enter = timing.annotate, timing.span.__enter__

    def annotate(name, device=None):
        ranges.append(name)
        return real_annotate(name, device)

    def enter(self):
        entered()
        return real_enter(self)

    monkeypatch.setattr(timing, "annotate", annotate)
    monkeypatch.setattr(timing.span, "__enter__", enter)
    topo = tj.make_topology(["cpu"] * w)
    left, right = _sides("string_key")
    _join(topo, left, right)
    assert stamps.n == 0 and events.n == 0 and syncs.n == 0
    assert entered.n == len(ranges) > 0
    for key in ("dj_call", "dj_range_probe", "dj_join/sort", "dj_join/verify",
                "dj_join/string_hash"):
        assert key in ranges, key
    # The same call recording: the same ranges, now stamped.
    unrecorded = list(ranges)
    ranges.clear()
    with spmd.record_phases():
        _join(topo, left, right)
    assert sorted(ranges) == sorted(unrecorded) and stamps.n > 0


class _FakeEvent:
    """A CUDA event on the host clock: recorded at once, done at once."""

    made = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def port_obs():
    was = obs.enabled()
    obs.reset(reenable=True)
    obs.drain()
    yield obs
    obs.reset(reenable=was)
    obs.drain()


def test_observe_events_resolves_without_a_wait_and_calls_back(port_obs):
    got = []
    start, end = _FakeEvent(), _FakeEvent()
    start.record()
    end.record()
    with obs.query_ctx("q-ev", "tE"):
        roofline.observe_events("run", start, end, model_bytes=1e6, stage="serve",
                                then=got.append)
    assert roofline.resolve() == 0
    assert got == [pytest.approx(start.elapsed_time(end) / 1e3)]
    (ev,) = [e for e in obs.events("phase") if e["phase"] == "run"]
    assert ev["stage"] == "serve" and ev["query_id"] == "q-ev"
    obs.disable()
    roofline.observe_events("run", start, end, then=got.append)
    assert len(got) == 1 and roofline.pending_count() == 0


@pytest.mark.parametrize("enabled", [True, False])
def test_run_phase_takes_serve_runs_device_time_on_the_card(port_obs, monkeypatch, enabled):
    """The card's path on the CPU: a CUDA device stands in for the
    topology's, fake events for CUDA's. With obs enabled the ``run``
    phase and the tenant's device seconds are the events' time; with obs
    disabled no event is made."""
    monkeypatch.setattr(sched_mod, "_cuda_device", lambda topology: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    if not enabled:
        obs.disable()
    topo = tj.make_topology(["cpu"])
    left, right = _sides("int")
    (l, lc), (r, rc) = tj.shard_table(topo, left), tj.shard_table(topo, right)
    _FakeEvent.made = 0
    with tj.QueryScheduler(tj.ServeConfig(), worker=False) as s:
        t = s.submit(topo, l, lc, r, rc, [0], [0], tj.JoinConfig(), tenant="tR")
        t.result(timeout=300)
    roofline.resolve(wait=True)
    seconds = obs.counter_value("dj_tenant_device_seconds_total", tenant="tR")
    if not enabled:
        assert _FakeEvent.made == 0 and not seconds
        return
    assert _FakeEvent.made == 2
    start, end = t._run_events
    assert seconds == pytest.approx(start.elapsed_time(end) / 1e3)
    runs = [e for e in obs.events("phase") if e["phase"] == "run"]
    assert len(runs) == 1 and runs[0]["seconds"] == pytest.approx(seconds, abs=1e-6)

"""dj_tpu_torch.resilience.faults and the degradation ladder's host logic
against dj_tpu's.

Every case of ``tests/test_faults.py`` that is not marked slow, run
through both packages: the ``site@call=N`` grammar (the same accepts and
rejects; the messages name ``DJT_FAULT`` for ``DJ_FAULT``), exact call
firing, unarmed sites not counting, the env spec, ``configure`` over the
env, ``check`` raising ``FaultInjected(site, call)`` with its ``fault``
event and counter, and ``force_flags`` copying. Then the ladder unit for
unit: ``degrade_guard`` around a scripted attempt gives the same pins,
``degrade`` events, counters and propagation in both packages for each
tier's fault site, for a plain failure under active tiers, for the
routing errors that never pin and for a failure with no candidate tier;
``reset_pins`` restores each tier's knob; ``strip_pinned_wire`` drops the
wire options once pinned. The port's tiers are dj_tpu's less ``sort``,
``autotune`` and ``fleet`` (ROADMAP 10b), and the knobs are its own
(``DJT_*``), whose values map as the table below says. Last, where the
port parts from dj_tpu: a kernel that does not build or launch
(``KernelError``) and a device fault never pin, and a process world of
more than one process retries only an injected fault.
"""

import dataclasses
import os

import pytest
import torch

from dj_tpu import obs as jobs
from dj_tpu.resilience import errors as jerrors
from dj_tpu.resilience import faults as jfaults
from dj_tpu.resilience import ledger as jledger
from dj_tpu_torch import knobs, obs as tobs
from dj_tpu_torch import resilience as tres
from dj_tpu_torch.resilience import errors as terrors
from dj_tpu_torch.resilience import faults as tfaults
from dj_tpu_torch.resilience import ledger as tledger

PACKAGES = {"dj_tpu": (jfaults, jerrors, jobs), "port": (tfaults, terrors, tobs)}

# Each port tier: the knob value that makes it active in either package,
# and its baseline in either (dj_tpu's merge baseline is "xla").
TIER_ENV = {
    "merge": ({"DJ_JOIN_MERGE": "pallas"}, {"DJT_JOIN_MERGE": "merge"}, ("xla", "sort")),
    "adapt": ({"DJ_PLAN_ADAPT": "1"}, {"DJT_PLAN_ADAPT": "1"}, ("0", "0")),
    "expand": ({"DJ_PROBE_EXPAND": "pallas"}, {"DJT_PROBE_EXPAND": "pallas"}, ("hist", "hist")),
    "prepared_tier": ({"DJ_PREPARED_TIER": "auto"}, {"DJT_PREPARED_TIER": "auto"},
                      ("shuffle", "shuffle")),
    "wire": ({}, {}, ("uncompressed", "uncompressed")),
    "autotune": ({"DJ_AUTOTUNE": "1"}, {"DJT_AUTOTUNE": "1"}, ("0", "0")),
    "fleet": ({"DJ_FLEET_DIR": "/nonexistent/fleet"}, {"DJT_FLEET_DIR": "/nonexistent/fleet"},
              ("", "")),
}
LADDER = ("merge", "wire", "expand", "prepared_tier", "adapt", "autotune", "fleet")


@pytest.fixture(autouse=True)
def clean_slate(monkeypatch):
    """No spec, no counts, no pins and no reset-class knob in either
    package, obs on and empty in both, one torch thread; all undone
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("DJ_FAULT", raising=False)
    was = {k: o.enabled() for k, (_, _, o) in PACKAGES.items()}
    for f, e, o in PACKAGES.values():
        f.reset()
        e.reset_pins()
        o.reset(reenable=True)
        o.drain()
    tledger.reset()
    jledger.reset()
    yield
    for k, (f, e, o) in PACKAGES.items():
        f.reset()
        e.reset_pins()
        o.reset(reenable=was[k])
        o.drain()
    tledger.reset()
    torch.set_num_threads(threads)


def _port_names(text: str) -> str:
    """dj_tpu's message with the port's variable name (DJT_FAULT)."""
    return text.replace("(DJ_FAULT ", "(DJT_FAULT ")


def _ladder_events(o) -> list:
    """The fault and degrade events recorded so far, without times."""
    return [{k: v for k, v in e.items() if k not in ("seq", "ts")}
            for e in o.drain() if e["type"] in ("fault", "degrade")]


# --- the spec contract ---------------------------------------------------


def test_parse_spec_grammar_matches_dj_tpu():
    spec = "join.join_overflow@call=1, codec@call=2,codec@call=4"
    want = {"join.join_overflow": frozenset({1}), "codec": frozenset({2, 4})}
    assert tfaults.parse_spec(spec) == jfaults.parse_spec(spec) == want
    assert tfaults.parse_spec(" , ") == jfaults.parse_spec(" , ") == {}


@pytest.mark.parametrize(
    "bad", ["join_overflow", "a@call=x", "a@calls=1", "a@call=0", "@call=1", "a@call", "a@call=-2"])
def test_parse_spec_rejects_as_dj_tpu(bad):
    with pytest.raises(ValueError) as j:
        jfaults.parse_spec(bad)
    with pytest.raises(ValueError) as t:
        tfaults.parse_spec(bad)
    assert str(t.value) == str(j.value).replace("DJ_FAULT", "DJT_FAULT")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_exact_call_firing_no_rng(pkg):
    f = PACKAGES[pkg][0]
    f.configure("site@call=2")
    assert [f.should_fire("site") for _ in range(3)] == [False, True, False]
    assert f.call_count("site") == 3


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_unarmed_sites_do_not_count(pkg):
    f = PACKAGES[pkg][0]
    f.configure("armed@call=1")
    assert not f.should_fire("other")
    assert f.call_count("other") == 0
    assert f.should_fire("armed")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_noop_when_unset(pkg):
    f = PACKAGES[pkg][0]
    assert not f.active()
    assert not f.should_fire("anything")
    info = {"join_overflow": False}
    assert f.force_flags("join", info) is info  # the same object: no copy
    f.check("module_build")  # does not raise
    assert f.call_count("anything") == 0


def test_env_spec_names_each_packages_variable(monkeypatch):
    monkeypatch.setenv("DJ_FAULT", "s@call=1")
    assert jfaults.active() and not tfaults.active()
    monkeypatch.delenv("DJ_FAULT")
    monkeypatch.setenv("DJT_FAULT", "s@call=1")
    assert tfaults.active() and not jfaults.active()
    assert tfaults.should_fire("s") and not tfaults.should_fire("s")
    monkeypatch.setenv("DJT_FAULT", "bad")
    with pytest.raises(ValueError, match="DJT_FAULT"):
        tfaults.active()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_configure_overrides_env(pkg, monkeypatch):
    f = PACKAGES[pkg][0]
    monkeypatch.setenv("DJT_FAULT" if pkg == "port" else "DJ_FAULT", "envsite@call=1")
    f.configure("progsite@call=1")
    assert not f.should_fire("envsite")
    assert f.should_fire("progsite")
    f.configure(None)  # back to the env
    assert f.should_fire("envsite")


def test_check_raises_typed_with_one_event_and_counter():
    got = {}
    for pkg, (f, e, o) in PACKAGES.items():
        f.arm("communicator", 1)
        with pytest.raises(e.FaultInjected) as ei:
            f.check("communicator")
        assert ei.value.site == "communicator" and ei.value.call == 1
        assert isinstance(ei.value, RuntimeError)
        assert str(ei.value) == "fault injected: communicator@call=1 (DJ_FAULT / faults.arm)" \
            .replace("DJ_", "DJT_" if pkg == "port" else "DJ_")
        f.check("communicator")  # call 2 is not armed
        got[pkg] = (_ladder_events(o), o.counter_value("dj_fault_injected_total",
                                                       site="communicator"))
    assert got["port"] == got["dj_tpu"] == (
        [{"type": "fault", "site": "communicator", "call": 1}], 1)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_arm_merges_without_resetting_counts(pkg):
    f = PACKAGES[pkg][0]
    f.arm("a", 2)
    assert not f.should_fire("a")
    f.arm("a", 3)
    assert f.should_fire("a") and f.should_fire("a")
    for bad in ((), (0,), (1, -1)):
        with pytest.raises(ValueError):
            f.arm("a", *bad)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_force_flags_copies(pkg):
    f = PACKAGES[pkg][0]
    f.configure("join.join_overflow@call=1,join.char_overflow@call=2")
    info = {"join_overflow": False, "char_overflow": False}
    out = f.force_flags("join", info)
    assert out is not info and out["join_overflow"] is True
    assert info["join_overflow"] is False  # the caller's dict untouched
    assert out["char_overflow"] is False
    # The keys are consulted in sorted order: char_overflow's call 2 is
    # the second call's.
    second = f.force_flags("join", info)
    assert second["char_overflow"] is True and second["join_overflow"] is False
    assert f.force_flags("prepared", info) is info


# --- the ladder, unit for unit ----------------------------------------------


def test_the_ladder_is_dj_tpus_less_the_unported_tiers():
    gone = {"sort"}
    assert set(terrors.TIER_BASELINE) == set(jerrors.TIER_BASELINE) - gone
    assert terrors._SITE_TIER == {s: t for s, t in jerrors._SITE_TIER.items() if t not in gone}
    for tier, (knob, baseline) in terrors.TIER_BASELINE.items():
        jknob, jbaseline = jerrors.TIER_BASELINE[tier]
        assert (knob is None) == (jknob is None) and baseline == TIER_ENV[tier][2][1]
        assert knob is None or knob == "DJT_" + jknob[3:]
        assert jbaseline == TIER_ENV[tier][2][0]
    assert sorted(tres.__all__) == sorted(__import__("dj_tpu").resilience.__all__)


def _activate(monkeypatch, tiers):
    for t in tiers:
        jenv, tenv, _ = TIER_ENV[t]
        for k, v in {**jenv, **tenv}.items():
            monkeypatch.setenv(k, v)


class _Opts:
    """A config-like object with compression options (the wire tier)."""

    left_compression = ("cascaded",)
    right_compression = None


def _guard(pkg, script, tiers, wire=False):
    """degrade_guard over attempts that raise ``script``'s entries in
    turn, then return "served". Returns (outcome, attempts, pins, the
    fault and degrade events, dj_degrade_total per tier)."""
    f, e, o = PACKAGES[pkg]
    errs = {"FaultInjected": lambda site: e.FaultInjected(site, 1),
            "PlanMismatch": lambda _: e.PlanMismatch("structural"),
            "CapacityExhausted": lambda _: e.CapacityExhausted("budget", stage="join"),
            "DeadlineExceeded": lambda _: e.DeadlineExceeded("late", where="healing"),
            "RuntimeError": lambda msg: RuntimeError(msg)}
    calls = []

    def attempt():
        calls.append(1)
        if len(calls) <= len(script):
            kind, arg = script[len(calls) - 1]
            raise errs[kind](arg)
        return "served"

    try:
        outcome = e.degrade_guard("test_call", attempt, tiers=tiers,
                                  config=_Opts() if wire else None)
    except Exception as exc:  # noqa: BLE001 - compared between packages
        outcome = (type(exc).__name__, _port_names(str(exc)))
    events = _ladder_events(o)
    for ev in events:
        if ev["type"] == "degrade":
            ev["reason"] = _port_names(ev["reason"])
            if ev["tier"] == "merge":
                ev["baseline"] = "sort"  # dj_tpu's merge baseline is "xla"
    counts = {t: o.counter_value("dj_degrade_total", tier=t) for t in LADDER}
    pins = {t: _port_names(r) for t, r in e.pinned_tiers().items()}
    return outcome, len(calls), pins, events, counts


def _same_in_both(script, tiers, wire=False):
    j = _guard("dj_tpu", script, tiers, wire)
    t = _guard("port", script, tiers, wire)
    assert t == j
    return t


@pytest.mark.parametrize("site", sorted(terrors._SITE_TIER))
def test_a_tier_site_pins_its_own_tier(site, monkeypatch):
    """The site's tier is pinned even with another tier active before it
    in the ladder, with one degrade event and dj_degrade_total{tier} = 1;
    the retry is served."""
    tier = terrors._SITE_TIER[site]
    _activate(monkeypatch, LADDER)
    outcome, attempts, pins, events, counts = _same_in_both(
        [("FaultInjected", site)], LADDER, wire=True)
    assert outcome == "served" and attempts == 2
    assert pins == {tier: f"test_call: FaultInjected: fault injected: {site}@call=1 "
                          f"(DJT_FAULT / faults.arm)"}
    assert [ev["type"] for ev in events] == ["degrade"] and events[0]["tier"] == tier
    assert counts == {t: int(t == tier) for t in LADDER}
    knob = terrors.TIER_BASELINE[tier][0]
    if knob is not None:
        assert os.environ[knob] == TIER_ENV[tier][2][1]
    terrors.reset_pins()
    jerrors.reset_pins()
    if knob is not None:
        assert os.environ[knob] == TIER_ENV[tier][1][knob]


def test_a_site_whose_tier_is_inactive_or_unlisted_propagates(monkeypatch):
    _activate(monkeypatch, ("merge",))
    for tiers in (("merge",), ("merge", "wire")):
        # codec names the wire tier, which is inactive here (no options).
        outcome, attempts, pins, events, _ = _same_in_both([("FaultInjected", "codec")], tiers)
        assert outcome == ("FaultInjected", "fault injected: codec@call=1 (DJT_FAULT / faults.arm)")
        assert attempts == 1 and pins == {} and events == []
    outcome, _, pins, _, _ = _same_in_both([("FaultInjected", "pallas_merge")], ("wire",),
                                           wire=True)
    assert outcome[0] == "FaultInjected" and pins == {}


def test_a_plain_failure_pins_the_first_active_tier_each_retry(monkeypatch):
    """A failure that names no tier (module_build, or any exception) pins
    the first active unpinned tier of the call's ladder, one a retry,
    until the attempt is served or no tier is left."""
    _activate(monkeypatch, ("merge", "expand"))
    script = [("FaultInjected", "module_build"), ("RuntimeError", "a kernel failed")]
    outcome, attempts, pins, events, counts = _same_in_both(
        script, ("merge", "wire", "expand", "prepared_tier"))
    assert outcome == "served" and attempts == 3
    assert list(pins) == ["merge", "expand"]
    assert pins["expand"] == "test_call: RuntimeError: a kernel failed"
    assert counts["merge"] == counts["expand"] == 1
    terrors.reset_pins()
    jerrors.reset_pins()
    outcome, attempts, pins, _, _ = _same_in_both(script * 2, ("merge", "expand"))
    assert outcome == ("FaultInjected",
                       "fault injected: module_build@call=1 (DJT_FAULT / faults.arm)")
    assert attempts == 3
    assert list(pins) == ["merge", "expand"]


@pytest.mark.parametrize("kind", ["PlanMismatch", "CapacityExhausted", "DeadlineExceeded"])
def test_routing_errors_never_pin(kind, monkeypatch):
    _activate(monkeypatch, LADDER)
    outcome, attempts, pins, events, counts = _same_in_both([(kind, None)], LADDER, wire=True)
    assert outcome[0] == kind and attempts == 1
    assert pins == {} and events == [] and not any(counts.values())


def test_degrade_guard_propagates_without_candidate_tier():
    outcome, attempts, pins, _, _ = _same_in_both([("RuntimeError", "baseline failure")],
                                                  ("wire", "merge", "adapt"))
    assert outcome == ("RuntimeError", "baseline failure") and attempts == 1 and pins == {}


# --- where the port parts from dj_tpu -----------------------------------------


def _port_guard(exc, topology=None):
    """The port's degrade_guard with every tier active over an attempt
    that raises ``exc`` once: (outcome, attempts, pins, events, knobs)."""
    calls = []

    def attempt():
        calls.append(1)
        if len(calls) == 1:
            raise exc
        return "served"

    try:
        outcome = terrors.degrade_guard("test_call", attempt, tiers=LADDER, config=_Opts(),
                                        topology=topology)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        outcome = e
    knob_values = {k: os.environ.get(k) for k, _ in terrors.TIER_BASELINE.values() if k}
    return outcome, len(calls), terrors.pinned_tiers(), _ladder_events(tobs), knob_values


@pytest.mark.parametrize("exc", [
    terrors.KernelError("merge_sorted_u64: CUDA launch failed with error 700"),
    terrors.KernelError("kernel build failed:\nmerge_sorted_u64: nvcc exit 1"),
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
], ids=["launch", "build", "device_fault"])
def test_a_kernel_failure_never_pins(exc, monkeypatch):
    """A kernel that does not build or launch, or a device fault, fails
    the call with every tier active: no tier's baseline serves in its
    place, nothing is pinned, no degrade event, every knob unchanged."""
    _activate(monkeypatch, LADDER)
    before = {k: os.environ.get(k) for k, _ in terrors.TIER_BASELINE.values() if k}
    outcome, attempts, pins, events, knob_values = _port_guard(exc)
    assert outcome is exc and attempts == 1
    assert pins == {} and events == [] and knob_values == before


def test_a_failed_launch_raises_kernel_error():
    from dj_tpu_torch.ops import cuda_build

    with pytest.raises(terrors.KernelError, match="merge_sorted_u64: CUDA launch failed"):
        cuda_build.check(700, "merge_sorted_u64")
    cuda_build.check(0, "merge_sorted_u64")


@pytest.mark.parametrize("processes,retries", [(1, True), (2, False)])
def test_a_process_world_retries_only_an_injected_fault(processes, retries, monkeypatch):
    """In a process world of more than one process a plain failure
    propagates unpinned (a retry there would reissue this process's
    collectives alone); an injected fault, which every process consults
    alike, still pins its tier and retries. A world of one process
    retries both, as dj_tpu's one controller does."""
    from dj_tpu_torch.parallel.topology import Topology

    topo = Topology((torch.device("cpu"),), rank=0, process_count=processes)
    _activate(monkeypatch, LADDER)
    err = RuntimeError("a peer-local failure")
    outcome, attempts, pins, events, _ = _port_guard(err, topo)
    if retries:
        assert outcome == "served" and attempts == 2 and list(pins) == ["merge"]
    else:
        assert outcome is err and attempts == 1 and pins == {} and events == []
    terrors.reset_pins()
    outcome, attempts, pins, _, _ = _port_guard(terrors.FaultInjected("pallas_merge", 1), topo)
    assert outcome == "served" and attempts == 2 and list(pins) == ["merge"]


@pytest.mark.parametrize("tier", [t for t in LADDER if t != "wire"])
def test_pin_baseline_is_idempotent_and_reset_pins_restores_the_knob(tier, monkeypatch):
    knob = terrors.TIER_BASELINE[tier][0]
    jknob = jerrors.TIER_BASELINE[tier][0]
    _activate(monkeypatch, (tier,))
    before = os.environ[knob]
    for _ in range(2):
        terrors.pin_baseline(tier, "test")
        jerrors.pin_baseline(tier, "test")
    assert os.environ[knob] == TIER_ENV[tier][2][1] and os.environ[jknob] == TIER_ENV[tier][2][0]
    assert terrors.tier_pinned(tier) and terrors.pinned_tiers() == jerrors.pinned_tiers() == {
        tier: "test"}
    assert tobs.counter_value("dj_degrade_total", tier=tier) == \
        jobs.counter_value("dj_degrade_total", tier=tier) == 1
    terrors.reset_pins()
    jerrors.reset_pins()
    assert os.environ[knob] == before and not terrors.tier_pinned(tier)
    monkeypatch.delenv(knob)
    terrors.pin_baseline(tier, "test")
    terrors.reset_pins()
    assert knob not in os.environ


def test_strip_pinned_wire_matches_dj_tpu():
    import dj_tpu
    from dj_tpu_torch import convert

    opts = (dj_tpu.ColumnCompressionOptions("cascaded", dj_tpu.CascadedOptions(1, 0, True)),)
    jcfg = dj_tpu.JoinConfig(left_compression=opts)
    tcfg = convert.join_config_from(jcfg)
    for e, cfg in ((jerrors, jcfg), (terrors, tcfg)):
        assert e.strip_pinned_wire(cfg) is cfg and e.strip_pinned_wire(None) is None
        e.pin_baseline("wire", "test")
        stripped = e.strip_pinned_wire(cfg)
        assert stripped.left_compression is None and stripped.right_compression is None
        assert dataclasses.replace(stripped, left_compression=cfg.left_compression) == cfg
        plain = type(cfg)()
        assert e.strip_pinned_wire(plain) is plain

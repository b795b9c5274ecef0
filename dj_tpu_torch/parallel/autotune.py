"""The per-signature plan autotuner: measured truth turned into control.

Counterpart of ``dj_tpu/parallel/autotune.py``. A human sets the plan
knobs and the degradation ladder is the only controller that reacts;
this module closes the loop with the reference's sampling idiom (its
compression auto-selector: sample, price the candidates, pick one, run
with it) applied to a whole plan.

On a plan signature's first sighting under ``DJT_AUTOTUNE=1``, and
never again (plan_adapt's decide-once contract), the tuner builds a
small candidate set over the plan space:

- ``odf`` in ``DJT_AUTOTUNE_ODF`` (default 1,2,4; unprepared plans
  only: a PreparedSide's batch count is fixed at its prepare),
- the merge tier in ``DJT_AUTOTUNE_MERGE`` (default sort,probe,merge,
  dj_tpu's xla,probe,pallas; prepared plans only),
- the probe tier's expansion in ``DJT_AUTOTUNE_EXPAND`` (default
  segment,hist; a prepared plan on the probe tier only),
- one coarser shape-bucket grid ratio (only with ``DJT_SHAPE_BUCKET=1``),
- the salt fan-out, only within a salted decision plan_adapt already
  persisted: the tuner picks knobs inside the tier plan_adapt chose,
  never another tier.

It prices every candidate without running it
(``dist_join.price_plan_candidate``: the port compiles no module, so the
price is the byte model of the candidate's plan), confirms the two
cheapest by bytes with one timed probe dispatch each (under
``roofline.phase("autotune_probe")``, and, inside the pricing, with the
collective accounting suppressed), and persists the winner as an
``autotune`` ledger record, as plan_adapt persists its decision: it
replays after a restart with no probe, and a torn tail of the ledger
file is skipped.

**Drift demotes.** A model excursion (:func:`note_drift`, fed by the
query scheduler's drift audit, ``serve.admission.reprice``) or a regression in the signature's
latency window (:func:`note_latency`: the latest result above
``DJT_AUTOTUNE_REGRESS`` times the trailing median of
``DJT_AUTOTUNE_WINDOW`` results) flags the signature; its next resolve
re-tunes once, at most ``DJT_AUTOTUNE_RETUNE_MAX`` times, after which
the record demotes to the defaults (persisted, so a restart replays the
demotion too).

**One decision in a process world.** dj_tpu has one controller; the
port plans on every process, and the processes must issue the same
exchanges. So with a topology of more than one process,
:func:`resolve` takes rank 0's step (serve, replay, demote or tune) on
every process, and a tune takes rank 0's candidate list, each
candidate's largest price and largest probe seconds over the
processes: each process ranks and picks from the same numbers (one
``all_gather_object`` over the default group a step).

**Failures route to the ladder.** Tier ``"autotune"`` (baseline
``DJT_AUTOTUNE=0``) owns the fault sites ``autotune_probe`` (each timed
probe dispatch) and ``autotune_apply`` (a config's application). A
faulted tune propagates out of :func:`resolve`; the caller's
``degrade_guard(..., tiers=("autotune",))`` pins the tier (one
``degrade`` event) and the retry serves the defaults. The probe runs
its dispatch without the ladder (``dist_join.price_plan_candidate``),
so no other tier is pinned inside a candidate's env; a pin taken
inside a tuned dispatch's env outlives it (:func:`_env_override`).

Observed as dj_tpu's: a ``tune`` event with ``action`` tune, retune,
replay or demote, ``dj_autotune_total{action}`` and
``dj_autotune_flag_total{reason}``. Stdlib and the host layers only at
import: the pricing lives in dist_join.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import threading
from collections import deque
from typing import Callable, Optional

from .. import knobs
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs
from ..obs import roofline as obs_roofline
from ..resilience import errors as resil
from ..resilience import faults
from ..resilience import ledger as dj_ledger
from .agree import gather as _gather
from .agree import multi_process as _multi_process

__all__ = [
    "TunedDecision",
    "apply_config",
    "demote",
    "dispatch_scope",
    "enabled",
    "make_tuner",
    "note_drift",
    "note_latency",
    "resolve",
    "tuned_from_entry",
    "tunez_summary",
]

MERGE_CHOICES = ("sort", "probe", "merge")
EXPAND_CHOICES = ("segment", "hist", "pallas")


@dataclasses.dataclass(frozen=True)
class TunedDecision:
    """One signature's tuned plan knobs. None on an axis leaves its
    default alone (a demoted record is all None). ``source``: probe,
    ledger or demote."""

    odf: Optional[int] = None
    merge: Optional[str] = None
    expand: Optional[str] = None
    bucket_ratio: Optional[float] = None
    salt_replicas: Optional[int] = None
    source: str = "probe"
    retunes: int = 0
    probe_s: Optional[float] = None


# The process's tuner state, all under _lock:
#   _DECISIONS[sig] -> TunedDecision resolved in this process
#   _EVIDENCE[sig]  -> the candidates' prices and probe times
#   _INFLIGHT       -> signatures being tuned now (a concurrent dispatch
#                      of one serves the defaults: no wait, no 2nd tune)
#   _RETUNE[sig]    -> the reason of a pending re-tune
#   _LATENCY[sig]   -> the sliding result-latency window (seconds)
_lock = threading.Lock()
_DECISIONS: dict = {}
_EVIDENCE: dict = {}
_INFLIGHT: set = set()
_RETUNE: dict = {}
_LATENCY: dict = {}

_tls = threading.local()


def enabled() -> bool:
    """``DJT_AUTOTUNE`` truthy. The ladder's pin writes 0 there, so a
    pinned process reads disabled: one switch for the operator and the
    ladder."""
    return knobs.read_bool("DJT_AUTOTUNE")


def retune_max() -> int:
    return max(0, knobs.read_int("DJT_AUTOTUNE_RETUNE_MAX"))


def _csv_knob(name: str) -> tuple:
    return tuple(p.strip() for p in str(knobs.read(name) or "").split(",") if p.strip())


def odf_candidates() -> tuple:
    out = []
    for p in _csv_knob("DJT_AUTOTUNE_ODF"):
        try:
            v = int(p)
        except ValueError:
            continue
        if v >= 1 and v not in out:
            out.append(v)
    return tuple(out) or (1, 2, 4)


def merge_candidates() -> tuple:
    out = [p for p in _csv_knob("DJT_AUTOTUNE_MERGE") if p in MERGE_CHOICES]
    return tuple(dict.fromkeys(out)) or MERGE_CHOICES


def expand_candidates() -> tuple:
    out = [p for p in _csv_knob("DJT_AUTOTUNE_EXPAND") if p in EXPAND_CHOICES]
    return tuple(dict.fromkeys(out)) or ("segment", "hist")


def tuned_from_entry(entry: Optional[dict]) -> Optional[TunedDecision]:
    """The persisted ``autotune`` ledger record as a TunedDecision
    (source ``ledger``), or None when the entry has none or a torn or
    foreign one."""
    at = (entry or {}).get("autotune")
    if not isinstance(at, dict) or "source" not in at:
        return None
    try:
        odf, merge, expand = at.get("odf"), at.get("merge"), at.get("expand")
        ratio, reps = at.get("bucket_ratio"), at.get("salt_replicas")
        return TunedDecision(
            odf=None if odf is None else int(odf),
            merge=None if merge is None else str(merge),
            expand=None if expand is None else str(expand),
            bucket_ratio=None if ratio is None else float(ratio),
            salt_replicas=None if reps is None else int(reps),
            source="ledger",
            retunes=int(at.get("retunes", 0)),
            probe_s=None if at.get("probe_s") is None else float(at["probe_s"]),
        )
    except (TypeError, ValueError):
        return None


def _record_event(sig: str, decision: TunedDecision, action: str, **extra) -> None:
    obs.inc("dj_autotune_total", action=action)
    obs.record("tune", action=action, sig=sig[:200], source=decision.source, odf=decision.odf,
               merge=decision.merge, expand=decision.expand,
               bucket_ratio=decision.bucket_ratio, salt_replicas=decision.salt_replicas,
               retunes=decision.retunes,
               probe_s=None if decision.probe_s is None else round(decision.probe_s, 6),
               **extra)


def _persist(sig: str, decision: TunedDecision, evidence) -> None:
    dj_ledger.update(sig, autotune={
        "odf": decision.odf, "merge": decision.merge, "expand": decision.expand,
        "bucket_ratio": decision.bucket_ratio, "salt_replicas": decision.salt_replicas,
        "source": decision.source, "retunes": decision.retunes,
        "probe_s": None if decision.probe_s is None else round(decision.probe_s, 6),
        "candidates": list(evidence or ()),
    })
    # The salt axis lands inside plan_adapt's record: the decision replay
    # is the one owner of salted dispatch.
    if decision.salt_replicas is not None:
        pa = (dj_ledger.lookup(sig) or {}).get("plan_adapt")
        if isinstance(pa, dict) and pa.get("tier") == "salted":
            dj_ledger.update(sig, plan_adapt={**pa, "replicas": int(decision.salt_replicas)})


@contextlib.contextmanager
def _env_override(name: str, value: Optional[str]):
    """``name`` set to ``value`` for the body. A ladder pin wins: a knob
    whose tier is pinned is left at its baseline, and a pin taken inside
    the body keeps the baseline after it (``resil.keep_pin_past_scope``),
    so the env and ``pinned_tiers()`` agree and ``reset_pins`` restores
    the operator's value, not the override."""
    if value is None or resil.knob_pinned(name):
        yield
        return
    with knobs.scoped({name: value}, keep=resil.keep_pin_past_scope):
        yield


def _candidate_env(cand: dict):
    """The env overrides a candidate is priced and probed under: the same
    for both, so the priced plan is the probed one."""
    stack = contextlib.ExitStack()
    if cand.get("merge") is not None:
        stack.enter_context(_env_override("DJT_JOIN_MERGE", str(cand["merge"])))
    if cand.get("expand") is not None:
        stack.enter_context(_env_override("DJT_PROBE_EXPAND", str(cand["expand"])))
    if cand.get("bucket_ratio") is not None:
        stack.enter_context(_env_override("DJT_SHAPE_BUCKET_RATIO", str(cand["bucket_ratio"])))
    return stack


def _candidate_space(config, *, prepared: bool, sig: str) -> list:
    """The candidate set (module docstring): dicts of axis overrides, the
    default (empty) always first, so "the defaults win" is a verdict
    with evidence. The resolved merge tier and expansion are the default
    and are not listed again (two equal plans would take both probes),
    and an axis whose tier the ladder pinned has no other candidate."""
    cands: list = [{}]
    if prepared:
        from ..ops.join import resolve_merge_impl, resolve_probe_expand

        cur_merge = resolve_merge_impl()
        if not resil.tier_pinned("merge"):
            cands += [{"merge": m} for m in merge_candidates() if m != cur_merge]
        if cur_merge == "probe" and not resil.tier_pinned("expand"):
            cur_expand = resolve_probe_expand()
            cands += [{"expand": e} for e in expand_candidates() if e != cur_expand]
    else:
        cur = getattr(config, "over_decom_factor", 1)
        cands += [{"odf": o} for o in odf_candidates() if o != cur]
        pa = (dj_ledger.lookup(sig) or {}).get("plan_adapt")
        if isinstance(pa, dict) and pa.get("tier") == "salted":
            try:
                reps = int(pa.get("replicas", 2))
            except (TypeError, ValueError):
                reps = 2
            cands.append({"salt_replicas": reps * 2})
    from . import shape_bucket

    if shape_bucket.enabled():
        cands.append({"bucket_ratio": round(shape_bucket.grid_ratio() * 1.28, 4)})
    return cands


def _score(price: dict) -> float:
    """A candidate's rank: its bytes, else its peak; unpriced ones last."""
    for k in ("bytes_accessed", "peak_hbm_bytes"):
        v = price.get(k)
        if v is not None:
            return float(v)
    return float("inf")


def _worst(values: list) -> list:
    """Per candidate, the largest of the processes' values (``values``:
    one list a process); None where any process has None."""
    return [None if any(v is None for v in col) else max(col) for col in zip(*_gather(values))]


def make_tuner(topology, left, left_counts, right, right_counts=None, left_on=(),
               right_on=None, config=None) -> Callable:
    """The tune function of one dispatch's arguments for :func:`resolve`
    (a closure, so a test can stand a counting stub in): prices every
    candidate with ``dist_join.price_plan_candidate``, probes the two
    cheapest and returns ``(winner axes, probe seconds, evidence)``.

    In a process world of more than one process every process tunes
    together, and each step is made common, for the processes must
    issue the same exchanges in the probes and in the chain after them:
    rank 0's candidate list; a candidate's price is the largest any
    process gives it (infeasible if any process finds it so); and its
    probe seconds are the largest any process measured, the time of a
    dispatch that ends when its slowest rank does. Every process then
    ranks and picks from the same numbers."""

    def tune(sig: str):
        from . import dist_join

        multi = _multi_process(topology)
        cands = _candidate_space(config, prepared=hasattr(right, "batches"), sig=sig)
        if multi:
            cands = _gather(cands)[0]
        rows, probes, scores = [], [], []
        for cand in cands:
            row = dict(cand)
            try:
                with _candidate_env(cand):
                    cfg = config
                    if cand.get("odf") is not None:
                        cfg = dataclasses.replace(config, over_decom_factor=int(cand["odf"]))
                    price, probe = dist_join.price_plan_candidate(
                        topology, left, left_counts, right, right_counts, left_on, right_on,
                        cfg, salt_replicas=cand.get("salt_replicas"))
            except Exception as e:  # noqa: BLE001 - an infeasible candidate is evidence
                row.update(infeasible=True, error=type(e).__name__)
                price = probe = None
            else:
                row.update({k: price.get(k) for k in
                            ("tier", "flops", "bytes_accessed", "peak_hbm_bytes")})
            rows.append(row)
            probes.append(probe)
            scores.append(None if price is None else _score(price))
        if multi:
            scores = _worst(scores)
        priced = []
        for i, (row, probe, score) in enumerate(zip(rows, probes, scores)):
            if score is None:
                if probe is not None:
                    row.update(infeasible=True, error="infeasible on another process")
                continue
            row["score"] = score
            priced.append((score, i))
        if not priced:
            return {}, None, rows
        top = [i for _, i in sorted(priced)[:2]]
        seconds = []
        for i in top:
            # The stand-in for any probe dispatch failure: it propagates,
            # and the caller's ladder pins tier "autotune".
            faults.check("autotune_probe")
            with _candidate_env(cands[i]), obs_roofline.phase("autotune_probe", stage="autotune"):
                seconds.append(probes[i]())
        if multi:
            seconds = _worst(seconds)
        best_s, winner = None, {}
        for i, s in zip(top, seconds):
            rows[i]["probe_s"] = round(s, 6)
            if best_s is None or s < best_s:
                best_s, winner = s, cands[i]
        return winner, best_s, rows

    return tune


def _local_step(sig: str) -> tuple:
    """What this process's state says :func:`resolve` does for ``sig``,
    its state updated to match: ``("serve", decision)``, ``("replay",
    decision)``, ``("demote", decision, reason)`` or ``("tune", action,
    retunes, reason)`` (the signature then in flight)."""
    with _lock:
        decision = _DECISIONS.get(sig)
        reason = _RETUNE.get(sig)
        replayed = None
        if decision is None:
            entry = dj_ledger.lookup(sig)
            replayed = tuned_from_entry(entry)
            if replayed is not None:
                _DECISIONS[sig] = decision = replayed
                _EVIDENCE.setdefault(
                    sig, list((entry or {}).get("autotune", {}).get("candidates") or ()))
                reason = None  # a record just replayed is not flagged
        if sig in _INFLIGHT:
            return ("serve", decision)
        if decision is not None and reason is None:
            # A persisted decision's first sighting in this process: one
            # replay event, no probe.
            return ("replay" if replayed is not None else "serve", decision)
        if decision is not None and decision.retunes >= retune_max():
            decision = TunedDecision(source="demote", retunes=decision.retunes)
            _DECISIONS[sig] = decision
            _RETUNE.pop(sig, None)
            return ("demote", decision, reason)
        _INFLIGHT.add(sig)
        if decision is None:
            return ("tune", "tune", 0, reason)
        return ("tune", "retune", decision.retunes + 1, reason)


def _agree(sig: str, step: tuple) -> tuple:
    """Rank 0's step for every process of a process world, each
    process's state brought to it: a process whose ledger, flags or
    in-flight set differ from rank 0's must not tune alone, nor skip a
    tune the others make (the probes are collective dispatches)."""
    agreed = _gather(step)[0]
    with _lock:
        if step[0] == "tune":
            _INFLIGHT.discard(sig)
        if agreed[0] == "tune":
            _INFLIGHT.add(sig)
        elif agreed[1] is not None:
            _DECISIONS[sig] = agreed[1]
            _RETUNE.pop(sig, None)
    return agreed


def resolve(sig: str, tune_fn: Callable, *, topology=None) -> Optional[TunedDecision]:
    """The per-signature tune or replay (module docstring). Returns the
    signature's TunedDecision, or None when the tuner is off or a tune
    of the same signature is running (the dispatch then serves the
    defaults). A persisted record replays with no probe; a flagged
    signature re-tunes once, up to ``DJT_AUTOTUNE_RETUNE_MAX`` times,
    then demotes. ``tune_fn(sig) -> (axes, probe_s, evidence)`` is
    :func:`make_tuner`'s closure or a stub. With ``topology`` a process
    world of more than one process, every process takes rank 0's step
    (one object all-gather over the default group a call): all serve,
    replay, demote or tune alike."""
    if not enabled():
        return None
    step = _local_step(sig)
    if _multi_process(topology):
        step = _agree(sig, step)
    kind = step[0]
    if kind == "serve":
        return step[1]
    if kind == "replay":
        _record_event(sig, step[1], "replay")
        return step[1]
    if kind == "demote":
        _, decision, reason = step
        _persist(sig, decision, _EVIDENCE.get(sig))
        _record_event(sig, decision, "demote", reason=str(reason)[:200])
        return decision
    _, action, retunes, reason = step
    try:
        winner, probe_s, evidence = tune_fn(sig)
        decision = TunedDecision(
            odf=winner.get("odf"), merge=winner.get("merge"), expand=winner.get("expand"),
            bucket_ratio=winner.get("bucket_ratio"), salt_replicas=winner.get("salt_replicas"),
            source="probe", retunes=retunes, probe_s=probe_s)
        _persist(sig, decision, evidence)
        with _lock:
            _DECISIONS[sig] = decision
            _EVIDENCE[sig] = list(evidence)
            _RETUNE.pop(sig, None)
        extra = {"candidates": len(evidence)}
        if reason:
            extra["reason"] = str(reason)[:200]
        _record_event(sig, decision, action, **extra)
        return decision
    finally:
        with _lock:
            _INFLIGHT.discard(sig)


def demote(sig: str, reason: str) -> Optional[TunedDecision]:
    """Demote ``sig`` to the defaults (an operator's or the scheduler's
    call), persisted so a restart replays the demotion."""
    if not enabled():
        return None
    with _lock:
        decision = _DECISIONS.get(sig) or tuned_from_entry(dj_ledger.lookup(sig))
        if decision is None:
            return None
        _RETUNE.pop(sig, None)
        decision = TunedDecision(source="demote", retunes=decision.retunes)
        _DECISIONS[sig] = decision
    _persist(sig, decision, _EVIDENCE.get(sig))
    _record_event(sig, decision, "demote", reason=str(reason)[:200])
    return decision


def apply_config(decision: Optional[TunedDecision], config):
    """A dispatch's tuned config: the decision's odf in
    ``over_decom_factor`` (the env axes ride :func:`dispatch_scope`).
    Fault site ``autotune_apply`` stands in for a failure here: a half
    applied config routes to the ladder, never to a dispatch."""
    if decision is None:
        return config
    faults.check("autotune_apply")
    if decision.odf is not None and decision.odf != getattr(config, "over_decom_factor",
                                                            decision.odf):
        config = dataclasses.replace(config, over_decom_factor=int(decision.odf))
    return config


@contextlib.contextmanager
def dispatch_scope(decision: Optional[TunedDecision], sig: Optional[str] = None):
    """Run a dispatch under the decision's env axes (merge tier, probe
    expansion, bucket ratio: the overrides it was priced under), with
    ``sig`` ambient for :func:`note_drift`. A ladder pin of the merge or
    expand tier wins over the tuned preference, also one taken during
    the dispatch (:func:`_env_override`)."""
    prev = getattr(_tls, "sig", None)
    _tls.sig = sig
    try:
        with contextlib.ExitStack() as stack:
            if decision is not None:
                stack.enter_context(_env_override("DJT_JOIN_MERGE", decision.merge))
                stack.enter_context(_env_override("DJT_PROBE_EXPAND", decision.expand))
                if decision.bucket_ratio is not None:
                    stack.enter_context(_env_override("DJT_SHAPE_BUCKET_RATIO",
                                                      str(decision.bucket_ratio)))
            yield
    finally:
        _tls.sig = prev


def note_drift(ratio: float, sig: Optional[str] = None) -> None:
    """A model excursion: flag ``sig`` (else the ambient one of
    :func:`dispatch_scope`) for one re-tune. A no-op for an untuned
    signature."""
    if not enabled():
        return
    sig = sig if sig is not None else getattr(_tls, "sig", None)
    if sig is None:
        return
    with _lock:
        if sig in _DECISIONS and sig not in _RETUNE:
            _RETUNE[sig] = f"model_xla_ratio {float(ratio):.3g}"
            obs.inc("dj_autotune_flag_total", reason="drift")


def note_latency(sig: str, seconds: float) -> None:
    """One result latency of a tuned signature into its window: a full
    window whose latest exceeds ``DJT_AUTOTUNE_REGRESS`` times the
    trailing median flags one re-tune. Heal-learned factors then widen
    the tuned record (:func:`_widen_from_ledger`)."""
    if not enabled():
        return
    with _lock:
        if sig not in _DECISIONS:
            return
        size = max(4, knobs.read_int("DJT_AUTOTUNE_WINDOW"))
        win = _LATENCY.get(sig)
        if win is None or win.maxlen != size:
            win = _LATENCY[sig] = deque(win or (), maxlen=size)
        win.append(float(seconds))
        if len(win) == win.maxlen and sig not in _RETUNE:
            med = statistics.median(list(win)[:-1])
            if med > 0 and win[-1] > med * max(1.0, knobs.read_float("DJT_AUTOTUNE_REGRESS")):
                _RETUNE[sig] = (f"latency regression {win[-1]:.4g}s vs trailing median "
                                f"{med:.4g}s")
                obs.inc("dj_autotune_flag_total", reason="regression")
    _widen_from_ledger(sig)


def _widen_from_ledger(sig: str) -> None:
    """Heal-learned factors widen the tuned record through
    ``ledger.wider_factors`` (the one owner of monotone factor growth),
    so a replayed tune starts at the healed sizing."""
    entry = dj_ledger.lookup(sig)
    learned = (entry or {}).get("factors")
    at = (entry or {}).get("autotune")
    if not learned or not isinstance(at, dict):
        return
    current = at.get("factors") or {}
    wider = dj_ledger.wider_factors(learned, current)
    if wider:
        dj_ledger.update(sig, autotune={**at, "factors": {**current, **wider}})


def flagged(sig: str) -> Optional[str]:
    with _lock:
        return _RETUNE.get(sig)


def tunez_summary() -> dict:
    """Every tuned signature's decision and evidence, and the tuner's
    counters (dj_tpu's ``/tunez`` payload)."""
    with _lock:
        sigs = {sig: {"odf": d.odf, "merge": d.merge, "bucket_ratio": d.bucket_ratio,
                      "salt_replicas": d.salt_replicas, "source": d.source,
                      "retunes": d.retunes, "probe_s": d.probe_s, "flagged": _RETUNE.get(sig),
                      "candidates": list(_EVIDENCE.get(sig) or ())}
                for sig, d in _DECISIONS.items()}
        inflight = sorted(_INFLIGHT)

    def by(name, label):
        return {dict(k).get(label, "?"): v
                for k, v in obs_metrics.counter_series(name).items()}

    return {"enabled": enabled(), "retune_max": retune_max(), "signatures": sigs,
            "inflight": inflight,
            "counters": {"tunes": by("dj_autotune_total", "action"),
                         "flags": by("dj_autotune_flag_total", "reason")}}


def _clear() -> None:
    with _lock:
        _DECISIONS.clear()
        _EVIDENCE.clear()
        _INFLIGHT.clear()
        _RETUNE.clear()
        _LATENCY.clear()


# The tuner's state clears with the rest of the obs state (a hook, as
# roofline's and skew's).
obs._aux_resets.append(_clear)

"""Chaos soak of the serving stack: the scheduler and its observatory
survive every way a worker fails.

Counterpart of the JAX package's ``scripts/chaos_soak.py``, with its
three arms, each a function here:

- the main walk (:func:`main_walk`, the default arm);
- the fleet drill (:func:`fleet_drill`, ``--fleet``);
- the hard-death arm (:func:`hard_death`, ``--hard-death``).

**The main walk** sends a fixed query mix through ``QueryScheduler``
while deterministic faults (``faults.configure``, no randomness) walk
every site family the serving path consults, the 24 specs of
``FAULT_WALK`` (the first is the fault-free baseline). The adaptive
planner (``DJT_PLAN_ADAPT=1``, a broadcast budget that fits the small
build sides, a lowered salt ratio), the skew probe (``DJT_OBS_SKEW=1``),
the probe merge tier (``DJT_JOIN_MERGE=probe``), the measured admission
gate (``DJT_SERVE_MEASURED_HBM=1``), the prepared build tiers
(``DJT_PREPARED_TIER=auto``) and the per-signature autotuner
(``DJT_AUTOTUNE=1``) are armed throughout. The mix: the uniform pair
unprepared, prepared twice (a coalescable pair), a heavy-hitter probe
(half its rows on keys 7, 211 and 499), a 128-row broadcast build side,
a broadcast-prepared 32-row side, a salted-prepared heavy-hitter side,
a two-stage pipeline, a zero deadline and an over-budget config; a
fresh-shape probe of ``rows // 2`` rows in the ``probe_expand``
iteration, and the demoted side of a faulted prepare. Key ranges scale
with ``--rows`` so rows per key stay those of 2048 rows on 500 keys.

Every iteration holds: exactly one terminal state for every ticket
within ``TIMEOUT_S``, a result or one of ``ALLOWED``; a result's row
count equal to the numpy oracle; on each ``NEW_TIER_SITES`` and
``FLEET_SITES`` iteration exactly one pin of the site's tier and no
``FaultInjected`` terminal; on each autotune iteration exactly one
``autotune`` pin; no signature tuned twice. After the walk: every
query's timeline closed (its ``query`` span, no orphan, a terminal
``serve`` event for a ticket), the skew events fired, and the broadcast
and salted tiers engaged both as plans and as prepared tiers.

Two of dj_tpu's invariants read XLA, which the port has not:

- its strict HLO audit becomes ``collective_audits``: after the walk,
  with faults, pins and the tuner off and the skew probe quiet (dj_tpu
  audits the query's module, not the probe's), each audited query
  dispatches once while the walk counts the in-process transport's
  collectives by kind, ``dj_collective_launches_total`` and the sorts of
  ``ops.merge.sort_u64``. The bounds are dj_tpu's contracts: a
  broadcast-prepared query issues no collective (``bc_prepared_query``);
  a salted-prepared one at least one all-to-all
  (``salted_prepared_query``); a prepared one at most half the
  unprepared query's all-to-alls (``prepared_halves_collectives``); the
  broadcast plan no all-to-all and at least one all-gather
  (``broadcast_query``); the probe tier no sort of L or more words, L
  the query's left rows a rank, while the merge tier on the same query
  does sort them (``probe_query``, and proof that the count sees sorts);
- its XLA truth becomes the device half of measured truth
  (``DJT_SERVE_MEASURED_HBM=1``). On the CPU the gate has no device to
  read: no measured reject (dj_tpu's no-op on its mesh). On the card,
  under a budget of the card's bytes, the gate is live and outranks the
  model at the door: it answers the over-budget submit and may refuse
  no forecast the model admits; the allocator sample of a last
  ``/healthz`` read equals ``torch.cuda.memory_allocated()`` read
  around it.

Fault sites that dj_tpu consults only while it traces a module
(``module_build``, ``communicator``, ``probe_expand``, ``codec``, the
merge sites) are consulted on every dispatch attempt here; the specs
are dj_tpu's all the same.

**The fleet drill** (``--fleet``) runs subprocess peers (this module
with ``--fleet-child MODE ROWS``) sharing one ``DJT_FLEET_DIR`` under a
short lease TTL: (1) a live peer owns a prepared side, and the parent's
identical submit defers to it (one ``dj_fleet_peer_defer_total``, no
duplicate prepare) and is served row-exact; (2) a peer SIGKILLed while
it holds the prepare lease, whose lease the parent reclaims (one
``dj_fleet_lease_reclaimed_total``); (3) a peer that settled a healed
plan into the manifest and died, whose factors the parent replays
(``dj_fleet_replay_total`` >= 1, no prepare-stage heal, equal factors
in both manifest records). The children serve on ``--device``: on the
card each holds its own CUDA context on the one GPU.

**The hard-death arm** proves that the observatory outlives the
scheduler. A child process (``--hard-death-child``) arms the black box
from ``DJT_OBS_BLACKBOX``, submits 4 queries to a ``QueryScheduler``
with a worker thread, and sends itself SIGTERM with the queries in
flight, as a preempted worker dies. The parent audits what it left:

1. the child died by the signal (exit -15, or 143 through a shell);
2. no bare traceback in its output;
3. exactly one bundle, with every section whole and reason ``sigterm``
   (and the dump's own ``blackbox`` event in its ring);
4. a submitted query whose timeline is open, its ``query`` span begun
   and not ended;
5. the reader, ``dj_tpu_torch/scripts/blackbox_read.py`` (run by its
   path: it is stdlib only), exits 0 and names that query.

The hard-death child serves phase 4's generated tables (selectivity
0.3, unique build keys) at ``--rows`` build and probe rows with the
admission budget off (a full-width query's forecast exceeds the
default): the arm tests the black box, not the door.

Each arm prints one JSON summary line (``"metric": "chaos_soak"``,
``"chaos_soak_fleet"`` or ``"chaos_soak_hard_death"``) and exits 0 only
when it holds no violation. ``--device cuda`` (the default) serves on
the card, ``--device cpu`` on CPU tensors; ``--world`` ranks (threads of
this process) serve the walk and the drill.

Usage: python -m dj_tpu_torch.scripts.chaos_soak [--fleet | --hard-death]
       [--device cuda|cpu] [--rows N] [--world W] [--blackbox-dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 600.0
SECTIONS = ("meta", "traces", "ring", "metrics", "knobs", "serve", "ledger", "fleet",
            "coordination")

# The walk: every site family the serving path consults, each with an
# exact-call spec, and one repeated-fire spec per stage that pushes a
# heal ladder into typed exhaustion.
FAULT_WALK = (
    None,  # the baseline: no fault, every query a result
    "module_build@call=1",
    "communicator@call=1",
    "join.join_overflow@call=1",
    "join.shuffle_overflow@call=1",
    "join.char_overflow@call=1",
    ",".join(f"join.join_overflow@call={i}" for i in range(1, 5)),
    "prepared.join_overflow@call=1",
    "prepared.char_overflow@call=1",
    "prepared.prepared_plan_mismatch@call=1",
    ",".join(f"prepared.join_overflow@call={i}" for i in range(1, 5)),
    # A plan mismatch re-prepares, and the re-prepare's build meets a
    # forced shuffle overflow: the prepare.* family on the live path.
    "prepared.prepared_plan_mismatch@call=1,prepare.shuffle_overflow@call=1",
    # The skew-adaptive plans: a failing broadcast or salted body pins
    # the "adapt" baseline and the query runs again on the shuffle plan.
    "broadcast@call=1",
    "salted@call=1",
    # The autotuner: a faulted probe dispatch or apply pins "autotune"
    # once, and the retry serves the hand-set config.
    "autotune_probe@call=1",
    "autotune_apply@call=1",
    # The prepared build tiers and the probe expansion: each pins its
    # own tier once (NEW_TIER_SITES) and never ends a query.
    "probe_expand@call=1",
    "bc_prepared_query@call=1",
    "salted_prepared_query@call=1",
    "prepare_broadcast@call=1",
    "prepare_salted@call=1",
    # Fleet coordination, armed for its iteration only (a throwaway
    # DJT_FLEET_DIR and an index cache in front of the scheduler): each
    # pins the "fleet" tier once and serving goes on process-local.
    "fleet.lease_acquire@call=1",
    "fleet.lease_heartbeat@call=1",
    "fleet.publish@call=1",
)

# The prepared-tier sites walked above: site -> the ladder tier a fault
# must pin, exactly once in its iteration.
NEW_TIER_SITES = {
    "probe_expand": "expand",
    "bc_prepared_query": "prepared_tier",
    "salted_prepared_query": "prepared_tier",
    "prepare_broadcast": "prepared_tier",
    "prepare_salted": "prepared_tier",
}

# Walked with DJT_FLEET_DIR armed for that iteration only; each fault
# must pin the "fleet" tier exactly once.
FLEET_SITES = ("fleet.lease_acquire", "fleet.lease_heartbeat", "fleet.publish")

ALLOWED = (
    "result", "AdmissionRejected", "QueueFull", "DeadlineExceeded",
    "CapacityExhausted", "FaultInjected", "BackendError", "PlanMismatch",
)

# dj_tpu's walk: 2048 rows on keys [0, 500). The hot keys of the
# heavy-hitter sides, and the broadcast sides' fixed row counts.
BASE_ROWS, BASE_KEYS = 2048, 500
HOT_KEYS = (7, 211, 499)
SMALL_ROWS, TINY_ROWS = 128, 32
# The knobs the walk arms for its whole run, restored after it.
WALK_KNOBS = {
    "DJT_OBS_SKEW": "1",
    "DJT_PLAN_ADAPT": "1",
    "DJT_BROADCAST_BYTES": "8000",
    "DJT_SALT_RATIO": "1.3",
    "DJT_JOIN_MERGE": "probe",
    "DJT_SERVE_MEASURED_HBM": "1",
    "DJT_PREPARED_TIER": "auto",
    "DJT_AUTOTUNE": "1",
}


def _env(**kv):
    """``kv`` in the environment for the body (None unsets); restored after."""
    from dj_tpu_torch import knobs

    return knobs.scoped(kv)


def _device(device: str):
    import torch

    if device == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cpu")


def _topology(dj, dev, world: int):
    return dj.make_topology([str(dev) if dev.type == "cuda" else "cpu"] * world)


def _matches(*keys, hi: int) -> int:
    """The inner join's row count of key columns joined on equality, all
    of them in [0, hi): the sum over keys of the product of counts."""
    prod = np.ones(hi, np.int64)
    for k in keys:
        prod *= np.bincount(k, minlength=hi)
    return int(prod.sum())


class _Collectives:
    """Counts the in-process transport's collectives by kind, and the
    sorts of ``ops.merge.sort_u64`` by size, while it is entered (the
    walk's own wrappers, removed on exit)."""

    KINDS = ("all_to_all_start", "all_gather", "all_reduce", "shift_start")

    def __enter__(self):
        from dj_tpu_torch.parallel import communicator
        from dj_tpu_torch.ops import join, merge

        self.counts = dict.fromkeys(self.KINDS, 0)
        self.sorts: list = []
        cls = communicator.InProcessTransport
        self.saved = [(cls, k, getattr(cls, k)) for k in self.KINDS]
        for cls_, kind, fn in self.saved:
            setattr(cls_, kind, self._counted(kind, fn))
        sort = merge.sort_u64

        def counted_sort(words):
            self.sorts.append(int(words.shape[0]))
            return sort(words)

        self.saved += [(merge, "sort_u64", sort), (join, "sort_u64", join.sort_u64)]
        merge.sort_u64 = join.sort_u64 = counted_sort
        return self

    def _counted(self, kind, fn):
        def counted(transport, *a, **k):
            self.counts[kind] += 1
            return fn(transport, *a, **k)
        return counted

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)

    def take(self) -> tuple:
        """(collectives by kind, sort sizes) since the last take."""
        out = (dict(self.counts), list(self.sorts))
        self.counts = dict.fromkeys(self.KINDS, 0)
        self.sorts.clear()
        return out


def main_walk(device: str = "cuda", rows: int = BASE_ROWS, world: int = 8,
              specs=FAULT_WALK) -> dict:
    """The fault walk (module docstring) over ``specs``; returns the
    summary, ``ok`` when no violation was found. Restores the knobs it
    arms, the fault spec, the pins, the ledger and the tuner's state."""
    with _env(**WALK_KNOBS):
        from dj_tpu_torch import obs

        was = obs.enabled()
        try:
            return _walk(device, rows, world, specs)
        finally:
            from dj_tpu_torch import fleet
            from dj_tpu_torch.parallel import autotune
            from dj_tpu_torch.resilience import errors, faults, ledger

            faults.reset()
            errors.reset_pins()
            ledger.reset()
            autotune._clear()
            fleet.reset()
            if not was:
                obs.disable()


def _walk(device: str, rows: int, world: int, specs) -> dict:
    import torch

    import dj_tpu_torch as dj
    from dj_tpu_torch import fleet as fleet_mod
    from dj_tpu_torch import obs
    from dj_tpu_torch.cache import IndexConfig, JoinIndexCache
    from dj_tpu_torch.obs import http as obs_http
    from dj_tpu_torch.parallel import autotune
    from dj_tpu_torch.resilience import errors as resil
    from dj_tpu_torch.resilience import faults
    from dj_tpu_torch.resilience import ledger as dj_ledger
    from dj_tpu_torch.resilience.errors import AdmissionRejected, DJError, QueueFull
    from dj_tpu_torch.serve import QueryScheduler, ServeConfig

    obs.enable()
    dev = _device(device)
    topo = _topology(dj, dev, world)
    scale = max(1.0, rows / BASE_ROWS)
    hi = max(BASE_KEYS, round(BASE_KEYS * rows / BASE_ROWS))
    # dj_tpu's byte budgets at 2048 rows, scaled with the rows; on the
    # card the admission budget is the card's bytes, so the measured
    # gate (live there) has the whole card to judge.
    budget = 50e6 * scale
    if dev.type == "cuda":
        budget = float(torch.cuda.get_device_properties(dev).total_memory)

    def table(*cols):
        return dj.shard_table(topo, dj.from_arrays(*cols, device=dev))

    # The draws of dj_tpu's walk, in its order: at 2048 rows the tables
    # are its tables.
    rng = np.random.default_rng(7)
    ids = np.arange(rows, dtype=np.int64)
    lk = rng.integers(0, hi, rows).astype(np.int64)
    rk = rng.integers(0, hi, rows).astype(np.int64)
    left, lc = table(lk, ids)
    right, rc = table(rk, ids)
    hot = np.array(HOT_KEYS, dtype=np.int64)
    # The heavy-hitter probe: half its rows on the hot keys; an extra
    # payload column gives it a signature of its own (plan decisions
    # are per signature), so it salts without moving the uniform plan.
    lk_skew = rng.integers(0, hi, rows).astype(np.int64)
    hot_mask = rng.random(rows) < 0.5
    lk_skew[hot_mask] = hot[rng.integers(0, len(hot), int(hot_mask.sum()))]
    left_skew, lsc = table(lk_skew, ids, ids)
    # The broadcast-eligible build side: small, with an int32 payload
    # (its own signature), so the planner broadcasts it.
    rk_small = rng.integers(0, hi, SMALL_ROWS).astype(np.int64)
    right_small, rsc = table(rk_small, np.arange(SMALL_ROWS, dtype=np.int32))
    # The broadcast-prepared build side: its replicated bytes fit
    # DJT_BROADCAST_BYTES, so the auto planner prepares it broadcast.
    rk_tiny = rng.integers(0, hi, TINY_ROWS).astype(np.int64)
    right_tiny, rtc = table(rk_tiny, np.arange(TINY_ROWS, dtype=np.int64))
    # The salted-prepared build side: the heavy-hitter shape on the
    # build side, with an extra payload column for a signature of its own.
    rk_hot = rng.integers(0, hi, rows).astype(np.int64)
    hot_mask_r = rng.random(rows) < 0.5
    rk_hot[hot_mask_r] = hot[rng.integers(0, len(hot), int(hot_mask_r.sum()))]
    right_hot, rhc = table(rk_hot, ids, ids)
    # The fresh-shape probe of the probe_expand iteration: a row count
    # no other query uses.
    fresh_rows = rows // 2
    lk_fresh = rng.integers(0, hi, fresh_rows).astype(np.int64)
    left_fresh, lfc = table(lk_fresh, np.arange(fresh_rows, dtype=np.int64))

    oracle = _matches(lk, rk, hi=hi)
    oracle_skew = _matches(lk_skew, rk, hi=hi)
    oracle_fresh = _matches(lk_fresh, rk, hi=hi)
    oracle_bc = _matches(lk, rk_small, hi=hi)
    oracle_tiny = _matches(lk, rk_tiny, hi=hi)
    oracle_hot = _matches(lk, rk_hot, hi=hi)
    oracle_pipe = _matches(lk, rk, rk_tiny, hi=hi)  # left JOIN right JOIN right_tiny
    cfg = dj.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    prep = dj.prepare_join_side(topo, right, rc, [0], cfg, left_capacity=left.capacity)
    # The two replication-tier sides stay live over the walk: every
    # iteration serves one query against each.
    prep_bc = dj.prepare_join_side(topo, right_tiny, rtc, [0], cfg,
                                   left_capacity=left.capacity)
    prep_salt = dj.prepare_join_side(topo, right_hot, rhc, [0], cfg,
                                     left_capacity=left.capacity)
    violations: list = []
    for side, want in ((prep, "shuffle"), (prep_bc, "broadcast"), (prep_salt, "salted")):
        if side.tier != want:
            violations.append(f"the auto planner prepared a {side.tier} side where "
                              f"dj_tpu's walk asserts {want}")

    tally: dict = {}
    measured_sheds: list = []  # one a measured reject: whether the model would admit it
    iterations: list = []
    all_qids: list = []  # (query_id, ticketed) of every submit
    t_start = time.perf_counter()

    def series(name: str, label: str) -> dict:
        return {dict(k).get(label): v for k, v in obs.counter_series(name).items()}

    for spec in specs:
        # Fresh serving state each iteration: one site's faults, learned
        # factors, pins and tuned decisions must not mask the next's.
        faults.reset()
        dj_ledger.reset()
        resil.reset_pins()
        autotune._clear()
        at_events_before = len(obs.events("tune"))
        tally_before = dict(tally)
        degrades_before = series("dj_degrade_total", "tier")
        heals_before = obs.counter_value("dj_heal_total")
        repreps_before = obs.counter_value("dj_reprepare_total")
        site = spec.split("@", 1)[0] if spec is not None and "," not in spec else None
        new_site = site if site in NEW_TIER_SITES else None
        fleet_site = site if site in FLEET_SITES else None
        fleet_idx = fdir = None
        if fleet_site is not None:
            # Coordination armed for this iteration only, with an index
            # cache in front of the scheduler: the faulted site fires
            # inside the real prepare gate or budget publish.
            fleet_mod.reset()
            fdir = tempfile.mkdtemp(prefix="djt-soak-fleet-")
            os.environ["DJT_FLEET_DIR"] = fdir
            fleet_idx = JoinIndexCache(IndexConfig(
                hbm_budget_bytes=50e6 * scale,
                manifest_path=os.path.join(fdir, "manifest.jsonl")))
        if spec is not None:
            faults.configure(spec)
        # The tuner prices candidates by dispatching them: a fault that a
        # candidate meets is the tuner's to swallow (it drops the
        # candidate), which would starve the ladder's pin below. As in
        # dj_tpu's walk, this one iteration dispatches untuned.
        if new_site == "probe_expand":
            os.environ["DJT_AUTOTUNE"] = "0"
        # The prepare-time replication sites fire only during a broadcast
        # or salted prepare: run one under the fault. The ladder pins
        # "prepared_tier" and hands back a demoted shuffle side, which
        # must still serve row-exact.
        demoted = demoted_oracle = None
        if new_site == "prepare_broadcast":
            demoted = dj.prepare_join_side(topo, right_tiny, rtc, [0], cfg,
                                           left_capacity=left.capacity)
            demoted_oracle = oracle_tiny
        elif new_site == "prepare_salted":
            demoted = dj.prepare_join_side(topo, right_hot, rhc, [0], cfg,
                                           left_capacity=left.capacity)
            demoted_oracle = oracle_hot
        if demoted is not None and demoted.tier != "shuffle":
            violations.append(f"{spec}: faulted prepare returned tier {demoted.tier!r}, "
                              f"expected the demoted shuffle baseline")
        with QueryScheduler(ServeConfig(hbm_budget_bytes=budget, max_attempts=3),
                            index=fleet_idx) as sched:
            tickets: list = []

            def submit(*args, expected=None, submit_fn=None, **kw):
                try:
                    t = (submit_fn or sched.submit)(*args, **kw)
                    tickets.append((t, expected))
                    all_qids.append((t.query_id, True))
                except (AdmissionRejected, QueueFull) as e:
                    # A typed shed at the door is a legal terminal, and
                    # its trace must close too (submit tags the error).
                    if getattr(e, "measured", None) is not None:
                        # The measured gate outranks the model at the
                        # door: a reject is spurious unless the model
                        # would refuse the forecast too.
                        measured_sheds.append(e.forecast_bytes <= budget)
                    qid = getattr(e, "query_id", None)
                    if qid is None:
                        violations.append(f"door shed without query_id: {e}")
                    else:
                        all_qids.append((qid, False))
                    tally[type(e).__name__] = tally.get(type(e).__name__, 0) + 1

            submit(topo, left, lc, right, rc, [0], [0], cfg, expected=oracle)
            submit(topo, left, lc, prep, None, [0], None, cfg, expected=oracle)
            submit(topo, left, lc, prep, None, [0], None, cfg, expected=oracle)
            submit(topo, left_skew, lsc, right, rc, [0], [0], cfg, expected=oracle_skew)
            submit(topo, left, lc, right_small, rsc, [0], [0], cfg, expected=oracle_bc)
            submit(topo, left, lc, prep_bc, None, [0], None, cfg, expected=oracle_tiny)
            submit(topo, left, lc, prep_salt, None, [0], None, cfg, expected=oracle_hot)
            submit(topo, left, lc,
                   [dj.JoinStage(right=right, right_counts=rc, left_on=(0,), right_on=(0,)),
                    dj.JoinStage(right=right_tiny, right_counts=rtc, left_on=(0,),
                                 right_on=(0,))],
                   cfg, expected=oracle_pipe, submit_fn=sched.submit_pipeline)
            if new_site == "probe_expand":
                submit(topo, left_fresh, lfc, prep, None, [0], None, cfg,
                       expected=oracle_fresh)
            if demoted is not None:
                submit(topo, left, lc, demoted, None, [0], None, cfg, expected=demoted_oracle)
            submit(topo, left, lc, right, rc, [0], [0], cfg, deadline_s=0.0, expected=oracle)
            submit(topo, left, lc, right, rc, [0], [0], dj.JoinConfig(join_out_factor=1e9),
                   expected=oracle)
            for t, expected in tickets:
                try:
                    r = t.result(timeout=TIMEOUT_S)
                    label = "result"
                    got = int(r[1].sum())
                    if got != expected:
                        violations.append(f"{spec}: wrong rows {got} != {expected}")
                except TimeoutError:
                    violations.append(f"{spec}: HANG (query #{t.seq})")
                    continue
                except DJError as e:
                    label = type(e).__name__
                except Exception as e:  # noqa: BLE001 - an untyped one is the finding
                    violations.append(f"{spec}: BARE exception {type(e).__name__}: {e}")
                    continue
                if not t.done:
                    violations.append(f"{spec}: no terminal state")
                if label not in ALLOWED:
                    violations.append(f"{spec}: unexpected {label}")
                tally[label] = tally.get(label, 0) + 1
        if new_site == "probe_expand":
            os.environ["DJT_AUTOTUNE"] = "1"
        # No signature tuned twice in one iteration: concurrent dispatches
        # of one signature serve defaults while it tunes, and a decision
        # replays after.
        tuned = [e.get("sig") for e in obs.events("tune")[at_events_before:]
                 if e.get("action") == "tune"]
        dupes = sorted({s for s in tuned if tuned.count(s) > 1})
        if dupes:
            violations.append(f"{spec}: duplicate tune(s) for signature(s) {dupes}")
        pins = {t: int(v - degrades_before.get(t, 0))
                for t, v in series("dj_degrade_total", "tier").items()
                if v - degrades_before.get(t, 0)}
        injected = tally.get("FaultInjected", 0) - tally_before.get("FaultInjected", 0)
        want_tier = ("autotune" if spec is not None and spec.startswith("autotune_")
                     else NEW_TIER_SITES.get(new_site) or ("fleet" if fleet_site else None))
        if want_tier is not None:
            # A fault of these sites pins its tier exactly once and never
            # ends a query: the retry serves the baseline.
            if pins.get(want_tier, 0) != 1:
                violations.append(f"{spec}: expected exactly one {want_tier!r} degrade pin, "
                                  f"saw {pins.get(want_tier, 0)}")
            if injected:
                violations.append(f"{spec}: a {site} fault surfaced as a terminal "
                                  f"FaultInjected instead of degrading")
        if fleet_site is not None:
            # Disarm: unpin first (reset_pins restores the knob the pin
            # overwrote), then drop the knob, the cache and the
            # process-local coordination state.
            resil.reset_pins()
            os.environ.pop("DJT_FLEET_DIR", None)
            try:
                fleet_idx.clear(force=True)
            except Exception:  # noqa: BLE001 - the disarm goes on
                pass
            fleet_mod.reset()
            shutil.rmtree(fdir, ignore_errors=True)
        iterations.append({
            "spec": spec,
            "outcomes": {k: v - tally_before.get(k, 0) for k, v in sorted(tally.items())
                         if v - tally_before.get(k, 0)},
            "pins": pins,
            "heals": int(obs.counter_value("dj_heal_total") - heals_before),
            "reprepares": int(obs.counter_value("dj_reprepare_total") - repreps_before),
        })
    faults.reset()
    resil.reset_pins()
    # Every submitted query, door sheds included, reconstructs to a
    # closed timeline.
    traces_complete = 0
    for qid, ticketed in all_qids:
        tr = obs.query_trace(qid)
        if tr is None:
            violations.append(f"trace MISSING for {qid}")
        elif not tr["complete"] or tr["orphans"]:
            violations.append(f"INCOMPLETE trace {qid}: orphans={tr['orphans']}, "
                              f"spans={tr['spans']}")
        elif ticketed and tr["terminal"] is None:
            violations.append(f"no terminal serve event for {qid}")
        else:
            traces_complete += 1
    # The heavy-hitter mix ran under the skew probe every iteration.
    sk = obs.skew.summary()
    if sk["batches"] == 0:
        violations.append("skew probe armed but no skew events fired")
    elif sk["max_ratio"] < 1.2:
        violations.append(f"heavy-hitter mix observed max skew ratio only {sk['max_ratio']} "
                          f"(expected > 1.2)")
    tiers_engaged = {dict(k).get("tier") for k in obs.counter_series("dj_plan_adapt_total")}
    prepared_tiers = {dict(k).get("tier")
                      for k, v in obs.counter_series("dj_prepared_tier_total").items() if v > 0}
    for want in ("broadcast", "salted"):
        if want not in tiers_engaged:
            violations.append(f"adaptive planner armed but the {want} tier never engaged "
                              f"(tiers seen: {sorted(t for t in tiers_engaged if t)})")
        if want not in prepared_tiers:
            violations.append(f"prepared-tier planner armed but the {want} build tier never "
                              f"engaged (tiers seen: {sorted(t for t in prepared_tiers if t)})")
    audits = _collective_audits(dj, obs, topo, world, left, lc, right, rc, right_small, rsc,
                                prep, prep_bc, prep_salt, cfg, dev.type == "cuda", violations)
    # Measured truth, the device half. On the CPU the armed gate has no
    # device to read (dj_tpu's no-op): no measured reject at all. On the
    # card it is live and outranks the model at the door, so it answers
    # the over-budget submit; it may refuse nothing the model admits.
    measured_rejects = int(obs.counter_value("dj_serve_rejected_total", reason="measured_hbm"))
    spurious = sum(measured_sheds)
    if spurious or (dev.type != "cuda" and measured_rejects):
        violations.append(f"measured-HBM gate fired {measured_rejects}x under a budget of "
                          f"{budget:.4g} bytes, {spurious}x on a forecast the model admits")
    truth = {"measured_rejects": measured_rejects, "measured_rejects_model_admits": spurious,
             "budget_bytes": budget}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        sample = (obs_http._healthz_payload().get("device_hbm") or {}).get(str(dev.index))
        after = torch.cuda.memory_allocated(dev)
        truth.update(healthz_bytes_in_use=None if sample is None else sample["bytes_in_use"],
                     allocated_around=[before, after])
        if sample is None or not before == sample["bytes_in_use"] == after:
            violations.append(f"/healthz's allocator sample {sample} is not "
                              f"memory_allocated() {before} / {after} read around it")
    else:
        truth["device_hbm"] = obs_http._healthz_payload().get("device_hbm")
        if truth["device_hbm"] is not None:
            violations.append(f"a CPU walk sampled device memory: {truth['device_hbm']}")
    return {
        "metric": "chaos_soak",
        "device": dev.type,
        "rows": rows,
        "world": world,
        "sites": len(specs),
        "truth": truth,
        "collective_audits": audits,
        "autotune": {dict(k).get("action", "?"): int(v)
                     for k, v in obs.counter_series("dj_autotune_total").items()},
        "queries": sum(tally.values()),
        "traces_complete": f"{traces_complete}/{len(all_qids)}",
        "outcomes": dict(sorted(tally.items())),
        "iterations": iterations,
        "skew": sk,
        "plan_tiers_engaged": sorted(t for t in tiers_engaged if t is not None),
        "prepared_tiers_engaged": sorted(t for t in prepared_tiers if t is not None),
        "elapsed_s": round(time.perf_counter() - t_start, 2),
        "ok": not violations,
        "violations": violations,
    }


def _collective_audits(dj, obs, topo, world, left, lc, right, rc, right_small, rsc, prep,
                       prep_bc, prep_salt, cfg, on_card, violations) -> dict:
    """The walk's stand-in for dj_tpu's strict HLO audit (module
    docstring): each audited query once, with its collectives by kind
    (every rank's), its collective launches (rank 0's
    ``dj_collective_launches_total``), its sorts of L or more words and
    its kernel launches, each held to its contract's bound. Appends
    the broken bounds to ``violations``."""
    import dataclasses

    from dj_tpu_torch.ops import kernel_launches
    from dj_tpu_torch.resilience import errors as resil
    from dj_tpu_torch.resilience import faults
    from dj_tpu_torch.resilience import ledger as dj_ledger

    big = left.capacity // world  # L: a rank's left rows
    out: dict = {"L": big}
    faults.reset()
    resil.reset_pins()
    dj_ledger.reset()
    # dj_tpu holds prepared_halves_collectives on its contract's own
    # workload (test_hlo_prepared_halves_collectives): one collective a
    # buffer (fused, both sides of the unprepared epoch share each
    # dtype's launch), and a build side of two int64 columns and a
    # string payload; here the walk's build keys with their decimal text.
    unfused = dataclasses.replace(cfg, fuse_columns=False, char_out_factor=4.0)
    keys = right.columns[0].data
    text = dj.from_strings([b"%d" % k for k in keys.tolist()], device=keys.device)
    right_str, rsc_str = dj.shard_table(topo, dj.Table((*right.columns, text)))
    prep_str = dj.prepare_join_side(topo, right_str, rsc_str, [0], unfused,
                                    left_capacity=left.capacity)
    if prep_str.tier != "shuffle":
        violations.append(f"the string build side prepared {prep_str.tier}, not shuffle")
    with _env(DJT_AUTOTUNE="0", DJT_OBS_SKEW="0"), _Collectives() as cc:

        def run(name, right_side, right_counts, config=cfg, merge="probe"):
            with _env(DJT_JOIN_MERGE=merge):
                cc.take()
                l0 = kernel_launches()
                c0 = obs.counter_value("dj_collective_launches_total")
                dj.distributed_inner_join(topo, left, lc, right_side, right_counts, [0],
                                          None if right_counts is None else [0], config)
                kinds, sorts = cc.take()
                out[name] = {
                    "collectives": kinds,
                    "launches_rank0": int(obs.counter_value("dj_collective_launches_total")
                                          - c0),
                    "sorts_of_L": sum(1 for n in sorts if n >= big),
                    "kernels": {k: v - l0[k] for k, v in kernel_launches().items()},
                }
            return out[name]

        # The planner decides once a signature (a gather of counts): each
        # side's decision is taken before its counted query.
        for r_side, r_counts in ((right, rc), (right_small, rsc)):
            dj.distributed_inner_join(topo, left, lc, r_side, r_counts, [0], [0], cfg)
        bc_plan = run("broadcast_query", right_small, rsc)
        probe = run("probe_query", prep, None)
        merged = run("merge_tier_query", prep, None, merge="merge")
        bc_prep = run("bc_prepared_query", prep_bc, None)
        salted = run("salted_prepared_query", prep_salt, None)
        unprep = run("unprepared_unfused", right_str, rsc_str, unfused)
        prepared = run("prepared_unfused", prep_str, None, unfused)

    def a2a(q):
        return q["collectives"]["all_to_all_start"]

    bounds = {
        "bc_prepared_query": sum(bc_prep["collectives"].values()) == 0
        and bc_prep["launches_rank0"] == 0,
        "salted_prepared_query": a2a(salted) >= 1,
        "prepared_halves_collectives": a2a(unprep) >= 1 and a2a(prepared) <= 0.5 * a2a(unprep),
        "broadcast_query": a2a(bc_plan) == 0 and bc_plan["collectives"]["all_gather"] >= 1,
        # No sort of L words on the probe tier, while the merge tier's
        # query sorts its left words: the count sees the sorts it bounds.
        "probe_query": probe["sorts_of_L"] == 0 and merged["sorts_of_L"] >= 1
        and (not on_card or (probe["kernels"]["expand_ranks"] >= 1
                             and merged["kernels"]["merge_sorted_u64"] >= 1)),
    }
    for name, ok in bounds.items():
        if not ok:
            violations.append(f"collective audit {name} broke its bound: {out}")
    out["verdicts"] = {k: "pass" if ok else "violated" for k, ok in bounds.items()}
    return out


def hard_death_child(device: str, rows: int) -> int:
    """The victim (module docstring): arm the black box, put queries in
    flight and die by SIGTERM. A return is a failure of the arm."""
    t_main = time.time()  # ``-m`` has imported the package, and torch
    import torch

    import dj_tpu_torch as dj
    from dj_tpu_torch import obs
    from dj_tpu_torch.obs import forensics
    from dj_tpu_torch.serve import QueryScheduler, ServeConfig

    if not forensics.maybe_arm_from_env():
        print("chaos_soak: the child expects DJT_OBS_BLACKBOX in its environment",
              file=sys.stderr)
        return 3
    obs.enable()
    if device == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        topo = dj.make_topology()
    else:
        dev = torch.device("cpu")
        topo = dj.make_topology(["cpu"])
    gen = torch.Generator(device=dev).manual_seed(3)
    build, probe = dj.generate_build_probe_tables(gen, rows, rows, 0.3, 2 * rows, True)
    left, lc = dj.shard_table(topo, probe)
    right, rc = dj.shard_table(topo, build)
    sched = QueryScheduler(ServeConfig(hbm_budget_bytes=0), worker=True)
    # Nobody waits for a result: the worker may finish the first query,
    # the later ones are still queued or running when the signal lands.
    tickets = [sched.submit(topo, left, lc, right, rc, [0], [0], dj.JoinConfig())
               for _ in range(4)]
    print(json.dumps({"child_qids": [t.query_id for t in tickets], "t_main": t_main,
                      "t_kill": time.time()}), flush=True)
    # The black box's handler dumps, restores the default disposition and
    # raises the signal again: the exit code must still say SIGTERM.
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(TIMEOUT_S)  # never reached
    return 3


def hard_death(device: str = "cuda", rows: int = 2048, bb_dir=None) -> int:
    """The auditor (module docstring): run the child, check what it left,
    print the summary line; 0 when every check held."""
    bb_dir = bb_dir or tempfile.mkdtemp(prefix="djt-soak-blackbox-")
    os.makedirs(bb_dir, exist_ok=True)
    env = dict(os.environ, DJT_OBS_BLACKBOX=bb_dir)  # cwd=REPO makes ``-m`` find the package
    t0, t_start = time.perf_counter(), time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "dj_tpu_torch.scripts.chaos_soak", "--hard-death-child",
         "--device", device, "--rows", str(rows)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S)
    child_s = time.perf_counter() - t0
    violations: list = []
    if proc.returncode not in (-15, 143):
        violations.append(f"child exited {proc.returncode}, expected death by SIGTERM (-15)")
    for name, stream in (("stdout", proc.stdout), ("stderr", proc.stderr)):
        if "Traceback (most recent call last)" in stream:
            violations.append(f"bare traceback in child {name}: the death handlers must "
                              f"dump, not print")
    qids: list = []
    times: dict = {}
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        qids = obj.get("child_qids") or qids
        times = {k: obj[k] for k in ("t_main", "t_kill") if k in obj} or times
    if not qids:
        violations.append("child never reported its query ids")
    bundles = glob.glob(os.path.join(bb_dir, "blackbox-*.jsonl"))
    sections: dict = {}
    bundle_bytes = None
    if len(bundles) != 1:
        violations.append(f"expected exactly one bundle in {bb_dir}, found "
                          f"{sorted(os.path.basename(b) for b in bundles)}")
    else:
        bundle_bytes = os.path.getsize(bundles[0])
        with open(bundles[0]) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    sections[obj.pop("section")] = obj
                except (ValueError, KeyError):
                    violations.append("torn line in a dump that was not torn")
        for want in SECTIONS:
            if want not in sections:
                violations.append(f"bundle missing section {want!r}")
            elif set(sections[want]) == {"error"}:
                violations.append(f"section {want!r} failed at dump time: "
                                  f"{sections[want]['error']}")
        meta = sections.get("meta") or {}
        if meta.get("reason") != "sigterm":
            violations.append(f"bundle reason {meta.get('reason')!r}, expected 'sigterm'")
        open_traces = (sections.get("traces") or {}).get("open") or []
        open_ids = {t.get("query_id") for t in open_traces}
        if not [q for q in qids if q in open_ids]:
            violations.append(f"no submitted query ({qids}) has an open timeline in the "
                              f"bundle (open: {sorted(open_ids)})")
        for tr in open_traces:
            if tr.get("complete"):
                violations.append(f"open timeline {tr.get('query_id')} claims complete=true")
            q = (tr.get("spans") or {}).get("query") or {}
            if not q.get("begin", 0) > q.get("end", 0):
                violations.append(f"open timeline {tr.get('query_id')}: `query` span not "
                                  f"marked open (spans={tr.get('spans')})")
        ring = (sections.get("ring") or {}).get("events") or []
        if not any(e.get("type") == "blackbox" and e.get("reason") == "sigterm" for e in ring):
            violations.append("ring section lacks the dump's own blackbox event")
    # The reader by its path: it is stdlib only, and ``-m`` would import
    # the package (and torch) to read a JSON file.
    reader = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "blackbox_read.py"), bb_dir],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=60)
    if reader.returncode != 0:
        violations.append(f"blackbox_read exited {reader.returncode}: "
                          f"{reader.stderr.strip()[:200]}")
    elif qids and not any(q in reader.stdout for q in qids):
        violations.append("blackbox_read's output never names a dead query id")
    schedulers = (sections.get("serve") or {}).get("schedulers") or []
    summary = {
        "metric": "chaos_soak_hard_death",
        "device": device,
        "rows": rows,
        "child_exit": proc.returncode,
        "queries_in_flight": len(qids),
        "bundle_sections": sorted(sections),
        "bundle_bytes": bundle_bytes,
        "open_timelines": len((sections.get("traces") or {}).get("open") or []),
        "serve_queued": sum(s.get("queue_depth", 0) for s in schedulers),
        "serve_reserved_bytes": sum(s.get("reserved_bytes", 0) for s in schedulers),
        # The child's wall: its start to its code running (the package and
        # torch imported), to the kill, to its exit (the dump, the teardown).
        "child_imported_s": times["t_main"] - t_start if times else None,
        "child_to_kill_s": times["t_kill"] - t_start if times else None,
        "elapsed_s": round(child_s, 3),
        "blackbox_dir": bb_dir,
        "ok": not violations,
        "violations": violations,
    }
    print(json.dumps(summary), flush=True)
    return 0 if not violations else 1


FLEET_TTL_S = 0.5
# dj_tpu's drill: phases of 256, 320 and 64 rows on keys [0, 200), which
# scale with --rows as the walk's do (2048 rows give dj_tpu's shapes).
FLEET_KEYS = 200


def _fleet_shapes(rows: int) -> tuple:
    """(defer rows, reclaim rows, replay rows, key range) of a drill at
    ``rows``."""
    return (rows // 8, rows * 5 // 32, rows // 32,
            max(FLEET_KEYS, round(FLEET_KEYS * rows / BASE_ROWS)))


def _fleet_tables(dj, topo, dev, rows: int, hi: int, skew: bool = False):
    """The drill's tables: every drill process must compute the same plan
    signature (lease keys and manifest records are matched across
    processes), so all of it comes from one fixed seed. ``skew`` is
    phase 3's shape: the build side on one hot key, so the prepare
    overflows its resident partition and heals to a larger settled
    factor, the learned plan the survivor replays."""
    rng = np.random.default_rng(11)
    lk = rng.integers(0, hi, rows).astype(np.int64)
    if skew:
        rk = np.full(rows, 7, dtype=np.int64)
        # Two anchor rows stretch the build side's probed key range over
        # every probe key, so the replayed side serves without a
        # range-widening re-prepare.
        rk[0] = 0
        rk[1] = hi
        lk[:4] = 7  # matches against the hot build key
        # The one-key build side lands every row on one partition: the
        # prepare heals bucket_factor upward. join_out is wide because
        # every match shares that partition too.
        cfg = dj.JoinConfig(bucket_factor=4.0, join_out_factor=64.0)
    else:
        rk = rng.integers(0, hi, rows).astype(np.int64)
        cfg = dj.JoinConfig(bucket_factor=4.0, join_out_factor=4.0)
    ids = np.arange(rows, dtype=np.int64)
    left, lc = dj.shard_table(topo, dj.from_arrays(lk, ids, device=dev))
    right, rc = dj.shard_table(topo, dj.from_arrays(rk, ids, device=dev))
    return left, lc, right, rc, cfg, _matches(lk, rk, hi=hi + 1)


def fleet_child(mode: str, rows: int, device: str = "cuda", world: int = 8,
                drill_rows: int = BASE_ROWS) -> int:
    """A drill peer (``--fleet-child MODE ROWS``): the parent's tables and
    signature, then ``hold`` (win the prepare lease and wait to be
    SIGKILLed), ``prepare-hold`` (prepare and stay alive: the live owner)
    or ``prepare-exit`` (prepare and exit: the dead owner whose settled
    plan the parent replays)."""
    import dj_tpu_torch as dj
    from dj_tpu_torch import fleet as coord
    from dj_tpu_torch.cache import IndexConfig, JoinIndexCache
    from dj_tpu_torch.parallel.dist_join import _config_factors
    from dj_tpu_torch.resilience import ledger as dj_ledger

    if not coord.enabled():
        print("chaos_soak: the drill's child expects DJT_FLEET_DIR in its environment",
              file=sys.stderr)
        return 3
    dev = _device(device)
    topo = _topology(dj, dev, world)
    hi = _fleet_shapes(drill_rows)[3]
    left, lc, right, rc, cfg, _ = _fleet_tables(dj, topo, dev, rows, hi,
                                                skew=mode == "prepare-exit")
    sig = dj_ledger.plan_signature(topo, None, right, None, (0,), cfg)
    if mode == "hold":
        lease = coord.leases.acquire(f"prepare|default||{sig}")
        if lease is None:
            print(json.dumps({"phase": "lost", "pid": os.getpid()}), flush=True)
            return 3
        print(json.dumps({"phase": "holding", "pid": os.getpid()}), flush=True)
        time.sleep(TIMEOUT_S)  # SIGKILLed by the parent mid-"build"
        return 3
    scale = max(1.0, drill_rows / BASE_ROWS)
    idx = JoinIndexCache(IndexConfig(
        hbm_budget_bytes=500e6 * scale,
        manifest_path=os.path.join(os.environ["DJT_FLEET_DIR"], "manifest.jsonl")))
    lease = idx.get_or_prepare(topo, right, rc, [0], cfg, left_capacity=left.capacity)
    factors = _config_factors(lease.prepared.config)
    lease.release()
    print(json.dumps({"phase": "prepared", "pid": os.getpid(), "factors": factors}),
          flush=True)
    if mode == "prepare-hold":
        time.sleep(TIMEOUT_S)  # the live owner until the parent kills it
    return 0


def fleet_drill(device: str = "cuda", rows: int = BASE_ROWS, world: int = 8) -> dict:
    """The coordination drill (module docstring): defer to a live owner,
    reclaim a SIGKILLed owner's lease, replay a dead owner's heal.
    Returns the summary; every parent query must end typed, no prepare
    may repeat a live peer's, and no child outlives the drill. Restores
    the knobs it sets."""
    shared = tempfile.mkdtemp(prefix="djt-soak-fleet-")
    off = {k: None for k in ("DJT_PLAN_ADAPT", "DJT_AUTOTUNE", "DJT_PREPARED_TIER",
                             "DJT_SHAPE_BUCKET")}
    try:
        with _env(DJT_FLEET_DIR=shared, DJT_FLEET_LEASE_TTL_S=str(FLEET_TTL_S),
                  DJT_FLEET_LEASE_WAIT_S="1.0",
                  DJT_LEDGER=os.path.join(shared, "ledger.jsonl"), **off):
            return _drill(device, rows, world, shared)
    finally:
        from dj_tpu_torch import fleet
        from dj_tpu_torch.resilience import ledger

        ledger.reset()
        fleet.reset()
        shutil.rmtree(shared, ignore_errors=True)


def _drill(device: str, rows: int, world: int, shared: str) -> dict:
    import dj_tpu_torch as dj
    from dj_tpu_torch import obs
    from dj_tpu_torch.cache import IndexConfig, JoinIndexCache
    from dj_tpu_torch.resilience import ledger as dj_ledger
    from dj_tpu_torch.resilience.errors import DJError
    from dj_tpu_torch.serve import QueryScheduler, ServeConfig

    obs.enable()
    dj_ledger.reset()
    dev = _device(device)
    topo = _topology(dj, dev, world)
    n_defer, n_reclaim, n_replay, hi = _fleet_shapes(rows)
    scale = max(1.0, rows / BASE_ROWS)
    manifest = os.path.join(shared, "manifest.jsonl")
    violations: list = []
    tally: dict = {}
    phases: dict = {}
    children: list = []
    t0 = time.perf_counter()

    def spawn(mode: str, n: int):
        p = subprocess.Popen(
            [sys.executable, "-m", "dj_tpu_torch.scripts.chaos_soak", "--fleet-child", mode,
             str(n), "--device", device, "--world", str(world), "--rows", str(rows)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        children.append(p)
        line = p.stdout.readline()
        try:
            return p, json.loads(line)
        except ValueError:
            err = p.stderr.read()[-400:] if p.poll() is not None else "..."
            violations.append(f"{mode} child spoke {line!r} instead of JSON (stderr: {err})")
            return p, {}

    def run_query(sched, n: int, skew: bool) -> None:
        left, lc, right, rc, cfg, oracle = _fleet_tables(dj, topo, dev, n, hi, skew=skew)
        try:
            t = sched.submit(topo, left, lc, right, rc, [0], [0], cfg)
        except DJError as e:
            tally[type(e).__name__] = tally.get(type(e).__name__, 0) + 1
            violations.append(f"rows={n}: door shed {type(e).__name__} where a result was "
                              f"expected: {e}")
            return
        try:
            r = t.result(timeout=TIMEOUT_S)
        except TimeoutError:
            violations.append(f"HANG: drill query rows={n}")
            return
        except DJError as e:
            tally[type(e).__name__] = tally.get(type(e).__name__, 0) + 1
            violations.append(f"rows={n}: typed {type(e).__name__} where a result was "
                              f"expected: {e}")
            return
        except Exception as e:  # noqa: BLE001 - an untyped one is the finding
            violations.append(f"rows={n}: BARE exception {type(e).__name__}: {e}")
            return
        tally["result"] = tally.get("result", 0) + 1
        got = int(r[1].sum())
        if got != oracle:
            violations.append(f"rows={n}: wrong rows {got} != {oracle}")

    def manifest_inserts(sig: str) -> list:
        out = []
        try:
            with open(manifest) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # a torn tail line
                    if rec.get("op") == "insert" and rec.get("sig") == sig:
                        out.append(rec)
        except OSError:
            pass
        return out

    def sig_of(n: int, skew: bool) -> str:
        _, _, right, _, cfg, _ = _fleet_tables(dj, topo, dev, n, hi, skew=skew)
        return dj_ledger.plan_signature(topo, None, right, None, (0,), cfg)

    def counter(name: str, **labels) -> int:
        return int(obs.counter_value(name, **labels))

    idx = JoinIndexCache(IndexConfig(hbm_budget_bytes=500e6 * scale, manifest_path=manifest))
    try:
        with QueryScheduler(ServeConfig(hbm_budget_bytes=500e6 * scale), index=idx) as sched:
            # Phase 1: a live peer owns the signature; the parent's
            # identical submit defers (served unprepared, row-exact)
            # instead of building it again.
            c1, msg = spawn("prepare-hold", n_defer)
            if msg.get("phase") != "prepared":
                violations.append(f"defer phase: child never prepared ({msg})")
            defer0 = counter("dj_fleet_peer_defer_total")
            prep0 = counter("dj_tenant_prepares_total", tenant="default")
            run_query(sched, n_defer, False)
            defers = counter("dj_fleet_peer_defer_total") - defer0
            dup = counter("dj_tenant_prepares_total", tenant="default") - prep0
            if defers != 1:
                violations.append(f"defer phase: expected exactly one peer defer, saw {defers}")
            if dup != 0:
                violations.append(f"defer phase: parent paid {dup} duplicate prepare(s) "
                                  f"against a live owner")
            if any(x.get("pid") == os.getpid() for x in manifest_inserts(sig_of(n_defer, False))):
                violations.append("defer phase: parent wrote a duplicate insert record")
            c1.kill()
            c1.wait()
            phases["defer"] = {"defers": defers, "duplicate_prepares": dup}

            # Phase 2: the peer dies by SIGKILL holding the lease; once
            # its heartbeat is older than the TTL the survivor reclaims
            # it (exactly one winner) and builds the side itself.
            c2, msg = spawn("hold", n_reclaim)
            if msg.get("phase") != "holding":
                violations.append(f"reclaim phase: child never held ({msg})")
            c2.kill()
            c2.wait()
            time.sleep(FLEET_TTL_S + 0.4)  # the heartbeat crosses the TTL
            recl0 = counter("dj_fleet_lease_reclaimed_total")
            run_query(sched, n_reclaim, False)
            recl = counter("dj_fleet_lease_reclaimed_total") - recl0
            if recl != 1:
                violations.append(f"reclaim phase: expected exactly one lease reclaim, "
                                  f"saw {recl}")
            own = [x for x in manifest_inserts(sig_of(n_reclaim, False))
                   if x.get("pid") == os.getpid()]
            if len(own) != 1:
                violations.append("reclaim phase: survivor did not publish the rebuilt side")
            phases["reclaim"] = {"reclaims": recl}

            # Phase 3: the peer settled a healed plan into the manifest
            # and exited; the survivor replays those factors (no
            # prepare-stage heal) instead of paying the ladder again.
            c3, msg = spawn("prepare-exit", n_replay)
            rc3 = c3.wait(timeout=TIMEOUT_S)
            if rc3 != 0 or msg.get("phase") != "prepared":
                violations.append(f"replay phase: dead-owner child failed (exit {rc3}, {msg})")
            child_factors = msg.get("factors") or {}
            replay0 = counter("dj_fleet_replay_total")
            heal0 = len([e for e in obs.events("heal") if e.get("stage") == "prepare"])
            run_query(sched, n_replay, True)
            replays = counter("dj_fleet_replay_total") - replay0
            heals = len([e for e in obs.events("heal") if e.get("stage") == "prepare"]) - heal0
            if replays < 1:
                violations.append(f"replay phase: expected a dead-owner replay, saw {replays}")
            if heals != 0:
                violations.append(f"replay phase: survivor re-healed the dead owner's plan "
                                  f"({heals} prepare heal(s)) instead of replaying it")
            own3 = [x for x in manifest_inserts(sig_of(n_replay, True))
                    if x.get("pid") == os.getpid()]
            if len(own3) != 1:
                violations.append("replay phase: survivor did not publish the replayed side")
            else:
                got_f = own3[-1].get("factors") or {}
                if json.dumps(got_f, sort_keys=True) != json.dumps(child_factors,
                                                                   sort_keys=True):
                    violations.append(f"replay phase: survivor factors {got_f} != dead "
                                      f"owner's settled {child_factors}")
                if float(child_factors.get("bucket_factor", 0.0)) <= 4.0:
                    violations.append("replay phase: the dead owner's plan never healed: "
                                      "the replay check is vacuous")
            phases["replay"] = {"replays": replays, "prepare_heals": heals,
                                "factors": child_factors}
        idx.clear(force=True)
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
            p.wait()
            for stream in (p.stdout, p.stderr):
                stream.close()
    alive = [p.pid for p in children if p.poll() is None]
    if alive:
        violations.append(f"children outlived the drill: {alive}")
    return {
        "metric": "chaos_soak_fleet",
        "device": dev.type,
        "rows": rows,
        "world": world,
        "phases": phases,
        "queries": sum(tally.values()),
        "outcomes": dict(sorted(tally.items())),
        "children": len(children),
        "elapsed_s": round(time.perf_counter() - t0, 2),
        "ok": not violations,
        "violations": violations,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0] + " Arms: the main walk (the default), the "
        "fleet drill (--fleet) and the hard-death arm (--hard-death).")
    arm = ap.add_mutually_exclusive_group()
    arm.add_argument("--fleet", action="store_true",
                     help="run the fleet drill (subprocess peers sharing DJT_FLEET_DIR)")
    arm.add_argument("--hard-death", action="store_true",
                     help="run the hard-death arm (a SIGTERMed child and its bundle)")
    arm.add_argument("--hard-death-child", action="store_true", help=argparse.SUPPRESS)
    arm.add_argument("--fleet-child", nargs=2, metavar=("MODE", "ROWS"), help=argparse.SUPPRESS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ranks serve (default: the card)")
    ap.add_argument("--rows", type=int, default=BASE_ROWS,
                    help="the walk's table rows, the drill's scale, the hard-death child's "
                    "build and probe rows (default 2048)")
    ap.add_argument("--world", type=int, default=8,
                    help="ranks of the walk's and the drill's world, threads of this "
                    "process (default 8)")
    ap.add_argument("--blackbox-dir", default=None,
                    help="the hard-death child's DJT_OBS_BLACKBOX (default: a new "
                    "temporary directory)")
    args = ap.parse_args(argv)
    if args.hard_death_child:
        return hard_death_child(args.device, args.rows)
    if args.hard_death:
        return hard_death(args.device, args.rows, args.blackbox_dir)
    if args.device == "cpu":
        import torch

        # A CPU world's ranks are threads of this process: one intra-op
        # thread each, or their pools oversubscribe the cores.
        torch.set_num_threads(1)
    if args.fleet_child:
        mode, n = args.fleet_child
        return fleet_child(mode, int(n), args.device, args.world, args.rows)
    if args.fleet:
        summary = fleet_drill(args.device, args.rows, args.world)
    else:
        summary = main_walk(args.device, args.rows, args.world)
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""The join-index cache: a multi-tenant store of resident PreparedSides.

Counterpart of ``dj_tpu/cache/index.py``. ``prepare_join_side`` gives the
build-once, probe-many pattern to one caller; :class:`JoinIndexCache`
gives it to a server: one store, keyed by signature, that owns the
PreparedSides' lifecycles.

- **Keying**: ``tenant | name | buffer identity | plan_signature``. The
  signature is :func:`~..resilience.ledger.plan_signature`'s, as the
  capacity ledger keys it, so a heal learned anywhere finds the same
  entry. It describes a shape, not a dataset, so the key also carries the
  source tensors' identity (their ids, stable while the caller serves
  from the same resident tensors; the entry keeps them referenced, so an
  id cannot be recycled under a live entry) and an optional ``name`` that
  survives restarts in the manifest, where tensor ids cannot.
- **Admission and eviction**: an entry costs exactly
  :func:`~..obs.bytemodel.prepared_side_bytes` of its side, the device
  bytes its batches hold. Residency past ``DJT_INDEX_HBM_BUDGET`` evicts
  the least recently used UNPINNED entries, and raises the typed
  :class:`AdmissionRejected` when evicting all of them does not free
  enough. An evicted entry drops its side, so its batches' memory goes
  back to the allocator once no caller holds the side.
- **Pins**: :meth:`JoinIndexCache.get_or_prepare` returns a refcounted
  :class:`Lease`; a pinned entry is never evicted, so no side is evicted
  under a running query.
- **Maintenance**: :meth:`JoinIndexCache.append_rows` merges appended
  build rows into the touched odf batches only
  (``dist_join.append_to_prepared``); appended keys that escape the
  anchored range (or a batch's slack) heal by a full re-prepare under the
  widened range, as the ``prepared_plan_mismatch`` query heal does.
- **Warm restart**: ``DJT_INDEX_MANIFEST`` appends one JSONL line per
  state change (a torn tail line is skipped, as in ``DJT_LEDGER``);
  :meth:`JoinIndexCache.warm_restart` replays it and re-prepares the
  inventory before traffic arrives. The manifest keeps what to prepare
  (signature, key range, factors, odf), never the data: a resolver maps
  each record back to the caller's tables.
- **Fleet**: under ``DJT_FLEET_DIR`` a miss consults the shared manifest
  and takes a prepare lease first (``fleet``): a live peer's side defers
  the caller (the typed reject), a dead owner's record is rebuilt under
  its settled plan, else this worker builds under the lease. A faulted
  coordination step pins the ladder's ``fleet`` tier and the miss builds
  process-locally. The prepare itself runs outside that guard, so a
  kernel that fails to build or launch fails the call as everywhere.

Counters ``dj_index_{hit,miss,evict,pin,reprepare}_total``,
``dj_tenant_prepares_total{tenant}`` and the fleet's
``dj_fleet_{peer_defer,replay}_total``; gauges
``dj_index_resident_bytes``, ``dj_index_entries`` and
``dj_tenant_index_bytes{tenant}`` (``obs.truth.tenant_summary`` reads
it); one ``index`` event per state change (hit, miss, insert, evict,
append, reprepare, restore, reject), as dj_tpu's.

**A process world.** Every process of a ``torch.distributed`` world calls
:meth:`~JoinIndexCache.get_or_prepare` with its own shard, so each
decision must be the same on every process: if one hit while another
built, one would issue the prepare's collectives alone. The port takes
each decision once and shares it (dj_tpu has one controller and needs
none of this): one gather of every process's (hit, fleet armed, pid,
host) a call, a hit only when every process hits; process 0 alone runs
the fleet gate, under the world's identity (``fleet.set_world``), and
broadcasts its outcome, a pin of the ``fleet`` tier included; one gather
of each process's admission plan (evictions and a reject) before it is
applied, which must agree; process 0 alone writes the manifest, and
:meth:`~JoinIndexCache.warm_restart` replays process 0's reading of it.
A hit in such a world costs that one gather of Python objects.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
import weakref
from typing import Callable, Optional, Sequence

from .. import fleet as _fleet
from .. import knobs, obs
from ..obs.bytemodel import prepared_side_bytes
from ..obs.bytemodel import source_bytes as _source_bytes
from ..parallel.agree import dist_world as _dist_world
from ..parallel.agree import from_rank0 as _from_rank0
from ..parallel.agree import gather as _gather
from ..parallel.agree import multi_process as _multi
from ..resilience import errors as resil
from ..resilience import ledger as dj_ledger
from ..resilience.errors import AdmissionRejected, PlanMismatch

__all__ = [
    "IndexConfig",
    "JoinIndexCache",
    "Lease",
    "reset",
    "resident_bytes",
    "shed_bytes",
]

# Live caches, so admission and the broadcast fit see the resident total
# without a handle threaded everywhere. Weak: a dropped cache is collected.
_CACHES: "weakref.WeakSet[JoinIndexCache]" = weakref.WeakSet()


def resident_bytes() -> float:
    """Resident bytes over every live cache (what the broadcast fit and
    admission subtract from their budgets)."""
    return float(sum(c.resident_bytes for c in list(_CACHES)))


def shed_bytes(need: float) -> float:
    """Evict LRU unpinned entries over every live cache until ``need``
    bytes are freed, or nothing evictable remains; returns the bytes
    freed. Admission's relief valve: a resident side is an optimization
    and yields to a live query that would not fit beside it."""
    freed = 0.0
    for c in list(_CACHES):
        if freed >= need:
            break
        freed += c.shed_bytes(need - freed)
    return freed


def reset() -> None:
    """Clear every live cache (leases dropped by force) and the
    ``dj_index_*`` metric series (tests, maintenance)."""
    for c in list(_CACHES):
        try:
            c.clear(force=True)
        except Exception:  # noqa: BLE001 - reset must reset the rest
            pass
    obs.clear_prefix("dj_index")


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """The cache's knobs (``from_env`` reads ``DJT_INDEX_HBM_BUDGET`` and
    ``DJT_INDEX_MANIFEST``).

    hbm_budget_bytes: the residency budget in exact resident bytes
      (``prepared_side_bytes`` units); <= 0 disables budgeting (nothing is
      evicted). A new entry's cost is known only once it is built, so
      residency may overshoot by one entry while victims are chosen.
    manifest_path: the warm-restart JSONL manifest (``DJT_INDEX_MANIFEST``);
      None keeps nothing.
    """

    hbm_budget_bytes: float = 0.0
    manifest_path: Optional[str] = None

    @classmethod
    def from_env(cls) -> "IndexConfig":
        return cls(hbm_budget_bytes=knobs.read_float("DJT_INDEX_HBM_BUDGET"),
                   manifest_path=knobs.read("DJT_INDEX_MANIFEST") or None)


class Lease:
    """A refcounted pin on one resident entry. While a lease is out the
    entry is not evicted: release it promptly (a context manager, or
    :meth:`release`). ``prepared`` reads the entry's current side, so a
    lease held across :meth:`JoinIndexCache.append_rows` sees the
    maintained batches."""

    __slots__ = ("_cache", "key", "_released")

    def __init__(self, cache: "JoinIndexCache", key: str):
        self._cache = cache
        self.key = key
        self._released = False

    @property
    def prepared(self):
        return self._cache._entry_prepared(self.key)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._cache._release(self.key)

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _table_ident(table, counts) -> str:
    """The dataset identity of one sharded table: its tensors' ids,
    hashed. Stable while the caller serves from the same tensors, and
    not recyclable under a live entry, which keeps them referenced."""
    ids = [id(counts)]
    for c in table.columns:
        if hasattr(c, "chars"):
            ids.append(id(c.offsets))
            ids.append(id(c.chars))
        else:
            ids.append(id(c.data))
    return "%012x" % (hash(tuple(ids)) & 0xFFFFFFFFFFFF)


class _Entry:
    __slots__ = (
        "key", "tenant", "name", "sig", "prepared", "cost_bytes", "pins",
        "last_use", "right_on", "left_capacity", "source", "owns_source",
    )

    def __init__(self, key, tenant, name, sig, prepared, cost_bytes,
                 right_on, left_capacity, source):
        self.key = key
        self.tenant = tenant
        self.name = name
        self.sig = sig
        self.prepared = prepared
        self.cost_bytes = cost_bytes
        self.pins = 0
        self.last_use = 0
        self.right_on = right_on
        self.left_capacity = left_capacity
        # The caller's (right, right_counts) the key's identity was taken
        # from. Maintenance swaps prepared.right for a combined table, so
        # without this the original tensors could be collected and their
        # ids recycled by another same-schema table, which would then hit
        # this entry.
        self.source = source
        # False while prepared.right is the caller's table (not this
        # cache's residency); True once maintenance swaps in a combined
        # source the cache built, whose bytes then count into cost_bytes.
        self.owns_source = False


class JoinIndexCache:
    """The multi-tenant store of resident PreparedSides (the module
    docstring has the design). Thread-safe; two concurrent misses on one
    key in one process both build, and one side is kept."""

    def __init__(self, config: Optional[IndexConfig] = None):
        self.config = config if config is not None else IndexConfig.from_env()
        self._lock = threading.Lock()
        # Serializes maintenance (append_rows, replace): a merge reads an
        # entry's side, works on the device, then writes the result back,
        # and two at once would lose one's rows. Taken outside _lock.
        self._maint_lock = threading.Lock()
        self._entries: dict[str, _Entry] = {}
        self._resident = 0.0
        self._tick = itertools.count(1)
        # Per-tenant resident bytes, kept at the sites _resident changes,
        # so a hit scans nothing; a tenant whose last entry goes gauges 0.
        self._tenant_bytes: dict = {}
        _CACHES.add(self)

    # -- introspection ------------------------------------------------

    @property
    def resident_bytes(self) -> float:
        return self._resident

    @property
    def entry_count(self) -> int:
        return len(self._entries)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        """{key: {tenant, name, bytes, pins, last_use}}."""
        with self._lock:
            return {k: {"tenant": e.tenant, "name": e.name, "bytes": e.cost_bytes,
                        "pins": e.pins, "last_use": e.last_use}
                    for k, e in self._entries.items()}

    # -- entry plumbing -------------------------------------------------

    def _entry_prepared(self, key: str):
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                raise KeyError(f"join-index entry evicted or cleared: {key}")
            return e.prepared

    def _release(self, key: str) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.pins > 0:
                e.pins -= 1

    def _pin_locked(self, e: _Entry) -> Lease:
        e.pins += 1
        e.last_use = next(self._tick)
        obs.inc("dj_index_pin_total")
        return Lease(self, e.key)

    def _set_gauges_locked(self) -> None:
        obs.set_gauge("dj_index_resident_bytes", self._resident)
        obs.set_gauge("dj_index_entries", len(self._entries))

    def _tenant_adjust_locked(self, tenant: str, delta: float) -> None:
        """Move one tenant's resident bytes by ``delta`` and re-gauge
        ``dj_tenant_index_bytes{tenant}`` (a registry write, no I/O)."""
        t = self._tenant_bytes.get(tenant, 0.0) + delta
        if t <= 0:
            self._tenant_bytes.pop(tenant, None)
            t = 0.0
        else:
            self._tenant_bytes[tenant] = t
        obs.set_gauge("dj_tenant_index_bytes", t, tenant=tenant)

    def _evict_locked(self, e: _Entry, reason: str) -> None:
        del self._entries[e.key]
        self._resident = max(0.0, self._resident - e.cost_bytes)
        self._tenant_adjust_locked(e.tenant, -e.cost_bytes)
        obs.inc("dj_index_evict_total")
        obs.record("index", op="evict", reason=reason, tenant=e.tenant, bytes=e.cost_bytes,
                   sig=e.sig[:200])
        self._manifest_append({"op": "evict", "tenant": e.tenant, "name": e.name,
                               "sig": e.sig}, e.prepared.topology)

    def _victims_locked(self, cost: float, exclude_key: Optional[str] = None) -> list:
        """The LRU unpinned entries that admitting ``cost`` more bytes
        evicts, in eviction order ([] when it fits or nothing budgets)."""
        budget = self.config.hbm_budget_bytes
        if budget <= 0 or self._resident + cost <= budget:
            return []
        out, resident = [], self._resident
        for v in sorted((e for e in self._entries.values()
                         if e.pins == 0 and e.key != exclude_key), key=lambda e: e.last_use):
            if resident + cost <= budget:
                break
            out.append(v)
            resident = max(0.0, resident - v.cost_bytes)
        return out

    def _admit_locked(self, cost: float, sig: str, *, strict: bool = True,
                      exclude_key: Optional[str] = None, victims=None) -> None:
        """Make room for ``cost`` more resident bytes: evict LRU unpinned
        victims until the budget fits (``victims``: an agreed list, else
        chosen here). ``strict`` raises the typed AdmissionRejected when
        nothing evictable frees enough; ``strict=False`` is maintenance's
        posture: a completed append that grew past the budget evicts what
        it can and keeps serving."""
        budget = self.config.hbm_budget_bytes
        if budget <= 0 or self._resident + cost <= budget:
            return
        for v in (self._victims_locked(cost, exclude_key) if victims is None else victims):
            if v.key in self._entries:
                self._evict_locked(v, reason="budget")
        if strict and self._resident + cost > budget:
            obs.record("index", op="reject", bytes=cost, resident_bytes=self._resident,
                       budget_bytes=budget, sig=sig[:200])
            raise AdmissionRejected(
                f"join-index admission rejected: entry cost {cost:.3g} B + resident "
                f"{self._resident:.3g} B exceeds DJT_INDEX_HBM_BUDGET {budget:.3g} B with "
                f"every remaining entry pinned",
                forecast_bytes=cost, reserved_bytes=self._resident, budget_bytes=budget,
                signature=sig)

    def shed_bytes(self, need: float) -> float:
        """Evict LRU unpinned entries until ``need`` bytes are freed, or
        nothing evictable remains; returns the bytes freed."""
        with self._lock:
            freed = 0.0
            for v in sorted((e for e in self._entries.values() if e.pins == 0),
                            key=lambda e: e.last_use):
                if freed >= need:
                    break
                freed += v.cost_bytes
                self._evict_locked(v, reason="serve_pressure")
            self._set_gauges_locked()
            return freed

    # -- manifest -------------------------------------------------------

    @staticmethod
    def _writes_manifest(topology) -> bool:
        """Process 0 alone writes the manifest of a process world."""
        return not _multi(topology) or topology.rank == 0

    def _manifest_append(self, rec: dict, topology=None) -> None:
        path = self.config.manifest_path
        if path is None or not self._writes_manifest(topology):
            return
        rec = dict(rec)
        rec["ts"] = round(time.time(), 3)
        # One whole line a write (ledger.append_line): a shared fleet
        # manifest has concurrent writers, and a broken one must never
        # take serving down.
        dj_ledger.append_line(path, rec)

    def _insert_record(self, e: _Entry) -> dict:
        from ..parallel.dist_join import _config_factors

        rec = {
            "op": "insert",
            "tenant": e.tenant,
            "name": e.name,
            "sig": e.sig,
            "key_range": [list(p) for p in e.prepared.key_range],
            "factors": _config_factors(e.prepared.config),
            "odf": e.prepared.config.over_decom_factor,
            "on": list(e.right_on),
            "left_capacity": e.left_capacity,
        }
        if _fleet.enabled():
            # The owner, for fleet peers' liveness checks (the world's in
            # a process world); a replay ignores the extra keys.
            rec.update(_fleet.identity())
        return rec

    def _read_manifest(self) -> Optional[list]:
        """Every decodable record of the manifest in order (torn lines
        skipped), or None when there is none or it cannot be read."""
        path = self.config.manifest_path
        if not path:
            return None
        out = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue  # a torn tail line
        except OSError:
            return None
        return out

    # -- fleet coordination --------------------------------------------

    def _manifest_live_record(self, tenant: str, name: str, sig: str) -> Optional[dict]:
        """The shared manifest's live insert record of (tenant, name,
        sig), last wins, or None: whether a worker already built the side
        (the line grammar and torn-line tolerance of warm_restart)."""
        live: Optional[dict] = None
        for rec in self._read_manifest() or ():
            if rec.get("tenant") != tenant or rec.get("name") != name or rec.get("sig") != sig:
                continue
            if rec.get("op") == "evict":
                live = None
            elif rec.get("op") == "insert":
                live = rec
        return live

    def _fleet_prepare_gate(self, tenant: str, name: str, sig: str):
        """How a miss proceeds under fleet coordination:

        - ``("defer", rec)``: a live peer owns the signature; the caller
          serves unprepared instead of building it twice.
        - ``("replay", (lease, rec))``: we hold the lease and a dead
          owner's record exists: rebuild under its settled plan.
        - ``("build", lease_or_None)``: we hold the lease (or the bounded
          wait expired, or coordination degraded): the one build.
        """
        if not _fleet.enabled():
            return ("build", None)
        rec = self._manifest_live_record(tenant, name, sig)
        if rec is not None and _fleet.owner_alive(rec):
            return ("defer", rec)
        flease = _fleet.leases.acquire(f"prepare|{tenant}|{name}|{sig}")
        if flease is None:
            # The wait expired with a live holder (or fleet went away):
            # the holder probably finished; consult again, else build
            # locally (degrade, never deadlock).
            rec = self._manifest_live_record(tenant, name, sig)
            if rec is not None and _fleet.owner_alive(rec):
                return ("defer", rec)
            return ("build", None)
        flease.heartbeat()  # the TTL measures the build, not the wait
        rec = self._manifest_live_record(tenant, name, sig)
        if rec is not None and _fleet.owner_alive(rec):
            flease.release()  # a peer finished while we waited
            return ("defer", rec)
        if rec is not None:
            return ("replay", (flease, rec))
        return ("build", flease)

    @staticmethod
    def _fleet_replay_config(config, rec, key_range, left_capacity):
        """A dead owner's record applied to this rebuild: its settled
        factors, odf and key range seed the prepare (as warm_restart
        applies them); values the caller gave win."""
        factors = {f: float(v) for f, v in (rec.get("factors") or {}).items()
                   if hasattr(config, f)}
        if factors:
            config = dataclasses.replace(config, **factors)
        if rec.get("odf"):
            config = dataclasses.replace(config, over_decom_factor=int(rec["odf"]))
        if key_range is None and rec.get("key_range"):
            key_range = tuple(tuple(p) for p in rec["key_range"])
        if left_capacity is None and rec.get("left_capacity"):
            left_capacity = rec["left_capacity"]
        return config, key_range, left_capacity

    def _gate(self, topology, tenant: str, name: str, sig: str):
        """The fleet gate under the ladder: (action, payload). In a
        process world process 0 runs it and every process takes its
        outcome, a pin of the ``fleet`` tier included; only process 0
        holds the lease."""
        def run():
            gate = _fleet.guarded("index_fleet_gate",
                                  lambda: self._fleet_prepare_gate(tenant, name, sig))
            return ("build", None) if gate is None else gate

        if not _multi(topology):
            return run()
        shared = None
        if topology.rank == 0:
            try:
                action, payload = run()
                rec = payload if action == "defer" else (
                    payload[1] if action == "replay" else None)
                shared = (action, rec, resil.pinned_tiers().get("fleet"), None)
            except Exception as e:  # noqa: BLE001 - the peers must hear of it
                shared, payload = ("error", None, None, f"{type(e).__name__}: {e}"), None
        action, rec, pin_reason, error = _from_rank0(shared)
        if pin_reason is not None and not resil.tier_pinned("fleet"):
            resil.pin_baseline("fleet", pin_reason)
        if error is not None:
            raise RuntimeError(f"join-index fleet gate failed on process 0: {error}")
        if topology.rank == 0:
            return action, payload
        return action, ((None, rec) if action == "replay" else rec)

    # -- the front door -------------------------------------------------

    def get_or_prepare(self, topology, right, right_counts, right_on: Sequence[int],
                       config=None, *, tenant: str = "default", name: str = "",
                       left_capacity: Optional[int] = None, key_range=None) -> Lease:
        """The resident side of (tenant, name, dataset, plan signature):
        a hit pins and returns the EXISTING side with no prepare work; a
        miss builds it with ``prepare_join_side`` (its heal underneath),
        admits it against the budget (evicting LRU unpinned entries) and
        inserts it. Returns a pinned :class:`Lease`: release it when the
        query holding it ends.

        A hit needs the same source tensors (module docstring): a table
        sharded anew each call makes a new entry. ``name`` labels the
        dataset for operators and the manifest (two same-schema tables of
        one tenant need it to stay two records over a warm restart)."""
        from ..parallel.dist_join import JoinConfig, prepare_join_side

        if config is None:
            config = JoinConfig()
        right_on = tuple(right_on)
        sig = dj_ledger.plan_signature(topology, None, right, None, right_on, config)
        key = f"{tenant}|{name}|{_table_ident(right, right_counts)}|{sig}"
        multi = _multi(topology)
        lease = None
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                if not multi:
                    obs.inc("dj_index_hit_total")
                    lease = self._pin_locked(e)
                    self._set_gauges_locked()
                else:
                    e.pins += 1  # held while the world agrees; not a Lease yet
        fleet_on = _fleet.enabled()
        if multi:
            votes = _gather((e is not None, fleet_on, os.getpid(), _fleet._hostname()))
            _fleet.set_world(votes[0][2], votes[0][3], topology.rank, topology.process_count)
            if len({v[1] for v in votes}) != 1:
                if e is not None:
                    self._release(key)
                raise ValueError("join-index: DJT_FLEET_DIR is set on some processes of the "
                                 "world and not on others")
            with self._lock:
                if e is not None:
                    e.pins -= 1
                    if all(v[0] for v in votes):
                        obs.inc("dj_index_hit_total")
                        lease = self._pin_locked(e)
                        self._set_gauges_locked()
        if lease is not None:
            # hit/miss events, not only counters, so a query's trace says
            # whether it paid a prepare; recorded outside the lock.
            obs.record("index", op="hit", tenant=tenant, name=name, sig=sig[:200])
            return lease
        obs.inc("dj_index_miss_total")
        obs.record("index", op="miss", tenant=tenant, name=name, sig=sig[:200])
        # Fleet prepare-once: the shared manifest and the lease before a
        # build, under the ladder's fleet tier. The defer raises outside
        # the guard: a routing decision (serve unprepared), not a failure.
        action, payload = "build", None
        if fleet_on:
            action, payload = self._gate(topology, tenant, name, sig)
        if action == "defer":
            obs.inc("dj_fleet_peer_defer_total")
            obs.record("fleet", action="peer_defer", tenant=tenant, name=name, sig=sig[:200],
                       pid=payload.get("pid"))
            raise AdmissionRejected(
                f"join-index prepare deferred: signature resident on fleet peer pid "
                f"{payload.get('pid')}; serve unprepared or retry after its lease TTL",
                signature=sig)
        fleet_lease = None
        if action == "replay":
            fleet_lease, rec = payload
            config, key_range, left_capacity = self._fleet_replay_config(
                config, rec, key_range, left_capacity)
            obs.inc("dj_fleet_replay_total")
            obs.record("fleet", action="replay", tenant=tenant, name=name, sig=sig[:200],
                       dead_pid=rec.get("pid"))
        elif action == "build":
            fleet_lease = payload
        try:
            prepared = prepare_join_side(topology, right, right_counts, right_on, config,
                                         left_capacity=left_capacity, key_range=key_range)
            # The tenant paid this build, whether its side is kept or not.
            obs.inc("dj_tenant_prepares_total", tenant=tenant)
            cost = float(prepared_side_bytes(prepared))
            victims = None
            if multi:
                victims = self._agree_admission(topology, key, cost)
            with self._lock:
                e = self._entries.get(key)
                if e is not None:
                    # A concurrent build won the race: keep its side.
                    obs.inc("dj_index_hit_total")
                    lease = self._pin_locked(e)
                    self._set_gauges_locked()
                    return lease
                self._admit_locked(cost, sig, victims=victims)
                e = _Entry(key, tenant, name, sig, prepared, cost, right_on,
                           left_capacity if left_capacity is not None
                           else prepared.l_cap * topology.world_size,
                           (right, right_counts))
                self._entries[key] = e
                self._resident += cost
                self._tenant_adjust_locked(tenant, cost)
                lease = self._pin_locked(e)
                self._set_gauges_locked()
            obs.record("index", op="insert", tenant=tenant, name=name, bytes=cost,
                       key_range=prepared.key_range, sig=sig[:200])
            self._manifest_append(self._insert_record(e), topology)
            return lease
        finally:
            # Released after the manifest line: a peer that outwaits the
            # lease must find the insert record, not a gap.
            if fleet_lease is not None:
                fleet_lease.release()

    def _agree_admission(self, topology, key: str, cost: float) -> list:
        """A process world's admission: each process's plan (an entry
        already there, the victims by (tenant, name, sig), a reject),
        gathered; the plans must agree, or every process raises. Returns
        this process's victims."""
        budget = self.config.hbm_budget_bytes
        with self._lock:
            raced = key in self._entries
            victims = [] if raced else self._victims_locked(cost)
            left = self._resident - sum(v.cost_bytes for v in victims)
            reject = not raced and budget > 0 and left + cost > budget
            plan = (raced, [(v.tenant, v.name, v.sig) for v in victims], reject)
        plans = _gather(plan)
        if any(p != plans[0] for p in plans):
            raise RuntimeError(f"join-index admission differs between the processes of the "
                               f"world: {plans}")
        return victims

    def lease(self, key: str) -> Lease:
        """Pin an EXISTING entry by key (``Lease.key`` / ``keys()``);
        KeyError when absent. The warmup walk's accessor."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                raise KeyError(f"join-index entry not resident: {key}")
            lease = self._pin_locked(e)
            self._set_gauges_locked()
            return lease

    # -- incremental maintenance ------------------------------------------

    def append_rows(self, key: str, rows, rows_counts) -> None:
        """Append build rows to the resident entry ``key``
        (``Lease.key``): the touched odf batches merge them
        (``dist_join.append_to_prepared``); appended keys that escape the
        anchored range, overflow a batch's slack or hit a structural limit
        heal by a full re-prepare under the widened range (one ``index``
        reprepare event). The entry is pinned meanwhile, so no eviction
        races the merge."""
        from ..parallel.dist_join import append_to_prepared
        from ..resilience.heal import flag_fired

        with self._lock:
            e = self._entries.get(key)
            if e is None:
                raise KeyError(f"join-index entry not resident: {key}")
            e.pins += 1  # maintenance pin (internal, not a Lease)
        try:
            self._maint_lock.acquire()
            healed = False
            detail = None
            try:
                new_prepared, info = append_to_prepared(e.prepared.topology, e.prepared, rows,
                                                        rows_counts)
                fired = sorted(k for k, v in info.items() if k != "touched" and flag_fired(v))
                if fired:
                    healed, detail = True, ",".join(fired)
                    new_prepared = None
            except PlanMismatch as exc:
                healed, detail = True, str(exc)[:200]
                info = {}
                new_prepared = None
            if new_prepared is None:
                new_prepared = self._reprepare_with(e, rows, rows_counts)
            # Both paths build a combined source the cache now owns: its
            # bytes are this entry's residency.
            cost = float(prepared_side_bytes(new_prepared) + _source_bytes(new_prepared))
            with self._lock:
                self._resident += cost - e.cost_bytes
                self._tenant_adjust_locked(e.tenant, cost - e.cost_bytes)
                e.prepared = new_prepared
                e.owns_source = True
                e.cost_bytes = cost
                e.last_use = next(self._tick)
                # The entry may have grown: rebalance, best effort (the
                # append is done; raising would un-report it).
                self._admit_locked(0.0, e.sig, strict=False)
                self._set_gauges_locked()
            if healed:
                obs.inc("dj_index_reprepare_total")
                obs.record("index", op="reprepare", tenant=e.tenant, name=e.name,
                           reason=detail, bytes=cost, sig=e.sig[:200],
                           key_range=new_prepared.key_range)
            else:
                obs.record("index", op="append", tenant=e.tenant, name=e.name,
                           touched=list(info.get("touched", ())), bytes=cost, sig=e.sig[:200])
            # The (possibly widened) decision again, so a restart
            # re-prepares under it (last wins).
            self._manifest_append(self._insert_record(e), new_prepared.topology)
        finally:
            self._maint_lock.release()
            self._release(key)

    def replace(self, key: str, new_prepared, reason: str = "query_heal", *,
                expect=None) -> None:
        """Swap an entry's side for a healed replacement (a query whose
        auto loop re-prepared), so the next query of the signature does
        not heal again. Never raises: rebalancing evicts, best effort.
        ``expect`` is the side the heal started from; when the entry no
        longer holds it (a concurrent append or heal won), nothing is
        swapped."""
        with self._maint_lock:
            with self._lock:
                e = self._entries.get(key)
                if e is None:
                    return
                if expect is not None and e.prepared is not expect:
                    return
                cost = float(prepared_side_bytes(new_prepared)
                             + (_source_bytes(new_prepared) if e.owns_source else 0))
                self._resident += cost - e.cost_bytes
                self._tenant_adjust_locked(e.tenant, cost - e.cost_bytes)
                e.prepared = new_prepared
                e.cost_bytes = cost
                e.last_use = next(self._tick)
                self._admit_locked(0.0, e.sig, strict=False, exclude_key=key)
                self._set_gauges_locked()
        obs.inc("dj_index_reprepare_total")
        obs.record("index", op="reprepare", tenant=e.tenant, reason=reason, bytes=cost,
                   sig=e.sig[:200], key_range=new_prepared.key_range)
        self._manifest_append(self._insert_record(e), new_prepared.topology)

    def _reprepare_with(self, e: _Entry, rows, rows_counts):
        """The append heal: a full re-prepare of the combined source under
        the union of the prepared range and the combined data's probed
        bounds (as ``dist_join``'s re-prepare widens)."""
        from ..parallel.dist_join import (
            _probe_side_range,
            combine_prepared_source,
            prepare_join_side,
        )

        topo = e.prepared.topology
        comb, comb_counts = combine_prepared_source(topo, e.prepared, rows, rows_counts)
        kr = e.prepared.key_range
        probed = _probe_side_range(comb, comb_counts, tuple(e.prepared.right_on), topo)
        if probed is not None:
            kr = tuple((min(a_lo, b_lo), max(a_hi, b_hi))
                       for (a_lo, a_hi), (b_lo, b_hi) in zip(kr, probed))
        return prepare_join_side(topo, comb, comb_counts, e.prepared.right_on,
                                 e.prepared.config,
                                 left_capacity=e.prepared.l_cap * topo.world_size, key_range=kr)

    # -- warm restart -----------------------------------------------------

    def warm_restart(self, resolver: Callable[[dict], Optional[dict]]) -> int:
        """Replay the manifest and re-prepare the surviving inventory
        before traffic arrives. Per (tenant, name, sig) the last state
        wins: insert lines add, evict lines remove, undecodable lines (a
        crashed writer's torn tail) are skipped.

        ``resolver(record)`` maps one insert record back to live data:
        None skips it, else a dict with ``topology``, ``right`` and
        ``right_counts`` (and optionally ``config``). The data always
        comes from those tables (with every appended row: the manifest
        keeps only what to prepare); the record's factors, odf and key
        range apply on top, so the restart starts at the settled plan.
        In a process world every process calls this together, and each
        replays process 0's reading of the manifest. Returns the number
        of entries re-prepared."""
        from ..parallel.dist_join import JoinConfig

        if not self.config.manifest_path:
            return 0
        records = self._read_manifest()
        if _dist_world():
            records = _from_rank0(records)
        if records is None:
            return 0
        live: dict[tuple, dict] = {}
        for rec in records:
            k = (rec.get("tenant"), rec.get("name"), rec.get("sig"))
            if rec.get("op") == "evict":
                live.pop(k, None)
            elif rec.get("op") == "insert":
                live[k] = rec
        restored = 0
        topology = None
        for (tenant, name, sig), rec in live.items():
            src = resolver(rec)
            if not src:
                continue
            topology = src["topology"]
            cfg = src.get("config") or JoinConfig()
            factors = {f: float(v) for f, v in (rec.get("factors") or {}).items()
                       if hasattr(cfg, f)}
            if factors:
                cfg = dataclasses.replace(cfg, **factors)
            if rec.get("odf"):
                cfg = dataclasses.replace(cfg, over_decom_factor=int(rec["odf"]))
            kr = rec.get("key_range")
            kr = tuple(tuple(p) for p in kr) if kr else None
            on = rec.get("on") or src.get("right_on")
            try:
                self.get_or_prepare(topology, src["right"], src["right_counts"], tuple(on), cfg,
                                    tenant=tenant or "default", name=name or "",
                                    left_capacity=rec.get("left_capacity"),
                                    key_range=kr).release()
            except AdmissionRejected:
                if not _fleet.enabled():
                    raise
                continue  # resident on a fleet peer: theirs to restore
            obs.record("index", op="restore", tenant=tenant, sig=(sig or "")[:200])
            restored += 1
        self._compact_manifest(topology)
        return restored

    def _compact_manifest(self, topology=None) -> None:
        """Rewrite the manifest to the live inventory's insert records (an
        atomic rename), so restarts do not grow it without bound. Skipped
        under fleet mode: a shared manifest holds peers' records too."""
        path = self.config.manifest_path
        if not path or _fleet.enabled() or not self._writes_manifest(topology):
            return
        with self._lock:
            records = [self._insert_record(e) for e in self._entries.values()]
        try:
            tmp = path + ".compact"
            with open(tmp, "w") as f:
                for rec in records:
                    rec = dict(rec)
                    rec["ts"] = round(time.time(), 3)
                    f.write(json.dumps(rec) + "\n")
            os.replace(tmp, path)
        except (OSError, TypeError):
            pass

    # -- lifecycle --------------------------------------------------------

    def clear(self, force: bool = False) -> None:
        """Drop every entry. ``force=True`` drops pinned entries too
        (tests, shutdown); else a pinned entry makes it raise
        ValueError."""
        with self._lock:
            pinned = [k for k, e in self._entries.items() if e.pins > 0]
            if pinned and not force:
                raise ValueError(f"join-index clear refused: {len(pinned)} pinned entries "
                                 f"(release their leases, or force=True)")
            self._entries.clear()
            self._resident = 0.0
            for t in list(self._tenant_bytes):
                self._tenant_adjust_locked(t, -self._tenant_bytes[t])
            self._set_gauges_locked()

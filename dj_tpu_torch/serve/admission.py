"""Admission control: cost a query before it runs, reject it at the door.

Counterpart of ``dj_tpu/serve/admission.py``. The heal engine turns a
capacity that runs out mid-flight into a typed ``CapacityExhausted``, but
a serving loop should not pay a heal ladder (attempts times re-runs) to
learn that a query never fit. What the forecast needs exists already:

- :func:`~..obs.bytemodel.hbm_model_bytes` models a join's HBM traffic
  from its static shapes, monotone in the working set the query pins;
- the capacity ledger keeps the sizing factors each plan signature
  needed (heals already paid, max-merged), so a signature that healed to
  4x buckets an hour ago is priced at 4x now.

:func:`forecast` combines the two: the byte model under the ledger-warmed
factors of the query's plan signature, at the plan tier, merge tier and
tuned knobs the dispatch will run. The scheduler admits against
``DJT_SERVE_HBM_BUDGET`` less the bytes reserved for queued and running
work and rejects with the typed
:class:`~..resilience.errors.AdmissionRejected` carrying the arithmetic.

The forecast is a traffic model used as a cost proxy, not a residency
count: the budget and the forecast are both modeled bytes, the units of
dj_tpu's bench ``model_GB``. Its integer is dj_tpu's for the same tables,
config and ledger state (the byte model keeps dj_tpu's terms, TPU ones
included: ``obs.bytemodel``). Forecasting reads capacities, dtypes and
ledger entries only, never device data, so a submit does not wait for
the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..obs.bytemodel import hbm_model_bytes
from ..resilience import ledger as dj_ledger

__all__ = [
    "Forecast",
    "forecast",
    "forecast_pipeline",
    "query_signature",
    "reprice",
    "reserved_index_bytes",
]

_FACTORS = ("pre_shuffle_out_factor", "bucket_factor", "join_out_factor", "char_out_factor")


@dataclasses.dataclass(frozen=True)
class Forecast:
    """One query's admission forecast: modeled HBM bytes under the
    ledger-warmed factors, the provenance a reject carries, and the model
    inputs :func:`reprice` needs to price the same query under the config
    it ran with (the drift audit). ``plan_tier`` is the skew-adaptive
    tier the dispatch will run ("pipeline" for a chain); ``autotuned``
    says the forecast priced a tuned config."""

    bytes: float
    signature: str
    ledger_warmed: bool
    factors: dict
    prepared: bool
    rows: int = 0
    match_rows: int = 0
    plan: object = None
    merge_impl: str = "sort"
    plan_tier: str = "shuffle"
    right_rows: int = 0
    world: int = 1
    salt_replicas: int = 1
    autotuned: bool = False


def _effective_config(config, entry: Optional[dict]):
    """The config the forecast prices: the caller's, widened by the
    ledger's learned factors (max-merged, as the heal engine applies
    them before its first attempt: the run will start at these)."""
    if not entry:
        return config, False
    learned = entry.get("factors", {})
    widened = dj_ledger.wider_factors(
        learned, {f: getattr(config, f) for f in learned if hasattr(config, f)})
    if not widened:
        return config, False
    return dataclasses.replace(config, **widened), True


def query_signature(topology, left, right, left_on: Sequence[int],
                    right_on: Optional[Sequence[int]], config) -> str:
    """The plan signature admission keys the ledger with: the auto
    wrappers' and the join-index cache's, for it is the same function
    (:func:`~..resilience.ledger.plan_signature`)."""
    return dj_ledger.plan_signature(topology, left, right, left_on, right_on, config)


def reserved_index_bytes() -> float:
    """Resident bytes of every live join-index cache: the scheduler
    counts them in its reserved bytes, so admission and the cache spend
    one device budget, not two."""
    from ..cache import resident_bytes

    return float(resident_bytes())


def _plan_of(left_cols, left_on, right_cols):
    """dj_tpu's plan inputs of a query: one int key or not, a string
    column on either side, the left side's payload count."""
    from ..core.table import Column
    from ..ops.join import effective_plan

    int_keys = all(isinstance(left_cols[c], Column) for c in left_on)
    has_strings = (any(hasattr(c, "chars") for c in left_cols)
                   or any(hasattr(c, "chars") for c in right_cols))
    return effective_plan(max(1, len(left_cols) - len(left_on)),
                          single_int_key=(len(left_on) == 1 and int_keys),
                          has_strings=has_strings)


def forecast(topology, left, right, left_on: Sequence[int], right_on: Optional[Sequence[int]],
             config, *, match_factor: float = 1.0) -> Forecast:
    """Modeled HBM bytes of one query (module docstring).
    ``match_factor`` estimates output matches a probe row (1.0: about
    one, the unique-build-key shape). Rows are a shard's capacity: the
    per-device working set is what the budget bounds."""
    from ..ops.join import resolve_merge_impl
    from ..parallel import autotune, plan_adapt
    from ..parallel.dist_join import PreparedSide

    prepared = isinstance(right, PreparedSide)
    sig = query_signature(topology, left, right, left_on, right_on, config)
    # lookup, not consult: admission peeks at the learned factors without
    # moving the hit and miss counters the heal engine owns.
    entry = dj_ledger.lookup(sig)
    cfg, warmed = _effective_config(config, entry)
    w = topology.world_size
    rows = max(1, left.capacity // w)
    plan_tier, replicas = "shuffle", 1
    if prepared:
        # The prepared build tier is the side's own (decided at prepare).
        plan_tier = right.tier
        replicas = max(1, int(right.salt_replicas))
    elif plan_adapt.enabled():
        pa = plan_adapt.decision_from_entry(entry)
        if pa is not None:
            plan_tier, replicas = pa.tier, max(1, pa.replicas)
    r_table = right.right if prepared else right
    rrows = max(1, r_table.capacity // w)
    plan = _plan_of(left.columns, left_on, r_table.columns)
    merge_impl = resolve_merge_impl() if prepared else "sort"
    # A signature with an autotune record dispatches the tuned knobs; a
    # tuned salt fan-out lives in the plan_adapt record read above.
    autotuned = False
    tuned = autotune.tuned_from_entry(entry) if autotune.enabled() else None
    if tuned is not None:
        autotuned = True
        if not prepared and tuned.odf is not None:
            cfg = dataclasses.replace(cfg, over_decom_factor=int(tuned.odf))
        if prepared and tuned.merge is not None:
            merge_impl = tuned.merge
    total = hbm_model_bytes(rows, cfg.over_decom_factor, cfg, int(rows * match_factor), plan,
                            prepared=prepared, merge_impl=merge_impl, plan_tier=plan_tier,
                            right_rows=rrows, world=w, salt_replicas=replicas)
    return Forecast(bytes=float(total), signature=sig, ledger_warmed=warmed,
                    factors={f: getattr(cfg, f) for f in _FACTORS}, prepared=prepared,
                    rows=int(rows), match_rows=int(rows * match_factor), plan=plan,
                    merge_impl=merge_impl, plan_tier=plan_tier, right_rows=int(rrows),
                    world=int(w), salt_replicas=int(replicas), autotuned=autotuned)


def forecast_pipeline(topology, plan, config, *, match_factor: float = 1.0) -> Forecast:
    """One forecast for a multi-join chain (``plan``: a
    :class:`~..parallel.pipeline.PipelinePlan` built with
    ``resolve_ranges=False``, so the door reads no device data). Each
    stage prices under the byte model at its mode's tier (a local or
    broadcast stage prices its collective-free branch) and the chain
    sums (:func:`~..obs.bytemodel.pipeline_model_bytes`): the
    intermediates stay on the device, so the scheduler reserves once for
    the chain. An intermediate's rows are the capacity the stage
    allocates (``join_out_factor`` times the larger side). The ledger
    warms stage 0 only (later stages' signatures embed an intermediate);
    a tuned odf of the pipeline signature applies to every stage that is
    not prepared. ``plan`` and ``rows`` stay unset, so :func:`reprice`
    keeps the forecast."""
    from ..core.table import Column
    from ..obs.bytemodel import pipeline_model_bytes
    from ..ops.join import effective_plan
    from ..parallel import autotune
    from ..parallel.dist_join import PreparedSide
    from ..parallel.pipeline import MODE_PREPARED, pipeline_signature

    pipe_sig = pipeline_signature(topology, plan)
    w = topology.world_size
    sp0 = plan.stage_plans[0]
    entry0 = dj_ledger.lookup(dj_ledger.plan_signature(
        topology, plan.left, sp0.right, sp0.left_on, sp0.right_on, sp0.config or config))
    tuned = None
    if autotune.enabled():
        tuned = autotune.tuned_from_entry(dj_ledger.lookup(pipe_sig))
    # The running schema: (int column, string column) a column.
    cols = [(isinstance(c, Column), hasattr(c, "chars")) for c in plan.left.columns]
    rows = max(1, plan.left.capacity // w)
    stage_kwargs = []
    for i, sp in enumerate(plan.stage_plans):
        cfg = sp.config or config
        if i == 0:
            cfg, _ = _effective_config(cfg, entry0)
        if tuned is not None and tuned.odf is not None and sp.mode != MODE_PREPARED:
            cfg = dataclasses.replace(cfg, over_decom_factor=int(tuned.odf))
        prepared = isinstance(sp.right, PreparedSide)
        right_tab = sp.right.right if prepared else sp.right
        rrows = max(1, right_tab.capacity // w)
        if prepared:
            tier, replicas = sp.right.tier, max(1, int(sp.right.salt_replicas))
        else:
            tier = sp.mode if sp.mode in ("local", "broadcast") else "shuffle"
            replicas = 1
        int_keys = all(cols[c][0] for c in sp.left_on)
        right_cols = list(right_tab.columns)
        has_strings = any(ch for _, ch in cols) or any(hasattr(c, "chars") for c in right_cols)
        eff = effective_plan(max(1, len(cols) - len(sp.left_on)),
                             single_int_key=(len(sp.left_on) == 1 and int_keys),
                             has_strings=has_strings)
        stage_kwargs.append(dict(rows=rows, odf=cfg.over_decom_factor, config=cfg,
                                 matches=int(rows * match_factor), plan=eff, prepared=prepared,
                                 merge_impl="sort", plan_tier=tier, right_rows=rrows, world=w,
                                 salt_replicas=replicas))
        # The next stage's left: this schema plus the right payloads, at
        # the capacity this stage allocates.
        r_on = set(tuple(sp.right.right_on) if prepared else (sp.right_on or ()))
        cols.extend((isinstance(c, Column), hasattr(c, "chars"))
                    for j, c in enumerate(right_cols) if j not in r_on)
        if tier == "broadcast" and not prepared:
            rows = max(1, int(cfg.join_out_factor * max(rows, max(1, w) * rrows)))
        else:
            rows = max(1, int(cfg.join_out_factor * max(rows, rrows)))
    cfg0 = stage_kwargs[0]["config"]
    return Forecast(bytes=float(pipeline_model_bytes(stage_kwargs)), signature=pipe_sig,
                    ledger_warmed=bool(entry0 and entry0.get("factors")),
                    factors={f: getattr(cfg0, f) for f in _FACTORS}, prepared=False,
                    plan_tier="pipeline", world=int(w), autotuned=tuned is not None)


def reprice(fc: Forecast, config) -> float:
    """The byte model of ``fc``'s query shape under ``config``, the
    config the query ran with (the auto wrappers return it, healed
    factors included). The scheduler's drift audit divides it by
    ``fc.bytes``. The merge tier of a prepared query is read again (a
    ladder pin between admission and the terminal changes what ran; a
    tuned merge tier is applied again from the record), and the plan
    tier of an unprepared one is read again from the ledger (the first
    query of a signature is forecast before its decision exists)."""
    if fc.rows <= 0 or fc.plan is None:
        return fc.bytes
    merge_impl = fc.merge_impl
    plan_tier, replicas = "shuffle", 1
    if fc.prepared:
        from ..ops.join import resolve_merge_impl
        from ..parallel import autotune

        merge_impl = resolve_merge_impl()
        if autotune.enabled():
            tuned = autotune.tuned_from_entry(dj_ledger.lookup(fc.signature))
            if tuned is not None and tuned.merge is not None:
                merge_impl = tuned.merge
        # The build tier is the side's: replay the forecast's.
        plan_tier, replicas = fc.plan_tier, max(1, fc.salt_replicas)
    else:
        from ..parallel import plan_adapt

        if plan_adapt.enabled():
            pa = plan_adapt.decision_from_entry(dj_ledger.lookup(fc.signature))
            if pa is not None:
                plan_tier, replicas = pa.tier, max(1, pa.replicas)
    return float(hbm_model_bytes(fc.rows, config.over_decom_factor, config, fc.match_rows,
                                 fc.plan, prepared=fc.prepared, merge_impl=merge_impl,
                                 plan_tier=plan_tier, right_rows=fc.right_rows or fc.rows,
                                 world=max(1, fc.world), salt_replicas=max(1, replicas)))

"""Deterministic fault injection for the serving path. No RNG.

Counterpart of ``dj_tpu/resilience/faults.py``, word for word but for
the variable's name. The heal engine, the degradation ladder and the
typed-error paths have rare branches (exhaustion, repeated overflow, a
tier that fails) that no test could reach without hand-made adversarial
data. Here every such branch is a test target: named host-side sites
fire on exact call counts, never by chance, so a test (or a staging
canary) states "the 3rd join overflows" and gets exactly that.

Spec grammar (``DJT_FAULT`` env var or :func:`configure`)::

    DJT_FAULT=site@call=N[,site@call=N ...]

e.g. ``DJT_FAULT=join.join_overflow@call=1,codec@call=2``. ``call`` is
1-based and counts CONSULTATIONS of that site (only armed sites count,
so numbering is stable no matter what else runs). The same site may
appear several times to arm several calls. The site names are dj_tpu's,
so one spec arms the same site in both packages.

Two site families:

- **Flag sites** (``<stage>.<flag>``, consulted through
  :func:`force_flags` after a call ran): force the named overflow,
  collision or mismatch flag True for that call. Stages: ``join`` (the
  unprepared distributed_inner_join, a pipeline stage, a member of the
  coalesced unprepared dispatch), ``prepared`` (a prepared query, a
  member of the coalesced prepared dispatch), ``prepare``
  (prepare_join_side), ``append`` (append_to_prepared) and ``shuffle``
  (shuffle_on's split ``bucket_overflow`` / ``out_overflow`` bits). The
  flags are forced on the host after the ranks returned; nothing on the
  device changes.
- **Exception sites** (consulted through :func:`check`, raising
  :class:`~.errors.FaultInjected`): ``module_build`` (before every
  dispatch of dist_join, pipeline and shuffle), ``communicator``
  (``spmd.run_spmd``, before any rank starts), ``codec`` (a dispatch
  whose exchange compresses), ``pallas_merge`` (a prepared query under
  ``DJT_JOIN_MERGE=merge``, whose CUDA kernel keeps dj_tpu's site
  name), ``probe_merge`` and ``probe_expand`` (a prepared query on the
  probe tier, the second under a non-``hist`` expansion), ``broadcast``
  / ``salted`` (the skew-adaptive plans) and ``prepare_broadcast`` /
  ``prepare_salted`` / ``bc_prepared_query`` / ``salted_prepared_query``
  (the prepared build tiers), ``autotune_probe`` (each timed probe
  dispatch of the autotuner) and ``autotune_apply`` (a tuned config's
  application). The degradation ladder
  (``errors.degrade_guard``) pins the tier a site names.

dj_tpu consults ``communicator``, ``codec``, ``pallas_merge``,
``probe_merge`` and ``probe_expand`` while it traces a module, that is,
on a build-cache miss. The port builds no module: it consults each of
them once a dispatch attempt, on the dispatching thread (never on a rank
thread, so a thread world of w ranks counts one consultation, not w),
wherever the attempt runs the site's tier.

Everything is a strict no-op when no spec is configured.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .. import obs
from .errors import FaultInjected

_lock = threading.Lock()
# site -> frozenset of 1-based call numbers; None = programmatically
# unconfigured (fall back to the DJT_FAULT env var).
_configured: Optional[dict[str, frozenset[int]]] = None
_counts: dict[str, int] = {}
# Parsed-env cache keyed by the raw env string, so per-call env reads
# stay one dict lookup.
_env_cache: tuple[Optional[str], Optional[dict]] = (None, None)


def parse_spec(spec: str) -> dict[str, frozenset[int]]:
    """Parse ``site@call=N[,...]`` into {site: {call numbers}}."""
    out: dict[str, set[int]] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, rest = entry.partition("@")
        site = site.strip()
        key, eq, num = rest.partition("=")
        if not site or sep != "@" or key.strip() != "call" or eq != "=":
            raise ValueError(
                f"bad DJT_FAULT entry {entry!r}: expected "
                f"'site@call=N[,site@call=N ...]'"
            )
        try:
            n = int(num)
        except ValueError:
            raise ValueError(
                f"bad DJT_FAULT call count {num!r} in {entry!r}: "
                f"expected a 1-based integer"
            ) from None
        if n < 1:
            raise ValueError(
                f"bad DJT_FAULT call count {n} in {entry!r}: 1-based"
            )
        out.setdefault(site, set()).add(n)
    return {s: frozenset(ns) for s, ns in out.items()}


def configure(spec: Optional[str]) -> None:
    """Programmatic spec (overrides DJT_FAULT); None reverts to the env.
    Resets call counts: a new spec starts counting from call 1."""
    global _configured
    with _lock:
        _configured = parse_spec(spec) if spec is not None else None
        _counts.clear()


def arm(site: str, *calls: int) -> None:
    """Arm ``site`` at the given 1-based call numbers, merging into the
    current programmatic spec (counts are NOT reset: use configure or
    reset for a clean slate)."""
    global _configured
    if not calls or any(c < 1 for c in calls):
        raise ValueError(f"arm needs 1-based call numbers, got {calls}")
    with _lock:
        spec = dict(_configured or {})
        spec[site] = frozenset(spec.get(site, frozenset()) | set(calls))
        _configured = spec


def reset() -> None:
    """Drop the programmatic spec and every call count."""
    global _configured
    with _lock:
        _configured = None
        _counts.clear()


def _armed() -> Optional[dict[str, frozenset[int]]]:
    global _env_cache
    if _configured is not None:
        return _configured
    env = os.environ.get("DJT_FAULT")
    if not env:
        return None
    cached_env, cached = _env_cache
    if env == cached_env:
        return cached
    parsed = parse_spec(env)
    _env_cache = (env, parsed)
    return parsed


def active() -> bool:
    return bool(_armed())


def call_count(site: str) -> int:
    """Consultations of ``site`` so far (armed specs only)."""
    return _counts.get(site, 0)


def should_fire(site: str) -> bool:
    """Consult ``site``: increments its call count iff the site is
    armed, returns whether this call number fires. Records one
    ``fault`` event and ``dj_fault_injected_total{site}`` per firing."""
    spec = _armed()
    if spec is None or site not in spec:
        return False
    with _lock:
        _counts[site] = n = _counts.get(site, 0) + 1
    if n not in spec[site]:
        return False
    obs.inc("dj_fault_injected_total", site=site)
    obs.record("fault", site=site, call=n)
    return True


def check(site: str) -> None:
    """Exception-site consult: raise FaultInjected when armed for this
    call number, else return."""
    if should_fire(site):
        raise FaultInjected(site, _counts[site])


def force_flags(stage: str, info: dict) -> dict:
    """Flag-site consult for one completed call: every armed
    ``<stage>.<key>`` site whose call number matches forces that key
    True in a COPY of ``info`` (host-side only: the call already ran).
    Keys are consulted in sorted order so counts are deterministic."""
    spec = _armed()
    if spec is None:
        return info
    out = None
    for k in sorted(info):
        if should_fire(f"{stage}.{k}"):
            if out is None:
                out = dict(info)
            out[k] = True
    return info if out is None else out

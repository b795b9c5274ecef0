"""Graceful drain: a rolling restart sheds load forward, never drops it.

Counterpart of ``dj_tpu/fleet/drain.py``. SIGTERM (the fleet's routine
kill signal) puts every live scheduler into drain mode: its door rejects
new work with the typed :class:`~..resilience.errors.Draining`, queued and
running queries reach their usual terminals, and once the process
quiesces (or ``DJT_FLEET_DRAIN_GRACE_S`` runs out: the wait is bounded)
the worker's budget row is withdrawn so peers stop charging its bytes.

The schedulers live in :data:`_SCHEDULERS`, a weak registry that every
``serve.QueryScheduler`` joins at construction (:func:`register`); with
none alive :func:`begin` flips no door and :func:`wait_quiesced` returns
at once. A registered object has ``drain()`` (flip the door) and
``drained()`` (nothing queued or running).

The handler runs first and, after the quiesce or the grace, calls the
disposition installed before it (a crash recorder's, say), so the process
still ends as killed by SIGTERM. The drain runs on the main thread, the
only thread a signal handler runs on. :func:`begin` may be called
directly too (tests, an operator endpoint).
"""

from __future__ import annotations

import os
import signal
import threading
import time
import weakref

from .. import knobs as _knobs
from .. import obs

__all__ = ["begin", "draining", "install", "register", "uninstall", "wait_quiesced"]

_lock = threading.Lock()
_draining = False
_installed = False
_prev_sigterm = None
# The live schedulers a drain flips (weak: a closed scheduler is collected).
_SCHEDULERS: "weakref.WeakSet" = weakref.WeakSet()


def register(scheduler) -> None:
    """Add a scheduler (an object with ``drain()`` and ``drained()``) to
    the registry a drain walks; a scheduler born while the process drains
    is flipped at once."""
    _SCHEDULERS.add(scheduler)
    if _draining:
        scheduler.drain()


def draining() -> bool:
    """Has this process entered drain mode?"""
    return _draining


def begin(reason: str = "manual") -> list:
    """Enter drain mode: flip every registered scheduler's door to reject
    with ``Draining`` while its queue keeps dispatching. Idempotent;
    returns the schedulers flipped. One ``drain`` event and the
    ``dj_fleet_draining`` gauge mark the transition."""
    global _draining
    with _lock:
        first = not _draining
        _draining = True
    scheds = list(_SCHEDULERS)
    for s in scheds:
        try:
            s.drain()
        except Exception:  # noqa: BLE001 - drain the rest regardless
            pass
    if first:
        obs.set_gauge("dj_fleet_draining", 1)
        obs.record("drain", phase="begin", reason=reason, pid=os.getpid(),
                   schedulers=len(scheds))
    return scheds


def wait_quiesced(timeout_s: float, poll_s: float = 0.05) -> bool:
    """Wait, at most ``timeout_s``, for every registered scheduler to
    finish its queued and running work. True on quiesce, False when the
    grace ran out; the caller proceeds either way."""
    deadline = time.monotonic() + max(0.0, timeout_s)
    while True:
        if all(s.drained() for s in list(_SCHEDULERS)):
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(poll_s)


def _release_fleet_state() -> None:
    from . import budget, enabled

    if not enabled():
        return
    try:
        budget.withdraw()
    except OSError:
        pass


def _on_sigterm(signum, frame):
    begin(reason="sigterm")
    grace = max(0.0, _knobs.read_float("DJT_FLEET_DRAIN_GRACE_S"))
    quiesced = wait_quiesced(grace)
    _release_fleet_state()
    obs.record("drain", phase="quiesced" if quiesced else "grace_expired",
               grace_s=round(grace, 3), pid=os.getpid())
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    else:
        try:
            signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
        except ValueError:
            pass
        os.kill(os.getpid(), signum)


def install() -> bool:
    """Install the SIGTERM drain handler (main thread only, signal's own
    rule; returns False elsewhere). Idempotent. Install it after any
    handler it should chain to."""
    global _installed, _prev_sigterm
    with _lock:
        if _installed:
            return True
    try:
        prev = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        return False
    with _lock:
        _prev_sigterm = prev
        _installed = True
    obs.record("drain", phase="installed", pid=os.getpid())
    return True


def uninstall() -> None:
    """Restore the SIGTERM disposition from before :func:`install`."""
    global _installed, _prev_sigterm
    with _lock:
        was, prev = _installed, _prev_sigterm
        _installed, _prev_sigterm = False, None
    if not was:
        return
    try:
        if signal.getsignal(signal.SIGTERM) is _on_sigterm:
            signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)
    except ValueError:
        pass


def _reset_for_tests() -> None:
    global _draining
    with _lock:
        _draining = False
    uninstall()

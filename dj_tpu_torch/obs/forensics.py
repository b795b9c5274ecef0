"""The crash black box: telemetry that survives the process.

Counterpart of ``dj_tpu/obs/forensics.py``. The ring, the query
timelines, the registry and the fleet view live in process memory, so a
worker that dies (a fault, an out-of-memory kill, a preemption) takes
its evidence with it. ``DJT_OBS_BLACKBOX=<dir>`` arms three death
handlers:

- ``sys.excepthook``: an uncaught exception dumps the bundle with the
  exception, then chains the previous hook;
- ``SIGTERM``: dumps, then calls the previous handler (``fleet.drain``'s,
  say), or restores the default disposition and re-raises the signal,
  so the exit code still says SIGTERM;
- ``atexit``: a clean exit dumps the final state, unless a crash handler
  already wrote this process's bundle.

The bundle is one JSONL file a process, ``blackbox-r{rank}-p{pid}.jsonl``,
one section a line in the order meta (reason, exception), traces (the
open and the last ``DJT_OBS_BLACKBOX_TRACES`` closed timelines), ring,
metrics, knobs, serve, ledger, fleet (the last gathered view only: a
death handler never enters a collective) and coordination. Each line is
flushed as it is written and each section is guarded: a failing section
leaves a stub line ``{"section": name, "error": type}``, and a dump torn
mid-write loses only its tail. The SIGTERM handler runs on the main
thread, which the signal may have caught holding one of the plain locks
of ``metrics``, ``recorder``, ``trace``, ``roofline`` or the ledger. So
the dump records the device phases that have finished (a resolve takes
the first four locks) only when all four are free, without waiting for
the rest, and reads every section with resolving held off; it takes each lock a section reads with a short timeout
(``LOCK_TIMEOUT_S``) first, and a section whose lock stays held is
written as ``{"section": name, "incomplete": "lock held"}``, so the
process still dies by the signal. Its own ``blackbox`` event carries no
query id, so it never enters a timeline.
``python -m dj_tpu_torch.scripts.blackbox_read`` reads it.

Arming enables obs, is idempotent and is wired into
``init_distributed`` through :func:`maybe_arm_from_env`. The SIGTERM
handler installs only from the main thread (``signal.signal``'s rule);
elsewhere the other two install alone. ``_rank`` never initializes a
process group or a CUDA context.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
import traceback as _tb
from typing import Optional

from .. import knobs as _knobs
from . import metrics as _metrics
from . import recorder as _recorder
from . import roofline as _roofline
from . import skew as _skew
from . import trace as _trace

__all__ = [
    "arm",
    "armed_dir",
    "bundle_path",
    "disarm",
    "dump",
    "maybe_arm_from_env",
]

_lock = threading.Lock()
# How long the dump waits for an obs lock a section reads. A lock the
# interrupted main thread holds never frees while its handler runs.
LOCK_TIMEOUT_S = 0.5
# The plain locks each section takes while resolving is held off (the
# serve section's rank-skew summary reads the phase totals).
_SECTION_LOCKS = {"traces": ("trace",), "ring": ("recorder",), "metrics": ("metrics",),
                  "serve": ("roofline",), "ledger": ("ledger",)}
# What resolving the pending device phases takes: observe_phase's totals
# and histograms, its event, and that event's timeline.
_RESOLVE_LOCKS = ("roofline", "metrics", "recorder", "trace")
_dir: Optional[str] = None
_dumped = False  # a crash or SIGTERM dump happened: atexit stands down
_prev_excepthook = None
_prev_sigterm = None
_atexit_registered = False


def _rank() -> int:
    """This process's rank: ``DJT_PROCESS_ID``, else the default process
    group's rank if one is initialized, else 0."""
    v = os.environ.get("DJT_PROCESS_ID")
    if v not in (None, ""):
        try:
            return int(v)
        except ValueError:
            pass
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 - safe in teardown
        pass
    return 0


def armed_dir() -> Optional[str]:
    """The armed bundle directory, or None."""
    with _lock:
        return _dir


def bundle_path() -> Optional[str]:
    """This process's bundle path (by rank and pid: processes of one host
    that all say rank 0 must not overwrite each other), or None."""
    d = armed_dir()
    if d is None:
        return None
    return os.path.join(d, f"blackbox-r{_rank()}-p{os.getpid()}.jsonl")


def _traces_closed_n() -> int:
    return max(0, _knobs.read_int("DJT_OBS_BLACKBOX_TRACES"))


def _sections(reason: str, exc: Optional[BaseException]) -> list:
    """(name, thunk) of each section, the most telling first; each thunk
    runs guarded when the dump writes it."""

    def _meta():
        out = {"ts": round(time.time(), 6), "rank": _rank(), "pid": os.getpid(),
               "reason": reason, "argv": list(sys.argv), "exc": None}
        if exc is not None:
            out["exc"] = {
                "type": type(exc).__name__,
                "message": str(exc)[:2000],
                "traceback": "".join(_tb.format_exception(type(exc), exc,
                                                          exc.__traceback__))[-8000:],
            }
        return out

    def _serve():
        from ..serve import schedulers_snapshot

        return {"schedulers": schedulers_snapshot()}

    def _ledger():
        from ..resilience import ledger

        return {"entries": ledger.entries()}

    def _coordination():
        from .. import fleet as _coord

        return {"coordination": _coord.snapshot()}

    return [
        ("meta", _meta),
        ("traces", lambda: _trace.blackbox_traces(_traces_closed_n())),
        ("ring", lambda: {"events": _recorder.events()}),
        ("metrics", lambda: _metrics.metrics_summary()),
        ("knobs", lambda: {"knobs": _knobs.registry_snapshot()}),
        ("serve", _serve),
        ("ledger", _ledger),
        ("fleet", lambda: {"fleet": _skew._last_fleet}),
        ("coordination", _coordination),
    ]


def _free(names) -> bool:
    """Whether each lock of ``names`` can be taken within
    ``LOCK_TIMEOUT_S`` (taken and given back at once)."""
    from ..resilience import ledger

    locks = {"metrics": _metrics._lock, "recorder": _recorder._rlock,
             "trace": _trace._traces_lock, "roofline": _roofline._lock,
             "ledger": ledger._lock}
    for name in names:
        if not locks[name].acquire(timeout=LOCK_TIMEOUT_S):
            return False
        locks[name].release()
    return True


def dump(reason: str, exc: Optional[BaseException] = None) -> Optional[str]:
    """Write this process's bundle (the newest dump replaces an older
    one) and return its path; None when disarmed or the file cannot be
    opened. One section a line, flushed a line; a failing section writes
    its stub line, a section whose lock stays held its ``incomplete``
    line, and the dump goes on."""
    global _dumped
    path = bundle_path()
    if path is None:
        return None
    # The device phases that have finished, without waiting for the rest.
    if _free(_RESOLVE_LOCKS):
        _roofline.resolve()
    # Into the ring before the ring section reads it: the bundle's last
    # event is its own cause.
    if _free(("recorder",)):
        _recorder.record("blackbox", _ids=None, action="dump", reason=reason, path=path)
    try:
        f = open(path, "w", buffering=1)
    except OSError:
        return None
    with f, _roofline._deferred():
        for name, thunk in _sections(reason, exc):
            try:
                if _free(_SECTION_LOCKS.get(name, ())):
                    line = json.dumps({"section": name, **_recorder._jsonable(thunk())})
                else:
                    line = json.dumps({"section": name, "incomplete": "lock held"})
            except Exception as e:  # noqa: BLE001 - the dump must finish
                line = json.dumps({"section": name, "error": type(e).__name__})
            try:
                f.write(line + "\n")
            except OSError:
                break
    with _lock:
        _dumped = True
    return path


def _on_uncaught(etype, value, tb):
    try:
        dump("excepthook", value)
    except Exception:  # noqa: BLE001 - never mask the real crash
        pass
    (_prev_excepthook or sys.__excepthook__)(etype, value, tb)


def _on_sigterm(signum, frame):
    try:
        dump("sigterm")
    except Exception:  # noqa: BLE001
        pass
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    else:
        # The previous disposition (default: terminate) and the signal
        # again, so the exit code says SIGTERM.
        signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def _on_atexit():
    with _lock:
        done = _dumped
        armed = _dir is not None
    if armed and not done:
        dump("atexit")


def arm(dir_path: str) -> str:
    """Arm the black box into ``dir_path`` (made if missing): install the
    death handlers, enable obs and record one ``blackbox`` event.
    Idempotent; arming again moves the directory. Returns the bundle
    path."""
    global _dir, _prev_excepthook, _prev_sigterm, _atexit_registered
    os.makedirs(dir_path, exist_ok=True)
    _metrics.enable()
    with _lock:
        first = _dir is None
        _dir = str(dir_path)
    if first:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _on_uncaught
        try:
            _prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            _prev_sigterm = None  # not the main thread: excepthook and atexit only
        if not _atexit_registered:
            atexit.register(_on_atexit)
            _atexit_registered = True
    _recorder.record("blackbox", action="armed", dir=str(dir_path))
    return bundle_path() or ""


def disarm() -> None:
    """Uninstall the handlers and forget the directory. The atexit hook
    stays registered and stands down while disarmed."""
    global _dir, _prev_excepthook, _prev_sigterm, _dumped
    with _lock:
        was = _dir
        _dir = None
        _dumped = False
    if was is None:
        return
    if sys.excepthook is _on_uncaught:
        sys.excepthook = _prev_excepthook or sys.__excepthook__
    _prev_excepthook = None
    try:
        if signal.getsignal(signal.SIGTERM) is _on_sigterm:
            signal.signal(signal.SIGTERM,
                          _prev_sigterm if _prev_sigterm is not None else signal.SIG_DFL)
    except ValueError:
        pass
    _prev_sigterm = None


def maybe_arm_from_env() -> Optional[str]:
    """Arm iff ``DJT_OBS_BLACKBOX`` names a directory; unset is a no-op.
    Returns the bundle path or None. A directory that cannot be made
    warns (and mirrors ``obs_blackbox_arm_failed``) and returns None."""
    v = _knobs.read("DJT_OBS_BLACKBOX")
    if not v:
        return None
    try:
        return arm(str(v))
    except OSError as e:
        import warnings

        detail = f"DJT_OBS_BLACKBOX={v}: {e} — crash black-box disabled for this process"
        warnings.warn(detail, stacklevel=2)
        _recorder.mirror_warning("obs_blackbox_arm_failed", detail)
        return None

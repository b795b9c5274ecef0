"""The live telemetry endpoint: scrape a serving process over HTTP.

Counterpart of ``dj_tpu/obs/http.py``: a threaded stdlib
``http.server`` whose routes read the same locked snapshots the tests
read, so a scrape never stalls serving and never enters a collective or
synchronizes the card.

- ``/metrics``: the Prometheus text (``metrics_text()``).
- ``/healthz``: liveness and pressure: each scheduler's snapshot,
  draining, the pressure level, the allocator's sample
  (``truth.sample_device_hbm``), the history ring's size and the SLO
  alert states. A degraded process answers 200 and says so in the body.
- ``/queryz?n=``: the last n query timelines (obs.trace).
- ``/varz``: ``metrics_summary()``.
- ``/skewz?n=``: the wire matrix, the skew aggregates, the last n
  ``skew`` events and ``skew.fleet_view()`` (never ``fleet_snapshot``:
  in a process world that is a collective).
- ``/rooflinez``: the roofline phases, the two peaks and the stragglers.
- ``/tenantz``: ``truth.tenant_summary()``.
- ``/trendz?n=``: the history ring and the burn-rate alerts
  (obs.history); the sampler starts with this server.
- ``/knobz``: ``knobs.registry_snapshot()``.
- ``/tunez``: ``parallel.autotune.tunez_summary()``.
- ``/tracez?q=<query_id>[&format=chrome|perfetto]``: one stored
  timeline as Chrome trace-event JSON (404 when evicted or unknown).
- ``/fleetz``: ``obs.fleet.fleet_health()``.
- ``/profilez?secs=N``: a guarded, one-at-a-time ``torch.profiler``
  capture of N seconds (0 < N <= 600) into ``DJT_OBS_PROFILE_DIR``,
  written as a Chrome trace whose path the answer names: 409 while one
  runs, 400 with the directory unset, 500 when the profiler refuses.

A malformed query parameter answers 400 naming it; an unknown route
404; any other failure 500 with ``{"ok": false, "error": <type>}``.

Off by default. ``DJT_OBS_HTTP=<port>`` starts it from
``init_distributed`` (:func:`maybe_start_from_env`; 0 binds an ephemeral
port), or call :func:`start`. Starting it enables obs. It binds
``DJT_OBS_HTTP_HOST`` (127.0.0.1 by default): diagnostics, not an API.

Left out of dj_tpu's payloads: the fields that read a compiled XLA
module (the ``dj_xla_*`` gauges and the retrace and build-cache
counters), which the port does not have.

The profiler differs from dj_tpu's ``jax.profiler`` in one way: one
capture thread enters and leaves it (``utils.timing.profile``: torch's
profiler state belongs to the thread that entered it) and writes one
Chrome trace a capture; CUPTI records the card's kernels from every
thread of the process while it runs, and ``profile_all_threads`` the CPU
ranges of every thread.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .. import knobs as _knobs
from . import fleet as _fleet
from . import history as _history
from . import metrics, trace
from . import recorder as _recorder
from . import roofline as _roofline
from . import skew as _skew
from . import truth as _truth

__all__ = ["maybe_start_from_env", "server_address", "start", "stop"]


class _BadParam(ValueError):
    """A malformed query parameter: the route answers 400 with this
    message instead of a default or a 500."""


def _int_param(query: str, name: str, default: int) -> int:
    vals = parse_qs(query).get(name)
    if not vals:
        return default
    raw = vals[0]
    try:
        n = int(raw)
    except ValueError:
        raise _BadParam(f"query parameter {name}={raw!r}: expected a non-negative "
                        f"integer (e.g. ?{name}=32)") from None
    if n < 0:
        raise _BadParam(f"query parameter {name}={n}: expected a non-negative integer")
    return n


_server: Optional[ThreadingHTTPServer] = None
_thread: Optional[threading.Thread] = None
_lock = threading.Lock()
# Whether start() started the history sampler: stop() stops only that.
_history_owned = False


def _healthz_payload() -> dict:
    # Lazy and guarded: obs stays importable without the serving layer.
    try:
        from ..serve import schedulers_snapshot

        scheds = schedulers_snapshot()
    except Exception:  # noqa: BLE001 - health must always answer
        scheds = []
    return {
        "ok": True,
        "obs_enabled": metrics.enabled(),
        "ring_capacity": _recorder.ring_capacity(),
        "traces_stored": trace.trace_count(),
        "schedulers": scheds,
        "draining": any(s.get("draining") for s in scheds),
        "pressure_level": max([s.get("pressure_level", 0) for s in scheds], default=0),
        # The allocator's sample (no synchronize); a poll keeps the
        # dj_device_hbm_* gauges fresh on an idle process.
        "device_hbm": _truth.sample_device_hbm(),
        "history_snapshots": _history.snapshot_count(),
        "slo_alerts": _history.alerts_view(),
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "dj-obs/1"

    def log_message(self, *args) -> None:  # noqa: D102 - silence stderr
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, payload, code: int = 200) -> None:
        self._send(code, json.dumps(payload), "application/json")

    def do_GET(self) -> None:  # noqa: N802 - http.server contract
        try:
            url = urlparse(self.path)
            route = url.path.rstrip("/") or "/"
            if route == "/metrics":
                self._send(200, metrics.metrics_text(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif route == "/healthz":
                self._send_json(_healthz_payload())
            elif route == "/queryz":
                n = _int_param(url.query, "n", 32)
                self._send_json({"traces": trace.recent_traces(n) if n else []})
            elif route == "/skewz":
                n = _int_param(url.query, "n", 16)
                self._send_json({
                    "wire": _skew.wire_matrix(),
                    "skew": _skew.summary(),
                    "events": _recorder.events("skew")[-n:] if n else [],
                    "fleet": _skew.fleet_view(),
                })
            elif route == "/rooflinez":
                self._send_json({
                    "phases": _roofline.summary(),
                    "peaks": {"hbm_gbps": _roofline.hbm_peak_gbps(),
                              "wire_gbps": _roofline.wire_peak_gbps()},
                    "stragglers": _skew.rank_skew_summary(),
                })
            elif route == "/varz":
                self._send_json(metrics.metrics_summary())
            elif route == "/tenantz":
                self._send_json(_truth.tenant_summary())
            elif route == "/trendz":
                self._send_json(_history.trend_view(_int_param(url.query, "n", 32)))
            elif route == "/knobz":
                self._send_json({"knobs": _knobs.registry_snapshot()})
            elif route == "/tunez":
                from ..parallel import autotune as _autotune

                self._send_json(_autotune.tunez_summary())
            elif route == "/tracez":
                qs = parse_qs(url.query)
                qid = (qs.get("q") or [None])[0]
                if not qid:
                    raise _BadParam("query parameter q is required "
                                    "(?q=<query_id>[&format=chrome|perfetto])")
                fmt = (qs.get("format") or ["chrome"])[0]
                try:
                    out = trace.export_trace(qid, fmt=fmt)
                except ValueError as e:
                    raise _BadParam(str(e)) from None
                if out is None:
                    self._send(404, f"no stored trace for query {qid} (evicted, or never "
                                    f"seen by this process)\n", "text/plain")
                else:
                    self._send_json(out)
            elif route == "/fleetz":
                self._send_json(_fleet.fleet_health())
            elif route == "/profilez":
                raw = (parse_qs(url.query).get("secs") or ["2"])[0]
                try:
                    secs = float(raw)
                except ValueError:
                    raise _BadParam(f"query parameter secs={raw!r}: expected seconds "
                                    f"(e.g. ?secs=5)") from None
                if not 0 < secs <= 600:
                    raise _BadParam(f"query parameter secs={secs}: expected 0 < secs <= 600")
                result = start_profile(secs)
                if result.get("busy"):
                    self._send_json(result, code=409)
                elif not result.get("ok"):
                    self._send_json(result, code=500)
                else:
                    self._send_json(result)
            elif route == "/":
                self._send(200, "dj_tpu_torch obs endpoint: /metrics /healthz /queryz /varz"
                                " /skewz /rooflinez /tenantz /trendz /knobz /tunez /tracez"
                                " /fleetz /profilez\n", "text/plain")
            else:
                self._send(404, f"no route {route}\n", "text/plain")
        except _BadParam as e:
            self._send(400, f"{e}\n", "text/plain")
        except BrokenPipeError:
            pass  # the scraper went away mid-write
        except Exception as e:  # noqa: BLE001 - diagnostics must answer
            try:
                self._send_json({"ok": False, "error": type(e).__name__}, code=500)
            except Exception:  # noqa: BLE001
                pass


# One capture at a time, process-wide: the lock is a busy guard held for
# the capture's whole life and released by the capture thread.
_profile_busy = threading.Lock()


def _profile_capture(trace_dir: str, secs: float, started: threading.Event,
                     outcome: dict) -> None:
    """The capture thread: ``utils.timing.profile(trace_dir)`` (CPU and,
    with a card, CUDA activities; every thread's CPU ranges) around a
    ``secs`` sleep, which writes ``trace_dir/trace.json``. ``started`` is
    set once the profiler runs, or with ``outcome["error"]`` when it
    refused."""
    from ..utils.timing import profile

    state = "failed"
    try:
        with profile(trace_dir):
            _recorder.record("profile", state="started", dir=trace_dir, secs=secs)
            started.set()
            time.sleep(secs)
        state = "stopped"
    except Exception as e:  # noqa: BLE001 - the route's 500, or a failed capture
        outcome["error"] = f"{type(e).__name__}: {e}"
    finally:
        _profile_busy.release()
        ran = started.is_set()
        started.set()
    if ran:
        _recorder.record("profile", state=state, dir=trace_dir, secs=secs)
        if state == "stopped":
            metrics.inc("dj_profile_captures_total")


def start_profile(secs: float) -> dict:
    """Start a ``secs``-second ``torch.profiler`` capture into a new
    directory under ``DJT_OBS_PROFILE_DIR`` (module docstring). Returns
    ``{"ok": True, "dir", "path", "secs", "state": "started"}`` once the
    profiler runs (``path``: the Chrome trace it will write),
    ``{"ok": False, "busy": True, ...}`` while another capture runs, and
    ``{"ok": False, "error": ...}`` when the profiler refused; raises
    _BadParam when the directory knob is unset."""
    out_dir = _knobs.read("DJT_OBS_PROFILE_DIR")
    if not out_dir:
        raise _BadParam("DJT_OBS_PROFILE_DIR is not set — export it (or /knobz it) to the "
                        "directory profiler captures should land in")
    secs = float(secs)
    if not _profile_busy.acquire(blocking=False):
        return {"ok": False, "busy": True, "error": "capture in progress"}
    trace_dir = os.path.join(str(out_dir), f"profilez-{time.strftime('%Y%m%d-%H%M%S')}-"
                                           f"p{os.getpid()}-{time.monotonic_ns()}")
    started, outcome = threading.Event(), {}
    threading.Thread(target=_profile_capture, args=(trace_dir, secs, started, outcome),
                     name="dj-obs-profile", daemon=True).start()
    started.wait()
    if "error" in outcome:
        return {"ok": False, "error": outcome["error"]}
    return {"ok": True, "dir": str(out_dir), "path": os.path.join(trace_dir, "trace.json"),
            "secs": secs, "state": "started"}


def start(port: int, host: Optional[str] = None) -> tuple:
    """Start the endpoint (idempotent: a running server's address is
    returned) and return its bound ``(host, port)``; ``port=0`` binds an
    ephemeral one. Enables obs, sets the ``dj_obs_http_port`` gauge,
    records one ``obs_http`` event and starts the history sampler."""
    global _server, _thread, _history_owned
    with _lock:
        if _server is not None:
            return _server.server_address[:2]
        host = host or str(_knobs.read("DJT_OBS_HTTP_HOST"))
        srv = ThreadingHTTPServer((host, int(port)), _Handler)
        srv.daemon_threads = True
        th = threading.Thread(target=srv.serve_forever, name="dj-obs-http", daemon=True)
        th.start()
        _server, _thread = srv, th
    metrics.enable()
    bound = int(srv.server_address[1])
    metrics.set_gauge("dj_obs_http_port", bound)
    _recorder.record("obs_http", host=srv.server_address[0], port=bound, requested=int(port))
    _history_owned = _history.start() or _history_owned
    return srv.server_address[:2]


def stop() -> None:
    """Shut the endpoint down and join its thread (a no-op when none
    runs). Obs stays enabled; the history sampler stops only if
    :func:`start` started it."""
    global _server, _thread, _history_owned
    with _lock:
        srv, th = _server, _thread
        _server = _thread = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if th is not None:
        th.join(timeout=5)
    if _history_owned:
        _history_owned = False
        _history.stop()


def server_address() -> Optional[tuple]:
    """The live endpoint's ``(host, port)``, or None."""
    with _lock:
        return None if _server is None else _server.server_address[:2]


def maybe_start_from_env() -> Optional[tuple]:
    """Start the endpoint iff ``DJT_OBS_HTTP`` names a port; unset or
    malformed is a no-op. Returns the bound address or None. A bind
    failure warns (and mirrors ``obs_http_bind_failed``) and returns
    None: a diagnostics port never takes the process's start down."""
    v = _knobs.read("DJT_OBS_HTTP")
    if not v:
        return None
    try:
        port = int(v)
    except ValueError:
        return None
    try:
        return start(port)
    except OSError as e:
        detail = f"DJT_OBS_HTTP={v}: {e} — telemetry endpoint disabled for this process"
        warnings.warn(detail, stacklevel=2)
        _recorder.mirror_warning("obs_http_bind_failed", detail)
        return None

"""Live telemetry HTTP plane — the port's own copy of
``mxnet_tpu/telemetry/httpd.py``: scrape the process while it runs.

A ``ThreadingHTTPServer`` on a daemon thread, off by default, armed by
``MXNET_TELEMETRY_PORT=<port>`` (0 picks an ephemeral port) or
:func:`start`:

- ``GET /metrics``     — the Prometheus text exposition of the live
  ``MetricsRegistry`` (exactly ``telemetry.to_prometheus()``);
- ``GET /statusz``     — JSON run status: rank/world/pid, resolved
  ``MXNET_*`` knobs (non-default ones flagged), the rolling step-clock
  summary and bottleneck verdict, serving queue/slot/block gauges, and
  the telemetry/costmodel arming states;
- ``GET /ledger.json`` — the cost ledger (per-signature FLOPs/bytes/peak
  records) plus the per-op aggregate ledger;
- ``GET /healthz``     — liveness fed by ``resilience.heartbeat.status()``:
  200 + ``{phase, heartbeat_age_s}`` while the armed beater is fresh, 503
  once it goes stale past ``MXNET_ROUTER_HANG_S``; a process with no
  heartbeat armed answers 200;
- ``GET /``            — a plain-text index.

Not ported: the reference's ``/perfgate.json`` and the ``perfgate`` row
of ``/statusz`` (``telemetry/perfgate.py``, ROADMAP A.11).  Handlers only
read the registry (each metric snapshots under its own lock), and
rendering happens on the server's per-connection threads.  Stdlib-only.
"""

from __future__ import annotations

import json
import threading

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import config
from . import costmodel, ledger, metrics, stepclock

__all__ = ["start", "stop", "running", "port", "start_from_env"]

_lock = threading.Lock()
_server = None
_thread = None

_SERVING_GAUGES = (
    "mxnet_serving_queue_depth", "mxnet_serving_active_slots",
    "mxnet_serving_free_blocks",
)


def _statusz():
    import os
    from . import aggregate
    knobs = {}
    for name, current, default, _doc in config.describe():
        row = {"value": current}
        if current != default:
            row["default"] = default
        knobs[name] = row
    serving = {}
    for name in _SERVING_GAUGES:
        m = metrics.REGISTRY.get(name)
        if m is not None:
            serving[name] = m.value
    from . import tracer
    return {
        "pid": os.getpid(),
        "rank": aggregate.rank(),
        "world": config.get_int("MXNET_DIST_NUM_WORKERS", 1),
        "telemetry_enabled": tracer._ENABLED,
        "costmodel_armed": costmodel.armed(),
        "stepclock": stepclock.STEP_CLOCK.summary(),
        "serving": serving,
        "knobs": knobs,
    }


def _ledger_json():
    return {
        "costmodel": costmodel.LEDGER.snapshot(),
        "costmodel_sites": costmodel.LEDGER.site_summary(),
        "ops": {k: list(v) for k, v in ledger.snapshot().items()},
    }


def _healthz():
    """(status_code, body_dict) from the resilience heartbeat.  Stale =
    the armed beater has not landed a beat within MXNET_ROUTER_HANG_S
    (the same staleness bound the router's out-of-band hb-file check
    uses, so the two probes agree)."""
    from ..resilience import heartbeat
    st = heartbeat.status()
    st["ok"] = True
    if st["armed"]:
        stale_s = config.get_float("MXNET_ROUTER_HANG_S", 20.0)
        age = st["heartbeat_age_s"]
        if stale_s > 0 and (age is None or age > stale_s):
            st["ok"] = False
            return 503, st
    return 200, st


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxnet-tpu-torch-telemetry"

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = metrics.to_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/statusz":
                body = json.dumps(_statusz(), indent=1,
                                  default=str).encode()
                ctype = "application/json"
            elif path == "/ledger.json":
                body = json.dumps(_ledger_json(), default=str).encode()
                ctype = "application/json"
            elif path == "/healthz":
                code, health = _healthz()
                body = json.dumps(health).encode()
                ctype = "application/json"
                if code != 200:
                    # send_error would wrap the body in HTML; a liveness
                    # probe wants the JSON payload with the 503
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
            elif path == "/":
                body = (b"mxnet_tpu_torch telemetry\n"
                        b"  /metrics     Prometheus exposition\n"
                        b"  /statusz     run status JSON\n"
                        b"  /ledger.json cost + op ledgers\n"
                        b"  /healthz     heartbeat liveness probe\n")
                ctype = "text/plain; charset=utf-8"
            else:
                self.send_error(404, "unknown endpoint")
                return
        except Exception as e:  # noqa: BLE001 — a scrape bug must not 500-loop
            self.send_error(500, f"{type(e).__name__}: {e}"[:200])
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # noqa: ARG002 — no stderr chatter
        pass


def start(port=None, host="0.0.0.0"):
    """Start the daemon-thread server (idempotent); returns the bound
    port.  ``port=0`` binds an ephemeral port (tests / parallel ranks).
    Asking for a DIFFERENT specific port while a server is already
    running (e.g. auto-started from ``MXNET_TELEMETRY_PORT``) raises —
    silently returning the old port would leave a router scraping a port
    nothing listens on."""
    global _server, _thread
    with _lock:
        if _server is not None:
            bound = _server.server_address[1]
            if port not in (None, 0, bound):
                raise RuntimeError(
                    f"telemetry httpd already serving on port {bound}; "
                    f"stop() it before rebinding to {port}")
            return bound
        if port is None:
            port = config.get_int("MXNET_TELEMETRY_PORT", -1)
            if port < 0:
                return None
        srv = ThreadingHTTPServer((host, int(port)), _Handler)
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever,
                             name="mxnet-telemetry-httpd", daemon=True)
        t.start()
        _server, _thread = srv, t
        return srv.server_address[1]


def stop():
    """Shut the server down and release the port (idempotent)."""
    global _server, _thread
    with _lock:
        srv, t = _server, _thread
        _server = _thread = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if t is not None:
        t.join(timeout=5)


def running():
    with _lock:
        return _server is not None


def port():
    with _lock:
        return None if _server is None else _server.server_address[1]


def start_from_env():
    """telemetry.__init__ calls this at import: serve only when the env
    knob names a port."""
    if config.get("MXNET_TELEMETRY_PORT") is not None:
        return start()
    return None

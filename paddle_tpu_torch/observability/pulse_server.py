"""Live /metrics endpoint: the pulse plane's operator surface.

A stdlib ``ThreadingHTTPServer`` bound to LOCALHOST ONLY (ephemeral
port for tests) that answers while the pod hangs — the handler chain
imports no torch and touches nothing that can block on a device
(``metrics``/``exporters``/``timeseries``/``flight_recorder``/
``goodput`` are all torch-free by construction; that is the whole
point, same as the flight recorder's dump path):

  /metrics    live Prometheus pull. The body IS
              ``exporters.to_prometheus(metrics.snapshot())`` — one
              renderer for the scrape and the file export, so the two
              surfaces cannot drift.
  /healthz    liveness verdict JSON: step progress + watchdog stall
              clock, goodput fractions, and the numeric-sentry health
              stamp when a monitor is registered. 200 when ok, 503
              when stalled/numeric-unhealthy — a probe can alert on
              status code alone.
  /snapshot   the raw registry snapshot as JSON (the typed transport
              format every exporter consumes).
  /series     ?key=<ring-key>&window=<seconds>: pulse-ring contents
              from ``timeseries`` (404 for a never-sampled key).

Security posture: the bind address is VALIDATED to be loopback — this
is an introspection port for the operator ssh'd into the host (or a
localhost sidecar scraper), not a fleet-wide listener; refusing
0.0.0.0 at construction time is cheaper than a CVE. No auth, no TLS,
GET only.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from . import exporters, goodput, metrics, timeseries
from . import flight_recorder as _fr

__all__ = ["PulseServer", "health_doc", "serve", "get_server",
           "shutdown", "LOOPBACK_HOSTS"]

LOOPBACK_HOSTS = ("127.0.0.1", "localhost")  # IPv4-only: the server
# socket is AF_INET ("::1" would pass validation then fail to bind,
# and an IPv6 URL would need brackets) — localhost resolves v4 here


def health_doc(watchdog=None, sentry_monitor=None) -> dict:
    """The /healthz verdict, computed from whatever planes are armed.

    Verdict precedence: ``stalled`` (no step inside the watchdog's
    timeout — or 5× the rolling p99 when no watchdog is registered)
    > ``numeric`` (a registered sentry monitor's health stamp says
    unhealthy loss) > ``ok``. A job with no steps yet is ``ok`` —
    warming up is not a hang (the watchdog makes the same call)."""
    prog = _fr.progress()
    doc = {"ts": round(time.time(), 3), "verdict": "ok", "ok": True,
           "progress": prog,
           "goodput": goodput.report(),
           "pulse": {"enabled": timeseries.enabled(),
                     "samples": timeseries.sample_count(),
                     "series": len(timeseries.keys())}}
    age = prog.get("last_step_age_s")
    stalled = False
    if watchdog is not None:
        limit = watchdog.timeout()
        doc["watchdog"] = {"timeout_s": limit,
                           "stall_count": watchdog.stall_count}
        stalled = age is not None and age > limit
    elif age is not None and prog.get("step_s_p99"):
        # no watchdog registered: a crude 5×p99 clock (floor 30 s) so
        # the endpoint still answers "is it moving" on its own
        stalled = age > max(30.0, 5.0 * prog["step_s_p99"])
    if sentry_monitor is not None:
        stamp = sentry_monitor.health_stamp()
        doc["sentry"] = stamp
        if not stamp.get("loss_finite", True):
            doc["verdict"], doc["ok"] = "numeric", False
    if stalled:
        doc["verdict"], doc["ok"] = "stalled", False
    return doc


class _Handler(BaseHTTPRequestHandler):
    server_version = "pd-pulse/1"

    # the request thread must never write to the job's stdout/stderr
    def log_message(self, fmt, *args):  # pragma: no cover — silence
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, doc, code: int = 200):
        self._send(code, json.dumps(doc).encode("utf-8"),
                   "application/json")

    def do_GET(self):  # noqa: N802 — http.server contract
        try:
            self._route()
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-write
        except Exception as e:   # the server must never crash the job
            try:
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)
            except Exception:
                pass

    def _route(self):
        url = urlparse(self.path)
        pulse: "PulseServer" = self.server.pulse  # type: ignore
        if url.path == "/metrics":
            # one renderer for scrape AND file export — parity by
            # construction with write_prometheus
            body = exporters.to_prometheus(metrics.snapshot())
            metrics.counter("pulse.scrapes_total", _always=True).add()
            self._send(200, body.encode("utf-8"),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif url.path == "/healthz":
            doc = health_doc(watchdog=pulse.watchdog,
                             sentry_monitor=pulse.sentry_monitor)
            self._json(doc, 200 if doc["ok"] else 503)
        elif url.path == "/snapshot":
            self._json({"ts": round(time.time(), 3),
                        "metrics": metrics.snapshot()})
        elif url.path == "/series":
            q = parse_qs(url.query)
            key = (q.get("key") or [""])[0]
            window = (q.get("window") or [None])[0]
            try:
                window = float(window) if window else None
            except ValueError:
                # a client typo is a 400, not a server fault — probes
                # alerting on 5xx must not fire on ?window=abc
                self._json({"error": f"window={window!r} is not a "
                            "number of seconds"}, 400)
                return
            pts = timeseries.series(key, window)
            if pts is None:
                self._json({"error": f"unknown series key {key!r}",
                            "keys": timeseries.keys()[:100]}, 404)
            else:
                self._json({"key": key, "window": window,
                            "points": [list(p) for p in pts]})
        else:
            self._json({"error": f"no route {url.path!r}",
                        "routes": ["/metrics", "/healthz",
                                   "/snapshot", "/series"]}, 404)


class PulseServer:
    """Owns the HTTP thread. ``watchdog``/``sentry_monitor`` are
    optional health sources (objects with ``timeout()``/
    ``stall_count`` resp. ``health_stamp()``) — registered by the
    caller so this module never imports a device-touching monitor."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 watchdog=None, sentry_monitor=None):
        if host not in LOOPBACK_HOSTS:
            raise ValueError(
                f"pulse server binds loopback only, got {host!r} "
                f"(allowed: {LOOPBACK_HOSTS}) — this is an unsecured "
                "introspection port, never a fleet listener")
        self.host = host
        self.requested_port = int(port)
        self.watchdog = watchdog
        self.sentry_monitor = sentry_monitor
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "PulseServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self.requested_port),
                                    _Handler)
        httpd.daemon_threads = True       # scrapers never block exit
        httpd.pulse = self                # type: ignore[attr-defined]
        self._httpd = httpd
        self._thread = threading.Thread(
            # 0.1 s shutdown poll: stop() costs a tick, not the
            # stdlib's 0.5 s default (tier-1 runs many start/stops)
            target=lambda: httpd.serve_forever(poll_interval=0.1),
            name="pd-pulse-server", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    @property
    def port(self) -> int:
        if self._httpd is None:
            return self.requested_port
        return self._httpd.server_address[1]

    @property
    def address(self):
        return None if self._httpd is None \
            else self._httpd.server_address

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


# -- module-level singleton (the worker-arming surface) ------------------------

_server: Optional[PulseServer] = None
_server_lock = threading.Lock()


def serve(port: int = 0, host: str = "127.0.0.1", watchdog=None,
          sentry_monitor=None) -> PulseServer:
    """Start (or return) the process's pulse server. Re-serving updates
    the health sources on the existing server instead of binding a
    second port."""
    global _server
    with _server_lock:
        if _server is not None:
            if watchdog is not None:
                _server.watchdog = watchdog
            if sentry_monitor is not None:
                _server.sentry_monitor = sentry_monitor
            return _server
        _server = PulseServer(host=host, port=port, watchdog=watchdog,
                              sentry_monitor=sentry_monitor).start()
        return _server


def get_server() -> Optional[PulseServer]:
    return _server


def shutdown():
    global _server
    with _server_lock:
        s, _server = _server, None
    if s is not None:
        s.stop()

"""HTTP KV store for rank rendezvous and heartbeats (a copy of
paddle_tpu/distributed/fleet/utils/http_server.py, which uses only the
standard library; the port keeps its own so that it imports nothing of
the JAX package).

A scoped key->value map any rank can PUT/GET while the job runs: the
elastic launcher's heartbeats (heartbeat.py) and the workers' gates.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib import request as _urlreq
from urllib.error import HTTPError

__all__ = ["KVServer", "KVClient"]


class _KVHandler(BaseHTTPRequestHandler):
    server_version = "pdkv/1"

    def log_message(self, *args):  # silent by default, like the reference
        pass

    def _key(self):
        return self.path.lstrip("/")

    def do_GET(self):
        with self.server.kv_lock:
            val = self.server.kv.get(self._key())
        if val is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)

    def do_PUT(self):
        n = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(n)
        with self.server.kv_lock:
            self.server.kv[self._key()] = data
        self.send_response(200)
        self.end_headers()

    do_POST = do_PUT

    def do_DELETE(self):
        with self.server.kv_lock:
            self.server.kv.pop(self._key(), None)
        self.send_response(200)
        self.end_headers()


class KVServer:
    """Threaded KV HTTP server. `with KVServer(port) as s:` or
    start()/stop()."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._httpd = ThreadingHTTPServer((host, port), _KVHandler)
        self._httpd.kv: Dict[str, bytes] = {}
        self._httpd.kv_lock = threading.Lock()
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def get_deleted_size(self, key=""):  # reference-API compatibility
        return 0

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class KVClient:
    """Client for KVServer (reference exposes raw http.client calls from
    role_maker; a client object keeps the surface tidy)."""

    def __init__(self, endpoint: str, timeout: float = 10.0):
        if not endpoint.startswith("http"):
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self.timeout = float(timeout)

    def put(self, key: str, value) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()
        req = _urlreq.Request(f"{self.endpoint}/{key}", data=data,
                              method="PUT")
        _urlreq.urlopen(req, timeout=self.timeout).read()

    def get(self, key: str) -> Optional[bytes]:
        """value bytes, or None for a missing key; transport errors
        raise (callers distinguish outage from absence)."""
        try:
            return _urlreq.urlopen(f"{self.endpoint}/{key}",
                                   timeout=self.timeout).read()
        except HTTPError as e:
            if e.code == 404:
                return None
            raise

    def delete(self, key: str) -> None:
        req = _urlreq.Request(f"{self.endpoint}/{key}", method="DELETE")
        _urlreq.urlopen(req, timeout=self.timeout).read()

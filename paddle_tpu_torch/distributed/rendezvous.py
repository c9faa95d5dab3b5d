"""TCP rendezvous bootstrap: rank 0 broadcasts a blob to every peer
(counterpart of paddle_tpu/distributed/rendezvous.py).

Reference: platform/gen_comm_id_helper.cc (the raw-socket exchange of
the ncclUniqueId before any collective can run). The channel carries
what a job needs before its process group exists: the coordinator
address, the topology, the experiment's config.

The JAX package serves it from native C++ sockets (csrc/runtime.cpp)
with a pure-Python fallback; the port has no native runtime and keeps
the Python path alone, with the same wire format (a 4-byte big-endian
length, then the payload), so a JAX rank 0 can bootstrap a port peer
and the other way round. Timeouts as there: per-call arguments first,
then ``PD_RDZV_TIMEOUT_S`` / ``PD_RDZV_ATTEMPTS`` / ``PD_RDZV_BACKOFF_S``,
with bounded retries and exponential backoff, and every failure names
the endpoint and the attempt count.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

__all__ = ["broadcast_bootstrap", "Rendezvous", "default_timeout",
           "default_attempts", "default_backoff"]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def default_timeout() -> float:
    """Per-attempt budget in seconds (PD_RDZV_TIMEOUT_S, default 120)."""
    return _env_float("PD_RDZV_TIMEOUT_S", 120.0)


def default_attempts() -> int:
    """Bounded retry count (PD_RDZV_ATTEMPTS, default 1 — exactly the
    legacy single-attempt behavior unless opted into)."""
    return max(1, int(_env_float("PD_RDZV_ATTEMPTS", 1)))


def default_backoff() -> float:
    """Base backoff between attempts (PD_RDZV_BACKOFF_S, default 0.5;
    doubles per retry)."""
    return _env_float("PD_RDZV_BACKOFF_S", 0.5)


class Rendezvous:
    """One rank-0-broadcast exchange on (host, port). `timeout` is the
    PER-ATTEMPT budget; `attempts`/`backoff` bound the retry loop —
    constructor values (or the PD_RDZV_* env) are the defaults each
    call can still override."""

    def __init__(self, endpoint: str, rank: int, nranks: int,
                 timeout: Optional[float] = None,
                 attempts: Optional[int] = None,
                 backoff: Optional[float] = None):
        host, port = endpoint.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.rank, self.nranks = rank, nranks
        self.timeout = default_timeout() if timeout is None else \
            float(timeout)
        self.attempts = default_attempts() if attempts is None else \
            max(1, int(attempts))
        self.backoff = default_backoff() if backoff is None else \
            float(backoff)
        self._py_thread = None
        self._py_done = threading.Event()

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    # -- rank 0 --------------------------------------------------------------
    def serve(self, payload: bytes):
        if self.nranks <= 1:
            return
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host if self.host != "" else "0.0.0.0", self.port))
        srv.listen(self.nranks - 1)
        self._py_srv = srv

        def run():
            served = 0
            while served < self.nranks - 1:
                try:
                    conn, _ = srv.accept()
                except OSError:
                    return  # listen socket closed under us (close())
                # one flaky peer must not abort the broadcast: it will
                # reconnect and retry (fetch retries until its timeout)
                try:
                    conn.sendall(struct.pack("!I", len(payload)) + payload)
                    served += 1
                except OSError:
                    pass
                finally:
                    conn.close()
            srv.close()
            self._py_done.set()
        self._py_thread = threading.Thread(target=run, daemon=True)
        self._py_thread.start()

    def wait_served(self, timeout: Optional[float] = None) -> bool:
        """Block until all (nranks-1) peers have fetched (rank 0 only).
        The reference's SendBroadCastCommID completes every send before
        returning; this is the explicit-wait equivalent for the
        background-thread server."""
        if timeout is None:
            timeout = self.timeout
        if self.nranks <= 1:
            return True
        if self._py_thread is not None:
            return self._py_done.wait(timeout)
        return True

    # -- peers ---------------------------------------------------------------
    def _fetch_once(self, timeout: float, max_len: int) -> bytes:
        """One bounded attempt; raises TimeoutError."""
        deadline = time.time() + timeout
        while True:
            try:
                with socket.create_connection(
                        (self.host, self.port),
                        timeout=max(0.05, min(2.0, timeout))) as conn:
                    hdr = conn.recv(4, socket.MSG_WAITALL)
                    if len(hdr) < 4:  # server closed early: retry
                        raise ConnectionError("short header")
                    (n,) = struct.unpack("!I", hdr)
                    data = b""
                    while len(data) < n:
                        chunk = conn.recv(n - len(data))
                        if not chunk:
                            break
                        data += chunk
                    if len(data) == n:
                        return data
            except OSError:
                pass
            if time.time() > deadline:
                raise TimeoutError(
                    f"rendezvous fetch from {self.endpoint} timed out")
            time.sleep(min(0.1, max(0.01, timeout / 10)))

    def fetch(self, timeout: Optional[float] = None,
              max_len: int = 1 << 20,
              attempts: Optional[int] = None,
              backoff: Optional[float] = None) -> bytes:
        """Fetch the broadcast blob: `attempts` bounded tries of
        `timeout` seconds each, exponential backoff between them. The
        terminal error names the endpoint, the attempt count and the
        total wall spent — everything the on-call needs."""
        if timeout is None:
            timeout = self.timeout
        attempts = self.attempts if attempts is None else max(1,
                                                              int(attempts))
        backoff = self.backoff if backoff is None else float(backoff)
        t0 = time.time()
        last: Optional[BaseException] = None
        for i in range(attempts):
            try:
                return self._fetch_once(timeout, max_len)
            except (TimeoutError, OSError) as e:
                last = e
                if i + 1 < attempts:
                    time.sleep(backoff * (2 ** i))
        raise TimeoutError(
            f"rendezvous fetch from {self.endpoint} failed after "
            f"{attempts} attempt(s) over {time.time() - t0:.1f}s "
            f"(per-attempt timeout {timeout:g}s)") from last

    def close(self):
        if self._py_thread is not None:
            srv = getattr(self, "_py_srv", None)
            if srv is not None:
                try:
                    srv.close()  # interrupts a blocked accept()
                except OSError:
                    pass
            self._py_thread.join(timeout=1.0)
            self._py_thread = None


def broadcast_bootstrap(payload: Optional[bytes], endpoint: str, rank: int,
                        nranks: int, timeout: Optional[float] = None,
                        attempts: Optional[int] = None) -> bytes:
    """Rank 0 passes its payload; every rank returns the payload
    (gen_comm_id one-shot convenience). timeout/attempts default to the
    PD_RDZV_* env knobs (legacy 120 s single attempt)."""
    rv = Rendezvous(endpoint, rank, nranks, timeout=timeout,
                    attempts=attempts)
    if rank == 0:
        assert payload is not None
        rv.serve(payload)
        # complete all sends before returning (SendBroadCastCommID
        # semantics), then release the listening socket so the port is
        # reusable in-process
        ok = rv.wait_served()
        rv.close()
        if not ok:
            raise TimeoutError(
                f"rendezvous: not all {nranks - 1} peers fetched from "
                f"{endpoint} within {rv.timeout:g}s")
        return payload
    return rv.fetch()

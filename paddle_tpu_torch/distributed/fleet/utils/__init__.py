"""The fleet KV store and heartbeats (standard library only)."""
from .heartbeat import HeartbeatMonitor, HeartbeatWorker  # noqa: F401
from .http_server import KVClient, KVServer  # noqa: F401

__all__ = ["KVServer", "KVClient", "HeartbeatWorker", "HeartbeatMonitor"]

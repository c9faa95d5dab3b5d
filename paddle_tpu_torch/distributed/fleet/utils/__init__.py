"""The fleet utilities: the filesystem abstraction, the fleet KV store
and heartbeats (standard library only), and recompute."""
from ...recompute import recompute  # noqa: F401
from .fs import FS, HDFSClient, LocalFS  # noqa: F401
from .heartbeat import HeartbeatMonitor, HeartbeatWorker  # noqa: F401
from .http_server import KVClient, KVServer  # noqa: F401

__all__ = ["FS", "LocalFS", "HDFSClient", "KVServer", "KVClient",
           "HeartbeatWorker", "HeartbeatMonitor", "recompute"]

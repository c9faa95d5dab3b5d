"""Observability (counterpart of paddle_tpu/observability; only the
recompile sentinel the serving engine observes)."""
from .sentinel import RecompileSentinel, diff_signatures  # noqa: F401

"""Observability (counterpart of paddle_tpu/observability; only the
recompile sentinel the serving engine and TrainStep observe)."""
from .sentinel import (RecompileSentinel, diff_signatures,  # noqa: F401
                       signature_of)

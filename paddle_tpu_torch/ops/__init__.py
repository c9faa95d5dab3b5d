"""Kernels of the port (counterpart of paddle_tpu/ops; only the modules
the ported slices run)."""
from . import extras, flash_attention  # noqa: F401

"""Kernels of the port (counterpart of paddle_tpu/ops; only the modules
the ported slices run)."""
from . import detection, extras, flash_attention, nms  # noqa: F401

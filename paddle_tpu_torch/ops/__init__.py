"""Kernels of the port (counterpart of paddle_tpu/ops; only the kernel
module the ported slice runs)."""
from . import flash_attention  # noqa: F401

"""paddle.device surface (counterpart of paddle_tpu/device.py)."""
from .core.place import (CPUPlace, CUDAPlace, get_device,  # noqa: F401
                         is_compiled_with_cuda, set_device)

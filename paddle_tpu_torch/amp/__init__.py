"""Automatic mixed precision (counterpart of paddle_tpu/amp)."""
from .auto_cast import (AMP_BLACK_LIST, AMP_WHITE_LIST, amp_guard,  # noqa: F401
                        auto_cast, black_list, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

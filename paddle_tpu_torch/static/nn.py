"""paddle.static.nn namespace (counterpart of paddle_tpu/static/nn.py):
control flow and the layer functionals."""
from ..ops.control_flow import (case, cond, fori_loop, scan, switch_case,
                                while_loop)  # noqa: F401
from ..nn.functional import *  # noqa: F401,F403

"""nn.weight_norm_hook (reference python/paddle/nn/weight_norm_hook.py):
the weight-norm reparameterisation lives in nn/utils.py."""
from .utils import weight_norm, remove_weight_norm  # noqa: F401

__all__ = ["weight_norm", "remove_weight_norm"]

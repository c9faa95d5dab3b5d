"""Carry weights from the JAX package into the port by name."""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["load_jax_params"]


def load_jax_params(model, state: Dict[str, np.ndarray]):
    """Copy a paddle_tpu `state_dict()` (as numpy arrays) into `model`.

    Both packages name parameters alike and Linear keeps the [in, out]
    layout, so every array copies 1:1, cast to the parameter's dtype.
    Raises KeyError on a missing or an extra name and ValueError on a
    shape mismatch: a partial load is never silent."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing "
                       f"{missing}, extra {extra}")
    arrays = {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":  # ml_dtypes; torch cannot wrap it
            arr = arr.astype(np.float32)
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                             f"match the model's {tuple(own[name].shape)}")
        arrays[name] = arr
    model.set_state_dict(arrays)
    return model

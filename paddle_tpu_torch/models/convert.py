"""Carry weights from the JAX package into the port: a model's
state_dict by name, and the serving engine's params tree (int8 or not)
leaf by leaf."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.place import resolve_device
from ..serialization import from_numpy

__all__ = ["load_jax_params", "load_jax_serving_params",
           "serving_params_to_numpy"]


def load_jax_params(model, state: Dict[str, np.ndarray]):
    """Copy a paddle_tpu `state_dict()` (as numpy arrays) into `model`.

    Both packages name parameters alike and Linear keeps the [in, out]
    layout, so every array copies 1:1, cast to the parameter's dtype; a
    scan_layers model's [L, ...] stacks carry the JAX model's
    `stk__...` names (nn/layer/scanned.py) and load the same way.
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
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                             f"match the model's {tuple(own[name].shape)}")
        arrays[name] = from_numpy(arr)
    model.set_state_dict(arrays)
    return model


def _tensor(arr, device):
    return from_numpy(np.array(arr)).to(device)


def load_jax_serving_params(snapshot, device=None):
    """A JAX generation/serving params tree (``wte``, ``wpe``,
    ``lnf_w``, ``lnf_b`` and per-block dicts, as
    paddle_tpu.serving.build_serving_snapshot returns it, int8 or not)
    -> the same tree of torch tensors on ``device`` (the current device
    when None), for ``ServingEngine.swap_weights(..., cast=False)``.

    Values and dtypes carry over unchanged: bf16 through f32, which is
    exact. An int8 ``{"q8", "s"}`` leaf becomes the port's leaf, its
    codes laid out as quant.int8_serving.quantize_weight lays them out
    (column-major, the layout the card's int8 GEMM reads)."""
    dev = resolve_device(device)
    if isinstance(snapshot, dict):
        if set(snapshot) == {"q8", "s"}:
            q8 = _tensor(snapshot["q8"], dev)
            return {"q8": q8.transpose(-2, -1).contiguous().transpose(-2, -1),
                    "s": _tensor(snapshot["s"], dev)}
        return {k: load_jax_serving_params(v, dev)
                for k, v in snapshot.items()}
    if isinstance(snapshot, (list, tuple)):
        return [load_jax_serving_params(v, dev) for v in snapshot]
    return _tensor(snapshot, dev)


def serving_params_to_numpy(params):
    """The inverse of load_jax_serving_params: the port's serving params
    tree as numpy arrays (bf16 leaves as f32, which is exact)."""
    if isinstance(params, dict):
        return {k: serving_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [serving_params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()

"""Carry weights from the JAX package into the port: a model's (or a
pipeline stage's, models/ernie.py ErnieStageFirst/Middle/Last)
state_dict by name (MoE blocks' gate, w1, b1, w2 and b2 included; a
model made on a mesh whose tp or ep axis spans several ranks takes this
rank's block of each split array), a rank's shard of every full array
under a sharding plan, and the serving engine's params tree (int8 or
not) leaf by leaf."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.place import resolve_device
from ..serialization import from_numpy

__all__ = ["load_jax_params", "shard_for_rank", "load_jax_serving_params",
           "serving_params_to_numpy"]


def load_jax_params(model, state: Dict[str, np.ndarray]):
    """Copy a paddle_tpu `state_dict()` (as numpy arrays) into `model`.

    Both packages name parameters alike and Linear keeps the [in, out]
    layout, so every array copies 1:1, cast to the parameter's dtype; a
    scan_layers model's [L, ...] stacks carry the JAX model's
    `stk__...` names (nn/layer/scanned.py) and load the same way.
    Raises KeyError on a missing or an extra name and ValueError on a
    shape mismatch: a partial load is never silent."""
    from ..distributed import sharding as _sh
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing "
                       f"{missing}, extra {extra}")
    arrays = {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        want = _sh._shape_of(own[name])
        if tuple(arr.shape) != want:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                             f"match the model's {want}")
        t = from_numpy(arr)
        layout = _sh.model_layout(own[name])
        arrays[name] = _sh.block_of(t, layout, _sh.get_mesh()) \
            if layout else t
    model.set_state_dict(arrays)
    return model


def shard_for_rank(state: Dict[str, np.ndarray], plan, rank: int,
                   named=None) -> Dict[str, np.ndarray]:
    """Rank `rank`'s block of every full array of `state` under `plan` (a
    MeshPlan or a ShardingPlan): each name's param_spec on the plan's
    mesh, from `named`'s annotations (name -> a tensor carrying
    ``sharding_spec``, e.g. a model's state_dict(keep_vars=True)), the
    plan's rules or replicated. A dim split over several axes holds the
    model axes' (tp, ep) block outermost, as the port stores it
    (distributed/sharding.py)."""
    from ..distributed import sharding as _sh
    mesh = plan.mesh
    coords = mesh.coords(int(rank))
    named = named or {}
    out = {}
    for name, arr in state.items():
        arr = np.asarray(arr)
        t = named.get(name)
        holder = t if t is not None else arr
        spec = plan.param_spec(name, holder)
        for dim, entry in enumerate(spec):
            axes = sorted(_sh._entry_axes(entry),
                          key=lambda a: 0 if a in _sh.MODEL_AXES else 1)
            n, idx = 1, 0
            for a in axes:
                n *= mesh.shape[a]
                idx = idx * mesh.shape[a] + coords[a]
            if n > 1:
                size = arr.shape[dim] // n
                arr = np.take(arr, np.arange(idx * size, (idx + 1) * size),
                              axis=dim)
        out[name] = arr
    return out


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

"""paddle.save / paddle.load over pickle (counterpart of
paddle_tpu/serialization.py, in its file layout).

A file is the pickle of {"__paddle_tpu_format__": 1, "payload": obj}.
Torch tensors in `obj` are written as numpy arrays (host copies), so a
file holds only standard containers, numpy arrays and Python scalars:
the JAX package's `paddle.load` reads it, and `load` here reads the JAX
package's files, whose tensors arrive wrapped in its `_TensorPayload`
(read through a local class of the same slots, never by importing the
JAX package). numpy has no bfloat16, so a bfloat16 tensor is written as
its float32 values, which hold it exactly: copying them back into a
bfloat16 tensor (as set_state_dict does) restores it bit for bit. The
JAX package writes bfloat16 as ml_dtypes bfloat16 arrays, which torch
cannot wrap: from_numpy widens them to float32 (exact) and casts back,
without importing ml_dtypes.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load", "from_numpy", "STATE_FORMAT_VERSION"]

# the envelope version the JAX package writes and reads
# (paddle_tpu/core/version_compat.py: v0 raw pickled payload, v1 envelope)
STATE_FORMAT_VERSION = 1


class _TensorPayload:
    """The JAX package's pickled Tensor wrapper, read back by slot."""

    __slots__ = ("array", "is_param", "stop_gradient", "name")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "_TensorPayload" and module.endswith("serialization"):
            return _TensorPayload
        return super().find_class(module, name)


def host_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor of `dtype` is written in: itself, or float32
    for bfloat16 (exact; numpy has no bfloat16)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a tensor (any device)."""
    return t.detach().to("cpu", host_dtype(t.dtype)).numpy()


def from_numpy(arr) -> torch.Tensor:
    """A CPU tensor of a numpy array's values and dtype. An ml_dtypes
    bfloat16 array (the JAX package's bf16) becomes a bfloat16 tensor
    by way of its float32 values, which hold it exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    if not arr.flags.writeable:   # torch shares the buffer: own a copy
        arr = arr.copy()
    return torch.as_tensor(arr)


def _encode(obj):
    if isinstance(obj, torch.Tensor):
        return to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(v) for v in obj)
    return obj


def _decode(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        return obj.array if return_numpy else from_numpy(obj.array)
    if isinstance(obj, dict):
        return {k: _decode(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(v, return_numpy) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"__paddle_tpu_format__": STATE_FORMAT_VERSION,
                     "payload": _encode(obj)}, f, protocol=protocol)


def load(path: str, return_numpy: bool = False, **kwargs) -> Any:
    """The saved object: numpy leaves as they were written; tensors the
    JAX package wrapped come back as CPU torch tensors (numpy arrays
    with return_numpy=True)."""
    with open(path, "rb") as f:
        data = _Unpickler(f).load()
    if isinstance(data, dict) and "__paddle_tpu_format__" in data:
        v = int(data["__paddle_tpu_format__"])
        if v > STATE_FORMAT_VERSION:
            raise ValueError(
                f"state file {path} has format version {v}; this package "
                f"reads up to {STATE_FORMAT_VERSION}")
        data = data["payload"]
    return _decode(data, return_numpy=return_numpy)

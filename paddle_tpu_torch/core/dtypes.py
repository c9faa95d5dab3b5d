"""Dtype names <-> torch dtypes.

Counterpart of paddle_tpu/core/dtypes.py: the same names and aliases,
mapped onto torch dtypes instead of jnp ones.
"""
from __future__ import annotations

import numpy as np
import torch

_ALIASES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "float": torch.float32, "fp32": torch.float32,
    "float64": torch.float64, "double": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}

FLOATING = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
INTEGER = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


def convert_dtype(dtype):
    """Normalize a user-provided dtype (str / numpy / torch) to a
    torch.dtype."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _ALIASES:
            raise ValueError(f"Unknown dtype '{dtype}'")
        return _ALIASES[dtype]
    name = np.dtype(dtype).name
    if name not in _ALIASES:
        raise ValueError(f"Unknown dtype '{dtype}'")
    return _ALIASES[name]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype) in FLOATING


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in INTEGER


_default_dtype = torch.float32


def set_default_dtype(dtype):
    global _default_dtype
    d = convert_dtype(dtype)
    if not is_floating(d):
        raise TypeError(f"default dtype must be floating, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype

"""InputSpec (counterpart of paddle_tpu/jit/api.py's InputSpec, the
reference's static/input.py): a shape and dtype signature. A None dim
is variable; hapi.Model reads its inputs=/labels= lists to split a
loader's batch into inputs and labels."""
from __future__ import annotations

from ..core import dtypes as _dtypes

__all__ = ["InputSpec"]


class InputSpec:
    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = _dtypes.convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype, name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"

"""TensorArray and the array ops (counterpart of
paddle_tpu/ops/tensor_array.py): a functional Python-list TensorArray
whose write returns a new array, as the JAX package's eager one does;
tensor_array_to_tensor stacks or concatenates its items."""
from __future__ import annotations

import torch

__all__ = ["TensorArray", "write_to_array", "read_from_array",
           "array_write", "array_read",
           "array_length", "tensor_array_to_tensor", "create_array"]


def _index(i):
    return int(i.item()) if isinstance(i, torch.Tensor) else int(i)


class TensorArray:
    """Functional tensor array: write returns a new TensorArray sharing
    the unwritten slots."""

    def __init__(self, items=None):
        self._items = list(items or [])

    def write(self, i, x):
        i = _index(i)
        items = list(self._items)
        if i < len(items):
            items[i] = x
        else:
            items.extend([None] * (i - len(items)))
            items.append(x)
        return TensorArray(items)

    def append(self, x):
        return self.write(len(self._items), x)

    def read(self, i):
        return self._items[_index(i)]

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def stack(self, axis=0):
        return torch.stack(list(self._items), dim=axis)

    def concat(self, axis=0):
        return torch.cat(list(self._items), dim=axis)


def create_array(dtype="float32", initialized_list=None):
    """paddle.tensor.create_array."""
    return TensorArray(initialized_list)


def write_to_array(array, i, x):
    """array[i] = x, as a new array (a fresh one when array is None)."""
    if array is None:
        array = TensorArray()
    return array.write(i, x)


def read_from_array(array, i):
    return array.read(i)


def array_length(array):
    return len(array)


# paddle.tensor's names for the same ops; array_write's signature is
# (x, i, array=None)
def array_write(x, i, array=None):
    return write_to_array(array, i, x)


array_read = read_from_array


def tensor_array_to_tensor(array, axis=0, use_stack=False, name=None):
    """(tensor, out_index): the items stacked (use_stack) or concatenated
    along axis, and int32 [n] of each item's extent along axis (1 each
    when stacked)."""
    items = list(array)
    if use_stack:
        out = torch.stack(items, dim=axis)
        index = [1] * len(items)
    else:
        out = torch.cat(items, dim=axis)
        index = [int(x.shape[axis]) for x in items]
    return out, torch.tensor(index, dtype=torch.int32, device=out.device)

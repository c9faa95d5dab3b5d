"""SelectedRows: the row-sparse gradient form and row-wise updates
(counterpart of paddle_tpu/core/selected_rows.py; reference
framework/selected_rows.h and operators/math/selected_rows_functor.*).

`value[i]` is the data of logical row `rows[i]` of a dense [height, ...]
tensor; rows may repeat until merged. The updates write only the rows
they touch and return new tensors, as the JAX package's functional ones
do.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["SelectedRows", "embedding_grad_rows", "merge_selected_rows",
           "sparse_row_update"]


class SelectedRows:
    """Row-sparse slab: `value[i]` is the data for logical row `rows[i]`
    of a dense [height, ...] tensor. Rows may repeat (unmerged grads).
    rows are int32, as the JAX package keeps them."""

    def __init__(self, rows, value, height: int):
        value = torch.as_tensor(value)
        self.rows = torch.as_tensor(rows, device=value.device).to(
            torch.int32)
        self.value = value
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.value.shape[1:])

    def to_dense(self):
        dense = self.value.new_zeros(self.shape)
        return dense.index_add(0, self.rows.long(), self.value)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]}, "
                f"row_shape={tuple(self.value.shape[1:])})")


def merge_selected_rows(sr: SelectedRows) -> SelectedRows:
    """Sum duplicate rows (ref scatter::MergeAdd), keeping the capacity:
    the unique rows first, in ascending order, then padding rows that
    point at row 0 with zero values."""
    n = sr.rows.shape[0]
    uniq, inv = torch.unique(sr.rows.long(), sorted=True,
                             return_inverse=True)
    k = uniq.shape[0]
    merged = sr.value.new_zeros(sr.value.shape).index_add(0, inv, sr.value)
    rows = torch.zeros(n, dtype=torch.int64, device=sr.rows.device)
    rows[:k] = uniq
    return SelectedRows(rows, merged, sr.height)


def embedding_grad_rows(ids, grad_out, height: int) -> SelectedRows:
    """The row-sparse gradient of an embedding lookup: ids [...],
    grad_out [..., dim] -> merged SelectedRows over the table's rows
    (ref lookup_table_v2_grad with is_sparse=True)."""
    flat_ids = ids.reshape(-1)
    flat_g = grad_out.reshape(flat_ids.shape[0], -1)
    return merge_selected_rows(SelectedRows(flat_ids, flat_g, height))


def sparse_row_update(param, sr: SelectedRows, lr,
                      velocity: Optional[torch.Tensor] = None,
                      momentum: float = 0.0):
    """SGD, or momentum with `velocity`, touching only sr's rows (ref
    selected_rows_functor sgd). Returns (new_param, new_velocity)."""
    rows = sr.rows.long()
    val = sr.value.reshape((rows.shape[0],) + tuple(param.shape[1:]))
    if velocity is None:
        return param.index_add(0, rows, -lr * val), None
    v_rows = momentum * velocity[rows] + val
    new_vel = velocity.index_put((rows,), v_rows)
    return param.index_add(0, rows, -lr * v_rows), new_vel

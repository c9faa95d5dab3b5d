"""Fleet global metrics (counterpart of
paddle_tpu/distributed/fleet/metrics/metric.py; reference
python/paddle/distributed/fleet/metrics/metric.py): sum, max, min, auc,
mae, rmse and acc over every trainer.

Each helper reduces per-rank statistics over the collective group
(distributed/collective.py; the identity at world size 1) and returns a
Python float or a float64 numpy array. A host statistic rides the
collective in 64 bits (int64 for integer sums, float64 otherwise), on
the card under NCCL, so counts stay exact; the JAX package, without x64
on its devices, uses int32 and float32 there. A tensor statistic is
reduced in its own dtype and stays a tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import collective as _c

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "acc"]


def _reduce(value, op, group=None):
    if isinstance(value, torch.Tensor):
        return _c.all_reduce(value.detach().clone(), op=op, group=group)
    arr64 = np.asarray(value, np.float64)
    _, pg = _c._resolve(group)
    if pg is None:
        return arr64
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if _c._dist().get_backend(pg) == "nccl" else torch.device("cpu")
    # torch.tensor copies: the collective reduces in place, and the
    # caller's array must stay as it was
    if op == _c.ReduceOp.SUM and \
            np.issubdtype(np.asarray(value).dtype, np.integer):
        t = torch.tensor(np.asarray(value, np.int64), device=dev)
    else:
        t = torch.tensor(arr64, device=dev)
    out = _c.all_reduce(t, op=op, group=group)
    return out.cpu().numpy().astype(np.float64)


def sum(input, group=None):  # noqa: A001 (the reference's name)
    """Global sum of a per-rank statistic."""
    return _reduce(input, _c.ReduceOp.SUM, group)


def max(input, group=None):  # noqa: A001
    return _reduce(input, _c.ReduceOp.MAX, group)


def min(input, group=None):  # noqa: A001
    return _reduce(input, _c.ReduceOp.MIN, group)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def acc(correct, total, group=None):
    """Global accuracy: sum(correct) / sum(total)."""
    c = float(_host(sum(correct, group)).sum())
    t = float(_host(sum(total, group)).sum())
    return c / t if t else 0.0


def mae(abserr, total_ins_num, group=None):
    """Global mean absolute error from per-rank (sum |err|, count)."""
    e = float(_host(sum(abserr, group)).sum())
    n = float(_host(sum(total_ins_num, group)).sum())
    return e / n if n else 0.0


def rmse(sqrerr, total_ins_num, group=None):
    """Global root-mean-square error from per-rank (sum err^2, count)."""
    e = float(_host(sum(sqrerr, group)).sum())
    n = float(_host(sum(total_ins_num, group)).sum())
    return float(np.sqrt(e / n)) if n else 0.0


def auc(stat_pos, stat_neg, group=None):
    """Global AUC from per-rank positive and negative score histograms:
    all-reduce the [num_buckets] counts, then the trapezoidal sweep from
    the highest score bucket down."""
    pos = _host(sum(stat_pos, group)).ravel()
    neg = _host(sum(stat_neg, group)).ravel()
    tot_pos = tot_neg = 0.0
    area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = tot_pos + pos[i]
        new_neg = tot_neg + neg[i]
        area += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
        tot_pos, tot_neg = new_pos, new_neg
    if tot_pos == 0.0 or tot_neg == 0.0:
        return 0.5
    return float(area / (tot_pos * tot_neg))

"""Metrics (counterpart of paddle_tpu/metric, the reference's
python/paddle/metric/metrics.py). The class metrics accumulate on the
host in numpy, as the JAX package's do; `accuracy` is the functional
form, in torch ops on the input's device (the port has no op
registry)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, pred, label):
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label):
        p = _np(pred)
        l = _np(label)
        if l.ndim == p.ndim and l.shape[-1] == 1:
            l = l[..., 0]
        topk_idx = np.argsort(-p, axis=-1)[..., :self.maxk]
        correct = topk_idx == l[..., None]
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct):
        c = _np(correct)
        for i, k in enumerate(self.topk):
            self.total[i] += c[..., :k].sum()
            self.count[i] += c.shape[0] if c.ndim > 1 else 1
        return (self.total / np.maximum(self.count, 1))[0]

    def accumulate(self):
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else list(res)

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).ravel()
        l = _np(labels).astype(np.int64).ravel()
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).ravel()
        l = _np(labels).astype(np.int64).ravel()
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        l = _np(labels).ravel()
        bins = (p.ravel() * self.num_thresholds).astype(np.int64)
        bins = np.clip(bins, 0, self.num_thresholds)
        for b, lab in zip(bins, l):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds, descending
        pos = np.cumsum(self._stat_pos[::-1])
        neg = np.cumsum(self._stat_neg[::-1])
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        return float(np.trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional accuracy (fluid layers.accuracy): the share of rows
    whose label is among the k highest scores (ties to the lower index,
    as a stable argsort orders them), a 0-d float32 tensor."""
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    top = torch.sort(-input, dim=-1, stable=True).indices[..., :k]
    hit = (top == label[..., None].to(top.dtype)).any(dim=-1)
    # the sum times the float32 reciprocal of n, as XLA computes
    # jnp.mean (a division by a constant becomes that product)
    inv_n = float(np.float32(1.0 / hit.numel()))
    return hit.to(torch.float32).sum() * inv_n


# the reference's metric/__init__.py does `from . import metrics`; this
# module is the implementation, so the submodule name aliases back to it
import sys as _sys
metrics = _sys.modules[__name__]
_sys.modules[__name__ + ".metrics"] = metrics

"""Adam and AdamW (counterpart of paddle_tpu/optimizer/optimizers.py).

The JAX package's rule, over lists with torch._foreach_* ops:
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    b1p *= b1;  b2p *= b2
    p -= lr * (m / (1 - b1p)) / (sqrt(v / (1 - b2p)) + eps)
with the bias-correction powers kept as per-param state (beta1_pow,
beta2_pow), as in the JAX package, so nothing is read back to the host.
AdamW is Adam with decoupled weight decay (optimizer.py). The other
optimizers of the JAX package wait for a later slice.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def init_state(self, param):
        return {
            "moment1": torch.zeros_like(param),
            "moment2": torch.zeros_like(param),
            "beta1_pow": torch.ones((), dtype=param.dtype,
                                    device=param.device),
            "beta2_pow": torch.ones((), dtype=param.dtype,
                                    device=param.device),
        }

    def update_rule(self, params, grads, states, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = torch._foreach_mul(states["moment1"], b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
        v = torch._foreach_mul(states["moment2"], b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        b1p = torch._foreach_mul(states["beta1_pow"], b1)
        b2p = torch._foreach_mul(states["beta2_pow"], b2)
        bc1 = torch._foreach_add(torch._foreach_neg(b1p), 1.0)  # 1 - b1p
        bc2 = torch._foreach_add(torch._foreach_neg(b2p), 1.0)
        m_hat = torch._foreach_div(m, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(den, eps)
        step = torch._foreach_div(torch._foreach_mul(m_hat, lr), den)
        new_p = torch._foreach_sub(params, step)
        return new_p, {"moment1": m, "moment2": v, "beta1_pow": b1p,
                       "beta2_pow": b2p}


class AdamW(Adam):
    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
        self._apply_decay_param_fun = apply_decay_param_fun

"""The ten optimizers of paddle_tpu/optimizer/optimizers.py: SGD,
Momentum, Adam, AdamW, Adagrad, Adadelta, Adamax, RMSProp, Lamb, Lars.

Each is the JAX package's rule, with its state names and its
arithmetic, over lists with torch._foreach_* ops (lr a 0-d f32 tensor,
optimizer.py). Adam, e.g.:
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    b1p *= b1;  b2p *= b2
    p -= lr * (m / (1 - b1p)) / (sqrt(v / (1 - b2p)) + eps)
with the bias-correction powers kept as per-param state (beta1_pow,
beta2_pow), as in the JAX package, so nothing is read back to the host.
AdamW is Adam with decoupled weight decay (optimizer.py). Lamb's trust
ratio and Lars's local lr take per-tensor f32 norms (_WholeNorms:
torch._foreach_norm, a shard's summed over its ranks) and decide their
where(w > 0 & r > 0) branches on the device.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "Adadelta",
           "Adamax", "RMSProp", "Lamb", "Lars"]


def _sq(xs):
    return torch._foreach_mul(xs, xs)


def _ema(olds, news, rho):
    """rho * old + (1 - rho) * new, over lists."""
    out = torch._foreach_mul(olds, rho)
    torch._foreach_add_(out, torch._foreach_mul(news, 1 - rho))
    return out


class _WholeNorms:
    """The norms of a rule that reads whole-tensor norms (Lamb, Lars).

    Under TrainStep's ZeRO / fsdp an optimizer param is this rank's
    block of the parameter; the step registers each block (and its
    master weight) with the groups of the ranks that hold the others
    (shard_norms_over), and the block's squared norm is summed over them
    before the square root, so the rule sees the whole tensor's norm, as
    the JAX step's update on whole arrays does. All on the device."""

    def shard_norms_over(self, tensors, groups):
        reg = self.__dict__.setdefault("_norm_groups", {})
        for t in tensors:
            reg[id(t)] = tuple(groups)

    def _norms(self, params, xs=None):
        """Per-tensor f32 L2 norms of `xs` (default `params`) as one [n]
        tensor; entry i is summed over params[i]'s groups."""
        from ..distributed import collective as _c
        xs = params if xs is None else xs
        norms = torch.stack(torch._foreach_norm([x.float() for x in xs]))
        reg = self.__dict__.get("_norm_groups", {})
        by_groups: Dict[tuple, List[int]] = {}
        for i, p in enumerate(params):
            if reg.get(id(p)):
                by_groups.setdefault(reg[id(p)], []).append(i)
        if not by_groups:
            return norms
        out = list(norms.unbind(0))
        for g, idx in by_groups.items():
            sq = torch.stack([out[i] * out[i] for i in idx])
            for pg in g:
                _c._all_reduce_(sq, _c.ReduceOp.SUM, pg)
            for i, v in zip(idx, sq.sqrt().unbind(0)):
                out[i] = v
        return torch.stack(out)


def _trust(w, r):
    """where(w > 0 & r > 0, w / r, 1) per tensor, decided on the device;
    a list of 0-d f32 tensors."""
    t = torch.where((w > 0) & (r > 0), w / r, torch.ones_like(w))
    return list(t.unbind(0))


class SGD(Optimizer):
    def update_rule(self, params, grads, states, lr):
        return torch._foreach_sub(params, torch._foreach_mul(grads, lr)), {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, param):
        return {"velocity": torch.zeros_like(param)}

    def update_rule(self, params, grads, states, lr):
        v = torch._foreach_mul(states["velocity"], self._momentum)
        torch._foreach_add_(v, grads)
        if self._nesterov:
            d = torch._foreach_add(grads, torch._foreach_mul(
                v, self._momentum))
        else:
            d = v
        new_p = torch._foreach_sub(params, torch._foreach_mul(d, lr))
        return new_p, {"velocity": v}


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


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, param):
        return {"moment": torch.full_like(param, self._init_acc)}

    def update_rule(self, params, grads, states, lr):
        acc = torch._foreach_add(states["moment"], _sq(grads))
        den = torch._foreach_sqrt(acc)
        torch._foreach_add_(den, self._epsilon)
        step = torch._foreach_div(torch._foreach_mul(grads, lr), den)
        return torch._foreach_sub(params, step), {"moment": acc}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._epsilon = epsilon
        self._rho = rho

    def init_state(self, param):
        return {"avg_squared_grad": torch.zeros_like(param),
                "avg_squared_update": torch.zeros_like(param)}

    def update_rule(self, params, grads, states, lr):
        rho, eps = self._rho, self._epsilon
        sg = _ema(states["avg_squared_grad"], _sq(grads), rho)
        num = torch._foreach_sqrt(torch._foreach_add(
            states["avg_squared_update"], eps))
        den = torch._foreach_sqrt(torch._foreach_add(sg, eps))
        update = torch._foreach_mul(torch._foreach_div(num, den), grads)
        su = _ema(states["avg_squared_update"], _sq(update), rho)
        new_p = torch._foreach_sub(params, torch._foreach_mul(update, lr))
        return new_p, {"avg_squared_grad": sg, "avg_squared_update": su}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_state(self, param):
        return {"moment": torch.zeros_like(param),
                "inf_norm": torch.zeros_like(param),
                "beta1_pow": torch.ones((), dtype=param.dtype,
                                        device=param.device)}

    def update_rule(self, params, grads, states, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = _ema(states["moment"], grads, b1)
        u = torch._foreach_maximum(torch._foreach_mul(states["inf_norm"], b2),
                                   torch._foreach_abs(grads))
        b1p = torch._foreach_mul(states["beta1_pow"], b1)
        # lr / (1 - b1p), one per tensor
        lr_t = torch._foreach_div(
            [lr] * len(params), torch._foreach_add(torch._foreach_neg(b1p),
                                                   1.0))
        den = torch._foreach_add(u, eps)
        step = torch._foreach_div(torch._foreach_mul(m, lr_t), den)
        return torch._foreach_sub(params, step), {
            "moment": m, "inf_norm": u, "beta1_pow": b1p}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_state(self, param):
        s = {"mean_square": torch.zeros_like(param),
             "momentum": torch.zeros_like(param)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(param)
        return s

    def update_rule(self, params, grads, states, lr):
        rho, eps = self._rho, self._epsilon
        ms = _ema(states["mean_square"], _sq(grads), rho)
        new_states = {"mean_square": ms}
        if self._centered:
            mg = _ema(states["mean_grad"], grads, rho)
            den = torch._foreach_sub(ms, _sq(mg))
            new_states["mean_grad"] = mg
        else:
            den = ms
        den = torch._foreach_sqrt(torch._foreach_add(den, eps))
        mom = torch._foreach_mul(states["momentum"], self._momentum)
        torch._foreach_add_(mom, torch._foreach_div(
            torch._foreach_mul(grads, lr), den))
        new_states["momentum"] = mom
        return torch._foreach_sub(params, mom), new_states


class Lamb(_WholeNorms, Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         name=name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_state(self, param):
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param),
                "beta1_pow": torch.ones((), dtype=param.dtype,
                                        device=param.device),
                "beta2_pow": torch.ones((), dtype=param.dtype,
                                        device=param.device)}

    def update_rule(self, params, grads, states, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = _ema(states["moment1"], grads, b1)
        v = _ema(states["moment2"], _sq(grads), b2)
        b1p = torch._foreach_mul(states["beta1_pow"], b1)
        b2p = torch._foreach_mul(states["beta2_pow"], b2)
        m_hat = torch._foreach_div(m, torch._foreach_add(
            torch._foreach_neg(b1p), 1.0))
        v_hat = torch._foreach_div(v, torch._foreach_add(
            torch._foreach_neg(b2p), 1.0))
        den = torch._foreach_sqrt(v_hat)
        torch._foreach_add_(den, eps)
        r = torch._foreach_div(m_hat, den)
        torch._foreach_add_(r, torch._foreach_mul(params, self._lamb_wd))
        trust = _trust(self._norms(params), self._norms(params, r))
        new_p = torch._foreach_sub(params, torch._foreach_mul(
            r, [lr * t for t in trust]))
        return new_p, {"moment1": m, "moment2": v, "beta1_pow": b1p,
                       "beta2_pow": b2p}


class Lars(_WholeNorms, Optimizer):
    """LARS (reference lars_momentum_op)."""

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         name=name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon

    def init_state(self, param):
        return {"velocity": torch.zeros_like(param)}

    def update_rule(self, params, grads, states, lr):
        w, g = self._norms(params), self._norms(params, grads)
        local = torch.where(
            (w > 0) & (g > 0),
            self._lars_coeff * w / (g + self._lars_wd * w + self._epsilon),
            torch.ones_like(w))
        d = torch._foreach_add(grads, torch._foreach_mul(params,
                                                         self._lars_wd))
        v = torch._foreach_mul(states["velocity"], self._momentum)
        torch._foreach_add_(v, torch._foreach_mul(
            d, [lr * t for t in local.unbind(0)]))
        return torch._foreach_sub(params, v), {"velocity": v}

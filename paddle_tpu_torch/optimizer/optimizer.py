"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

Each optimizer is an update rule over LISTS of tensors —
``init_state(param) -> {name: tensor}`` and
``update_rule(params, grads, states, lr) -> (new_params, new_states)``,
where ``states`` maps a state name to the list of that state over the
params — written with torch._foreach_* ops, so one rule updates every
parameter in a few launches. The JAX package writes the same rule per
array and leaves the fusion to XLA. The state names (moment1, moment2,
beta1_pow, beta2_pow, master_weight) are the JAX package's.

Around the rule, as in the JAX package: coupled (L2/L1) or decoupled
weight decay, the latter applied with the OLD parameter (p_new -= lr *
wd * p); multi-precision master weights for bf16/fp16 params (the rule
runs on an f32 master and the param is its cast-down); and, for the
loss-scale skip, a device-side bool `skip` that keeps params and state
exactly as they were without reading the flag back to the host. The
eager step() applies grad_clip (nn/clip.py) first; apply_gradients, the
compiled-step form, does not clip, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)


class Optimizer:
    # decoupled weight decay? (AdamW) — L2-style adds wd*p to the grad
    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        self._lr = learning_rate
        self._parameters = list(parameters) if parameters is not None \
            else None
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._wd_mode = "l2"
        if isinstance(weight_decay, (float, int)):
            self._weight_decay = float(weight_decay)
        elif weight_decay is None:
            self._weight_decay = 0.0
        else:  # regularizer.L1Decay/L2Decay-like object with a coeff
            self._weight_decay = float(
                getattr(weight_decay, "_coeff",
                        getattr(weight_decay, "coeff", 0.0)))
            self._wd_mode = getattr(weight_decay, "mode", "l2")
        # id(param) -> {name: tensor}
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- the rule (override) -------------------------------------------------
    def init_state(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def update_rule(self, params, grads, states, lr):
        raise NotImplementedError

    # -- state -------------------------------------------------------------
    def _uses_master(self, param) -> bool:
        return bool(self._multi_precision) and param.dtype in _LOW_PRECISION

    def init_param_state(self, param, master=None):
        """State of one param; a low-precision param under
        multi_precision gets an f32 master (from `master` when given:
        TrainStep's O2 passes the original f32 weights)."""
        with torch.no_grad():
            if self._uses_master(param):
                m = (master if master is not None else param).detach() \
                    .to(torch.float32).clone()
                st = self.init_state(m)
                st["master_weight"] = m
                return st
            return self.init_state(param.detach())

    def _state_of(self, p):
        st = self._accumulators.get(id(p))
        if st is None:
            st = self.init_param_state(p)
            self._accumulators[id(p)] = st
        return st

    # -- LR ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        self._lr = value

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    # -- update ------------------------------------------------------------
    def _apply_group(self, ps, gs, states, lr):
        """One rule application on same-dtype tensors: weight decay,
        the rule, decoupled decay with the old params. Returns the new
        params and states, leaving the inputs untouched."""
        wd = self._weight_decay
        if wd and not self._decoupled_wd:
            reg = torch._foreach_sign(ps) if self._wd_mode == "l1" else ps
            gs = torch._foreach_add(gs, reg, alpha=wd)
        new_ps, new_states = self.update_rule(ps, gs, states, lr)
        if self._decoupled_wd and wd:
            new_ps = torch._foreach_sub(new_ps, torch._foreach_mul(ps,
                                                                   lr * wd))
        return new_ps, new_states

    @staticmethod
    def _write(olds, news, skip):
        if skip is None:
            torch._foreach_copy_(olds, news)
        else:
            for o, n in zip(olds, news):
                o.copy_(torch.where(skip, o, n))

    @torch.no_grad()
    def apply_gradients(self, params, grads, lr=None, skip=None):
        """Update `params` in place from `grads` (one list each). skip: a
        bool device tensor; where True, params and state stay as they
        were (the loss-scale skip), decided on the device."""
        lr = self.get_lr() if lr is None else float(lr)
        self._step_count += 1
        groups: Dict[Any, List[int]] = {}
        for i, p in enumerate(params):
            st = self._state_of(p)
            groups.setdefault((p.dtype, "master_weight" in st), []) \
                .append(i)
        for (_, master), idx in groups.items():
            ps = [params[i] for i in idx]
            sts = [self._state_of(p) for p in ps]
            names = [k for k in sts[0] if k != "master_weight"]
            states = {k: [s[k] for s in sts] for k in names}
            if master:
                targets = [s["master_weight"] for s in sts]
                gs = [grads[i].to(torch.float32) for i in idx]
            else:
                targets = ps
                gs = [grads[i].to(p.dtype) for i, p in zip(idx, ps)]
            new_t, new_states = self._apply_group(targets, gs, states, lr)
            self._write(targets, new_t, skip)
            for k in names:
                self._write(states[k], new_states[k], skip)
            if master:
                self._write(ps, [t.to(p.dtype) for t, p in zip(targets, ps)],
                            None)

    def step(self):
        """Eager step over the params that have a gradient, clipped
        first by the optimizer's grad_clip (nn/clip.py), as the JAX
        package's eager step clips them."""
        pg = self._clipped([(p, p.grad) for p in self._param_list()
                            if p.grad is not None])
        if pg:
            self.apply_gradients([p for p, _ in pg], [g for _, g in pg])

    def _clipped(self, params_grads):
        """(param, grad) pairs through grad_clip when one is set, pairs
        without a gradient dropped: what an eager step applies."""
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        return [(p, g) for p, g in params_grads if g is not None]

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._param_list()]

    def _param_list(self):
        if self._parameters is None:
            raise ValueError(
                "optimizer constructed without parameters; pass parameters= "
                "or use apply_gradients")
        return self._parameters

    def clear_grad(self, set_to_zero=False):
        for p in self._param_list():
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict --------------------------------------------------------
    def state_dict(self):
        out: Dict[str, Any] = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameters or []):
            st = self._accumulators.get(id(p))
            if st:
                out[f"param_{i}"] = dict(st)
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        """Restore state_dict() output; tensors are copied onto each
        param's device."""
        self._step_count = state.get("_step_count", 0)
        for i, p in enumerate(self._parameters or []):
            key = f"param_{i}"
            if key in state:
                self._accumulators[id(p)] = {
                    k: torch.as_tensor(v).detach().clone().to(p.device)
                    for k, v in state[key].items()}
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])

    set_dict = set_state_dict

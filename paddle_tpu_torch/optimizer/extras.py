"""Weight-averaging training utilities: EMA, ModelAverage, Lookahead
(counterpart of paddle_tpu/optimizer/extras.py, the same names and
rules).

Reference: python/paddle/fluid/optimizer.py — ExponentialMovingAverage
(:3466, shadow vars updated as s = decay*s + (1-decay)*p with optional
thres_steps-ramped decay), ModelAverage (:3157, sliding-window parameter
sums with apply/restore scopes) and LookaheadOptimizer (:5238, slow/fast
weights: every k steps slow += alpha*(fast-slow), fast = slow).

All three are tensor transforms over the live parameters: the shadow
state is a dict of tensors on the parameters' device, and apply(),
restore() and Lookahead's sync write the parameters IN PLACE (copy_),
so a captured TrainStep that holds their addresses goes on reading the
values they hold. Usable from eager loops, after captured steps, and
from hapi callbacks.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["ExponentialMovingAverage", "ModelAverage",
           "LookaheadOptimizer"]


def _trainable(params):
    return [p for p in params if p.requires_grad]


def _swap_scope(obj, params, new_value_of, need_restore):
    """Back up the live params, write the new values into them, and
    return a context manager that restores on exit. A nested apply()
    without restore() would clobber the backup with already-swapped
    weights: refused."""
    if obj._backup is not None:
        raise RuntimeError(
            f"{type(obj).__name__}.apply() is already active; call "
            "restore() (or leave the `with` scope) before applying again")
    with torch.no_grad():
        obj._backup = {id(p): p.detach().clone() for p in params}
        for p in params:
            p.copy_(new_value_of(p).to(p.dtype))
    if not need_restore:
        # the swap is permanent: no backup, so later apply() calls are
        # not refused and a stray restore() cannot roll back to it
        obj._backup = None

    @contextlib.contextmanager
    def scope():
        try:
            yield
        finally:
            if need_restore:
                obj.restore()
    return scope()


def _restore(obj, params):
    if obj._backup is None:
        return
    with torch.no_grad():
        for p in params:
            p.copy_(obj._backup[id(p)])
    obj._backup = None


class ExponentialMovingAverage:
    """EMA of parameters (fluid/optimizer.py:3466 parity).

    update() after each optimizer step; apply() writes the EMA weights
    into the params (a context manager with ``with``), restore() writes
    the live ones back. With thres_steps: decay_t = min(decay,
    (1+t)/(10+t)), the reference's ramped schedule."""

    def __init__(self, parameters, decay: float = 0.999,
                 thres_steps: bool = False, name: Optional[str] = None):
        self._params = _trainable(parameters)
        self.decay = float(decay)
        self.thres_steps = bool(thres_steps)
        self._step = 0
        self._shadow: Dict[int, torch.Tensor] = {
            id(p): p.detach().clone() for p in self._params}
        self._backup: Optional[Dict[int, torch.Tensor]] = None

    def _decay_t(self) -> float:
        if not self.thres_steps:
            return self.decay
        t = self._step
        return min(self.decay, (1.0 + t) / (10.0 + t))

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay_t()
        for p in self._params:
            s = self._shadow[id(p)]
            self._shadow[id(p)] = d * s + (1.0 - d) * p.detach()

    def apply(self, need_restore: bool = True):
        """Write the EMA weights into the live params. Returns a context
        manager for ``with ema.apply(): ...``; without ``with``, call
        restore() by hand."""
        return _swap_scope(self, self._params,
                           lambda p: self._shadow[id(p)], need_restore)

    def restore(self):
        _restore(self, self._params)

    def state_dict(self):
        return {"step": self._step,
                "shadow": {i: s.detach().cpu().numpy() for i, (k, s) in
                           enumerate(self._shadow.items())}}

    def set_state_dict(self, state):
        self._step = int(state["step"])
        for i, p in enumerate(self._params):
            self._shadow[id(p)] = torch.as_tensor(
                np.asarray(state["shadow"][i])).to(p.device)


class ModelAverage:
    """Sliding-window parameter averaging (fluid/optimizer.py:3157
    parity): accumulates parameter sums each step; apply() writes the
    window average into the params for evaluation, restore() writes the
    live ones back. The window holds at most max_average_window steps and
    at least min_average_window (window <= average_window_rate *
    num_updates between them); past it the window restarts from the
    running mean."""

    def __init__(self, average_window_rate: float = 0.15, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name=None):
        self._params = _trainable(parameters or [])
        self.rate = float(average_window_rate)
        self.min_window = int(min_average_window)
        self.max_window = int(max_average_window)
        self._num_updates = 0
        self._window = 0
        self._sum: Dict[int, torch.Tensor] = {
            id(p): torch.zeros_like(p.detach()) for p in self._params}
        self._backup: Optional[Dict[int, torch.Tensor]] = None

    @torch.no_grad()
    def step(self):
        """Accumulate the current parameters into the window (call after
        each optimizer step)."""
        self._num_updates += 1
        self._window += 1
        limit = max(self.min_window,
                    min(self.max_window,
                        int(self.rate * self._num_updates) or 1))
        for p in self._params:
            self._sum[id(p)] = self._sum[id(p)] + p.detach()
        if self._window > limit:
            for p in self._params:
                self._sum[id(p)] = self._sum[id(p)] / self._window
            self._window = 1

    def apply(self, executor=None, need_restore: bool = True):
        if self._window == 0:
            raise RuntimeError(
                "ModelAverage.apply() before any step(): the window is "
                "empty (the reference errors on zero accumulates too)")
        w = self._window
        return _swap_scope(self, self._params,
                           lambda p: self._sum[id(p)] / w, need_restore)

    def restore(self, executor=None):
        _restore(self, self._params)


class LookaheadOptimizer:
    """Lookahead wrapper (fluid/optimizer.py:5238 parity): the inner
    optimizer updates the fast weights every step; every k steps the
    slow weights move slow += alpha*(fast-slow) and the fast weights are
    set to them (in place)."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5):
        if inner_optimizer is None:
            raise ValueError("LookaheadOptimizer needs an inner optimizer")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_count = 0
        self._slow: Optional[Dict[int, torch.Tensor]] = None

    def _params(self):
        return _trainable(self.inner_optimizer._param_list())

    @torch.no_grad()
    def start(self):
        """Take the slow weights from the params (step() does it at its
        first call)."""
        self._slow = {id(p): p.detach().clone() for p in self._params()}

    def step(self):
        if self._slow is None:
            self.start()
        self.inner_optimizer.step()
        self.sync()

    @torch.no_grad()
    def sync(self):
        """Count one fast step; every k-th, move the slow weights and set
        the fast ones to them. step() calls it; after a step the inner
        optimizer took elsewhere (a captured TrainStep's), call it by
        hand, with start() called before the first such step."""
        self._step_count += 1
        if self._step_count % self.k == 0:
            a = self.alpha
            for p in self._params():
                slow = self._slow[id(p)]
                slow = slow + a * (p.detach() - slow)
                self._slow[id(p)] = slow
                p.copy_(slow.to(p.dtype))

    def clear_grad(self, *a, **k):
        return self.inner_optimizer.clear_grad(*a, **k)

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._params()]

"""Dynamic loss scaling (counterpart of paddle_tpu/amp/grad_scaler.py).

AmpScaler/GradScaler hold the scale and the good/bad step counts as
device tensors once they are first used, and step() unscales, checks
for non-finite gradients, skips the update and adapts the scale without
reading anything back to the host (amp/functional.py). TrainStep reads
the configuration (_scale, _incr_ratio, ...) and keeps the same state
in its strategy_state, as the JAX package's does.
"""
from __future__ import annotations

import torch

from .functional import (check_finite_and_unscale_tree,
                         update_loss_scaling_state)

__all__ = ["AmpScaler", "GradScaler"]


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._counts = (0, 0)  # (good, bad) to start the device state from
        self._state = None  # (scale, good, bad, found_inf) device tensors

    def _dev_state(self, device):
        if self._state is None or self._state[0].device != device:
            self._state = (
                torch.tensor(self._scale, dtype=torch.float32, device=device),
                torch.tensor(self._counts[0], dtype=torch.int32, device=device),
                torch.tensor(self._counts[1], dtype=torch.int32, device=device),
                torch.zeros((), dtype=torch.bool, device=device))
        return self._state

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._dev_state(var.device)[0]

    def _unscale_grads(self, optimizer):
        params = [p for p in optimizer._param_list() if p.grad is not None]
        if not params:
            return None
        scale, good, bad, _ = self._dev_state(params[0].device)
        found = check_finite_and_unscale_tree([p.grad for p in params],
                                              scale)
        self._state = (scale, good, bad, found)
        return params, found

    def step(self, optimizer):
        """torch/paddle-2.x style: scaler.step(opt) after backward."""
        if not self._enable:
            optimizer.step()
            return
        res = self._unscale_grads(optimizer)
        if res is None:
            return
        params, found = res
        # the unscaled gradients through the optimizer's grad_clip, as
        # the JAX scaler's optimizer.step() clips them
        pg = optimizer._clipped([(p, p.grad) for p in params])
        optimizer.apply_gradients([p for p, _ in pg], [g for _, g in pg],
                                  skip=found)
        self._update(found)

    @torch.no_grad()
    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        pass  # state already updated in step/minimize (paddle parity shim)

    def _update(self, found_inf):
        if not self._dynamic:
            return
        scale, good, bad, _ = self._state
        scale, good, bad = update_loss_scaling_state(
            scale, good, bad, found_inf, self._incr_ratio, self._decr_ratio,
            self._incr_every_n, self._decr_every_n)
        self._state = (scale, good, bad, found_inf)

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        """The current scale as a float (reads the device)."""
        return float(self._state[0]) if self._state else self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)
        self._state = None

    def state_dict(self):
        return {"scale": self.get_loss_scaling(),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": int(self._state[1]) if self._state else 0,
                "bad_steps": int(self._state[2]) if self._state else 0}

    def load_state_dict(self, state):
        self._scale = float(state["scale"])
        self._counts = (int(state.get("good_steps", 0)),
                        int(state.get("bad_steps", 0)))
        self._state = None


class GradScaler(AmpScaler):
    """paddle.amp.GradScaler (wraps AmpScaler, 2.x surface)."""

    def unscale_(self, optimizer):
        self._unscale_grads(optimizer)

"""TrainStep: one training step (counterpart of
paddle_tpu/static/train_step.py).

The JAX package compiles forward + loss + backward + optimizer update +
loss scaling into one XLA executable. The port runs the same step
eagerly on the card, with the semantics of the JAX `_build`'s `step`:

- AMP: the forward and the loss run under amp.auto_cast(amp_level,
  amp_dtype). O2 casts the floating params down and keeps f32 master
  weights in the optimizer, taken from the ORIGINAL f32 values.
- grad_accum_steps: the batch is cut along dim 0 into microbatches
  (_microslice); gradients and losses are averaged over them.
- scaler (amp.GradScaler/AmpScaler): the loss is scaled, the gradients
  unscaled and checked for non-finite values, and on overflow the
  params and optimizer state stay exactly as they were, while the scale
  adapts and strategy_state["amp_skipped"] counts the skip. All of it
  on the device: the step never reads a value back to the host.
- dropout: every random draw of one step comes from one seed of the
  global stream (core/generator.py seed_scope; one per microbatch).
- __call__ returns the loss as a device tensor (no .item()).
- donate is accepted for the JAX signature: the eager step updates the
  params and the optimizer state in place anyway.

Capturing the step (a CUDA graph or a compiled graph) with a "no
recompiles after warm-up" contract is the next TrainStep item (ROADMAP queue A 7).
mesh/sharding_plan, grad_transform, remat and sentry belong to later
slices and raise NotImplementedError, as does an optimizer with a
grad_clip (the JAX package's compiled step does not clip).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..amp.auto_cast import auto_cast
from ..amp.functional import (check_finite_and_unscale_tree,
                              update_loss_scaling_state)
from ..core.generator import mix_seed, next_seed, seed_scope
from ..optimizer.optimizer import Optimizer

__all__ = ["TrainStep"]


def _microslice(a, idx, accum):
    """Microbatch idx of `accum` along the batch dim (scalars pass)."""
    if not isinstance(a, torch.Tensor) or a.dim() == 0:
        return a
    micro = a.shape[0] // accum
    return a[idx * micro:(idx + 1) * micro]


def _later(flag, where):
    return NotImplementedError(
        f"TrainStep({flag}=...) is not ported yet: it comes with {where}")


class TrainStep:
    """One training step of `layer`.

    loss_fn(outputs, *labels) -> scalar tensor. Usage:
        step = TrainStep(model, loss_fn, optimizer, amp_level="O1")
        loss = step(inputs, labels)
    """

    def __init__(self, layer, loss_fn: Callable, optimizer: Optimizer,
                 amp_level: Optional[str] = None, amp_dtype="bfloat16",
                 mesh=None, sharding_plan=None, donate: bool = True,
                 grad_accum_steps: int = 1,
                 grad_transform: Optional[Callable] = None,
                 strategy_state: Optional[Dict[str, Any]] = None,
                 remat: bool = False, remat_policy=None, scaler=None,
                 sentry=None):
        for flag, val, where in (
                ("mesh", mesh, "the distributed slice"),
                ("sharding_plan", sharding_plan, "the distributed slice"),
                ("grad_transform", grad_transform, "the distributed slice"),
                ("remat", remat, "a later training-slice PR"),
                ("sentry", sentry, "the observability slice")):
            if val:
                raise _later(flag, where)
        if getattr(optimizer, "_grad_clip", None) is not None:
            # the JAX TrainStep updates through apply_gradients_tree,
            # which never calls the optimizer's _grad_clip: its compiled
            # step does not clip. Refuse rather than differ in silence.
            raise NotImplementedError(
                "TrainStep with an optimizer that carries a grad_clip: the "
                "JAX package's compiled step never applies it (its "
                "apply_gradients_tree skips _grad_clip; ROADMAP.md queue "
                "C), so the port refuses it rather than clip or not in "
                "silence. Clip in an eager loop with optimizer.step().")
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{grad_accum_steps}")
        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.grad_accum_steps = int(grad_accum_steps)
        self.strategy_state = strategy_state if strategy_state is not None \
            else {}
        self.params = [p for p in layer.parameters() if p.requires_grad]
        if optimizer._parameters is None:
            optimizer._parameters = list(self.params)
        if amp_level == "O2":
            self._cast_down(amp_dtype)
        self._scaler_cfg = None
        if scaler is not None and getattr(scaler, "_enable", True):
            self._scaler_cfg = {
                "init_scale": float(scaler._scale),
                "incr_ratio": float(scaler._incr_ratio),
                "decr_ratio": float(scaler._decr_ratio),
                "incr_every_n": int(scaler._incr_every_n),
                "decr_every_n": int(scaler._decr_every_n),
                "dynamic": bool(scaler._dynamic),
            }
            self._init_scaler_state()

    def _device(self):
        return self.params[0].device

    @torch.no_grad()
    def _cast_down(self, amp_dtype):
        """O2: floating params cast to the AMP dtype; the optimizer keeps
        f32 masters made from the ORIGINAL values (a round trip through
        bf16 would quantize every weight at init)."""
        from ..core import dtypes as _dtypes
        dt = _dtypes.convert_dtype(amp_dtype)
        self.optimizer._multi_precision = True
        for p in self.params:
            if not p.is_floating_point() or p.dtype == dt:
                continue
            orig = p.detach().clone()
            p.data = p.data.to(dt)
            self.optimizer._accumulators[id(p)] = \
                self.optimizer.init_param_state(p, master=orig)

    def _init_scaler_state(self):
        dev = self._device()
        cfg = self._scaler_cfg
        st = self.strategy_state
        st.setdefault("amp_scale", torch.tensor(cfg["init_scale"],
                                                dtype=torch.float32,
                                                device=dev))
        for k in ("amp_good", "amp_bad", "amp_skipped"):
            st.setdefault(k, torch.zeros((), dtype=torch.int32, device=dev))

    def _forward_loss(self, inputs, labels):
        if self.amp_level:
            with auto_cast(level=self.amp_level, dtype=self.amp_dtype):
                out = self.layer(*inputs)
                loss = self.loss_fn(out, *labels)
        else:
            out = self.layer(*inputs)
            loss = self.loss_fn(out, *labels)
        return loss.to(torch.float32)

    def __call__(self, inputs, labels=()):
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        labels = tuple(labels) if isinstance(labels, (list, tuple)) \
            else (labels,)
        accum = self.grad_accum_steps
        scale = self.strategy_state["amp_scale"] \
            if self._scaler_cfg is not None else None
        step_seed = next_seed(self._device())
        for p in self.params:
            p.grad = None
        loss_sum = None
        for idx in range(accum):
            ins = tuple(_microslice(a, idx, accum) for a in inputs)
            lbls = tuple(_microslice(a, idx, accum) for a in labels)
            seed = step_seed if accum == 1 else mix_seed(step_seed, idx)
            with seed_scope(seed):
                loss = self._forward_loss(ins, lbls)
            scaled = loss / accum if accum > 1 else loss
            if scale is not None:
                scaled = scaled * scale
            scaled.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        loss = loss_sum / accum if accum > 1 else loss_sum
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        found_inf = None
        if scale is not None:
            found_inf = check_finite_and_unscale_tree(grads, scale)
        self.optimizer.apply_gradients(self.params, grads, skip=found_inf)
        if found_inf is not None:
            self._update_scaler(found_inf)
        return loss

    def _update_scaler(self, found_inf):
        st, cfg = self.strategy_state, self._scaler_cfg
        if cfg["dynamic"]:
            st["amp_scale"], st["amp_good"], st["amp_bad"] = \
                update_loss_scaling_state(
                    st["amp_scale"], st["amp_good"], st["amp_bad"],
                    found_inf, incr_ratio=cfg["incr_ratio"],
                    decr_ratio=cfg["decr_ratio"],
                    incr_every_n=cfg["incr_every_n"],
                    decr_every_n=cfg["decr_every_n"])
        st["amp_skipped"] = st["amp_skipped"] + found_inf.to(torch.int32)

    # -- checkpoints --------------------------------------------------------
    def state_dict(self):
        return {"model": self.layer.state_dict(),
                "opt": self.optimizer.state_dict(),
                "strategy_state": dict(self.strategy_state)}

    @torch.no_grad()
    def set_state_dict(self, state):
        """Restore a state_dict() checkpoint; tensors are copied."""
        if state.get("model"):
            own = self.layer.state_dict()
            for k, v in state["model"].items():
                if k in own:
                    own[k].copy_(v)
        if state.get("opt") is not None:
            self.optimizer.set_state_dict(state["opt"])
        if state.get("strategy_state") is not None:
            self.strategy_state = {
                k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                for k, v in state["strategy_state"].items()}
            if self._scaler_cfg is not None:
                self._init_scaler_state()

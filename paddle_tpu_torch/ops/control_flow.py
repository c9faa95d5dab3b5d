"""Control-flow ops (counterpart of paddle_tpu/ops/control_flow.py):
cond, while_loop, bounded_while_loop, fori_loop, scan, case and
switch_case.

Eagerly they branch and loop in Python over torch, as the JAX package's
eager path does. Inside a CUDA-graph capture (a captured TrainStep or
program) the host cannot read a device predicate, so the ops take the
JAX traced path's contract instead:

- cond, case and switch_case run every branch and select the result
  with torch.where on the predicate or index, so every branch must
  return the same structure of tensors (cond needs false_fn, case needs
  default, as lax.cond has no "do nothing" branch);
- bounded_while_loop, fori_loop and scan have static bounds and run as a
  fixed loop (bounded_while_loop masks the iterations past its exit, in
  both modes, as the JAX op does);
- while_loop has no static bound and raises: a stated limit
  (ROADMAP.md queue C), never a silent host sync.

A predicate that is a Python value, or a CPU tensor, is read on the host
in every mode. `static_branches()` makes the select path run for CPU
tensors outside a capture too (the CPU tests use it).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["cond", "while_loop", "bounded_while_loop", "case",
           "switch_case", "scan", "fori_loop"]

_state = threading.local()


@contextlib.contextmanager
def static_branches():
    """Run cond, case and switch_case as inside a CUDA-graph capture:
    every branch, then a torch.where select."""
    prev = getattr(_state, "forced", False)
    _state.forced = True
    try:
        yield
    finally:
        _state.forced = prev


def _capturing():
    return getattr(_state, "forced", False) or (
        torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def _selecting(pred):
    """True where `pred` cannot be read on the host: a tensor under
    static_branches(), or a card tensor while a CUDA-graph capture is in
    progress. A Python value, or a CPU tensor in a capture, is read."""
    if not isinstance(pred, torch.Tensor):
        return False
    if getattr(_state, "forced", False):
        return True
    return pred.device.type == "cuda" and _capturing()


def _flag(pred):
    """A 0-d bool tensor of a tensor predicate."""
    return pred.reshape(()).to(torch.bool)


def _select(pred, a, b):
    """torch.where(pred, a, b) leaf by leaf over one structure."""
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            raise ValueError("the branches must return the same structure "
                             f"under a capture, got {type(a).__name__} of "
                             f"{len(a)} and {b!r}")
        return type(a)(_select(pred, x, y) for x, y in zip(a, b))
    if a is None or b is None:
        raise ValueError("the branches must return tensors under a "
                         "capture, got None")
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.where(pred.to(a.device), a, b.to(a.dtype))


def cond(pred, true_fn, false_fn=None, operands=(), name=None):
    """paddle.static.nn.cond: true_fn(*operands) where pred holds, else
    false_fn(*operands) (None without one). Under a capture both run and
    the result is selected, so false_fn is required."""
    operands = tuple(operands)
    if not _selecting(pred):
        if bool(pred):
            return true_fn(*operands)
        return false_fn(*operands) if false_fn is not None else None
    if false_fn is None:
        raise ValueError(
            "paddle.cond under a CUDA-graph capture requires both true_fn "
            "and false_fn (branches must return the same structure); got "
            "false_fn=None")
    return _select(_flag(pred), true_fn(*operands), false_fn(*operands))


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """paddle.static.nn.while_loop: body_fn while cond_fn holds; returns
    the loop variables as a list. It reads the predicate on the host at
    every iteration, so it refuses to run under a CUDA-graph capture (use
    bounded_while_loop there)."""
    if _capturing():
        raise RuntimeError(
            "while_loop cannot run under a CUDA-graph capture: its "
            "iteration count is data on the device, which the host cannot "
            "read inside the graph; use bounded_while_loop(..., max_iters) "
            "(ROADMAP.md queue C)")
    vals = _as_list(loop_vars)
    while bool(cond_fn(*vals)):
        vals = _as_list(body_fn(*vals))
    return vals


def bounded_while_loop(cond_fn, body_fn, loop_vars, max_iters: int,
                       name=None):
    """A while loop of exactly max_iters iterations in which the ones
    past the exit condition pass the carry through unchanged
    (differentiable, and capture-safe: no host read). The same as
    while_loop as long as the true iteration count never exceeds
    max_iters."""
    vals = _as_list(loop_vars)
    for _ in range(int(max_iters)):
        pred = torch.as_tensor(cond_fn(*vals)).reshape(()).to(torch.bool)
        out = _as_list(body_fn(*vals))
        vals = [torch.where(pred.to(v.device), o.to(v.dtype), v)
                for o, v in zip(out, vals)]
    return vals


def fori_loop(lower, upper, body_fn, init, name=None):
    """val = body_fn(i, val) for i in [lower, upper); i is a 0-d int64
    tensor on init's device."""
    lo, hi = int(lower), int(upper)
    val = init
    dev = init.device if isinstance(init, torch.Tensor) else None
    for i in range(lo, hi):
        val = body_fn(torch.full((), i, dtype=torch.int64, device=dev), val)
    return val


def scan(f, init, xs, name=None):
    """(carry, ys): carry, y = f(carry, x) over the leading axis of xs,
    the ys stacked."""
    carry, ys = init, []
    for x in xs.unbind(0):
        carry, y = f(carry, x)
        ys.append(y)
    return carry, torch.stack(ys)


def case(pred_fn_pairs, default=None, name=None):
    """paddle.static.nn.case: the first branch whose predicate holds,
    else default. Under a capture every branch runs and the result is
    selected, so default is required."""
    pairs = list(pred_fn_pairs)
    if not any(_selecting(p) for p, _ in pairs):
        for pred, fn in pairs:
            if bool(pred):
                return fn()
        if default is not None:
            return default()
        raise ValueError("no case matched and no default given")
    if default is None:
        raise ValueError("paddle.case under a CUDA-graph capture requires "
                         "default= (every branch runs; no case can be "
                         "refused on the device)")
    out = default()
    for pred, fn in reversed(pairs):
        if not isinstance(pred, torch.Tensor):
            # a host predicate: this branch is taken or skipped outright
            out = fn() if bool(pred) else out
            continue
        out = _select(_flag(pred), fn(), out)
    return out


def switch_case(branch_index, branch_fns, default=None, name=None):
    """paddle.static.nn.switch_case: the branch of branch_index (a list
    index or a dict key), else default (None without one). Under a
    capture every branch runs and the result is selected, with
    lax.switch's rule where no default is given: the index is clamped
    into the list (a dict key goes to the first key not below it)."""
    if not _selecting(branch_index):
        i = int(branch_index)
        if isinstance(branch_fns, dict):
            fn = branch_fns.get(i)
        else:
            fns = list(branch_fns)
            fn = fns[i] if 0 <= i < len(fns) else None
        if fn is not None:
            return fn()
        return default() if default else None
    idx = torch.as_tensor(branch_index).reshape(()).to(torch.int64)
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
        karr = torch.tensor(keys, dtype=torch.int64, device=idx.device)
        pos = torch.searchsorted(karr, idx.reshape(1)).reshape(())
        matched = (pos < len(keys)) & (
            karr[pos.clamp(max=len(keys) - 1)] == idx)
    else:
        fns = list(branch_fns)
        pos = idx
        matched = (idx >= 0) & (idx < len(fns))
    if default is not None:
        pos = torch.where(matched, pos, torch.full_like(pos, len(fns)))
        fns = fns + [default]
    pos = pos.clamp(0, len(fns) - 1)
    outs = [fn() for fn in fns]
    out = outs[0]
    for i in range(1, len(outs)):
        out = _select(pos == i, outs[i], out)
    return out

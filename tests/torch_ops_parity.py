"""The harness of tests/test_torch_ops_*.py: one case of
tests/torch_ops_cases.py run through the JAX package (plain XLA on the
CPU) and through paddle_tpu_torch on the CPU, values, shapes and (for
differentiable cases) the gradients of sum(out * w) compared at the
case's tolerance."""
import functools

import numpy as np
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from torch_ops_cases import ARG, TOLS


def resolve(pkg, name):
    """The callable `name` of a package: a top-level op, or a dotted
    path below it (nn.functional.mse_loss)."""
    return functools.reduce(getattr, name.split("."), pkg)


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _np_jax(x):
    if isinstance(x, jp.Tensor):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _np_torch(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().resolve_neg().numpy()
    return np.asarray(x)


def _convert(v, make, grads):
    """Numpy arrays to tensors (make); floating ones that take a gradient
    are collected in grads."""
    if isinstance(v, ARG):
        return v.value
    if isinstance(v, list):
        return [_convert(a, make, grads) for a in v]
    if isinstance(v, np.ndarray):
        t = make(v, grads is not None and v.dtype == np.float32)
        if grads is not None and v.dtype == np.float32:
            grads.append(t)
        return t
    return v


def _weights(rng, shape):
    """The w of sum(out * w), drawn after the inputs (float32)."""
    return np.asarray(rng.randn(*shape), np.float32)


def _jax_make(a, grad):
    return jp.to_tensor(a, stop_gradient=not grad)


def run_jax(case):
    args, kwargs, rng = case.inputs()
    grads = [] if case.grad else None
    a = [_convert(v, _jax_make, grads) for v in args]
    k = {n: _convert(v, _jax_make, grads) for n, v in kwargs.items()}
    out = resolve(jp, case.fn)(*a, **k)
    res = {"out": [_np_jax(o) for o in _leaves(out)]}
    if case.grad:
        loss = None
        ws = []
        for o in _leaves(out):
            if isinstance(o, jp.Tensor) and \
                    np.issubdtype(np.dtype(o.dtype), np.floating):
                w = _weights(rng, o.shape)
                ws.append(w)
                if not o.stop_gradient:
                    term = jp.sum(o * jp.to_tensor(w))
                    loss = term if loss is None else loss + term
        res["ws"] = ws
        if loss is not None:
            loss.backward()
        res["grads"] = [None if t.grad is None else _np_jax(t.grad)
                        for t in grads]
    return res


def run_torch(case, device="cpu"):
    """The port's call on `device`, its outputs and gradients."""
    args, kwargs, rng = case.inputs()
    grads = [] if case.grad else None

    def make(a, grad):
        t = torch.from_numpy(np.array(a)).to(device)
        return t.requires_grad_(True) if grad else t
    a = [_convert(v, make, grads) for v in args]
    k = {n: _convert(v, make, grads) for n, v in kwargs.items()}
    out = resolve(pt, case.fn)(*a, **k)
    leaves = _leaves(out)
    res = {"out": [_np_torch(o) for o in leaves],
           "devices": [o.device.type for o in leaves
                       if isinstance(o, torch.Tensor)]}
    if case.grad:
        loss = None
        drawn = []
        for o in leaves:
            if isinstance(o, torch.Tensor) and o.is_floating_point():
                w = _weights(rng, o.shape)
                drawn.append(w)
                if o.requires_grad:
                    term = (o * torch.from_numpy(w).to(o.device)).sum()
                    loss = term if loss is None else loss + term
        res["ws"] = drawn
        if loss is not None:
            loss.backward()
        res["grads"] = [None if t.grad is None else _np_torch(t.grad)
                        for t in grads]
    return res


def _kind(a):
    a = np.asarray(a)
    if a.dtype == bool:
        return "bool"
    if np.issubdtype(a.dtype, np.integer):
        return "int"
    if np.issubdtype(a.dtype, np.complexfloating):
        return "complex"
    if np.issubdtype(a.dtype, np.floating):
        return "float"
    return "object"


def close(got, want, tol, what):
    """got against want: the same shape and kind; floats within
    tol * max(1, |want|) elementwise (NaN where want is NaN), integers
    and bools exactly."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs " \
                                    f"{want.shape}"
    assert _kind(got) == _kind(want), f"{what}: {got.dtype} vs {want.dtype}"
    if _kind(want) in ("float", "complex"):
        g, w = got.astype(np.complex128), want.astype(np.complex128)
        nan = np.isnan(w)
        assert np.array_equal(np.isnan(g), nan), f"{what}: NaN positions"
        g, w = g[~nan], w[~nan]
        inf = np.isinf(w)
        assert np.array_equal(g[inf], w[inf]), f"{what}: infinities"
        err = np.abs(g[~inf] - w[~inf])
        lim = tol * np.maximum(1.0, np.abs(w[~inf]))
        assert np.all(err <= lim), \
            f"{what}: max err {err.max()} (limit {tol} x max(1, |ref|))"
    else:
        assert np.array_equal(got, want), f"{what}: {got} vs {want}"


def check_case(case):
    want = run_jax(case)
    got = run_torch(case)
    tol = TOLS[case.tol]
    assert len(got["out"]) == len(want["out"]), case.id
    for i, (g, w) in enumerate(zip(got["out"], want["out"])):
        close(g, w, tol, f"{case.id} out[{i}]")
    if case.grad:
        assert len(got["ws"]) == len(want["ws"]), \
            f"{case.id}: {len(got['ws'])} differentiable outputs vs " \
            f"{len(want['ws'])}"
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            ref = np.zeros_like(g if g is not None else w) \
                if w is None else w
            val = np.zeros_like(ref) if g is None else g
            close(val, ref, tol, f"{case.id} grad[{i}]")

"""cross_entropy, softmax_with_cross_entropy and nn.CrossEntropyLoss over
a class axis other than the last, against the JAX package's.

The same numpy inputs go through paddle_tpu.nn.functional and
paddle_tpu_torch.nn.functional at axis 1 of an [N, C, H, W] input (a
segmentation loss) and at the middle axis of an [N, C, L] input (given
as -2). Both packages take the general path there: an f32 log_softmax
composition over the axis. Tolerances: the loss within 1e-5 and the
input's gradient within 1e-4, each x max(1, max|ref|) (the same
composition, sums in another order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.nn.functional import loss as L

# (shape, class axis)
SHAPES = {"nchw": ((2, 5, 3, 4), 1), "middle": ((3, 6, 4), -2)}


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _inputs(shape, axis, seed=0):
    """logits, soft labels (a softmax along axis), hard labels with the
    class axis dropped (every 7th ignored), and class weights."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    c = shape[axis]
    e = np.exp(rng.randn(*shape))
    soft = (e / e.sum(axis, keepdims=True)).astype(np.float32)
    lshape = list(shape)
    del lshape[axis]
    lbl = rng.randint(0, c, lshape).astype(np.int64)
    lbl.reshape(-1)[::7] = -100
    w = (np.abs(rng.randn(c)) + 0.1).astype(np.float32)
    return x, soft, lbl, w


# form -> (label, keyword arguments) of cross_entropy
_FORMS = {
    "hard": lambda x, s, l, w, a: (l, {}),
    "hard_kept_axis": lambda x, s, l, w, a: (np.expand_dims(l, a), {}),
    "soft": lambda x, s, l, w, a: (s, dict(soft_label=True)),
    "soft_float_labels": lambda x, s, l, w, a: (s, {}),
    "soft_smoothing": lambda x, s, l, w, a: (
        s, dict(soft_label=True, label_smoothing=0.1)),
    "weight": lambda x, s, l, w, a: (l, dict(weight=w)),
    "smoothing": lambda x, s, l, w, a: (l, dict(label_smoothing=0.1)),
    "weight_smoothing": lambda x, s, l, w, a: (
        l, dict(weight=w, label_smoothing=0.2)),
    "no_softmax": lambda x, s, l, w, a: (l, dict(use_softmax=False)),
}


def _args(form, shape_name):
    shape, axis = SHAPES[shape_name]
    x, soft, lbl, w = _inputs(shape, axis)
    if form == "no_softmax":
        x = soft.copy()   # probabilities in
    label, kw = _FORMS[form](x, soft, lbl, w, axis)
    return x, label, kw, axis


@pytest.mark.parametrize("red", ["mean", "sum", "none"])
@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_cross_entropy_over_an_axis_matches_jax(shape_name, form, red):
    x, label, kw, axis = _args(form, shape_name)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jkw = {k: paddle.to_tensor(v) if k == "weight" else v
           for k, v in kw.items()}
    jl = JF.cross_entropy(jx, paddle.to_tensor(label), reduction=red,
                          axis=axis, **jkw)
    jl.sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    tkw = {k: torch.from_numpy(v) if k == "weight" else v
           for k, v in kw.items()}
    tl = F.cross_entropy(tx, torch.from_numpy(label), reduction=red,
                         axis=axis, **tkw)
    tl.sum().backward()
    assert tuple(tl.shape) == tuple(np.shape(jl.numpy()))
    _close(tl.detach().numpy(), jl.numpy(), 1e-5)
    _close(tx.grad.numpy(), jx.grad.numpy(), 1e-4)


@pytest.mark.parametrize("return_softmax", [False, True])
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_softmax_with_cross_entropy_over_an_axis_matches_jax(
        shape_name, soft, return_softmax):
    """The loss keeps its singleton at the class axis; the returned
    softmax is taken over that axis; the gradient of loss (and softmax)
    against the JAX package's."""
    shape, axis = SHAPES[shape_name]
    x, sl, lbl, _ = _inputs(shape, axis, seed=5)
    label = sl if soft else np.expand_dims(lbl, axis)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_(True)
    jout = JF.softmax_with_cross_entropy(
        jx, paddle.to_tensor(label), soft_label=soft, axis=axis,
        return_softmax=return_softmax)
    tout = F.softmax_with_cross_entropy(
        tx, torch.from_numpy(label), soft_label=soft, axis=axis,
        return_softmax=return_softmax)
    if not return_softmax:
        jout, tout = (jout,), (tout,)
    want = list(shape)
    want[axis] = 1
    assert tuple(tout[0].shape) == tuple(want)
    if return_softmax:
        assert tuple(tout[1].shape) == shape
    for j, t in zip(jout, tout):
        _close(t.detach().numpy(), j.numpy(), 1e-5)
    sum(j.sum() for j in jout).backward()
    sum(t.sum() for t in tout).backward()
    _close(tx.grad.numpy(), jx.grad.numpy(), 1e-4)


@pytest.mark.parametrize("red", ["mean", "sum", "none"])
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_cross_entropy_loss_layer_takes_the_axis(shape_name, red):
    """nn.CrossEntropyLoss(axis=) reaches the same function: hard labels
    with ignore_index and class weights, against the JAX layer."""
    shape, axis = SHAPES[shape_name]
    x, _, lbl, w = _inputs(shape, axis, seed=9)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jl = paddle.nn.CrossEntropyLoss(weight=paddle.to_tensor(w),
                                    reduction=red, axis=axis)(
        jx, paddle.to_tensor(lbl))
    jl.sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = tnn.CrossEntropyLoss(weight=torch.from_numpy(w), reduction=red,
                              axis=axis)(tx, torch.from_numpy(lbl))
    tl.sum().backward()
    _close(tl.detach().numpy(), jl.numpy(), 1e-5)
    _close(tx.grad.numpy(), jx.grad.numpy(), 1e-4)


@pytest.mark.parametrize("axis", [-1, 2])
def test_last_axis_keeps_the_fused_path(monkeypatch, axis):
    """Hard labels over the last axis (given as -1 or by its index) still
    take the fused _SoftmaxCE, in both functions; another axis never
    does."""
    calls = []
    real = L._SoftmaxCE.apply
    monkeypatch.setattr(L._SoftmaxCE, "apply",
                        lambda *a: calls.append(1) or real(*a))
    x, _, lbl, _ = _inputs((2, 3, 5), 2, seed=3)
    F.cross_entropy(torch.from_numpy(x), torch.from_numpy(lbl), axis=axis)
    F.softmax_with_cross_entropy(torch.from_numpy(x),
                                 torch.from_numpy(lbl[..., None]), axis=axis)
    assert len(calls) == 2
    x1, _, lbl1, _ = _inputs((2, 5, 3), 1, seed=3)
    F.cross_entropy(torch.from_numpy(x1), torch.from_numpy(lbl1), axis=1)
    assert len(calls) == 2


def test_other_axis_equals_the_last_axis_after_a_move():
    """Over axis 1 the loss is the last-axis general path's on the input
    (and soft labels) with the class axis moved last, form by form
    (smoothing, weight, soft labels with weight, which the JAX function
    takes only at the last axis), element for element."""
    x, soft, lbl, w = _inputs((2, 5, 3, 4), 1, seed=4)
    tx, ts = torch.from_numpy(x), torch.from_numpy(soft)
    tw, tl = torch.from_numpy(w), torch.from_numpy(lbl)
    cases = ((tl, tl, dict(label_smoothing=0.1)), (tl, tl, dict(weight=tw)),
             (ts, ts.movedim(1, -1), dict(soft_label=True, weight=tw)))
    for label, moved_label, kw in cases:
        got = F.cross_entropy(tx, label, axis=1, reduction="none", **kw)
        want = F.cross_entropy(tx.movedim(1, -1), moved_label, axis=-1,
                               reduction="none", **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)

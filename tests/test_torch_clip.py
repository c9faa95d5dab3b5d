"""The port's gradient clipping (nn/clip.py) against the JAX package's.

The same numpy gradients go through paddle_tpu.nn.ClipGradBy* and
paddle_tpu_torch.nn.ClipGradBy*, within 1e-6 (f32 on both sides; the
global norm sums in another order). One eager AdamW step() with
ClipGradByGlobalNorm against the JAX optimizer's eager step(), and one
GradScaler.step with it against the JAX scaler's, at 1e-6.
The port's TrainStep refuses a clipping optimizer: the JAX TrainStep's
compiled update never applies the clip (ROADMAP.md queue C).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.static import TrainStep

SHAPES = [(7, 5), (5,), (3, 4, 2)]


def _grads(scale, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]


def _pairs_jax(grads):
    return [(paddle.to_tensor(np.zeros_like(g)), paddle.to_tensor(g))
            for g in grads]


def _pairs_torch(grads):
    return [(torch.zeros(g.shape), torch.from_numpy(g)) for g in grads]


@pytest.mark.parametrize("name,args", [
    ("ClipGradByValue", (0.5,)), ("ClipGradByValue", (0.5, -0.2)),
    ("ClipGradByNorm", (1.0,)), ("ClipGradByGlobalNorm", (1.0,)),
    ("ClipGradByGlobalNorm", (1e3,))])
@pytest.mark.parametrize("scale", [0.1, 3.0])
def test_clips_match_jax(name, args, scale):
    grads = _grads(scale)
    ref = getattr(jnn, name)(*args)(_pairs_jax(grads))
    got = getattr(tnn, name)(*args)(_pairs_torch(grads))
    assert len(got) == len(ref) == len(grads)
    for (_, g), (_, r) in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r.numpy()),
                                   atol=1e-6, rtol=1e-6)


def test_global_norm_skips_none_and_need_clip_false():
    grads = _grads(3.0, seed=1)
    pairs = _pairs_torch(grads)
    pairs[1][0].need_clip = False
    pairs.append((torch.zeros(2), None))
    out = tnn.ClipGradByGlobalNorm(1.0)(pairs)
    assert out[-1][1] is None
    assert torch.equal(out[1][1], pairs[1][1])
    total = torch.sqrt(sum((g ** 2).sum() for _, g in pairs[:-1]))
    torch.testing.assert_close(out[0][1], pairs[0][1] / total)


def test_eager_adamw_step_with_global_norm_clip_matches_jax():
    init = _grads(1.0, seed=2)
    coefs = _grads(4.0, seed=3)      # d(sum(p * c))/dp = c: large grads
    jps = [paddle.to_tensor(a, stop_gradient=False) for a in init]
    jopt = paddle.optimizer.AdamW(
        learning_rate=1e-2, parameters=jps, weight_decay=0.01,
        grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    tps = [torch.from_numpy(a.copy()).requires_grad_(True) for a in init]
    topt_ = topt.AdamW(learning_rate=1e-2, parameters=tps,
                       weight_decay=0.01,
                       grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    for _ in range(2):
        jl = sum((p * paddle.to_tensor(c)).sum() for p, c in zip(jps, coefs))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = sum((p * torch.from_numpy(c)).sum() for p, c in zip(tps, coefs))
        tl.backward()
        topt_.step()
        topt_.clear_grad()
    for t, j in zip(tps, jps):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j.numpy()),
                                   atol=1e-6, rtol=1e-6)
    # the clip did act: an unclipped step moves the params elsewhere
    free = [torch.from_numpy(a.copy()).requires_grad_(True) for a in init]
    fo = topt.AdamW(learning_rate=1e-2, parameters=free, weight_decay=0.01)
    sum((p * torch.from_numpy(c)).sum() for p, c in zip(free, coefs)) \
        .backward()
    fo.step()
    assert not torch.allclose(free[0], tps[0])


def test_scaler_step_clips_the_unscaled_grads_like_jax():
    """GradScaler.step unscales, then the optimizer's grad_clip acts on
    the unscaled gradients, as the JAX scaler's optimizer.step() does."""
    from paddle_tpu_torch import amp as tamp
    init = _grads(1.0, seed=5)
    coefs = _grads(4.0, seed=6)
    jps = [paddle.to_tensor(a, stop_gradient=False) for a in init]
    jopt = paddle.optimizer.AdamW(
        learning_rate=1e-2, parameters=jps,
        grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    jsc = paddle.amp.GradScaler(init_loss_scaling=64.0)
    jsc.scale(sum((p * paddle.to_tensor(c)).sum()
                  for p, c in zip(jps, coefs))).backward()
    jsc.step(jopt)
    tps = [torch.from_numpy(a.copy()).requires_grad_(True) for a in init]
    topt_ = topt.AdamW(learning_rate=1e-2, parameters=tps,
                       grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    tsc = tamp.GradScaler(init_loss_scaling=64.0)
    tsc.scale(sum((p * torch.from_numpy(c)).sum()
                  for p, c in zip(tps, coefs))).backward()
    tsc.step(topt_)
    for t, j in zip(tps, jps):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j.numpy()),
                                   atol=1e-6, rtol=1e-6)


def test_clip_grad_norm_and_value_in_place():
    grads = _grads(3.0, seed=4)
    ps = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(ps, grads):
        p.grad = torch.from_numpy(g.copy())
    total = tnn.clip.clip_grad_norm_(ps, 1.0)
    want = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    np.testing.assert_allclose(total.item(), want, rtol=1e-6)
    got = np.sqrt(sum((p.grad.double() ** 2).sum().item() for p in ps))
    np.testing.assert_allclose(got, 1.0, rtol=1e-5)
    tnn.clip.clip_grad_value_(ps, 0.01)
    assert all(p.grad.abs().max() <= 0.01 for p in ps)


def test_trainstep_refuses_a_clipping_optimizer():
    pt.seed(0)
    layer = tnn.Linear(4, 3, device="cpu")
    opt = topt.AdamW(learning_rate=0.1,
                     grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    with pytest.raises(NotImplementedError, match="apply_gradients_tree"):
        TrainStep(layer, lambda o, y: ((o - y) ** 2).mean(), opt)

"""ResNet-18 training through the port's TrainStep against the JAX
TrainStep, and BatchNorm's running statistics through the step.

bench.py's bench_resnet on the CPU: resnet18(num_classes=10) at
4x3x32x32, labels in [0, 10), Momentum(0.1, momentum 0.9, weight_decay
1e-4), softmax cross-entropy, f32; weights from a numpy seed given to
the JAX model (tests/torch_vision_weights.py) and carried into the port
by name (load_jax_params).

Each of the 3 steps starts both packages from the JAX step's state
before it (parameters, running statistics and Momentum velocities
copied into the port), and holds the loss at 1e-5 relative, the
running statistics (`_mean`, `_variance`) at 1e-5 and the parameters
after the update at 1e-4, each relative to max(1, max|ref|). The step
is held from the JAX state, not left to run free: at lr 0.1 this random
model's loss climbs (4.2, 5.1, 10.4), and the free run multiplies the
two packages' 1e-7 differences in the convolutions' sums by that
growth, 0.7% apart in the third loss. The parameters' 1e-4 is the
gradients' tolerance: an update moves a parameter by lr times its
gradient, and a train-mode BatchNorm over the 4 samples a channel has
at layer4's 1x1 maps scales the sums' differences (conv1's weight, the
deepest gradient, sits at 7e-5).

The cases of static/train_step.py where the JAX step's buffers and the
port's in-place ones could part, each against the JAX TrainStep:
grad_accum_steps=2 (every microbatch from the step's initial buffers,
the last one's update kept; at batch 8, so each microbatch has the main
case's 4 samples), remat (no second update in the recompute) and a
loss-scale skip (parameters and velocities kept, buffers advanced).
Then the step's state_dict carries the buffers, set_state_dict restores
them in place, and build_eval_fn normalises with them.

In the three tests of the step's main case, grad_accum_steps=2 and
remat, where a loss or a tensor parts from the JAX step's by more than
its tolerance it is held three ways instead (torch_vision_weights
nearer_f64): the port's f32 value may lie no further from the same step
in float64 (the JAX TrainStep under jax.enable_x64 from the same state,
the cross-entropy in f64) than the JAX package's f32 value does, and
both within 1e-2 of it. On some CPUs the JAX step's parameters after
step 1 lie up to 2.8e-3 from the f64 step's (layer1.0.bn2's weight and
bias first, then the layers below it) where the port's lie within
4.3e-6 of it (tests/bn_rounding_report.py prints these distances).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.amp import GradScaler as JScaler
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.static import TrainStep as JStep
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.amp import GradScaler as TScaler
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.optimizer import Momentum as TMomentum
from paddle_tpu_torch.static import TrainStep as TStep
from paddle_tpu_torch.vision import models as TM
from torch_vision_weights import (ce64, jax_f64_steps, jax_vision_model,
                                  nearer_f64)

LOSS, BUF, PARAM = 1e-5, 1e-5, 1e-4
STEPS = 3



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: tier-1 runs several workers on the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _jloss(out, y):
    return JF.cross_entropy(out, y)


def _tloss(out, y):
    return TF.cross_entropy(out, y)


def _steps(batch=4, jscaler=None, tscaler=None, **kw):
    jm = jax_vision_model("resnet18")
    tm = TM.resnet18(num_classes=10, device="cpu")
    js = JStep(jm, _jloss, JMomentum(learning_rate=0.1, momentum=0.9,
                                     parameters=jm.parameters(),
                                     weight_decay=1e-4),
               scaler=jscaler, **kw)
    ts = TStep(tm, _tloss, TMomentum(learning_rate=0.1, momentum=0.9,
                                     weight_decay=1e-4),
               scaler=tscaler, **kw)
    rng = np.random.RandomState(0)
    x = rng.randn(batch, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, (batch,)).astype(np.int64)
    return jm, tm, js, ts, x, y


def _jax_state(jm, js):
    js.sync_to_layer()
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _force(tm, ts, state, js):
    """The port set to the JAX step's state: model (parameters and
    running statistics) and every Momentum velocity, in place."""
    load_jax_params(tm, state)
    with torch.no_grad():
        for name, p in zip(ts._param_names, ts.params):
            ts.optimizer._state_of(p)["velocity"].copy_(torch.from_numpy(
                np.asarray(js.opt_state[name]["velocity"])))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _check_state(tm, want, what, want64=None):
    """The port's state against the JAX step's `want`; where a tensor
    parts by more than its tolerance, three ways against want64() (the
    f64 step's state), when given."""
    got = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    assert list(got) == list(want)
    for k, w in want.items():
        tol = BUF if k.endswith(("_mean", "_variance")) else PARAM
        if want64 is not None and _rel(got[k], w) > tol:
            ok, seen = nearer_f64(got[k], w, want64()[k])
            assert ok, (what, k, seen)
        else:
            assert _rel(got[k], w) <= tol, (what, k, _rel(got[k], w))


def _f64_step(state, velocities, x, y, **kw):
    """The JAX step in float64 (jax_f64_steps; kw its TrainStep options)
    from the JAX state and Momentum velocities, on the same batch.
    Returns (loss, state after)."""
    (loss,), after = jax_f64_steps(
        jax_vision_model("resnet18"), ce64,
        lambda ps: JMomentum(learning_rate=0.1, momentum=0.9, parameters=ps,
                             weight_decay=1e-4),
        state, [(x, y)],
        opt_state={k: {"velocity": v} for k, v in velocities.items()}, **kw)
    return loss, after


def _run(jm, tm, js, ts, x, y, steps=STEPS, before=None, loss=True,
         f64=None):
    """`steps` steps, each from the JAX state; returns the losses. f64:
    the TrainStep's options, to hold a value that parts by more than its
    tolerance three ways against the step in float64 (none: no such
    fallback)."""
    losses = []
    for s in range(steps):
        state = _jax_state(jm, js)
        velocities = {k: np.asarray(v["velocity"])
                      for k, v in js.opt_state.items()}
        _force(tm, ts, state, js)
        if before is not None:
            before(s)
        ref = None if f64 is None else functools.cache(
            lambda: _f64_step(state, velocities, x, y, **f64))
        jl = float(js(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
        tl = float(ts(torch.from_numpy(x), torch.from_numpy(y)))
        if ref is not None and abs(tl - jl) > LOSS * abs(jl):
            ok, seen = nearer_f64(tl, jl, ref()[0])
            assert ok, (s, tl, jl, seen)
        else:
            assert not loss or abs(tl - jl) <= LOSS * abs(jl), (s, tl, jl)
        _check_state(tm, _jax_state(jm, js), f"step {s}",
                     None if ref is None else lambda: ref()[1])
        losses.append(tl)
    return losses


def _buffers(tm):
    return {k: v.detach().clone() for k, v in tm.state_dict().items()
            if k.endswith(("_mean", "_variance"))}


def test_resnet18_trainstep_matches_jax():
    jm, tm, js, ts, x, y = _steps()
    before = _buffers(tm)
    losses = _run(jm, tm, js, ts, x, y, f64={})
    assert all(np.isfinite(losses))
    after = _buffers(tm)
    # the running statistics moved: the step carried them
    assert all(not torch.equal(before[k], after[k]) for k in before)


def test_grad_accum_keeps_last_microbatch_update():
    """Every microbatch starts from the step's initial buffers; the step
    keeps the last microbatch's (JAX: the scan's new buffers, a[-1])."""
    jm, tm, js, ts, x, y = _steps(batch=8, grad_accum_steps=2)
    _run(jm, tm, js, ts, x, y, steps=2, f64=dict(grad_accum_steps=2))


def test_remat_updates_running_stats_once():
    """The recompute in the backward does not update the running
    statistics a second time (jax.checkpoint's recompute writes none)."""
    jm, tm, js, ts, x, y = _steps(remat=True)
    _run(jm, tm, js, ts, x, y, steps=2, f64=dict(remat=True))


def test_loss_scale_skip_advances_buffers():
    """On overflow the parameters and velocities stay, the running
    statistics advance, as the JAX step's new_buffers do."""
    jm, tm, js, ts, x, y = _steps(jscaler=JScaler(init_loss_scaling=1024.0),
                                  tscaler=TScaler(init_loss_scaling=1024.0))

    def overflow(s):
        js.strategy_state = dict(js.strategy_state,
                                 amp_scale=jnp.asarray(jnp.inf))
        ts.strategy_state["amp_scale"].fill_(float("inf"))

    start = _jax_state(jm, js)
    # the losses of the overflowing step are not compared: the JAX step
    # returns the scaled loss over the scale (inf / inf here), the port
    # the loss before scaling
    _run(jm, tm, js, ts, x, y, steps=1, before=overflow, loss=False)
    assert int(ts.strategy_state["amp_skipped"]) == 1
    for k, v in tm.named_parameters():
        assert torch.equal(v.detach(), torch.from_numpy(start[k])), k
    for k, v in _buffers(tm).items():
        assert not torch.equal(v, torch.from_numpy(start[k])), k


def test_state_dict_and_eval_fn_carry_the_running_stats():
    """state_dict copies the buffers, set_state_dict writes them back in
    place (a captured graph keeps their addresses), and build_eval_fn
    normalises with them, as the JAX step's eval function does."""
    jm, tm, js, ts, x, y = _steps()
    _run(jm, tm, js, ts, x, y, steps=1)
    snap = ts.state_dict()
    assert "layer1.0.bn1._mean" in snap["model"]
    live = tm.layer1[0].bn1._mean
    ts(torch.from_numpy(x), torch.from_numpy(y))
    assert not torch.equal(live, snap["model"]["layer1.0.bn1._mean"])
    ts.set_state_dict(snap)
    assert tm.layer1[0].bn1._mean is live
    assert torch.equal(live, snap["model"]["layer1.0.bn1._mean"])
    xe = np.random.RandomState(5).randn(4, 3, 32, 32).astype(np.float32)
    got = ts.build_eval_fn()(torch.from_numpy(xe)).numpy()
    assert tm.training
    js.sync_to_layer()
    want = np.asarray(js.build_eval_fn()(
        js.params, js.buffers, jax.random.key(0), (jnp.asarray(xe),)))
    assert _rel(got, want) <= PARAM

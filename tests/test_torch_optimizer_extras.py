"""The port's EMA, ModelAverage and Lookahead
(paddle_tpu_torch/optimizer/extras.py, and incubate's names for them)
against the JAX package's (tests/test_optimizer_extras.py's cases), on
the CPU: the same Linear(4, 1) weights, the same data and SGD steps in
both packages, and every shadow, window average, applied, restored and
synced weight equal at 1e-6. apply() and restore() write the parameters
in place (their storage stays the same), as a captured step needs.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.optimizer import (ExponentialMovingAverage as JEMA,
                                  LookaheadOptimizer as JLook,
                                  ModelAverage as JMA)
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import incubate
from paddle_tpu_torch.optimizer import (ExponentialMovingAverage,
                                        LookaheadOptimizer, ModelAverage)

TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _problem(seed=0):
    """(jax linear, torch linear with its weights, x, y numpy)."""
    rng = np.random.RandomState(seed)
    jl = jnn.Linear(4, 1)
    tl = tnn.Linear(4, 1)
    with torch.no_grad():
        for (_, jpar), (_, tpar) in zip(sorted(jl.state_dict().items()),
                                        sorted(tl.state_dict().items())):
            tpar.copy_(torch.from_numpy(np.array(jpar.numpy())))
    xs = rng.randn(16, 4).astype(np.float32)
    w = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    return jl, tl, xs, (xs @ w)


def _weights(layer, jax=False):
    return [np.asarray(p.numpy()) if jax else p.detach().numpy().copy()
            for p in layer.parameters()]


def _close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL)


def _sgd_step(jl, tl, jopt, topt, x, y, jstep=None, tstep=None):
    jloss = JF.mse_loss(jl(jp.to_tensor(x)), jp.to_tensor(y))
    jopt.clear_grad()
    jloss.backward()
    (jstep or jopt.step)()
    tloss = TF.mse_loss(tl(torch.from_numpy(x)), torch.from_numpy(y))
    topt.clear_grad()
    tloss.backward()
    (tstep or topt.step)()
    return float(np.asarray(jloss.numpy())), tloss.item()


@pytest.mark.parametrize("thres", [False, True])
def test_ema_shadow_apply_restore_match_jax(thres):
    jl, tl, x, y = _problem()
    jopt = jp.optimizer.SGD(learning_rate=0.1, parameters=jl.parameters())
    topt = pt.optimizer.SGD(learning_rate=0.1, parameters=tl.parameters())
    jema = JEMA(jl.parameters(), decay=0.9, thres_steps=thres)
    tema = ExponentialMovingAverage(tl.parameters(), decay=0.9,
                                    thres_steps=thres)
    for _ in range(3):
        _sgd_step(jl, tl, jopt, topt, x, y)
        jema.update()
        tema.update()
        assert tema._decay_t() == jema._decay_t()
    _close([s.numpy() for s in tema._shadow.values()],
           [np.asarray(s) for s in jema._shadow.values()])
    live = _weights(tl)
    ptrs = [p.data_ptr() for p in tl.parameters()]
    with tema.apply(), jema.apply():
        _close(_weights(tl), _weights(jl, jax=True))
        assert [p.data_ptr() for p in tl.parameters()] == ptrs
        with pytest.raises(RuntimeError, match="already active"):
            tema.apply()
    _close(_weights(tl), live)
    _close(_weights(tl), _weights(jl, jax=True))
    st = tema.state_dict()
    twin = ExponentialMovingAverage(tl.parameters(), decay=0.9)
    twin.set_state_dict(st)
    _close([s.numpy() for s in twin._shadow.values()],
           [s.numpy() for s in tema._shadow.values()])
    assert sorted(st) == sorted(jema.state_dict())


def test_model_average_window_matches_jax():
    jl, tl, x, y = _problem()
    jopt = jp.optimizer.SGD(learning_rate=0.5, parameters=jl.parameters())
    topt = pt.optimizer.SGD(learning_rate=0.5, parameters=tl.parameters())
    jma = JMA(parameters=jl.parameters(), min_average_window=3,
              max_average_window=5)
    tma = ModelAverage(parameters=tl.parameters(), min_average_window=3,
                       max_average_window=5)
    with pytest.raises(RuntimeError, match="empty"):
        tma.apply()
    for _ in range(7):       # past the window: a mean-seeded restart
        _sgd_step(jl, tl, jopt, topt, x, y)
        jma.step()
        tma.step()
        assert tma._window == jma._window
    live = _weights(tl)
    with tma.apply(), jma.apply():
        _close(_weights(tl), _weights(jl, jax=True))
    _close(_weights(tl), live)
    tma.apply(need_restore=False)
    jma.apply(need_restore=False)
    _close(_weights(tl), _weights(jl, jax=True))
    tma.restore()            # nothing backed up: a no-op
    _close(_weights(tl), _weights(jl, jax=True))


@pytest.mark.parametrize("k", [2, 3])
def test_lookahead_matches_jax(k):
    jl, tl, x, y = _problem(1)
    jlook = JLook(jp.optimizer.SGD(learning_rate=0.2,
                                   parameters=jl.parameters()),
                  alpha=0.8, k=k)
    tlook = LookaheadOptimizer(pt.optimizer.SGD(
        learning_rate=0.2, parameters=tl.parameters()), alpha=0.8, k=k)
    losses = []
    for _ in range(7):
        losses.append(_sgd_step(jl, tl, jlook, tlook, x, y))
        _close(_weights(tl), _weights(jl, jax=True))
        assert tlook._step_count == jlook._step_count
    np.testing.assert_allclose([t for _, t in losses],
                               [j for j, _ in losses], rtol=1e-5)
    assert tlook.get_lr() == jlook.get_lr()


def test_lookahead_sync_after_steps_taken_elsewhere():
    """start() then sync() after each step the inner optimizer took
    (a captured TrainStep's): the same weights as step()."""
    _, a, x, y = _problem(2)
    b = tnn.Linear(4, 1)
    b.load_state_dict(a.state_dict())
    la = LookaheadOptimizer(pt.optimizer.SGD(learning_rate=0.2,
                                             parameters=a.parameters()),
                            alpha=0.5, k=2)
    inner = pt.optimizer.SGD(learning_rate=0.2, parameters=b.parameters())
    lb = LookaheadOptimizer(inner, alpha=0.5, k=2)
    lb.start()
    for _ in range(4):
        for layer, step in ((a, la.step), (b, None)):
            loss = TF.mse_loss(layer(torch.from_numpy(x)),
                               torch.from_numpy(y))
            loss.backward()
            if step is not None:
                step()
                la.clear_grad()
            else:
                inner.step()
                inner.clear_grad()
                lb.sync()
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_incubate_names():
    assert incubate.LookAhead is LookaheadOptimizer
    assert incubate.ModelAverage is ModelAverage
    assert incubate.optimizer.__all__ == jp.incubate.optimizer.__all__
    assert incubate.__all__ == jp.incubate.__all__
    assert hasattr(incubate.reader, "DataLoader")

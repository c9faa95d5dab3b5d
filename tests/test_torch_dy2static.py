"""The port's dy2static (twin of tests/test_dy2static.py and
tests/test_dy2static_break.py).

Each function below is written once over `P` and run twice: with P the
port (converted by paddle_tpu_torch.jit.dy2static) and with P the JAX
package (a copy of the function whose globals name paddle_tpu, converted
by paddle_tpu.jit.dy2static), on the same numpy inputs; the outputs
agree to 1e-5 and the port's converted function equals its plain Python
one. "Traced" here is the port's: a Var of a static Program being
recorded (ifelse selects with torch.where; a tensor `while` runs as the
bounded loop under max_while_iters_guard, and raises without one), held
against the JAX package's jax.jit of the same converted function. The
capture path (a WHILE node of a CUDA graph) runs only on the card:
chip_smoke.py's to_static_while phase.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit.dy2static as jd2s
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.static as static
from paddle_tpu_torch.jit.dy2static import (ConversionError,
                                            convert_function,
                                            max_while_iters_guard)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


def tensor_if(x):
    if x.sum() > 0:
        y = x * 2
    else:
        y = x - 1
    return y


def tensor_if_return(x):
    if x.mean() > 0:
        return x * 2
    else:
        return x - 1


def tensor_while(x):
    i = P.to_tensor(np.float32(0))
    s = P.to_tensor(np.float32(0))
    while i < x.sum():
        s = s + i
        i = i + 1.0
    return s


def tensor_for_range(x, n):
    acc = P.zeros(list(x.shape))
    for i in range(n):
        acc = acc + x
    return acc


def for_over_tensor(xs):
    s = P.zeros([2])
    for row in xs:
        s = s + row
    return s


def nested_control(x, n):
    s = P.zeros([1])
    i = 0
    while i < n:
        if x.sum() > 0:
            s = s + x.sum()
        else:
            s = s - 1.0
        i = i + 1
    return s


def nested_if_in_if(x):
    if x.sum() > 0:
        if x.mean() > 1:
            y = x * 2
        else:
            y = x * 3
    else:
        y = x - 1
    return y


def if_in_static_for(x):
    y = x
    for i in range(2):
        if x.sum() > 0:
            y = y + 1
        else:
            y = y - 1
    return y


def boolop_pred(x):
    if x.sum() > 0 and x.mean() > 0:
        y = x * 2
    else:
        y = x - 1
    return y


def while_break(x):
    i = P.to_tensor(np.float32(0))
    s = P.to_tensor(np.float32(0))
    while i < 10:
        if i > x.sum():
            break
        s = s + i
        i = i + 1
    return s


def while_continue(x):
    i = P.to_tensor(np.float32(0))
    s = P.to_tensor(np.float32(0))
    while i < 6:
        i = i + 1
        if i.sum() % 2 == 0:
            continue
        s = s + i
    return s


def for_break(x):
    s = P.to_tensor(np.float32(0))
    for i in range(8):
        if s > x.sum():
            break
        s = s + 1.0
    return s


def for_continue(x):
    s = P.to_tensor(np.float32(0))
    for i in range(6):
        if i == 2:
            continue
        s = s + float(i)
    return s


def for_break_continue_mixed(x):
    s = P.to_tensor(np.float32(0))
    for i in range(10):
        if i == 1:
            continue
        if s > x.sum() + 4.0:
            break
        s = s + 1.0
    return s


def nested_for_break(x):
    s = P.to_tensor(np.float32(0))
    for i in range(3):
        for j in range(5):
            if j == 2:
                break
            s = s + 1.0
    return s


def early_return_in_if(x):
    if x.sum() > 0:
        return x * 2.0
    return x - 1.0


def return_in_for(x):
    s = P.to_tensor(np.float32(0))
    for i in range(10):
        s = s + x.sum()
        if s > 5.0:
            return s * 10.0
    return s


def return_in_while(x):
    i = P.to_tensor(np.float32(0))
    while i < 10:
        i = i + x.sum() * x.sum() + 0.5
        if i > 7.0:
            return i + 0.5
    return i


def return_no_value(x):
    if x.sum() > 100.0:
        return
    return x + 1.0


def break_after_stmts(x):
    s = P.to_tensor(np.float32(0))
    t = P.to_tensor(np.float32(0))
    for i in range(5):
        if i == 3:
            break
        s = s + 1.0
        t = t + s
    return s + t


def continue_skips_tail(x):
    s = P.to_tensor(np.float32(0))
    t = P.to_tensor(np.float32(0))
    for i in range(6):
        if i % 2 == 0:
            continue
        s = s + 1.0
        t = t + 10.0
    return s + t


def for_range_step_break(x):
    s = P.to_tensor(np.float32(0))
    for i in range(8, 0, -2):
        if i == 2:
            break
        s = s + float(i)
    return s


BREAK_FNS = [while_break, while_continue, for_break, for_continue,
             for_break_continue_mixed, nested_for_break, early_return_in_if,
             return_in_for, return_in_while, return_no_value,
             break_after_stmts, continue_skips_tail, for_range_step_break]


def _jax_twin(fn):
    """fn with P bound to the JAX package, converted by its dy2static."""
    twin = types.FunctionType(fn.__code__, dict(fn.__globals__, P=paddle),
                              fn.__name__, fn.__defaults__)
    return jd2s.convert_function(twin)


def _np(t):
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._data if hasattr(t, "_data") else t)


def _both(fn, *arrays, extra=()):
    port = convert_function(fn)(*[torch.from_numpy(a) for a in arrays],
                                *extra)
    jax = _jax_twin(fn)(*[paddle.to_tensor(a) for a in arrays], *extra)
    return _np(port), _np(jax)


VALS = [-2.0, 0.5, 3.0]


@pytest.mark.parametrize("fn", BREAK_FNS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("val", VALS)
def test_break_continue_return_match_python_and_jax(fn, val):
    x = np.full(2, val, np.float32)
    port, jax = _both(fn, x)
    want = _np(fn(torch.from_numpy(x)))
    if want is None:
        assert port is None and jax is None
        return
    np.testing.assert_allclose(port, want, rtol=TOL)
    np.testing.assert_allclose(port, jax, rtol=TOL)


@pytest.mark.parametrize("fn", [tensor_if, tensor_if_return, tensor_while,
                                nested_if_in_if, if_in_static_for,
                                boolop_pred], ids=lambda f: f.__name__)
@pytest.mark.parametrize("val", [-1.0, 0.5, 2.0])
def test_eager_conversion_matches_python_and_jax(fn, val):
    x = np.full(3, val, np.float32)
    port, jax = _both(fn, x)
    np.testing.assert_allclose(port, _np(fn(torch.from_numpy(x))),
                               rtol=TOL)
    np.testing.assert_allclose(port, jax, rtol=TOL)


def test_static_loops_and_row_iteration():
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    port, jax = _both(tensor_for_range, x[0], extra=(3,))
    np.testing.assert_allclose(port, jax, rtol=TOL)
    port, jax = _both(for_over_tensor, x)
    np.testing.assert_allclose(port, x.sum(0), rtol=TOL)
    np.testing.assert_allclose(port, jax, rtol=TOL)
    port, jax = _both(nested_control, np.ones(3, np.float32), extra=(3,))
    np.testing.assert_allclose(port, [9.0], rtol=TOL)
    np.testing.assert_allclose(port, jax, rtol=TOL)


def _recorded(fn, x, bound=None):
    """fn converted and recorded into a Program with x as its feed (a
    traced predicate), run by the CPU Executor."""
    conv = convert_function(fn)
    main = static.Program()
    guard = max_while_iters_guard(bound) if bound else \
        max_while_iters_guard(None)
    with static.program_guard(main), guard:
        out = conv(static.data("x", list(x.shape), "float32"))
    return static.Executor(P.CPUPlace()).run(main, {"x": x}, [out])[0]


def _jax_jit(fn, x, bound=None):
    import jax
    conv = _jax_twin(fn)

    def pure(a):
        return conv(paddle.Tensor(a))._data
    with jd2s.max_while_iters_guard(bound):
        return np.asarray(jax.jit(pure)(x))


@pytest.mark.parametrize("fn", [tensor_if, tensor_if_return,
                                nested_if_in_if, if_in_static_for,
                                boolop_pred, early_return_in_if],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("val", [-1.0, 0.5, 2.0])
def test_traced_if_selects_in_a_program(fn, val):
    x = np.full(3, val, np.float32)
    got = _recorded(fn, x)
    np.testing.assert_allclose(got, _np(fn(torch.from_numpy(x))), rtol=TOL)
    np.testing.assert_allclose(got, _jax_jit(fn, x), rtol=TOL)


@pytest.mark.parametrize("fn", [tensor_while, while_break, for_break],
                         ids=lambda f: f.__name__)
def test_traced_while_runs_bounded_in_a_program(fn):
    x = np.full(3, 2.0, np.float32)
    got = _recorded(fn, x, bound=12)
    np.testing.assert_allclose(got, _np(fn(torch.from_numpy(x))), rtol=TOL)
    np.testing.assert_allclose(got, _jax_jit(fn, x, bound=12), rtol=TOL)


def test_unbounded_traced_while_raises_clearly():
    with pytest.raises(ConversionError, match="set_max_while_iters"):
        _recorded(tensor_while, np.ones(3, np.float32))


def test_static_range_loop_stays_differentiable():
    x = torch.ones(2, requires_grad=True)
    convert_function(tensor_for_range)(x, 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])


class _Gate(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 4)

    def forward(self, x):
        h = self.fc(x)
        if h.sum() > 0:
            out = h * 2
        else:
            out = -h
        return out


def test_to_static_layer_with_tensor_branch():
    P.seed(11)
    model = _Gate()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4).astype(
        np.float32))
    with torch.no_grad():
        eager = model(x).numpy()
    smodel = P.jit.to_static(_Gate())
    smodel.set_state_dict(model.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(smodel(x).numpy(), eager, rtol=TOL)
    # the converted branch also records into a Program (a select)
    main = static.Program()
    with static.program_guard(main):
        out = smodel(static.data("x", [2, 4], "float32"))
    got = static.Executor(P.CPUPlace()).run(main, {"x": x.numpy()},
                                            [out])[0]
    np.testing.assert_allclose(got, eager, rtol=TOL)


def test_backward_through_converted_layer():
    class LoopNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(3, 3)

        def forward(self, x):
            y = self.fc(x)
            for i in range(2):
                y = y + x
            return y
    P.seed(12)
    net = LoopNet()
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3).astype(
        np.float32))
    net(x).sum().backward()
    want = {k: p.grad.clone() for k, p in net.named_parameters()}
    for p in net.parameters():
        p.grad = None
    P.jit.to_static(net)(x).sum().backward()
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=TOL)


def test_nonrange_iterable_break_keeps_python_semantics():
    def take_three(x):
        s = x * 0
        for k, v in enumerate(range(100)):
            if k == 3:
                break
            s = s + 1.0
        return s
    got = convert_function(take_three)(torch.zeros(2))
    np.testing.assert_allclose(got.numpy(), [3.0, 3.0])


def test_undef_use_raises_unbound():
    def f(x, flag):
        if flag:
            y = x + 1
        return y
    conv = convert_function(f)
    x = torch.ones(2)
    np.testing.assert_allclose(conv(x, True).numpy(), [2.0, 2.0])
    with pytest.raises(UnboundLocalError):
        conv(x, False) + 1

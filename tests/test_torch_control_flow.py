"""paddle_tpu_torch's control-flow ops against the JAX package's on the
CPU, in both modes. Eagerly, cond, case and switch_case branch in Python
(held against the JAX eager ops); under a CUDA-graph capture they run
every branch and select with torch.where, which static_branches() forces
here on CPU tensors (held against the JAX ops traced under jax.jit,
lax.cond and lax.switch, out-of-range indices included, and the
gradients through the select against the eager branch's). while_loop
under the capture contract refuses carries that require grad (no
reverse mode, as lax.while_loop) and otherwise loops on the host for CPU
tensors (on the card it becomes a conditional graph node, held by
chip_smoke.py); bounded_while_loop, fori_loop and scan
against the JAX ops (f32, 1e-6), with their gradients (the JAX ops
record no tape) against the loop written out in torch."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.ops import control_flow as jcf
from paddle_tpu_torch.ops import control_flow as tcf

RNG = np.random.RandomState(5)
A = RNG.randn(3, 4).astype(np.float32)
B = RNG.randn(3, 4).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                               atol=1e-6)


def _jit(fn, *arrays):
    """fn over JAX Tensors, traced under jax.jit (the JAX traced path)."""
    def pure(*xs):
        out = fn(*[jp.Tensor(x) for x in xs])
        if isinstance(out, (list, tuple)):
            return tuple(o._data for o in out)
        return out._data
    return jax.jit(pure)(*arrays)


def _true(x, y):
    return x * y, x - y


def _false(x, y):
    return x + y, x * 2.0


@pytest.mark.parametrize("flag", [True, False])
def test_cond_both_modes(flag):
    ta, tb = (torch.from_numpy(a).requires_grad_(True) for a in (A, B))
    pred = torch.tensor(flag)
    eager = tcf.cond(pred, _true, _false, operands=(ta, tb))
    with tcf.static_branches():
        sel = tcf.cond(pred, _true, _false, operands=(ta, tb))
    want = jcf.cond(jp.to_tensor(flag), _true, _false,
                    operands=(jp.to_tensor(A), jp.to_tensor(B)))
    traced = _jit(lambda p, a, b: jcf.cond(p, _true, _false,
                                           operands=(a, b)),
                  np.asarray(flag), A, B)
    for e, s, w, t in zip(eager, sel, want, traced):
        _close(e.detach(), w.numpy())
        _close(s.detach(), t)
    ge = torch.autograd.grad(sum(o.sum() for o in eager), (ta, tb))
    gs = torch.autograd.grad(sum(o.sum() for o in sel), (ta, tb))
    for a, b in zip(ge, gs):
        _close(a, b)


def test_cond_without_false_fn():
    x = torch.from_numpy(A)
    assert tcf.cond(torch.tensor(False), lambda: x) is None
    assert jcf.cond(jp.to_tensor(False), lambda: 1) is None
    with tcf.static_branches(), pytest.raises(ValueError, match="false_fn"):
        tcf.cond(torch.tensor(True), lambda: x)
    with pytest.raises(ValueError, match="false_fn"):
        _jit(lambda p: jcf.cond(p, lambda: p), np.asarray(True))
    # a host predicate is read on the host in every mode
    with tcf.static_branches():
        assert tcf.cond(True, lambda: x) is x


@pytest.mark.parametrize("flags", [(True, False), (False, True),
                                   (False, False), (True, True)])
def test_case_both_modes(flags):
    x = torch.from_numpy(A)
    fns = [lambda: x * 3.0, lambda: x - 1.0]
    default = lambda: x * 0.5  # noqa: E731
    pairs = [(torch.tensor(f), fn) for f, fn in zip(flags, fns)]
    jx = jp.to_tensor(A)
    jfns = [lambda: jx * 3.0, lambda: jx - 1.0]
    want = jcf.case([(jp.to_tensor(f), fn) for f, fn in zip(flags, jfns)],
                    default=lambda: jx * 0.5)
    _close(tcf.case(pairs, default=default), want.numpy())
    with tcf.static_branches():
        _close(tcf.case(pairs, default=default), want.numpy())
        with pytest.raises(ValueError, match="default"):
            tcf.case(pairs)
    if not any(flags):
        with pytest.raises(ValueError):
            tcf.case(pairs)


def _branches(x):
    return [lambda: x * 2.0, lambda: x + 5.0, lambda: -x]


@pytest.mark.parametrize("index", [-1, 0, 2, 3, 7])
@pytest.mark.parametrize("with_default", [False, True])
@pytest.mark.parametrize("as_dict", [False, True])
def test_switch_case_both_modes(index, with_default, as_dict):
    def build(x, make_default):
        fns = _branches(x)
        branch = {1: fns[0], 3: fns[1], 7: fns[2]} if as_dict else fns
        return branch, (make_default(x) if with_default else None)

    x = torch.from_numpy(A)
    jx = jp.to_tensor(A)
    tb, td = build(x, lambda v: (lambda: v * 0.0 + 9.0))
    jb, jd = build(jx, lambda v: (lambda: v * 0.0 + 9.0))
    # eager, against the JAX eager op (None where neither matches)
    got = tcf.switch_case(torch.tensor(index), tb, td)
    want = jcf.switch_case(jp.to_tensor(index), jb, jd)
    assert (got is None) == (want is None)
    if got is not None:
        _close(got, want.numpy())
    # the select path, against the JAX op traced (lax.switch)
    with tcf.static_branches():
        sel = tcf.switch_case(torch.tensor(index), tb, td)

    def traced(i, a):
        b_, d_ = build(a, lambda v: (lambda: v * 0.0 + 9.0))
        return jcf.switch_case(i, b_, d_)
    _close(sel, _jit(traced, np.asarray(index, np.int32), A))


def test_while_loop_eager_and_under_static_branches():
    """Eagerly, and under static_branches() (the capture contract on the
    CPU, which has no graph to capture into: the CPU predicate is read
    on the host), the loop equals the JAX op's lax.while_loop. On the
    card a capture runs it as a conditional WHILE node (chip_smoke.py's
    graph_while phase)."""
    def cond_fn(i, x):
        return i < 4

    def body(i, x):
        return i + 1, x * 1.5
    ji, jx = jcf.while_loop(cond_fn, body, [jp.to_tensor(0),
                                            jp.to_tensor(A)])
    i, x = tcf.while_loop(cond_fn, body, [torch.tensor(0),
                                          torch.from_numpy(A)])
    assert int(i) == int(ji.numpy()) == 4
    _close(x, jx.numpy())
    with tcf.static_branches():
        si, sx = tcf.while_loop(cond_fn, body, [torch.tensor(0),
                                                torch.from_numpy(A)])
    assert int(si) == 4
    _close(sx, jx.numpy())
    assert tcf.launches["graph_while_set_condition"] == 0


def test_while_loop_refuses_carries_that_require_grad_under_capture():
    """lax.while_loop has no reverse mode: under the capture contract a
    carry that requires grad raises a clear error (eagerly the host loop
    stays differentiable, as before)."""
    x = torch.from_numpy(A).requires_grad_()

    def body(i, v):
        return i + 1, v * 1.5
    with tcf.static_branches(), pytest.raises(RuntimeError,
                                              match="reverse mode"):
        tcf.while_loop(lambda i, v: i < 3, body, [torch.tensor(0), x])
    with tcf.static_branches(), torch.no_grad():
        tcf.while_loop(lambda i, v: i < 3, body, [torch.tensor(0), x])
    _, y = tcf.while_loop(lambda i, v: i < 3, body, [torch.tensor(0), x])
    y.sum().backward()
    _close(x.grad, np.full_like(A, 1.5 ** 3))


def test_bounded_while_loop_values_and_grads():
    def cond_fn(i, x):
        return i < 3

    def body(i, x):
        return i + 1, x * x * 0.5 + 0.1

    t = torch.from_numpy(A).requires_grad_(True)
    i, x = tcf.bounded_while_loop(cond_fn, body, [torch.tensor(0), t], 6)
    (g,) = torch.autograd.grad(x.sum(), t)
    ji, jx = jcf.bounded_while_loop(cond_fn, body, [jp.to_tensor(0),
                                                    jp.to_tensor(A)], 6)
    assert int(i) == int(ji.numpy()) == 3
    _close(x.detach(), jx.numpy())
    r = t
    for _ in range(3):
        r = body(0, r)[1]
    _close(g, torch.autograd.grad(r.sum(), t)[0])


def test_fori_loop_and_scan():
    got = tcf.fori_loop(1, 5, lambda i, v: v * 0.9 + i.to(v.dtype),
                        torch.from_numpy(A))
    want = jcf.fori_loop(1, 5, lambda i, v: v * 0.9 + i.astype("float32"),
                         jp.to_tensor(A))
    _close(got, want.numpy())

    t = torch.from_numpy(A).requires_grad_(True)

    def step(c, x):
        c = c * 0.5 + x
        return c, c * 2.0
    carry, ys = tcf.scan(step, torch.zeros(4), t)
    (g,) = torch.autograd.grad(ys.sum() + carry.sum(), t)
    jc, jys = jcf.scan(step, jp.to_tensor(np.zeros(4, np.float32)),
                       jp.to_tensor(A))
    _close(carry.detach(), jc.numpy())
    _close(ys.detach(), jys.numpy())
    c, total = torch.zeros(4), 0.0
    for row in t:
        c, y = step(c, row)
        total = total + y.sum()
    _close(g, torch.autograd.grad(total + c.sum(), t)[0])

"""The port's Program passes (twin of tests/test_program_passes.py).

Contract per pass, as in the JAX package: the op count drops on a
program built with the targeted redundancy, and Executor.run's fetches
are bit-identical before and after. Each program is also run through
the JAX package's Executor on the same numpy feed: the port's fetches
agree with it to 1e-5. The port's graph records torch ops (paddle.scale
is a multiply and an add), so the counts are the port's own; the quant
passes raise until quant's QAT rewrite is ported (ROADMAP.md item 18.6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.static as jstatic
import paddle_tpu_torch as pt
import paddle_tpu_torch.static as static
from paddle_tpu_torch.static import PassBuilder, apply_pass, program_guard
from paddle_tpu_torch.static.program import Program

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    pt.set_device("cpu")


def _run(prog, feed, fetch):
    return static.Executor(pt.CPUPlace()).run(prog, feed=feed,
                                              fetch_list=fetch)


def _jax(build, feed):
    """build(paddle, data) -> the fetch var, recorded in a JAX Program
    and run by its Executor."""
    main = jstatic.Program()
    with jstatic.program_guard(main):
        y = build(paddle, jstatic.data)
    return jstatic.Executor().run(main, feed=feed, fetch_list=[y])[0]


def _port(build):
    main = Program()
    with program_guard(main):
        y = build(pt, static.data)
    return main, y


def _const_chain(lib, data):
    x = data("x", [2, 3], "float32")
    c = lib.to_tensor(np.full((2, 3), 2.0, np.float32))
    k = lib.sqrt(lib.scale(c, scale=3.0, bias=1.0))
    return lib.add(x, k)


def test_constant_folding_pass():
    main, y = _port(_const_chain)
    n0 = len(main.ops)
    # captured buffers are live state: nothing folds by default
    assert len(apply_pass(main, "constant_folding_pass").ops) == n0
    folded = apply_pass(main, "constant_folding_pass", freeze_buffers=True)
    assert len(folded.ops) < n0
    assert any("add" in n.op_type for n in folded.ops)
    feed = {"x": np.ones((2, 3), np.float32)}
    got = _run(folded, feed, [y.name])[0]
    np.testing.assert_array_equal(_run(main, feed, [y.name])[0], got)
    np.testing.assert_allclose(got, _jax(_const_chain, feed), rtol=TOL)


def _two_exps(lib, data):
    x = data("x", [2, 3], "float32")
    return lib.add(lib.exp(x), lib.exp(x))


def test_cse_pass():
    main, y = _port(_two_exps)
    deduped = apply_pass(main, "cse_pass")
    assert len(deduped.ops) == len(main.ops) - 1
    feed = {"x": np.random.RandomState(0).randn(2, 3).astype(np.float32)}
    got = _run(deduped, feed, [y.name])[0]
    np.testing.assert_array_equal(_run(main, feed, [y.name])[0], got)
    np.testing.assert_allclose(got, _jax(_two_exps, feed), rtol=TOL)


def _identities(lib, data):
    x = data("x", [2, 3], "float32")
    a = lib.scale(x, scale=1.0, bias=0.0)
    b = lib.reshape(a, [2, 3])
    return lib.tanh(b.astype("float32"))


def test_identity_elimination_pass():
    main, y = _port(_identities)
    slim = apply_pass(main, "identity_elimination_pass")
    assert len(slim.ops) <= len(main.ops) - 2
    assert [n.op_type for n in slim.ops] == ["torch.tanh"]
    feed = {"x": np.random.RandomState(1).randn(2, 3).astype(np.float32)}
    got = _run(slim, feed, [y.name])[0]
    np.testing.assert_array_equal(_run(main, feed, [y.name])[0], got)
    np.testing.assert_allclose(got, _jax(_identities, feed), rtol=TOL)


def _dead_tail(lib, data):
    x = data("x", [2, 3], "float32")
    y = lib.tanh(x)
    lib.sqrt(lib.exp(lib.scale(x, scale=2.0)))
    return y


def test_dead_code_elimination_pass():
    main, y = _port(_dead_tail)
    live = apply_pass(main, "dead_code_elimination_pass", targets=[y])
    assert len(live.ops) < len(main.ops)
    feed = {"x": np.random.RandomState(2).randn(2, 3).astype(np.float32)}
    got = _run(live, feed, [y.name])[0]
    np.testing.assert_array_equal(_run(main, feed, [y.name])[0], got)
    np.testing.assert_allclose(got, _jax(_dead_tail, feed), rtol=TOL)


def _pipeline(lib, data):
    x = data("x", [2, 2], "float32")
    a = lib.scale(x, scale=1.0, bias=0.0)
    e1, e2 = lib.exp(a), lib.exp(a)
    c = lib.to_tensor(np.ones((2, 2), np.float32))
    k = lib.scale(c, scale=2.0)
    return lib.add(lib.add(e1, e2), k)


def test_pass_builder_pipeline_and_registry():
    from paddle_tpu_torch.static import PASS_REGISTRY
    for name in ("constant_folding_pass", "cse_pass",
                 "identity_elimination_pass", "dead_code_elimination_pass"):
        assert name in PASS_REGISTRY
    main, y = _port(_pipeline)
    builder = PassBuilder()
    builder.append_pass("identity_elimination_pass") \
           .append_pass("cse_pass") \
           .append_pass("constant_folding_pass")
    builder.append_pass("dead_code_elimination_pass")
    assert len(builder.all_passes()) == 4
    builder.remove_pass("dead_code_elimination_pass")
    out = builder.apply_all(main, freeze_buffers=True)
    assert len(out.ops) <= len(main.ops) - 3
    feed = {"x": np.random.RandomState(3).randn(2, 2).astype(np.float32)}
    got = _run(out, feed, [y.name])[0]
    np.testing.assert_array_equal(_run(main, feed, [y.name])[0], got)
    np.testing.assert_allclose(got, _jax(_pipeline, feed), rtol=TOL)
    with pytest.raises(KeyError, match="unknown pass"):
        builder.append_pass("nope_pass")


def _positional_bias(lib, data):
    x = data("x", [2, 2], "float32")
    return lib.tanh(lib.scale(x, 1.0, 5.0))


def test_identity_elimination_keeps_positional_bias_scale():
    """scale(x, 1.0, 5.0) passed positionally is not an identity: its add
    of 5 survives the pass."""
    main, y = _port(_positional_bias)
    slim = apply_pass(main, "identity_elimination_pass")
    assert any("add" in n.op_type for n in slim.ops)
    feed = {"x": np.zeros((2, 2), np.float32)}
    got = _run(slim, feed, [y.name])[0]
    np.testing.assert_array_equal(_run(main, feed, [y.name])[0], got)
    np.testing.assert_allclose(got, _jax(_positional_bias, feed), rtol=TOL)


def test_cse_keeps_var_grad_targets():
    main = Program()
    with program_guard(main):
        x = static.data("x", [2, 2], "float32")
        pt.exp(x)
        t = pt.exp(x)
        (g,) = static.gradients([t], [x])
    deduped = apply_pass(main, "cse_pass")
    feed = {"x": np.random.RandomState(6).randn(2, 2).astype(np.float32)}
    np.testing.assert_allclose(_run(deduped, feed, [g.name])[0],
                               np.exp(feed["x"]), rtol=1e-6)


@pytest.mark.parametrize("name", ["quantization_transform_pass",
                                  "quantization_freeze_pass"])
def test_quant_passes_cite_their_item(name):
    main = Program()
    with program_guard(main):
        static.data("x", [2, 4], "float32") * 2.0
    with pytest.raises(NotImplementedError, match="18.6"):
        apply_pass(main, name)


def test_dropout_eval_is_an_identity():
    main = Program()
    with program_guard(main):
        x = static.data("x", [4, 4], "float32")
        y = pt.tanh(pt.nn.functional.dropout(x, p=0.5, training=True))
    test_prog = main.clone(for_test=True)
    slim = apply_pass(test_prog, "identity_elimination_pass")
    assert [n.op_type for n in slim.ops] == ["torch.tanh"]
    feed = {"x": np.random.RandomState(8).randn(4, 4).astype(np.float32)}
    np.testing.assert_array_equal(_run(slim, feed, [y.name])[0],
                                  _run(test_prog, feed, [y.name])[0])
    np.testing.assert_allclose(_run(slim, feed, [y.name])[0],
                               np.tanh(feed["x"]), rtol=1e-6)


def test_passes_never_touch_train_bookkeeping():
    main = Program()
    with program_guard(main):
        x = static.data("x", [4, 3], "float32")
        lin = pt.nn.Linear(3, 2)
        out = lin(x)
        pt.exp(out)
        loss = pt.mean(out * out)
        pt.optimizer.SGD(learning_rate=0.1,
                         parameters=lin.parameters()).minimize(loss)
    slim = apply_pass(main, "dead_code_elimination_pass", targets=[loss])
    assert len(slim.ops) < len(main.ops)
    feed = {"x": np.random.RandomState(4).randn(4, 3).astype(np.float32)}
    l0 = [float(_run(main, feed, [loss.name])[0]) for _ in range(2)]
    l1 = [float(_run(slim, feed, [loss.name])[0]) for _ in range(2)]
    assert l0[1] < l0[0] and l1[1] < l1[0]
    w = lin.weight.detach().clone()
    assert not torch.equal(w, torch.zeros_like(w))

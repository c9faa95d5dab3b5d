"""The port's static Program and Executor against the JAX package's.

Twins of tests/test_jit_static.py (the Program cases),
test_program_serialization.py, test_program_train_resume.py and
test_static_compat.py: the same weights go into both packages (by name,
models/convert.py load_jax_params) and the same numpy feeds, made from a
seed, through each package's Program and Executor, on the CPU (the port's
Executor with CPUPlace(), where its named ops run their plain versions).
Forwards agree to 1e-5; static train loops to 1e-5 relative over three
steps. A tiny ERNIE (2 layers, hidden 64) Program records flash attention
as one node and its Executor output matches the JAX Program's to 1e-5.
Serialization round-trips resume training bit-identically.
"""
import pickle
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.static as jstatic
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
import paddle_tpu_torch.static as static
from paddle_tpu_torch.core.enforce import EnforceNotMet, NotFoundError
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.static.program import SYMBOLIC_DIM, Var

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    torch.set_num_threads(n)


def _exe():
    return static.Executor(pt.CPUPlace())


class _JaxMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(4, 8)
        self.fc2 = jnn.Linear(8, 2)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class _MLP(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(4, 8)
        self.fc2 = nn.Linear(8, 2)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


def _pair(seed=3):
    paddle.seed(seed)
    jm = _JaxMLP()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = _MLP()
    load_jax_params(tm, state)
    return jm, tm


def _feed(b=3, seed=0):
    return np.random.RandomState(seed).randn(b, 4).astype(np.float32)


def _mlp_programs(jm, tm, shape=(None, 4)):
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jx = jstatic.data("x", list(shape), "float32")
        jout = jm(jx)
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", list(shape), "float32")
        out = tm(x)
    return (jmain, jout), (main, out)


def test_executor_infer_matches_jax_program():
    jm, tm = _pair()
    (jmain, jout), (main, out) = _mlp_programs(jm, tm)
    feed = {"x": _feed()}
    want = jstatic.Executor().run(jmain, feed=feed, fetch_list=[jout])[0]
    got = _exe().run(main, feed=feed, fetch_list=[out])[0]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert [n.op_type for n in main.ops] == [
        "torch.addmm", "torch.relu", "torch.addmm"]


@pytest.mark.parametrize("batch", [3, 7])
def test_symbolic_batch_dim_no_specialization(batch):
    """data(shape=[None, ...]) does not specialise batch-1 semantics: the
    squeeze keeps the batch axis at every batch size, as the JAX
    Program's."""
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [None, 1, 4], "float32")
        assert tuple(x.shape) == (SYMBOLIC_DIM, 1, 4)
        out = pt.squeeze(x, axis=1) * 2.0
    jprog = jstatic.Program()
    with jstatic.program_guard(jprog):
        jx = jstatic.data("x", [None, 1, 4], "float32")
        jout = paddle.squeeze(jx, axis=1) * 2.0
    arr = np.random.RandomState(0).randn(batch, 1, 4).astype(np.float32)
    (res,) = _exe().run(prog, feed={"x": arr}, fetch_list=[out])
    (want,) = jstatic.Executor().run(jprog, feed={"x": arr},
                                     fetch_list=[jout])
    assert res.shape == (batch, 4)
    np.testing.assert_allclose(res, want, rtol=TOL)


def test_symbolic_dim_leak_warns():
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [None, 4], "float32")
        leaked = int(x.shape[0])
        assert leaked == SYMBOLIC_DIM
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            pt.reshape(x, [leaked, 4])
    assert any("symbolic-dim placeholder" in str(m.message) for m in w)


def test_train_loop_matches_jax_program():
    """SGD on an MSE loss: three Executor steps of each package from the
    same weights, losses and weights within 1e-5 relative."""
    jm, tm = _pair(14)
    rng = np.random.RandomState(7)
    xs = rng.rand(32, 4).astype(np.float32)
    ys = rng.rand(32, 2).astype(np.float32)
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jx = jstatic.data("x", [None, 4])
        jy = jstatic.data("y", [None, 2])
        jloss = JF.mse_loss(jm(jx), jy)
        paddle.optimizer.SGD(learning_rate=0.1).minimize(jloss)
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [None, 4])
        y = static.data("y", [None, 2])
        loss = F.mse_loss(tm(x), y)
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    jexe, exe = jstatic.Executor(), _exe()
    for _ in range(3):
        (jl,) = jexe.run(jmain, feed={"x": xs, "y": ys}, fetch_list=[jloss])
        (tl,) = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        np.testing.assert_allclose(tl, jl, rtol=TOL)
    for name, p in tm.state_dict().items():
        want = np.asarray(jm.state_dict()[name].numpy())
        np.testing.assert_allclose(p.numpy(), want, rtol=TOL, atol=1e-7)


def test_append_backward_fetch_grads_match_jax():
    jm, tm = _pair(5)
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jx = jstatic.data("x", [3, 4])
        jpairs = jstatic.append_backward(jm(jx).sum())
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [3, 4])
        pairs = static.append_backward(tm(x).sum())
    feed = {"x": _feed()}
    want = jstatic.Executor().run(jmain, feed=feed,
                                  fetch_list=[g for _, g in jpairs])
    got = _exe().run(main, feed=feed, fetch_list=[g for _, g in pairs])
    assert [g.name.endswith("@GRAD") for _, g in pairs] == [True] * 4
    for a, b in zip(sorted(got, key=np.shape), sorted(want, key=np.shape)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


# -- tiny ERNIE ---------------------------------------------------------------

def _ernie_pair(dropout):
    from paddle_tpu.models import ErnieConfig as JaxConfig
    from paddle_tpu.models import ErnieForPretraining as JaxErnie
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    kw = dict(hidden_dropout_prob=dropout,
              attention_probs_dropout_prob=dropout)
    paddle.seed(0)
    jm = JaxErnie(JaxConfig.tiny(**kw))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig.tiny(**kw), device="cpu")
    load_jax_params(tm, state)
    return jm, tm


def test_tiny_ernie_program_flash_node_matches_jax():
    jm, tm = _ernie_pair(0.0)
    jm.eval()
    tm.eval()
    ids = np.random.RandomState(0).randint(0, 1024, (2, 32)).astype(
        np.int64)
    main = static.Program()
    with static.program_guard(main):
        logits, nsp = tm(static.data("ids", [2, 32], "int64"))
    flash = [n for n in main.ops if n.op_type
             == "paddle_tpu_torch.nn.functional.attention.flash_attention"]
    assert len(flash) == 2                 # one node a layer
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain):
        jl, jn = jm(jstatic.data("ids", [2, 32], "int64"))
    assert sum(n.op_type.startswith("flash_attention")
               for n in jmain.ops) == 2
    want = jstatic.Executor().run(jmain, feed={"ids": ids},
                                  fetch_list=[jl, jn])
    got = _exe().run(main, feed={"ids": ids}, fetch_list=[logits, nsp])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_tiny_ernie_program_trains_with_dropout():
    """A training Program with dropout 0.1 (hidden dropout and the flash
    node's attention dropout drawn at each run): the loss falls over
    AdamW steps, one run seed repeats a run exactly, and the eval clone
    is deterministic and equal to the eager eval forward's loss."""
    from paddle_tpu_torch.models import ErnieForPretraining
    _, tm = _ernie_pair(0.1)
    tm.train()
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 1024, (2, 32)).astype(np.int64)
    labels = rng.randint(0, 1024, (2, 32)).astype(np.int64)
    main = static.Program()
    with static.program_guard(main):
        x = static.data("ids", [2, 32], "int64")
        y = static.data("labels", [2, 32], "int64")
        loss = ErnieForPretraining.pretraining_loss(tm(x), y)
        forward = main.clone()
        test_prog = main.clone(for_test=True)
        pt.optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                           weight_decay=0.01).minimize(loss)
    exe = _exe()
    feed = {"ids": ids, "labels": labels}
    e1, e2 = (exe.run(test_prog, feed, [loss])[0] for _ in range(2))
    tm.eval()
    with torch.no_grad():
        eager = ErnieForPretraining.pretraining_loss(
            tm(torch.from_numpy(ids)), torch.from_numpy(labels))
    tm.train()
    assert e1 == e2
    np.testing.assert_allclose(e1, eager.numpy(), rtol=TOL)
    a, b, c = (exe.run(forward, feed, [loss], seed=s)[0] for s in (5, 5, 6))
    assert a == b and a != c
    losses = [float(exe.run(main, feed, [loss], seed=s)[0])
              for s in range(6)]
    assert losses[-1] < losses[0]


def test_program_replays_recorded_ops_in_order():
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2, 3], "float32")
        y = (x * 2.0).exp().sum(dim=1)
    assert [n.op_type for n in prog.ops] == [
        "torch.Tensor.mul", "torch.Tensor.exp", "torch.Tensor.sum"]
    arr = np.random.RandomState(2).randn(2, 3).astype(np.float32)
    (got,) = _exe().run(prog, {"x": arr}, [y])
    np.testing.assert_allclose(got, np.exp(arr * 2).sum(1), rtol=TOL)


# -- serialization, prune, clone ---------------------------------------------

def _mlp_loss_program(seed=3):
    jm, tm = _pair(seed)
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [None, 4], "float32")
        out = tm(x)
        loss = out.mean()
    return main, out, loss, tm


def test_save_load_run_equivalence(tmp_path):
    main, out, _, _ = _mlp_loss_program()
    feed = {"x": _feed()}
    ref = _exe().run(main, feed=feed, fetch_list=[out])[0]
    path = str(tmp_path / "prog.pdmodel")
    main.save(path)
    loaded = static.Program.load(path)
    got = _exe().run(loaded, feed=feed,
                     fetch_list=[loaded.var_by_name(out.name)])[0]
    np.testing.assert_array_equal(ref, got)


def test_roundtrip_without_params():
    main, _, _, _ = _mlp_loss_program()
    loaded = static.Program.from_bytes(main.to_bytes(include_params=False))
    for t in loaded.params.values():
        assert float(t.detach().abs().sum()) == 0.0
    assert len(loaded.ops) == len(main.ops)


def test_unregistered_op_rejected():
    """A callable with no stable name (here an autograd Function defined
    in a test function) records, runs, and refuses to serialize."""
    class Double(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2
    main = static.Program()
    with static.program_guard(main, static.Program()):
        y = Double.apply(static.data("x", [2], "float32"))
    (got,) = _exe().run(main, {"x": np.ones(2, np.float32)}, [y])
    np.testing.assert_array_equal(got, [2.0, 2.0])
    with pytest.raises(EnforceNotMet, match="not a registered op"):
        main.to_bytes()


def test_jax_program_blob_refused():
    jprog = jstatic.Program()
    with jstatic.program_guard(jprog):
        jstatic.data("x", [2], "float32") * 2.0
    with pytest.raises(EnforceNotMet, match="not a paddle_tpu_torch"):
        static.Program.from_bytes(jprog.to_bytes())


def test_prune_drops_dead_branch():
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [4], "float32")
        kept = x * 2.0
        (x + 1.0).sum()
    pruned = main.prune(kept)
    assert len(pruned.ops) < len(main.ops)
    got = _exe().run(pruned, {"x": np.arange(4, dtype=np.float32)},
                     [pruned.vars[kept.var_id]])[0]
    np.testing.assert_allclose(got, np.arange(4) * 2.0)


def test_dropout_flips_to_identity_in_eval_clone():
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [32, 16], "float32")
        y = F.dropout(x, p=0.5, training=True)
    test_prog = main.clone(for_test=True)
    feed = {"x": np.ones((32, 16), np.float32)}
    train_out = _exe().run(main, feed, [main.vars[y.var_id]])[0]
    eval_out = _exe().run(test_prog, feed, [test_prog.vars[y.var_id]])[0]
    assert (train_out == 0).any()
    np.testing.assert_allclose(eval_out, 1.0)


def test_static_dropout_mask_varies_per_run():
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [16, 16], "float32")
        y = F.dropout(x, p=0.5, training=True)
        q = static.data("q", [2, 8, 2, 8], "float32")
        z = F.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                           training=True)
        w = F.flash_attention(q, q, q, dropout=0.5, training=True)
    feed = {"x": np.ones((16, 16), np.float32),
            "q": np.random.RandomState(3).randn(2, 8, 2, 8).astype(
                np.float32)}
    exe = _exe()
    outs = [exe.run(main, feed, [y, z, w]) for _ in range(2)]
    for a, b in zip(*outs):
        assert np.abs(a - b).max() > 1e-6
    again = [exe.run(main, feed, [y, z, w], seed=7) for _ in range(2)]
    for a, b in zip(*again):
        np.testing.assert_array_equal(a, b)


def test_attention_dropout_flips_in_eval_clone():
    main = static.Program()
    with static.program_guard(main, static.Program()):
        q = static.data("q", [2, 8, 2, 8], "float32")
        y = F.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                           training=True)
        z = F.flash_attention(q, q, q, dropout=0.5, training=True)
    test_prog = main.clone(for_test=True)
    feed = {"q": np.random.RandomState(0).randn(2, 8, 2, 8).astype(
        np.float32)}
    qt = torch.from_numpy(feed["q"])
    want = {y.var_id: F.scaled_dot_product_attention(qt, qt, qt),
            z.var_id: F.flash_attention(qt, qt, qt)}
    for var in (y, z):
        a, b = (_exe().run(test_prog, feed,
                           [test_prog.vars[var.var_id]])[0]
                for _ in range(2))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, want[var.var_id].numpy(), rtol=TOL,
                                   atol=1e-6)


def test_batchnorm_running_stats_and_eval_clone_match_jax():
    """Training-mode BatchNorm in a Program writes its running statistics
    at each run (the program's _buffer_writes), as the JAX Executor's
    write-back does; the eval clone normalises with them."""
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain, jstatic.Program()):
        jx = jstatic.data("x", [8, 4], "float32")
        jbn = jnn.BatchNorm1D(4)
        jbn._mean.set_value(np.full(4, 5.0, np.float32))
        jbn._variance.set_value(np.full(4, 4.0, np.float32))
        jy = jbn(jx)
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [8, 4], "float32")
        bn = nn.BatchNorm1D(4)
        bn._mean.set_value(np.full(4, 5.0, np.float32))
        bn._variance.set_value(np.full(4, 4.0, np.float32))
        y = bn(x)
    assert len(main._buffer_writes) == 2
    test_prog = main.clone(for_test=True)
    feed = {"x": np.random.RandomState(1).randn(8, 4).astype(
        np.float32) * 10 + 5}
    eval_out = _exe().run(test_prog, feed, [test_prog.vars[y.var_id]])[0]
    np.testing.assert_allclose(eval_out, (feed["x"] - 5.0) / np.sqrt(
        4.0 + 1e-5), rtol=1e-4, atol=1e-4)
    for _ in range(2):
        got = _exe().run(main, feed, [y])[0]
        want = jstatic.Executor().run(jmain, feed, [jy])[0]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bn._mean.numpy(), np.asarray(
        jbn._mean.numpy()), rtol=TOL)
    np.testing.assert_allclose(bn._variance.numpy(), np.asarray(
        jbn._variance.numpy()), rtol=TOL)
    eval2 = _exe().run(test_prog, feed, [test_prog.vars[y.var_id]])[0]
    assert not np.allclose(eval2, eval_out, atol=1e-3)


# -- gradients ------------------------------------------------------------------

def test_gradients_wrt_feed():
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [3], "float32")
        (gx,) = static.gradients((x * x).sum(), x)
    got = _exe().run(main, {"x": np.array([1.0, 2.0, 3.0], np.float32)},
                     [gx])[0]
    np.testing.assert_allclose(got, [2.0, 4.0, 6.0])


def test_gradients_wrt_intermediate_cuts_graph():
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [3], "float32")
        h = x * 3.0
        (gh,) = static.gradients((h * h).sum(), h)
    got = _exe().run(main, {"x": np.array([1.0, 2.0, 3.0], np.float32)},
                     [gh])[0]
    np.testing.assert_allclose(got, [6.0, 12.0, 18.0])


def test_gradients_with_target_gradients():
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [2], "float32")
        (gx,) = static.gradients(x * 2.0, x, target_gradients=np.array(
            [10.0, 1.0], np.float32))
    got = _exe().run(main, {"x": np.zeros(2, np.float32)}, [gx])[0]
    np.testing.assert_allclose(got, [20.0, 2.0])


def test_gradients_no_grad_set():
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [2], "float32")
        z = static.data("z", [2], "float32")
        gs = static.gradients((x * z).sum(), [x, z], no_grad_set=["z"])
    assert len(gs) == 1 and gs[0].name == "x@GRAD"


def test_append_backward_rejects_nonscalar():
    main = static.Program()
    with static.program_guard(main, static.Program()):
        x = static.data("x", [3], "float32")
        with pytest.raises(EnforceNotMet):
            static.append_backward(x * 2.0)


def test_append_backward_no_grad_set():
    main, _, loss, tm = _mlp_loss_program()
    pairs = static.append_backward(loss, no_grad_set=[tm.fc1.bias])
    bias_var = next(main.vars[vid].name for vid, p in main.params.items()
                    if p is tm.fc1.bias)
    names = [p.name for p, _ in pairs]
    assert bias_var not in names and len(names) == 3


# -- train resume -------------------------------------------------------------

RNG = np.random.RandomState(11)
X = RNG.randn(8, 4).astype(np.float32)
Y = RNG.randn(8, 1).astype(np.float32)
W0 = RNG.randn(4, 1).astype(np.float32) * 0.1


def _build_train_program():
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 4])
        y = static.data("y", [None, 1])
        w = pt.create_parameter([4, 1], "float32")
        w.set_value(W0)
        b = pt.create_parameter([1], "float32")
        b.set_value(np.zeros(1, np.float32))
        loss = pt.mean((x @ w + b - y) ** 2)
        pt.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, loss


def test_adam_train_program_matches_jax():
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain):
        jx = jstatic.data("x", [None, 4])
        jy = jstatic.data("y", [None, 1])
        w = paddle.create_parameter([4, 1], "float32")
        w.set_value(W0)
        b = paddle.create_parameter([1], "float32")
        b.set_value(np.zeros(1, np.float32))
        jloss = paddle.mean((jx @ w + b - jy) ** 2)
        paddle.optimizer.Adam(learning_rate=0.05).minimize(jloss)
    main, loss = _build_train_program()
    jexe, exe = jstatic.Executor(), _exe()
    for _ in range(3):
        (jl,) = jexe.run(jmain, {"x": X, "y": Y}, [jloss])
        (tl,) = exe.run(main, {"x": X, "y": Y}, [loss])
        np.testing.assert_allclose(tl, jl, rtol=TOL)


def test_save_load_train_continues_bit_identically():
    main, loss = _build_train_program()
    exe = _exe()
    feed = {"x": X, "y": Y}
    for _ in range(3):
        exe.run(main, feed, [loss])
    blob = main.to_bytes()
    control = [exe.run(main, feed, [loss])[0] for _ in range(3)]
    control_params = [p.detach().numpy().copy()
                      for p in main.params.values()]
    p2 = static.Program.from_bytes(blob)
    assert type(p2._optimize[0]).__name__ == "Adam"
    assert p2._opt_state is not None
    loss2 = p2.vars[loss.var_id]
    resumed = [_exe().run(p2, feed, [loss2])[0] for _ in range(3)]
    for c, r in zip(control, resumed):
        np.testing.assert_array_equal(c, r)
    for c, r in zip(control_params, p2.params.values()):
        np.testing.assert_array_equal(c, r.detach().numpy())


def test_fresh_program_trains_after_load():
    main, loss = _build_train_program()
    p2 = static.Program.from_bytes(main.to_bytes())
    exe = _exe()
    losses = [float(exe.run(p2, {"x": X, "y": Y},
                            [p2.vars[loss.var_id]])[0]) for _ in range(8)]
    assert losses[-1] < losses[0] * 0.9


def test_gradients_specs_survive_roundtrip():
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [3, 2])
        (gx,) = static.gradients(pt.sum(pt.tanh(x * 2.0)), x)
    p2 = static.Program.from_bytes(main.to_bytes())
    xv = RNG.randn(3, 2).astype(np.float32)
    (got,) = _exe().run(p2, {"x": xv}, [p2.vars[gx.var_id]])
    np.testing.assert_allclose(got, 2.0 / np.cosh(2.0 * xv) ** 2,
                               rtol=1e-5, atol=1e-6)


def test_uncomputable_fetch_raises_not_found():
    main = static.Program()
    with static.program_guard(main):
        pt.exp(static.data("x", [2, 2]))
    orphan = Var(main, "orphan", [2, 2], "float32")
    with pytest.raises(NotFoundError, match="not producible"):
        _exe().run(main, {"x": X[:2, :2]}, [orphan])


def test_grad_fetch_without_backward_section_raises():
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [2, 2])
        w = pt.create_parameter([2, 2], "float32")
        w.set_value(np.ones((2, 2), np.float32))
        pairs = static.append_backward(pt.sum(x * w))
    d = pickle.loads(main.to_bytes())
    d["grad_target"], d["grad_pairs"], d["var_grads"] = None, [], []
    p2 = static.Program.from_bytes(pickle.dumps(d, protocol=4))
    with pytest.raises(NotFoundError, match="grad var"):
        _exe().run(p2, {"x": X[:2, :2]}, [p2.vars[pairs[0][1].var_id]])


# -- compat -------------------------------------------------------------------

def test_scope_finds_program_params_after_run():
    main, out, _, tm = _mlp_loss_program()
    scope = static.Scope()
    with static.scope_guard(scope):
        _exe().run(main, {"x": _feed()}, [out])
        name = next(main.vars[vid].name for vid, p in main.params.items()
                    if p is tm.fc1.weight)
        view = static.global_scope().find_var(name)
    np.testing.assert_array_equal(view.get_tensor(), tm.fc1.weight.detach().numpy())


def test_static_save_load_roundtrip(tmp_path):
    main, out, _, tm = _mlp_loss_program()
    feed = {"x": _feed()}
    ref = _exe().run(main, feed, [out])[0]
    static.save(main, str(tmp_path / "m"))
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
    assert not np.allclose(_exe().run(main, feed, [out])[0], ref)
    static.load(main, str(tmp_path / "m"))
    np.testing.assert_array_equal(_exe().run(main, feed, [out])[0], ref)


def test_compiled_and_parallel_executor_delegate():
    main, out, _, _ = _mlp_loss_program()
    feed = {"x": _feed()}
    ref = _exe().run(main, feed, [out])[0]
    cp = static.CompiledProgram(main).with_data_parallel(loss_name=None)
    np.testing.assert_array_equal(_exe().run(cp, feed, [out])[0], ref)
    pe = static.ParallelExecutor(use_cuda=False, main_program=main)
    np.testing.assert_array_equal(pe.run([out.name], feed=feed)[0], ref)
    bs = static.BuildStrategy()
    assert bs.reduce_strategy == static.BuildStrategy.ReduceStrategy.AllReduce


def test_py_func_runs_host_callback_with_grad():
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [3], "float32")
        x.stop_gradient = False
        y = static.py_func(lambda a: a * 3.0, x, ([3], "float32"),
                           backward_func=lambda a, g: g * 3.0)
        (gx,) = static.gradients(pt.sum(y), x)
    got = _exe().run(main, {"x": np.arange(3, dtype=np.float32)}, [y, gx])
    np.testing.assert_allclose(got[0], [0.0, 3.0, 6.0])
    np.testing.assert_allclose(got[1], [3.0, 3.0, 3.0])


def test_auc_and_accuracy_match_jax():
    rng = np.random.RandomState(4)
    probs = rng.rand(64, 2).astype(np.float32)
    labels = rng.randint(0, 2, (64, 1)).astype(np.int64)
    want = float(jstatic.auc(paddle.to_tensor(probs),
                             paddle.to_tensor(labels)).numpy())
    got = float(static.auc(torch.from_numpy(probs), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=TOL)
    ja = float(jstatic.accuracy(paddle.to_tensor(probs),
                                paddle.to_tensor(labels)).numpy())
    ta = float(static.accuracy(torch.from_numpy(probs),
                               torch.from_numpy(labels)))
    assert ja == ta


def test_places_and_static_mode_switch():
    assert static.cpu_places(2) == [pt.CPUPlace(), pt.CPUPlace()]
    from paddle_tpu_torch.static import program
    pt.enable_static()
    try:
        assert program._static_mode
    finally:
        pt.disable_static()
    assert not program._static_mode

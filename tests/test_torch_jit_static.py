"""The port's to_static, StaticFunction, jit.save/jit.load and the jit
compatibility layer against the JAX package's (twin of
tests/test_jit_static.py's to_static and jit cases).

The same weights go into both packages (by name) and the same numpy
inputs, made from a seed, through each package's to_static function and
jit.load'ed layer; forwards agree to 1e-5, gradients to 1e-4 as the JAX
test holds them. On the CPU a StaticFunction runs its converted function
eagerly (the port's CUDA-graph replay runs only on the card:
chip_smoke.py's predictor and to_static_while phases). The port's
.pdmodel is a torch.export program; the .pdiparams of a JAX jit.save
load into the port and give the JAX outputs, while the JAX .pdmodel is
refused with a message that says so.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import jit
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.jit import InputSpec, to_static
from paddle_tpu_torch.models import load_jax_params

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    torch.set_num_threads(n)


class _JaxMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(4, 16)
        self.fc2 = jnn.Linear(16, 3)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class _MLP(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(4, 16)
        self.fc2 = nn.Linear(16, 3)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


def _pair(seed=10):
    paddle.seed(seed)
    jm = _JaxMLP()
    tm = _MLP()
    load_jax_params(tm, {k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jm, tm


def _x(b=5, seed=0):
    return np.random.RandomState(seed).randn(b, 4).astype(np.float32)


def test_to_static_matches_eager_and_jax():
    jm, tm = _pair()
    x = _x()
    eager = tm(torch.from_numpy(x)).detach().numpy()
    got = to_static(tm)(torch.from_numpy(x)).detach().numpy()
    want = paddle.jit.to_static(jm)(paddle.to_tensor(x)).numpy()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_to_static_function():
    @to_static
    def f(a, b):
        return pt.matmul(a, b) + 1.0
    rng = np.random.RandomState(1)
    a, b = rng.randn(2, 3).astype(np.float32), rng.randn(3, 2).astype(
        np.float32)
    np.testing.assert_allclose(
        f(torch.from_numpy(a), torch.from_numpy(b)).numpy(), a @ b + 1.0,
        atol=TOL)


def test_to_static_backward_matches_jax():
    jm, tm = _pair(11)
    x = _x()
    jloss = paddle.jit.to_static(jm)(paddle.to_tensor(x)).sum()
    jloss.backward()
    loss = to_static(tm)(torch.from_numpy(x)).sum()
    loss.backward()
    jgrads = {k: np.asarray(p.grad.numpy())
              for k, p in jm.named_parameters()}
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[k], atol=1e-4)


def test_to_static_batchnorm_buffer_writeback():
    net = nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1D(8))
    snet = to_static(net)
    before = net[1]._mean.clone()
    with torch.no_grad():
        snet(torch.randn(16, 4))
    assert not torch.allclose(before, net[1]._mean)


def test_to_static_dropout_varies_between_calls():
    sdo = to_static(nn.Dropout(0.5))
    x = torch.ones(64, 64)
    with torch.no_grad():
        a, b = sdo(x), sdo(x)
    assert not torch.equal(a, b)


def test_functionalize_takes_state_and_seed():
    _, tm = _pair(12)
    pure = jit.functionalize(tm.forward, tm)
    x = torch.from_numpy(_x())
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    state["fc2.bias"] = state["fc2.bias"] + 1.0
    out, new_state = pure(state, 0, x)
    with torch.no_grad():
        ref = tm(x) + 1.0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
    assert set(new_state) == set(state)
    assert not torch.equal(tm.fc2.bias.detach(), state["fc2.bias"])


def test_jit_save_load_matches_jax(tmp_path):
    jm, tm = _pair(13)
    spec = [InputSpec([None, 4], "float32")]
    tpath, jpath = str(tmp_path / "t" / "m"), str(tmp_path / "j" / "m")
    jit.save(tm, tpath, input_spec=spec)
    paddle.jit.save(jm, jpath, input_spec=[paddle.jit.InputSpec([None, 4])])
    loaded = jit.load(tpath)
    jl = paddle.jit.load(jpath)
    assert any("fc1" in k for k in loaded.original_state())
    for b in (2, 5):
        x = _x(b, seed=b)
        with torch.no_grad():
            got = loaded(torch.from_numpy(x)).numpy()
        want = np.asarray(jl(paddle.to_tensor(x)).numpy())
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_jax_pdiparams_load_into_the_port(tmp_path):
    """A JAX jit.save artifact: its .pdmodel is refused, its .pdiparams
    (a pickle of numpy arrays) loads and gives the JAX outputs."""
    paddle.seed(14)
    jm = _JaxMLP()
    path = str(tmp_path / "jax" / "m")
    paddle.jit.save(jm, path, input_spec=[paddle.jit.InputSpec([3, 4])])
    assert os.path.exists(path + ".pdmodel")
    with pytest.raises(EnforceNotMet, match="not a paddle_tpu_torch"):
        jit.load(path)
    loaded = jit.load(path, weights_only=True)
    tm = _MLP()
    load_jax_params(tm, {k: v.detach().numpy()
                         for k, v in loaded.original_state().items()})
    x = _x(3)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jm(paddle.to_tensor(x)).numpy(),
                               atol=TOL, rtol=TOL)


def test_export_records_flash_attention_as_one_node(tmp_path):
    """A tiny ERNIE's export: each layer's attention is one
    paddle_tpu.flash_attn_fwd node; the loaded program runs at two batch
    sizes (None dim dynamic) and matches the eager forward."""
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    pt.seed(0)
    model = ErnieForPretraining(ErnieConfig.tiny(), device="cpu").eval()
    path = str(tmp_path / "ernie" / "m")
    jit.save(to_static(model), path,
             input_spec=[InputSpec([None, 16], "int64")])
    loaded = jit.load(path)
    nodes = [n for n in loaded._exported.ep.graph.nodes
             if "flash_attn_fwd" in str(n.target)]
    assert len(nodes) == 2
    rng = np.random.RandomState(2)
    for b in (2, 3):
        ids = torch.from_numpy(rng.randint(0, 1024, (b, 16)).astype(
            np.int64))
        with torch.no_grad():
            got, want = loaded(ids), model(ids)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL,
                                       rtol=TOL)


def test_program_translator_and_not_to_static():
    calls = []

    def f(x):
        calls.append(1)
        if x.sum() > 0:
            y = x * 2
        else:
            y = x
        return y
    sf = to_static(f)
    x = torch.ones(2)
    pt_ = jit.ProgramTranslator.get_instance()
    pt_.enable(False)
    try:
        np.testing.assert_array_equal(sf(x).numpy(), [2.0, 2.0])
    finally:
        pt_.enable(True)
    np.testing.assert_array_equal(sf(x).numpy(), [2.0, 2.0])
    g = jit.not_to_static(lambda a: a + 1)
    assert getattr(g, "_not_to_static", False)


def test_traced_layer_trace_and_save(tmp_path):
    _, tm = _pair(15)
    x = torch.from_numpy(_x(2))
    out, traced = jit.TracedLayer.trace(tm, [x])
    np.testing.assert_allclose(traced(x).detach().numpy(),
                               out.detach().numpy())
    prefix = str(tmp_path / "traced" / "m")
    traced.save_inference_model(prefix)
    assert os.path.exists(prefix + ".pdmodel")
    pred, feeds, fetches = pt.static.load_inference_model(
        prefix, executor=pt.static.Executor(pt.CPUPlace()))
    np.testing.assert_allclose(pred.run([x.numpy()])[0],
                               out.detach().numpy(), atol=TOL)

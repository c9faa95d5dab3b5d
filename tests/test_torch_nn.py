"""The port's layers against the JAX package's, with weights copied.

Each layer is built in both packages; the JAX layer's state_dict is
copied into the port's by name, the same numpy input (seeded) goes
through both, and outputs agree at atol=rtol=1e-5 in float32 (both run
f32 on the CPU; tests/conftest.py sets the JAX matmul precision to
"highest"). Everything here runs with device="cpu": the port's default
device is the CUDA card.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

TOL = 1e-5


def _copy(jax_layer, torch_layer):
    state = {k: np.asarray(v.numpy()) for k, v in
             jax_layer.state_dict().items()}
    missing, unexpected = torch_layer.set_state_dict(state)
    assert not missing and not unexpected
    return torch_layer


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_linear_matches_jax():
    paddle.seed(0)
    j = jnn.Linear(12, 7)
    t = _copy(j, tnn.Linear(12, 7, device="cpu"))
    assert tuple(t.weight.shape) == (12, 7)  # Paddle's [in, out] layout
    for shape in [(5, 12), (2, 3, 12)]:
        x = _x(*shape)
        np.testing.assert_allclose(
            t(torch.from_numpy(x)).detach().numpy(),
            j(paddle.to_tensor(x)).numpy(), atol=TOL, rtol=TOL)


def test_linear_without_bias():
    t = tnn.Linear(4, 3, bias_attr=False, device="cpu")
    assert t.bias is None
    x = torch.from_numpy(_x(2, 4))
    torch.testing.assert_close(t(x), x @ t.weight)


def test_embedding_matches_jax():
    paddle.seed(1)
    j = jnn.Embedding(50, 8)
    t = _copy(j, tnn.Embedding(50, 8, device="cpu"))
    ids = np.random.RandomState(2).randint(0, 50, (4, 9)).astype(np.int64)
    ids[0, :3] = 3
    np.testing.assert_allclose(t(torch.from_numpy(ids)).detach().numpy(),
                               j(paddle.to_tensor(ids)).numpy(),
                               atol=TOL, rtol=TOL)
    # padding_idx reads as zeros, through the functionals of both
    w = _x(50, 8, seed=3)
    out = TF.embedding(torch.from_numpy(ids), torch.from_numpy(w),
                       padding_idx=3).numpy()
    np.testing.assert_allclose(
        out, JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w),
                          padding_idx=3).numpy(), atol=TOL, rtol=TOL)
    assert not out[0, :3].any()
    t_pad = tnn.Embedding(50, 8, padding_idx=3, device="cpu")
    assert not t_pad.weight[3].any()


def test_layer_norm_matches_jax():
    paddle.seed(2)
    j = jnn.LayerNorm(16, epsilon=1e-12)
    t = tnn.LayerNorm(16, epsilon=1e-12, device="cpu")
    state = {"weight": _x(16, seed=3), "bias": _x(16, seed=4)}
    j.set_state_dict(state)
    t.set_state_dict(state)
    x = _x(3, 5, 16, seed=5) * 3 + 1
    np.testing.assert_allclose(
        t(torch.from_numpy(x)).detach().numpy(),
        j(paddle.to_tensor(x)).numpy(), atol=TOL, rtol=TOL)


def test_layer_norm_functional_uses_biased_variance():
    x = torch.from_numpy(_x(4, 10, seed=6))
    got = TF.layer_norm(x, 10, epsilon=1e-5)
    ref = (x - x.mean(-1, keepdim=True)) / torch.sqrt(
        x.var(-1, unbiased=False, keepdim=True) + 1e-5)
    torch.testing.assert_close(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = _x(64, seed=7) * 3
    np.testing.assert_allclose(
        TF.gelu(torch.from_numpy(x), approximate=approximate).numpy(),
        JF.gelu(paddle.to_tensor(x), approximate=approximate).numpy(),
        atol=TOL, rtol=TOL)


def test_tanh_matches_jax():
    x = _x(32, seed=8)
    np.testing.assert_allclose(TF.tanh(torch.from_numpy(x)).numpy(),
                               JF.tanh(paddle.to_tensor(x)).numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_eval_matches_jax(mode):
    x = _x(6, 5, seed=9)
    j = jnn.Dropout(0.3, mode=mode)
    t = tnn.Dropout(0.3, mode=mode, device="cpu")
    j.eval()
    t.eval()
    np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(),
                               j(paddle.to_tensor(x)).numpy(),
                               atol=TOL, rtol=TOL)


def test_dropout_train_keeps_expectation():
    pt.seed(0)
    t = tnn.Dropout(0.25, device="cpu")
    x = torch.ones(200_000)
    y = t(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))


def test_seed_makes_init_deterministic():
    pt.seed(123)
    a = tnn.Linear(8, 8, device="cpu").weight.detach().clone()
    pt.seed(123)
    b = tnn.Linear(8, 8, device="cpu").weight.detach().clone()
    pt.seed(124)
    c = tnn.Linear(8, 8, device="cpu").weight.detach().clone()
    assert torch.equal(a, b) and not torch.equal(a, c)
    # XavierNormal std for [8, 8]: sqrt(2 / 16)
    big = tnn.Linear(256, 256, device="cpu").weight
    assert abs(big.std().item() - (2 / 512) ** 0.5) < 2e-3


def test_explicit_generator_drives_init():
    from paddle_tpu_torch.nn.initializer import Normal
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = Normal(0, 1)((3, 4), "float32", torch.device("cpu"), g1)
    b = Normal(0, 1)((3, 4), "float32", torch.device("cpu"), g2)
    assert torch.equal(a, b)


def test_set_state_dict_reports_and_rejects():
    t = tnn.Linear(3, 2, device="cpu")
    missing, unexpected = t.set_state_dict({"weight": np.zeros((3, 2)),
                                            "extra": np.zeros(1)})
    assert missing == ["bias"] and unexpected == ["extra"]
    assert not t.weight.detach().any()
    with pytest.raises(ValueError, match="shape"):
        t.set_state_dict({"weight": np.zeros((2, 3))})


def test_to_tensor_and_dtypes():
    from paddle_tpu_torch.core import dtypes
    a = pt.to_tensor([1.0, 2.0], place="cpu")
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    b = pt.to_tensor(np.arange(3, dtype=np.int32), place="cpu",
                     stop_gradient=False, dtype="float32")
    assert b.requires_grad and b.dtype == torch.float32
    assert dtypes.convert_dtype("bf16") is torch.bfloat16
    assert dtypes.convert_dtype(np.float32) is torch.float32
    assert dtypes.is_floating("float16") and dtypes.is_integer("int64")
    assert pt.Tensor is torch.Tensor and pt.no_grad is torch.no_grad
    assert pt.Parameter is torch.nn.Parameter


def test_places_map_to_torch_devices():
    from paddle_tpu_torch.core import place
    assert place.resolve_device("cpu") == torch.device("cpu")
    assert place.resolve_device("gpu:1") == torch.device("cuda", 1)
    assert place.resolve_device(pt.CUDAPlace(0)) == torch.device("cuda", 0)
    assert place.resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError):
        place.resolve_device("tpu")

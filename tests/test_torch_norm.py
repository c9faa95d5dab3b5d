"""The port's norms, activations, containers and initializers against the
JAX package's.

Inputs come from numpy seeds and weights are carried across by name.
Values are held at 1e-5 and gradients at 1e-4 (relative and absolute,
float32). BatchNorm is held over three training calls on different
batches: outputs, input and weight gradients, and the running
statistics (`_mean`, `_variance`: paddle's momentum, the biased batch
variance) after each call; then eval and use_global_stats with them.
The initializers draw other numbers than jax.random for the same seed,
so their distributions are held statistically (moments and bounds of
a large draw, at the tolerance each test states).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.initializer as JI
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.nn.initializer as TI

VAL, GRAD = 1e-5, 1e-4



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: tier-1 runs several workers on the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _copy(j, t):
    missing, unexpected = t.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()})
    assert not missing and not unexpected
    return t


def _close(a, b, tol=VAL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kind,shape,fmt", [
    ("BatchNorm2D", (4, 3, 5, 6), "NCHW"),
    ("BatchNorm2D", (4, 5, 6, 3), "NHWC"),
    ("BatchNorm1D", (6, 3, 7), "NCL"),
    ("BatchNorm1D", (8, 3), "NCL"),
    ("BatchNorm3D", (2, 3, 4, 3, 5), "NCDHW"),
])
def test_batch_norm_train_three_calls_then_eval(kind, shape, fmt):
    paddle.seed(0)
    j = getattr(jnn, kind)(3, momentum=0.8, data_format=fmt)
    t = _copy(j, getattr(tnn, kind)(3, momentum=0.8, data_format=fmt,
                                    device="cpu"))
    # weights away from (1, 0), so their gradients are exercised
    w, b = _x(3, seed=9) + 1.0, _x(3, seed=10)
    j.weight.set_value(paddle.to_tensor(w))
    j.bias.set_value(paddle.to_tensor(b))
    t.set_state_dict({"weight": w, "bias": b})
    j.train()
    t.train()
    for call in range(3):
        x = _x(*shape, seed=call, scale=2.0) + 0.5 * call
        c = _x(*shape, seed=call + 20)
        jx = paddle.to_tensor(x, stop_gradient=False)
        jo = j(jx)
        (jo * paddle.to_tensor(c)).sum().backward()
        tx = torch.from_numpy(x).requires_grad_(True)
        to = t(tx)
        (to * torch.from_numpy(c)).sum().backward()
        _close(to.detach(), jo.numpy())
        _close(tx.grad, jx.grad.numpy(), GRAD)
        _close(t._mean, j._mean.numpy())
        _close(t._variance, j._variance.numpy())
    _close(t.weight.grad, j.weight.grad.numpy(), GRAD)
    _close(t.bias.grad, j.bias.grad.numpy(), GRAD)
    x = _x(*shape, seed=7)
    j.eval()
    t.eval()
    _close(t(torch.from_numpy(x)).detach(), j(paddle.to_tensor(x)).numpy())


def test_batch_norm_functional_use_global_stats():
    """training=True with use_global_stats: normalises with the running
    statistics and leaves them as they were, as in the JAX package."""
    x = _x(4, 3, 5, 5, seed=1)
    rm, rv = _x(3, seed=2), np.abs(_x(3, seed=3)) + 0.5
    w, b = _x(3, seed=4), _x(3, seed=5)
    jrm, jrv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    for ugs in (True, False):
        j = JF.batch_norm(paddle.to_tensor(x), jrm, jrv,
                          paddle.to_tensor(w), paddle.to_tensor(b),
                          training=True, use_global_stats=ugs)
        t = TF.batch_norm(torch.from_numpy(x), trm, trv,
                          torch.from_numpy(w), torch.from_numpy(b),
                          training=True, use_global_stats=ugs)
        _close(t, j.numpy())
        _close(trm, jrm.numpy())
        _close(trv, jrv.numpy())
    assert not np.allclose(trm.numpy(), rm)   # the second call updated


def test_batch_norm_running_stats_are_paddle_not_torch():
    """The update is momentum * running + (1 - momentum) * batch with the
    biased variance (torch's own F.batch_norm would weigh the other way
    and take the unbiased variance): pinned against numpy."""
    x = _x(5, 2, 3, 3, seed=3)
    rm, rv = torch.zeros(2), torch.ones(2)
    TF.batch_norm(torch.from_numpy(x), rm, rv, training=True, momentum=0.9)
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))     # biased
    _close(rm, 0.1 * mean)
    _close(rv, 0.9 + 0.1 * var)


def test_batch_norm_frozen_running_stats():
    from paddle_tpu_torch.nn.functional.norm import frozen_running_stats
    rm, rv = torch.zeros(2), torch.ones(2)
    with frozen_running_stats():
        TF.batch_norm(torch.from_numpy(_x(4, 2, 3, seed=1)), rm, rv,
                      training=True)
    assert torch.equal(rm, torch.zeros(2)) and torch.equal(rv, torch.ones(2))


def test_batch_norm_amp_o1_runs_in_f32():
    """batch_norm_op is on the AMP black list: a bf16 input is cast to
    f32, as in the JAX package."""
    from paddle_tpu_torch.amp import auto_cast
    x = torch.from_numpy(_x(4, 3, 2, 2)).to(torch.bfloat16)
    with auto_cast(level="O1", dtype="bfloat16"):
        out = TF.batch_norm(x, torch.zeros(3), torch.ones(3),
                            training=True)
    assert out.dtype == torch.float32


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_group_norm_matches_jax(fmt):
    paddle.seed(1)
    j = jnn.GroupNorm(2, 6, data_format=fmt)
    t = _copy(j, tnn.GroupNorm(2, 6, data_format=fmt, device="cpu"))
    shape = (3, 6, 4, 5) if fmt == "NCHW" else (3, 4, 5, 6)
    x = _x(*shape, seed=2)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jo = j(jx)
    jo.sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    to = t(tx)
    to.sum().backward()
    _close(to.detach(), jo.numpy())
    _close(tx.grad, jx.grad.numpy(), GRAD)


@pytest.mark.parametrize("kind,shape", [("InstanceNorm1D", (2, 3, 8)),
                                        ("InstanceNorm2D", (2, 3, 5, 4)),
                                        ("InstanceNorm3D", (2, 3, 3, 4, 3))])
def test_instance_norm_matches_jax(kind, shape):
    paddle.seed(2)
    j = getattr(jnn, kind)(3)
    t = _copy(j, getattr(tnn, kind)(3, device="cpu"))
    x = _x(*shape, seed=3)
    _close(t(torch.from_numpy(x)).detach(), j(paddle.to_tensor(x)).numpy())


@pytest.mark.parametrize("size,fmt", [(3, "NCHW"), (4, "NCHW"),
                                      (5, "NHWC")])
def test_local_response_norm_matches_jax(size, fmt):
    shape = (2, 7, 4, 3) if fmt == "NCHW" else (2, 4, 3, 7)
    x = _x(*shape, seed=4)
    j = jnn.LocalResponseNorm(size, data_format=fmt)(paddle.to_tensor(x))
    t = tnn.LocalResponseNorm(size, data_format=fmt)(torch.from_numpy(x))
    _close(t, j.numpy())


@pytest.mark.parametrize("p,axis", [(2, 1), (1, -1), (3, 0)])
def test_normalize_matches_jax(p, axis):
    x = _x(4, 5, 3, seed=5)
    _close(TF.normalize(torch.from_numpy(x), p=p, axis=axis),
           JF.normalize(paddle.to_tensor(x), p=p, axis=axis).numpy())


def test_spectral_norm_matches_jax():
    paddle.seed(3)
    j = jnn.SpectralNorm((6, 4, 3), dim=1, power_iters=3)
    t = _copy(j, tnn.SpectralNorm((6, 4, 3), dim=1, power_iters=3,
                                  device="cpu"))
    assert not t.weight_u.requires_grad and not t.weight_v.requires_grad
    w = _x(6, 4, 3, seed=6)
    jw = paddle.to_tensor(w, stop_gradient=False)
    jo = j(jw)
    (jo * paddle.to_tensor(_x(6, 4, 3, seed=7))).sum().backward()
    tw = torch.from_numpy(w).requires_grad_(True)
    to = t(tw)
    (to * torch.from_numpy(_x(6, 4, 3, seed=7))).sum().backward()
    _close(to.detach(), jo.numpy())
    _close(tw.grad, jw.grad.numpy(), GRAD)


def test_sync_batch_norm_without_group_is_batch_norm():
    """No process group: SyncBatchNorm is plain BatchNorm (the JAX
    docstring's single-replica case), and convert_sync_batchnorm keeps
    the weights and running statistics."""
    paddle.seed(4)
    j = jnn.BatchNorm2D(3)
    t = _copy(j, tnn.BatchNorm2D(3, device="cpu"))
    model = tnn.Sequential(t)
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert isinstance(conv[0], tnn.SyncBatchNorm)
    x = _x(4, 3, 3, 3, seed=8)
    _close(conv(torch.from_numpy(x)).detach(),
           j(paddle.to_tensor(x)).numpy())
    _close(conv[0]._mean, j._mean.numpy())


# -- activations ------------------------------------------------------------

ACTS = ["relu", "relu6", "elu", "selu", "celu", "gelu", "sigmoid",
        "hardsigmoid", "hardswish", "hardtanh", "hardshrink", "softshrink",
        "tanhshrink", "leaky_relu", "rrelu", "log_sigmoid", "log_softmax",
        "softmax", "softplus", "softsign", "swish", "silu", "mish",
        "thresholded_relu", "glu"]


@pytest.mark.parametrize("name", ACTS)
def test_activation_matches_jax(name):
    x = _x(3, 8, seed=11, scale=3.0)
    x[0, :4] = [-3.0, 0.0, 3.0, 6.0]     # the kinks of relu6/hardswish
    x[0, :4] += 0.25
    jx = paddle.to_tensor(x, stop_gradient=False)
    jo = getattr(JF, name)(jx)
    c = _x(*jo.shape, seed=12)
    (jo * paddle.to_tensor(c)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    to = getattr(TF, name)(tx)
    (to * torch.from_numpy(c)).sum().backward()
    _close(to.detach(), jo.numpy())
    _close(tx.grad, jx.grad.numpy(), GRAD)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_prelu_and_maxout_match_jax(fmt):
    x = _x(2, 4, 3, 3, seed=13)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    _close(TF.prelu(torch.from_numpy(x), torch.from_numpy(w), fmt),
           JF.prelu(paddle.to_tensor(x), paddle.to_tensor(w), fmt).numpy())
    axis = 1 if fmt == "NCHW" else -1
    _close(TF.maxout(torch.from_numpy(x), 2, axis=axis),
           JF.maxout(paddle.to_tensor(x), 2, axis=axis).numpy())


LAYERS = [("ReLU", {}), ("ReLU6", {}), ("ELU", dict(alpha=0.5)),
          ("SELU", {}), ("CELU", dict(alpha=2.0)),
          ("GELU", dict(approximate=True)), ("Sigmoid", {}),
          ("Hardsigmoid", {}), ("Hardswish", {}),
          ("Hardtanh", dict(min=-0.5, max=0.5)), ("Hardshrink", {}),
          ("Softshrink", {}), ("Tanhshrink", {}),
          ("LeakyReLU", dict(negative_slope=0.2)), ("PReLU", {}),
          ("RReLU", {}), ("LogSigmoid", {}), ("LogSoftmax", {}),
          ("Softmax", dict(axis=1)), ("Softplus", dict(beta=2.0)),
          ("Softsign", {}), ("Swish", {}), ("Silu", {}), ("Mish", {}),
          ("Maxout", dict(groups=2)), ("ThresholdedReLU", {}),
          ("GLU", {}), ("Tanh", {})]


@pytest.mark.parametrize("name,kw", LAYERS, ids=[n for n, _ in LAYERS])
def test_activation_layer_matches_jax(name, kw):
    x = _x(2, 4, 4, seed=14, scale=2.0)
    j = getattr(jnn, name)(**kw)
    if name == "PReLU":
        t = _copy(j, tnn.PReLU(device="cpu"))
    else:
        t = getattr(tnn, name)(**kw)
    _close(t(torch.from_numpy(x)).detach(), j(paddle.to_tensor(x)).numpy())


def test_inplace_activations_write_into_x():
    for name, ref in (("relu_", torch.relu), ("tanh_", torch.tanh),
                      ("elu_", torch.nn.functional.elu),
                      ("softmax_", lambda t: torch.softmax(t, -1))):
        x = torch.from_numpy(_x(3, 4, seed=15))
        want = ref(x.clone())
        out = getattr(TF, name)(x)
        assert out is x
        torch.testing.assert_close(x, want, rtol=VAL, atol=VAL)


def test_gumbel_softmax_is_a_distribution():
    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_x(6, 5, seed=16)).requires_grad_(True)
    y = TF.gumbel_softmax(x, temperature=0.5, generator=g)
    torch.testing.assert_close(y.sum(-1), torch.ones(6))
    h = TF.gumbel_softmax(x, hard=True, generator=g)
    assert set(h.detach().unique().tolist()) <= {0.0, 1.0}
    h.sum().backward()   # the straight-through gradient flows
    assert x.grad is not None


# -- containers -------------------------------------------------------------

def test_containers_name_like_jax():
    """Sequential (positional and named), LayerList, LayerDict and
    ParameterList register their members under the JAX package's names,
    so state_dicts carry across by name."""
    paddle.seed(5)
    jseq = jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(), jnn.Linear(4, 2))
    tseq = _copy(jseq, tnn.Sequential(tnn.Linear(3, 4, device="cpu"),
                                      tnn.ReLU(),
                                      tnn.Linear(4, 2, device="cpu")))
    x = _x(5, 3, seed=17)
    _close(tseq(torch.from_numpy(x)).detach(),
           jseq(paddle.to_tensor(x)).numpy())
    assert isinstance(tseq[1], tnn.ReLU) and len(tseq[0:2]) == 2
    jnamed = jnn.Sequential(("fc", jnn.Linear(3, 2)), ("act", jnn.Tanh()))
    tnamed = tnn.Sequential([("fc", tnn.Linear(3, 2, device="cpu")),
                             ("act", tnn.Tanh())])
    assert list(tnamed.state_dict()) == list(jnamed.state_dict())
    jl = jnn.LayerList([jnn.Linear(2, 2) for _ in range(3)])
    tl = tnn.LayerList([tnn.Linear(2, 2, device="cpu") for _ in range(2)])
    tl.append(tnn.Linear(2, 2, device="cpu"))
    tl.insert(0, tnn.Linear(2, 2, device="cpu"))
    assert len(tl) == 4
    tl = tnn.LayerList([tnn.Linear(2, 2, device="cpu") for _ in range(3)])
    assert list(tl.state_dict()) == list(jl.state_dict())
    jd = jnn.LayerDict({"a": jnn.Linear(2, 3), "b": jnn.ReLU()})
    td = tnn.LayerDict({"a": tnn.Linear(2, 3, device="cpu"),
                        "b": tnn.ReLU()})
    assert list(td.state_dict()) == list(jd.state_dict())
    assert "a" in td and list(td.keys()) == ["a", "b"]
    tp = tnn.ParameterList([torch.nn.Parameter(torch.zeros(2))
                            for _ in range(2)])
    assert list(tp.state_dict()) == ["0", "1"] and len(tp) == 2


# -- initializers -----------------------------------------------------------

N = 200_000


def _draw_t(init, shape=(N,)):
    g = torch.Generator().manual_seed(0)
    return init(shape, "float32", "cpu", g).numpy()


def _draw_j(init, shape=(N,)):
    paddle.seed(0)
    return np.asarray(init(shape, "float32"))


@pytest.mark.parametrize("name,args,shape", [
    ("Normal", (0.5, 2.0), (N,)),
    ("TruncatedNormal", (0.5, 2.0), (N,)),
    ("Uniform", (-0.5, 1.5), (N,)),
    ("XavierNormal", (), (400, 500)),
    ("XavierUniform", (), (400, 500)),
    ("KaimingNormal", (), (256, 96, 3, 3)),
    ("KaimingUniform", (), (256, 96, 3, 3)),
])
def test_initializer_distribution_matches_jax(name, args, shape):
    """Mean and standard deviation within 0.01 of the JAX draw's standard
    deviation (draws of 200k or more: the difference of two sample means
    has a standard error near 0.003 sd), and the bounds of the
    support."""
    t = _draw_t(getattr(TI, name)(*args), shape).ravel()
    j = _draw_j(getattr(JI, name)(*args), shape).ravel()
    sd = j.std()
    assert abs(t.mean() - j.mean()) < 0.01 * sd
    assert abs(t.std() - sd) < 0.01 * sd
    if name in ("Uniform", "XavierUniform", "KaimingUniform",
                "TruncatedNormal"):
        assert t.min() >= j.min() - 0.01 * sd
        assert t.max() <= j.max() + 0.01 * sd
        assert t.min() < j.min() + 0.01 * sd
        assert t.max() > j.max() - 0.01 * sd


def test_kaiming_uniform_is_conv_default_bound():
    """KaimingUniform(fan_in) draws U(-sqrt(6/fan_in), sqrt(6/fan_in))."""
    t = _draw_t(TI.KaimingUniform(fan_in=27), (N,))
    limit = math.sqrt(6.0 / 27)
    assert t.max() <= limit and t.min() >= -limit
    assert t.max() > 0.99 * limit and t.min() < -0.99 * limit


@pytest.mark.parametrize("shape,gain", [((6, 4), 1.0), ((4, 6), 2.0),
                                        ((3, 2, 5), 0.5)])
def test_orthogonal_matches_jax_layout(shape, gain):
    """Orthogonal flattens all dims but the last, as jax's column_axis -1
    does: rows or columns orthonormal (times gain) in both packages."""
    for w in (_draw_t(TI.Orthogonal(gain), shape),
              _draw_j(JI.Orthogonal(gain), shape)):
        assert w.shape == shape
        m = w.reshape(-1, shape[-1]) / gain
        small = min(m.shape)
        gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(gram, np.eye(small), atol=1e-5)


def test_dirac_matches_jax_pattern():
    """Dirac is delta_orthogonal on the shape as given: one orthogonal
    block over the last two dims at the centre of the leading ones."""
    shape = (5, 3, 4, 4)
    t = _draw_t(TI.Dirac(), shape)
    j = _draw_j(JI.Dirac(), shape)
    np.testing.assert_array_equal(t != 0, j != 0)
    block = t[2, 1]
    np.testing.assert_allclose(block @ block.T, np.eye(4), atol=1e-5)


def test_assign_bilinear_constant_and_gain():
    v = _x(2, 3, seed=18)
    np.testing.assert_array_equal(_draw_t(TI.Assign(v), (2, 3)), v)
    with pytest.raises(ValueError):
        TI.Assign(v)((3, 2), "float32", "cpu")
    np.testing.assert_allclose(
        TI.Bilinear()((2, 2, 4, 4), "float32", "cpu").numpy(),
        np.asarray(JI.Bilinear()((2, 2, 4, 4), "float32")), atol=VAL)
    for nl, p in (("relu", None), ("tanh", None), ("leaky_relu", 0.2),
                  ("selu", None), ("conv2d", None)):
        assert TI.calculate_gain(nl, p) == JI.calculate_gain(nl, p)


def test_set_global_initializer_is_the_default():
    TI.set_global_initializer(TI.Constant(0.5), TI.Constant(0.25))
    try:
        lin = tnn.Linear(3, 2, device="cpu")
        assert torch.all(lin.weight == 0.5) and torch.all(lin.bias == 0.25)
        # an explicit initializer still wins
        conv = tnn.Conv2D(2, 2, 1, weight_attr=TI.Constant(2.0),
                          device="cpu")
        assert torch.all(conv.weight == 2.0)
    finally:
        TI.set_global_initializer(None, None)
    assert not torch.all(tnn.Linear(3, 2, device="cpu").weight == 0.5)

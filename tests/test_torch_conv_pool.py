"""The port's convolutions and pools against the JAX package's.

Every case builds its inputs from a numpy seed, runs the JAX functional
(paddle_tpu.nn.functional, XLA's conv_general_dilated and reduce_window)
and the port's (torch's F.conv*d / pools on the CPU) on them, and holds
the outputs at 1e-5 and the gradients of sum(out * c) for the input,
the weight and the bias at 1e-4 (relative and absolute, float32). The
cases cover every padding form the JAX package reads (int, pairs, 2n
lists, the full-layout form, SAME and VALID at stride 2), groups,
dilation, NHWC, the transposes across stride, dilation, groups and
output_padding, and the pools' ceil_mode (including the case where
torch's own rule would drop a window), exclusive averages, adaptive
pooling (divisible and uneven) and return_mask.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.amp import auto_cast as t_auto_cast

VAL, GRAD = 1e-5, 1e-4



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: tier-1 runs several workers on the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _jax_run(fn, arrays, grads_for, cot=None):
    """fn(*tensors) in the JAX package: output, and with cot the
    gradients of sum(out * cot) for the indices in grads_for."""
    ts = [paddle.to_tensor(a, stop_gradient=i not in grads_for)
          if a is not None else None for i, a in enumerate(arrays)]
    out = fn(*ts)
    if cot is None:
        return out.numpy(), []
    (out * paddle.to_tensor(cot)).sum().backward()
    return out.numpy(), [ts[i].grad.numpy() for i in grads_for]


def _torch_run(fn, arrays, grads_for, cot=None):
    ts = [torch.from_numpy(a.copy()).requires_grad_(i in grads_for)
          if a is not None else None for i, a in enumerate(arrays)]
    out = fn(*ts)
    if cot is None:
        return out.detach().numpy(), []
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [ts[i].grad.numpy() for i in grads_for]


def _check(jfn, tfn, arrays, grads_for=(0, 1, 2), seed=1):
    j_out, _ = _jax_run(jfn, arrays, ())
    cot = np.random.RandomState(seed).randn(*j_out.shape).astype(np.float32)
    grads_for = [i for i in grads_for if i < len(arrays)
                 and arrays[i] is not None]
    j_out, j_g = _jax_run(jfn, arrays, grads_for, cot)
    t_out, t_g = _torch_run(tfn, arrays, grads_for, cot)
    assert t_out.shape == j_out.shape
    np.testing.assert_allclose(t_out, j_out, rtol=VAL, atol=VAL)
    for a, b in zip(t_g, j_g):
        np.testing.assert_allclose(a, b, rtol=GRAD, atol=GRAD)
    return t_out


# (name, n, in_c, out_c, k, spatial, kwargs)
CONV_CASES = [
    ("2d_int_pad", 2, 4, 6, 3, (9, 8), dict(stride=1, padding=1)),
    ("2d_stride2_pairs", 2, 4, 6, 3, (9, 8), dict(stride=2,
                                                  padding=[1, 2])),
    ("2d_asym_2n", 2, 4, 6, 3, (9, 8), dict(stride=1,
                                            padding=[0, 2, 1, 0])),
    ("2d_same_stride2", 2, 4, 6, 3, (9, 8), dict(stride=2,
                                                 padding="SAME")),
    ("2d_same_even_k", 2, 4, 6, 4, (9, 8), dict(stride=2,
                                                padding="same")),
    ("2d_valid_stride2", 2, 4, 6, 3, (9, 8), dict(stride=2,
                                                  padding="VALID")),
    ("2d_groups", 2, 4, 6, 3, (8, 8), dict(padding=1, groups=2)),
    ("2d_depthwise", 2, 4, 4, 3, (8, 8), dict(stride=2, padding=1,
                                              groups=4)),
    ("2d_dilation", 2, 4, 6, 3, (10, 9), dict(padding=2, dilation=2)),
    ("2d_same_dilation", 2, 4, 6, 3, (10, 9), dict(padding="SAME",
                                                   dilation=2,
                                                   stride=2)),
    ("2d_nhwc", 2, 4, 6, 3, (9, 8), dict(stride=2, padding=[1, 0],
                                         data_format="NHWC")),
    ("1d", 1, 3, 5, 3, (11,), dict(stride=2, padding=[1, 2])),
    ("1d_full_layout", 1, 3, 5, 3, (11,), dict(
        stride=2, padding=[[0, 0], [0, 0], [2, 1]])),
    ("3d_full_layout", 3, 2, 4, 3, (5, 6, 5), dict(
        padding=[[0, 0], [0, 0], [1, 0], [0, 2], [1, 1]])),
    ("1d_nlc", 1, 3, 5, 3, (11,), dict(padding="SAME",
                                       data_format="NLC")),
    ("3d", 3, 2, 4, 3, (5, 6, 5), dict(stride=(1, 2, 1), padding=1)),
    ("3d_ndhwc_groups", 3, 2, 4, 3, (5, 6, 5), dict(
        padding=[1, 0, 0, 1, 1, 1], groups=2, data_format="NDHWC")),
]
_FN = {1: ("conv1d", "conv1d_transpose"), 2: ("conv2d", "conv2d_transpose"),
       3: ("conv3d", "conv3d_transpose")}


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_matches_jax(case):
    name, n, cin, cout, k, spatial, kw = case
    rng = np.random.RandomState(len(name))
    groups = kw.get("groups", 1)
    last = kw.get("data_format", "NCHW")[-1] == "C"
    xshape = (2,) + spatial + (cin,) if last else (2, cin) + spatial
    x = _rand(rng, *xshape)
    w = _rand(rng, cout, cin // groups, *((k,) * n)) * 0.3
    b = _rand(rng, cout)
    fname = _FN[n][0]
    _check(lambda x, w, b: getattr(JF, fname)(x, w, b, **kw),
           lambda x, w, b: getattr(TF, fname)(x, w, b, **kw), [x, w, b])


# (name, n, in_c, out_c, k, spatial, kwargs)
TRANSPOSE_CASES = [
    ("2d_stride2", 2, 4, 6, 3, (5, 4), dict(stride=2, padding=1)),
    ("2d_opad", 2, 4, 6, 3, (5, 4), dict(stride=2, padding=1,
                                         output_padding=1)),
    ("2d_opad_past_stride", 2, 4, 6, 3, (5, 4), dict(
        stride=1, padding=1, output_padding=2)),
    ("2d_dilation", 2, 4, 6, 3, (5, 4), dict(stride=2, padding=2,
                                             dilation=2)),
    ("2d_groups", 2, 4, 6, 3, (5, 4), dict(stride=2, padding=1,
                                           groups=2)),
    ("2d_asym", 2, 4, 6, 3, (5, 4), dict(stride=2,
                                         padding=[0, 2, 1, 0])),
    ("2d_same", 2, 4, 6, 4, (5, 4), dict(stride=2, padding="SAME")),
    ("2d_valid_nhwc", 2, 4, 6, 3, (5, 4), dict(
        stride=3, padding="VALID", data_format="NHWC")),
    ("2d_output_size", 2, 4, 6, 3, (5, 4), dict(
        stride=2, padding=0, output_size=(9, 8))),
    ("1d", 1, 3, 5, 4, (7,), dict(stride=3, padding=1,
                                  output_padding=2)),
    ("3d_groups", 3, 2, 4, 3, (3, 4, 3), dict(stride=2, padding=1,
                                              groups=2, dilation=1)),
]


@pytest.mark.parametrize("case", TRANSPOSE_CASES,
                         ids=[c[0] for c in TRANSPOSE_CASES])
def test_conv_transpose_matches_jax(case):
    name, n, cin, cout, k, spatial, kw = case
    rng = np.random.RandomState(len(name) + 50)
    groups = kw.get("groups", 1)
    last = kw.get("data_format", "NCHW")[-1] == "C"
    xshape = (2,) + spatial + (cin,) if last else (2, cin) + spatial
    x = _rand(rng, *xshape)
    w = _rand(rng, cin, cout // groups, *((k,) * n)) * 0.3
    b = _rand(rng, cout)
    fname = _FN[n][1]
    _check(lambda x, w, b: getattr(JF, fname)(x, w, b, **kw),
           lambda x, w, b: getattr(TF, fname)(x, w, b, **kw), [x, w, b])


def test_conv_amp_o1_runs_in_bf16_as_jax():
    """conv2d is an AMP white-list op: under O1 both packages cast its
    inputs to bf16 (outputs within bf16's rounding, 2e-2)."""
    from paddle_tpu.amp import auto_cast as j_auto_cast
    rng = np.random.RandomState(7)
    x, w = _rand(rng, 2, 4, 8, 8), _rand(rng, 6, 4, 3, 3) * 0.3
    with j_auto_cast(level="O1", dtype="bfloat16"):
        j = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), padding=1)
    with t_auto_cast(level="O1", dtype="bfloat16"):
        t = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1)
    assert t.dtype == torch.bfloat16 and "bfloat16" in str(j.dtype)
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.numpy(), np.float32),
                               rtol=2e-2, atol=2e-2)


# (name, fn, spatial, kwargs)
POOL_CASES = [
    ("max2d_k3s2p1", "max_pool2d", (9, 8), dict(kernel_size=3, stride=2,
                                                padding=1)),
    ("max2d_ceil_torch_drops", "max_pool2d", (5, 5), dict(
        kernel_size=2, stride=2, padding=1, ceil_mode=True)),
    ("max2d_ceil", "max_pool2d", (7, 6), dict(kernel_size=3, stride=2,
                                              ceil_mode=True)),
    ("max2d_asym", "max_pool2d", (7, 6), dict(kernel_size=3, stride=2,
                                              padding=[0, 2, 1, 0])),
    ("max2d_same", "max_pool2d", (7, 6), dict(kernel_size=3, stride=2,
                                              padding="SAME")),
    ("max2d_nhwc", "max_pool2d", (7, 6), dict(kernel_size=2,
                                              data_format="NHWC")),
    ("max1d", "max_pool1d", (11,), dict(kernel_size=3, stride=2,
                                        padding=1, ceil_mode=True)),
    ("max3d", "max_pool3d", (5, 6, 5), dict(kernel_size=2, stride=2,
                                            padding=1)),
    ("avg2d_exclusive", "avg_pool2d", (7, 6), dict(kernel_size=3,
                                                   stride=2, padding=1)),
    ("avg2d_inclusive", "avg_pool2d", (7, 6), dict(
        kernel_size=3, stride=2, padding=1, exclusive=False)),
    ("avg2d_ceil", "avg_pool2d", (7, 6), dict(kernel_size=3, stride=2,
                                              ceil_mode=True)),
    ("avg2d_asym_exclusive", "avg_pool2d", (7, 6), dict(
        kernel_size=3, stride=2, padding=[0, 2, 1, 0])),
    ("avg2d_same", "avg_pool2d", (7, 6), dict(kernel_size=3, stride=2,
                                              padding="SAME")),
    ("avg2d_divisor", "avg_pool2d", (8, 8), dict(
        kernel_size=2, divisor_override=3)),
    ("avg2d_nhwc", "avg_pool2d", (8, 6), dict(kernel_size=2, stride=2,
                                              data_format="NHWC")),
    ("avg1d", "avg_pool1d", (11,), dict(kernel_size=4, stride=3,
                                        padding=1)),
    ("avg3d", "avg_pool3d", (5, 6, 5), dict(kernel_size=2, stride=2,
                                            padding=1, exclusive=False)),
    ("adaptive_avg2d_div", "adaptive_avg_pool2d", (8, 6),
     dict(output_size=(4, 3))),
    ("adaptive_avg2d_one", "adaptive_avg_pool2d", (7, 7),
     dict(output_size=1)),
    ("adaptive_avg2d_uneven", "adaptive_avg_pool2d", (7, 5),
     dict(output_size=(3, 4))),
    ("adaptive_avg2d_nhwc", "adaptive_avg_pool2d", (7, 6),
     dict(output_size=(3, 3), data_format="NHWC")),
    ("adaptive_avg1d", "adaptive_avg_pool1d", (10,), dict(output_size=4)),
    ("adaptive_avg3d", "adaptive_avg_pool3d", (4, 6, 5),
     dict(output_size=(2, 3, 2))),
    ("adaptive_max2d_uneven", "adaptive_max_pool2d", (7, 5),
     dict(output_size=(3, 2))),
    ("adaptive_max1d", "adaptive_max_pool1d", (9,), dict(output_size=3)),
    ("adaptive_max3d", "adaptive_max_pool3d", (4, 5, 6),
     dict(output_size=2)),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_pool_matches_jax(case):
    name, fname, spatial, kw = case
    rng = np.random.RandomState(len(name) + 100)
    last = kw.get("data_format", "NCHW")[-1] == "C"
    x = _rand(rng, *((2,) + spatial + (3,) if last else (2, 3) + spatial))
    with np.errstate(invalid="ignore"):
        _check(lambda x: getattr(JF, fname)(x, **kw),
               lambda x: getattr(TF, fname)(x, **kw), [x], (0,))


def test_conv2d_full_layout_padding_raises_as_jax():
    """The JAX package's _padding reads a 2d full-layout padding
    [[0,0],[0,0],[a,b],[c,d]] (four entries, 2n of them) as the flat 2n
    form first, and int() of a pair raises; the port reads it the same
    way (1d and 3d full-layout paddings work in both: CONV_CASES)."""
    x = np.zeros((1, 2, 5, 5), np.float32)
    w = np.zeros((2, 2, 3, 3), np.float32)
    pad = [[0, 0], [0, 0], [2, 1], [0, 1]]
    with pytest.raises(Exception):
        JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), padding=pad)
    with pytest.raises(TypeError):
        TF.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=pad)


def test_ceil_mode_keeps_the_window_torch_drops():
    """size 5, kernel 2, stride 2, padding 1, ceil_mode: the JAX package
    keeps 4 windows (the last one starts in the right padding: -inf for
    max, 0/0 for an exclusive average); torch's own ceil rule keeps 3.
    The port follows the JAX package."""
    x = _rand(np.random.RandomState(3), 1, 2, 5, 5)
    kw = dict(kernel_size=2, stride=2, padding=1, ceil_mode=True)
    torch_rule = torch.nn.functional.max_pool2d(torch.from_numpy(x), 2, 2, 1,
                                                ceil_mode=True)
    assert torch_rule.shape[-1] == 3
    for fname in ("max_pool2d", "avg_pool2d"):
        j = JF.__dict__[fname](paddle.to_tensor(x), **kw).numpy()
        t = getattr(TF, fname)(torch.from_numpy(x), **kw).numpy()
        assert t.shape == j.shape == (1, 2, 4, 4)
        np.testing.assert_allclose(t, j, rtol=VAL, atol=VAL)
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))


@pytest.mark.parametrize("kw", [
    dict(kernel_size=2, stride=2),
    dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=3, stride=2, padding=1, ceil_mode=True),
    dict(kernel_size=2, stride=2, padding=[1, 0, 0, 1], ceil_mode=True),
], ids=["k2", "k3p1", "k3p1_ceil", "asym_ceil"])
def test_max_pool2d_return_mask_matches_jax(kw):
    x = _rand(np.random.RandomState(4), 2, 3, 7, 6)
    j_out, j_mask = JF.max_pool2d(paddle.to_tensor(x), return_mask=True,
                                  **kw)
    t_out, t_mask = TF.max_pool2d(torch.from_numpy(x), return_mask=True,
                                  **kw)
    np.testing.assert_allclose(t_out.numpy(), j_out.numpy(), rtol=VAL,
                               atol=VAL)
    np.testing.assert_array_equal(t_mask.numpy(), j_mask.numpy())
    assert t_mask.dtype == torch.int32


@pytest.mark.parametrize("fname", ["adaptive_max_pool1d",
                                   "adaptive_max_pool2d",
                                   "adaptive_max_pool3d"])
def test_adaptive_max_return_mask_raises(fname):
    x = torch.zeros((1, 1) + (4,) * int(fname[-2]))
    with pytest.raises(NotImplementedError):
        getattr(TF, fname)(x, 2, return_mask=True)


CONV_LAYERS = [
    ("Conv1D", (3, 5, 3), dict(stride=2, padding=1), (2, 3, 9)),
    ("Conv2D", (4, 6, 3), dict(padding=1, groups=2), (2, 4, 7, 6)),
    ("Conv3D", (2, 4, 3), dict(padding=1), (1, 2, 4, 5, 4)),
    ("Conv1DTranspose", (3, 5, 3), dict(stride=2), (2, 3, 6)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1,
                                        output_padding=1, groups=2),
     (2, 4, 5, 4)),
    ("Conv3DTranspose", (2, 4, 3), dict(stride=2), (1, 2, 3, 3, 3)),
]


@pytest.mark.parametrize("case", CONV_LAYERS, ids=[c[0] for c in CONV_LAYERS])
def test_conv_layer_matches_jax(case):
    """The layer classes: weight layouts, the KaimingUniform default, and
    the forward with the JAX layer's weights."""
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as tnn
    name, args, kw, xshape = case
    paddle.seed(0)
    j = getattr(jnn, name)(*args, **kw)
    t = getattr(tnn, name)(*args, device="cpu", **kw)
    jw = j.weight.numpy()
    assert tuple(t.weight.shape) == jw.shape
    # the default init draws U(-limit, limit), limit = sqrt(6 / fan_in)
    fan_in = args[0] // kw.get("groups", 1) * args[2] ** (len(xshape) - 2)
    limit = np.sqrt(6.0 / fan_in)
    assert np.abs(t.weight.detach().numpy()).max() <= limit
    assert np.abs(jw).max() <= limit
    t.set_state_dict({k: np.asarray(v.numpy())
                      for k, v in j.state_dict().items()})
    x = _rand(np.random.RandomState(9), *xshape)
    np.testing.assert_allclose(
        t(torch.from_numpy(x)).detach().numpy(),
        j(paddle.to_tensor(x)).numpy(), rtol=VAL, atol=VAL)


POOL_LAYERS = [("MaxPool2D", dict(kernel_size=3, stride=2, padding=1)),
               ("AvgPool2D", dict(kernel_size=2, ceil_mode=True)),
               ("MaxPool1D", dict(kernel_size=2)),
               ("AvgPool1D", dict(kernel_size=3, stride=2)),
               ("MaxPool3D", dict(kernel_size=2)),
               ("AvgPool3D", dict(kernel_size=2)),
               ("AdaptiveAvgPool2D", dict(output_size=(3, 2))),
               ("AdaptiveMaxPool2D", dict(output_size=2)),
               ("AdaptiveAvgPool1D", dict(output_size=3)),
               ("AdaptiveMaxPool1D", dict(output_size=3)),
               ("AdaptiveAvgPool3D", dict(output_size=2)),
               ("AdaptiveMaxPool3D", dict(output_size=2))]


@pytest.mark.parametrize("case", POOL_LAYERS, ids=[c[0] for c in POOL_LAYERS])
def test_pool_layer_matches_jax(case):
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as tnn
    name, kw = case
    nd = int(name[-2])
    x = _rand(np.random.RandomState(10), *((2, 3) + (6,) * nd))
    j = getattr(jnn, name)(**kw)(paddle.to_tensor(x)).numpy()
    t = getattr(tnn, name)(**kw)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, j, rtol=VAL, atol=VAL)

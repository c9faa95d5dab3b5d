"""The port's interpolate, upsample, one_hot and Upsample layers
(paddle_tpu_torch/nn/functional/common.py, nn/layer/common.py) against
the JAX package's.

Every mode (nearest, bilinear with and without align_corners, bicubic
with and without, area, linear on 3-d and trilinear on 5-d inputs), up
and down, by size and by scale factor, NCHW and NHWC. The inputs come
from a numpy seed; the outputs are held at 1e-6 x max(1, max|ref|) and
the gradients of sum(out * c) for the input at 1e-5 x max(1, max|ref|).
Downsampling without align_corners in the linear modes is
jax.image.resize's antialiased triangle, which the port writes out; its
contraction is a sum over up to 2 x in/out taps in another order than
XLA's, hence the same 1e-6 relative bound rather than bit equality.
Nearest gathers the same source rows, so it is held bit-equal.
"""
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

VAL, GRAD = 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: tier-1 runs several workers on the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _run_both(jfn, tfn, x, seed=1):
    """(port out, JAX out, port grad, JAX grad) of sum(out * c)."""
    jt = paddle.to_tensor(x, stop_gradient=False)
    jout = jfn(jt)
    cot = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    (jout * paddle.to_tensor(cot)).sum().backward()
    tt = torch.from_numpy(x.copy()).requires_grad_(True)
    tout = tfn(tt)
    (tout * torch.from_numpy(cot)).sum().backward()
    return (tout.detach().numpy(), jout.numpy(), tt.grad.numpy(),
            jt.grad.numpy())


def _check(jfn, tfn, x, exact=False):
    t_out, j_out, t_g, j_g = _run_both(jfn, tfn, x)
    if exact:
        np.testing.assert_array_equal(t_out, j_out)
    _close(t_out, j_out, VAL)
    _close(t_g, j_g, GRAD)


# (mode, align_corners, in spatial, size or None, scale or None)
CASES = [
    ("nearest", False, (6, 5), None, 2),
    ("nearest", False, (6, 5), (9, 7), None),      # ratio not an integer
    ("nearest", False, (9, 8), (4, 3), None),      # down
    ("bilinear", False, (6, 5), (11, 9), None),
    ("bilinear", False, (12, 10), (5, 4), None),   # antialiased down
    ("bilinear", True, (6, 5), (11, 9), None),
    ("bilinear", True, (12, 10), (5, 4), None),
    ("bilinear", True, (6, 5), (1, 3), None),      # a one-row output
    ("bicubic", False, (6, 5), (11, 9), None),
    ("bicubic", False, (12, 10), (5, 4), None),
    ("bicubic", True, (6, 5), (11, 9), None),
    ("bicubic", True, (12, 10), (5, 4), None),
    ("area", False, (12, 10), (4, 5), None),       # divisible
    ("area", False, (11, 9), (4, 5), None),        # uneven
    ("bilinear", False, (6, 6), (6, 9), None),     # one axis kept
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode,align,spatial,size,scale", CASES,
                         ids=[f"{c[0]}-{'ac' if c[1] else 'hp'}-"
                              f"{c[2][0]}x{c[2][1]}-"
                              f"{c[3] or 'x' + str(c[4])}" for c in CASES])
def test_interpolate_matches_jax(mode, align, spatial, size, scale, layout):
    rng = np.random.RandomState(zlib.crc32(repr((mode, spatial, size))
                                           .encode()))
    shape = (2, 3) + spatial if layout == "NCHW" else (2,) + spatial + (3,)
    x = rng.randn(*shape).astype(np.float32)
    kw = dict(size=size, scale_factor=scale, mode=mode,
              align_corners=align, data_format=layout)
    _check(lambda t: JF.interpolate(t, **kw),
           lambda t: TF.interpolate(t, **kw), x, exact=mode == "nearest")


@pytest.mark.parametrize("mode,shape,size,layout", [
    ("linear", (2, 3, 7), (12,), "NCW"),
    ("linear", (2, 13, 3), (5,), "NWC"),
    ("trilinear", (1, 2, 4, 5, 3), (6, 3, 5), "NCDHW"),
    ("nearest", (1, 2, 4, 5, 3), (7, 3, 6), "NCDHW"),
])
def test_one_and_three_spatial_axes(mode, shape, size, layout):
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    kw = dict(size=size, mode=mode, data_format=layout)
    _check(lambda t: JF.interpolate(t, **kw),
           lambda t: TF.interpolate(t, **kw), x)


def test_upsample_is_interpolate():
    x = np.random.RandomState(2).randn(1, 2, 5, 4).astype(np.float32)
    _check(lambda t: JF.upsample(t, scale_factor=3, mode="bilinear"),
           lambda t: TF.upsample(t, scale_factor=3, mode="bilinear"), x)


@pytest.mark.parametrize("name,kw", [
    ("Upsample", dict(scale_factor=2, mode="nearest")),
    ("Upsample", dict(size=(7, 9), mode="bicubic", align_corners=True)),
    ("UpsamplingNearest2D", dict(scale_factor=2)),
    ("UpsamplingBilinear2D", dict(size=(8, 6))),
    ("Upsample", dict(scale_factor=2, mode="bilinear",
                      data_format="NHWC")),
])
def test_upsample_layers(name, kw):
    shape = (2, 5, 4, 3) if kw.get("data_format") == "NHWC" else (2, 3, 5, 4)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw)
    _check(jl, tl, x)


def test_upsampling_bilinear_aligns_corners():
    layer = tnn.UpsamplingBilinear2D(scale_factor=2)
    assert layer.mode == "bilinear" and layer.align_corners


def test_nearest_backward_is_deterministic_sum():
    """The nearest gather's backward sums each source's repeated rows
    (index_add under the deterministic flag): x2 nearest gives every
    source pixel 4 copies."""
    x = torch.randn(1, 1, 3, 3, requires_grad=True)
    TF.interpolate(x, scale_factor=2).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 4.0))
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("num_classes", [4, 7])
def test_one_hot(num_classes):
    idx = np.array([[0, 3, 1], [2, 5, -1]], np.int32)
    want = JF.one_hot(paddle.to_tensor(idx), num_classes).numpy()
    got = TF.one_hot(torch.from_numpy(idx), num_classes)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)

"""The port's vision model zoo (paddle_tpu_torch/vision/models) against the
JAX package's.

- Every constructor: the state_dict names and shapes equal the JAX
  model's (built under paddle_tpu.utils.abstract_init, which allocates
  nothing), and the port's forward in train and in eval mode gives
  finite logits of the right shape.
- A model of each family (LeNet, ResNet-18, ResNet-50, VGG-11 with
  BatchNorm, MobileNet V1 and V2 at scale 0.25), its JAX twin given
  numpy weights (tests/torch_vision_weights.py): the JAX model's weights
  loaded by name (models/convert.py load_jax_params), the same numpy
  input through both, in train mode (batch statistics, and the running
  statistics it leaves) and in eval mode (running statistics from a
  numpy seed), logits and running statistics within 5e-4 x max(1,
  max|ref|). Not 1e-5: a
  train-mode BatchNorm divides by the standard deviation of a few
  samples per channel at the last stages (8 at ResNet's 2x2 layer4 at
  batch 2), which scales the two packages' summation-order differences
  in the convolutions (1e-6 relative) up to 2e-4 of the largest logit
  (MobileNet V2, measured).
- BasicBlock and BottleneckBlock, each with a stride-2 downsample: the
  output, the input's gradient and every parameter's gradient of
  sum(out * c), at 1e-5 (values) and 1e-4 (gradients), and the running
  statistics after the call.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.utils.abstract_init import abstract_parameters
from paddle_tpu.vision import models as JM
from paddle_tpu.vision.models import resnet as JR
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.vision import models as TM
from paddle_tpu_torch.vision.models import resnet as TR
from torch_vision_weights import jax_vision_model

VAL, GRAD, MODEL = 1e-5, 1e-4, 5e-4

CONSTRUCTORS = [
    ("LeNet", {}, (2, 1, 28, 28)),
    ("resnet18", {}, (2, 3, 32, 32)), ("resnet34", {}, (2, 3, 32, 32)),
    ("resnet50", {}, (2, 3, 32, 32)), ("resnet101", {}, (2, 3, 32, 32)),
    ("resnet152", {}, (2, 3, 32, 32)),
    ("wide_resnet50_2", {}, (2, 3, 32, 32)),
    ("wide_resnet101_2", {}, (2, 3, 32, 32)),
    ("vgg11", {}, (2, 3, 32, 32)), ("vgg13", {}, (2, 3, 32, 32)),
    ("vgg16", dict(batch_norm=True), (2, 3, 32, 32)),
    ("vgg19", {}, (2, 3, 32, 32)),
    ("mobilenet_v1", {}, (2, 3, 32, 32)),
    ("mobilenet_v2", {}, (2, 3, 32, 32)),
]



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: tier-1 runs several workers on the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name,kw,xshape", CONSTRUCTORS,
                         ids=[c[0] for c in CONSTRUCTORS])
def test_constructor_names_shapes_and_forward(name, kw, xshape):
    with abstract_parameters():
        j = getattr(JM, name)(num_classes=10, **kw)
    want = {k: tuple(np.shape(v._data)) for k, v in j.state_dict().items()}
    torch.manual_seed(0)
    t = getattr(TM, name)(num_classes=10, device="cpu", **kw)
    got = {k: tuple(v.shape) for k, v in t.state_dict().items()}
    assert list(got) == list(want)
    assert got == want
    x = torch.from_numpy(_x(*xshape))
    for mode in ("train", "eval"):
        getattr(t, mode)()
        with torch.no_grad():
            out = t(x)
        assert out.shape == (xshape[0], 10)
        assert torch.isfinite(out).all(), mode


FORWARD = [
    ("LeNet", {}, (4, 1, 28, 28)),
    ("resnet18", {}, (2, 3, 64, 64)),
    ("resnet50", {}, (2, 3, 64, 64)),
    ("vgg11", dict(batch_norm=True), (2, 3, 32, 32)),
    ("mobilenet_v1", dict(scale=0.25), (2, 3, 64, 64)),
    ("mobilenet_v2", dict(scale=0.25), (2, 3, 64, 64)),
]


def _model_close(got, ref):
    tol = MODEL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=MODEL, atol=tol)


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("name,kw,xshape", FORWARD,
                         ids=[c[0] for c in FORWARD])
def test_forward_matches_jax(name, kw, xshape, mode):
    """train: the batch statistics' forward (MobileNet V2's and VGG's
    classifiers hold Dropout, so their features) and the running
    statistics it leaves; eval: the whole model, normalising with
    running statistics given from a numpy seed (mean N(0, 0.1), variance
    U(0.5, 1.5))."""
    j = jax_vision_model(name, **kw)
    t = getattr(TM, name)(num_classes=10, device="cpu", **kw)
    state = {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()}
    rng = np.random.default_rng(5)
    if mode == "eval":
        for k, v in state.items():
            if k.endswith("_mean"):
                state[k] = 0.1 * rng.standard_normal(v.shape, np.float32)
            elif k.endswith("_variance"):
                state[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        for k, tt in j.state_dict().items():
            tt._data = jnp.asarray(state[k])
    load_jax_params(t, state)
    x = _x(*xshape, seed=1)
    getattr(j, mode)()
    getattr(t, mode)()
    if mode == "eval":
        with torch.no_grad():
            got = t(torch.from_numpy(x)).numpy()
        _model_close(got, j(paddle.to_tensor(x)).numpy())
        return
    body_j = getattr(j, "features", j) if name != "LeNet" else j
    body_t = getattr(t, "features", t) if name != "LeNet" else t
    _model_close(body_t(torch.from_numpy(x)).detach().numpy(),
                 body_j(paddle.to_tensor(x)).numpy())
    for k, v in j.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(
                t.state_dict()[k].numpy(), np.asarray(v.numpy()),
                rtol=MODEL, atol=MODEL, err_msg=k)


@pytest.mark.parametrize("block,planes", [("BasicBlock", 6),
                                          ("BottleneckBlock", 3)])
def test_block_gradients_with_strided_downsample(block, planes):
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as tnn
    inplanes, exp = 4, getattr(JR, block).expansion
    paddle.seed(1)
    jds = jnn.Sequential(jnn.Conv2D(inplanes, planes * exp, 1, stride=2,
                                    bias_attr=False),
                         jnn.BatchNorm2D(planes * exp))
    j = getattr(JR, block)(inplanes, planes, stride=2, downsample=jds)
    tds = tnn.Sequential(tnn.Conv2D(inplanes, planes * exp, 1, stride=2,
                                    bias_attr=False, device="cpu"),
                         tnn.BatchNorm2D(planes * exp, device="cpu"))
    t = getattr(TR, block)(inplanes, planes, stride=2, downsample=tds,
                           device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()}
    load_jax_params(t, state)
    x = _x(3, inplanes, 8, 7, seed=3)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jo = j(jx)
    c = _x(*jo.shape, seed=4)
    (jo * paddle.to_tensor(c)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    to = t(tx)
    (to * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), rtol=VAL,
                               atol=VAL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=GRAD,
                               atol=GRAD)
    jparams = dict(j.named_parameters())
    for k, p in t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   jparams[k].grad.numpy(), rtol=GRAD,
                                   atol=GRAD, err_msg=k)
    for k, v in j.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(t.state_dict()[k].numpy(),
                                       np.asarray(v.numpy()), rtol=VAL,
                                       atol=VAL, err_msg=k)

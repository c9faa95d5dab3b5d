"""The rest of paddle.nn's layers against the JAX package's: the common
layers beyond Linear, Dropout, Embedding and Upsample (Identity, the
dropouts, Flatten, the pads, CosineSimilarity, Bilinear, the shuffles,
Unfold, Fold, PairwiseDistance) and every loss layer of
nn/layer/loss.py, CrossEntropyLoss first.

Each case builds the layer in both packages from the same arguments,
carries the JAX layer's parameters across by name (load_jax_params),
feeds the same numpy inputs (seeded) and compares the output and the
gradients of sum(out * w) with respect to every float input and every
parameter, at 1e-6 x max(1, |ref|) for element-wise layers and 1e-5
for reductions and products (the op tables' classes). The dropouts run
in eval mode here; their masks are tested in
tests/test_torch_nn_functional_rest.py.
"""
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.models import load_jax_params
from torch_ops_cases import Gen, I, R, U
from torch_ops_parity import close

TOLS = {"elem": 1e-6, "reduce": 1e-5}


class Tensor:
    """A constructor argument that is a tensor in each package (a class
    weight): made from this numpy array, no gradient."""

    def __init__(self, value):
        self.value = np.asarray(value)


class L:
    def __init__(self, cls, args, inputs, tol="elem", eval_mode=False,
                 tag=None, call_kw=None, **kwargs):
        self.cls, self.args, self.kwargs = cls, args, kwargs
        self.inputs, self.tol, self.eval_mode = inputs, tol, eval_mode
        self.call_kw = call_kw or {}
        self.id = f"{cls}-{tag}" if tag else cls

    def __repr__(self):
        return self.id


def _draw(case):
    rng = np.random.RandomState(zlib.crc32(case.id.encode()))
    return [v.make(rng) if isinstance(v, Gen) else np.asarray(v)
            for v in case.inputs], rng


def _ctor(case, to_tensor):
    def conv(v):
        return to_tensor(v.value) if isinstance(v, Tensor) else v
    return ([conv(a) for a in case.args],
            {k: conv(v) for k, v in case.kwargs.items()})


def _run_jax(case, arrays, rng_state):
    args, kw = _ctor(case, jp.to_tensor)
    layer = getattr(jnn, case.cls)(*args, **kw)
    if case.eval_mode:
        layer.eval()
    xs = [jp.to_tensor(a, stop_gradient=a.dtype != np.float32)
          for a in arrays]
    out = layer(*xs, **case.call_kw)
    rng = np.random.RandomState(rng_state)
    w = np.asarray(rng.randn(*out.shape), np.float32)
    jp.sum(out * jp.to_tensor(w)).backward()
    params = dict(layer.named_parameters())
    return (layer, np.asarray(out.numpy()),
            [None if x.stop_gradient else
             np.zeros(x.shape, np.float32) if x.grad is None else
             np.asarray(x.grad.numpy()) for x in xs],
            {k: np.asarray(p.grad.numpy()) for k, p in params.items()}, w)


def _run_torch(case, arrays, state, w):
    args, kw = _ctor(case, lambda v: torch.from_numpy(np.array(v)))
    layer = getattr(tnn, case.cls)(*args, **kw)
    load_jax_params(layer, state)
    if case.eval_mode:
        layer.eval()
    xs = [torch.from_numpy(a.copy()).requires_grad_(a.dtype == np.float32)
          for a in arrays]
    out = layer(*xs, **case.call_kw)
    (out * torch.from_numpy(w)).sum().backward()
    return (out.detach().numpy(),
            [None if not x.requires_grad else
             np.zeros(x.shape, np.float32) if x.grad is None else
             x.grad.numpy() for x in xs],
            {k: p.grad.numpy() for k, p in layer.named_parameters()})


CASES = [
    L("Identity", [], [R(3, 4)]),
    L("Dropout2D", [0.3], [R(2, 3, 4, 5)], eval_mode=True),
    L("Dropout3D", [0.3], [R(2, 3, 2, 4, 5)], eval_mode=True),
    L("AlphaDropout", [0.3], [R(4, 6)], eval_mode=True),
    L("Flatten", [], [R(2, 3, 4, 5)]),
    L("Flatten", [0, 2], [R(2, 3, 4, 5)], tag="0-2"),
    L("Pad1D", [[1, 2]], [R(2, 3, 5)]),
    L("Pad1D", [[2, 1]], [R(2, 3, 5)], mode="reflect", tag="reflect"),
    L("Pad2D", [[1, 0, 2, 1]], [R(2, 3, 4, 5)], value=0.5),
    L("Pad2D", [1], [R(2, 3, 4, 5)], mode="replicate", tag="replicate"),
    L("Pad2D", [[1, 1, 0, 2]], [R(2, 4, 5, 3)], mode="circular",
      data_format="NHWC", tag="circular-nhwc"),
    L("Pad3D", [[1, 0, 0, 1, 1, 1]], [R(1, 2, 3, 4, 5)]),
    L("ZeroPad2D", [[1, 2, 3, 0]], [R(2, 3, 4, 5)]),
    L("CosineSimilarity", [], [R(4, 5), R(4, 5)], tol="reduce"),
    L("CosineSimilarity", [2, 1e-6], [R(3, 4, 6), R(3, 4, 6)],
      tol="reduce", tag="axis2"),
    L("Bilinear", [3, 5, 6], [R(4, 3), R(4, 5)], tol="reduce"),
    L("Bilinear", [3, 5, 2], [R(4, 3), R(4, 5)], tol="reduce",
      bias_attr=False, tag="nobias"),
    L("PixelShuffle", [2], [R(2, 8, 3, 4)]),
    L("PixelShuffle", [3, "NHWC"], [R(2, 3, 4, 18)], tag="nhwc"),
    L("PixelUnshuffle", [2], [R(2, 3, 6, 4)]),
    L("ChannelShuffle", [3], [R(2, 6, 3, 2)]),
    L("Unfold", [[2, 3]], [R(2, 3, 6, 7)], tol="reduce"),
    L("Unfold", [3, 2, 1, 1], [R(2, 2, 7, 6)], tol="reduce", tag="strided"),
    L("Fold", [[6, 7], [2, 3]], [R(2, 12, 25)], tol="reduce"),
    L("PairwiseDistance", [], [R(4, 5), R(4, 5)], tol="reduce"),
    L("PairwiseDistance", [1.0, 1e-6, True], [R(4, 5), R(4, 5)],
      tol="reduce", tag="p1-keepdim"),
    L("PairwiseDistance", [float("inf")], [R(4, 5), R(4, 5)], tol="reduce",
      tag="inf"),
    # -- losses -------------------------------------------------------------
    L("CrossEntropyLoss", [], [R(6, 7), np.array([0, 3, 6, -100, 2, 2])],
      tol="reduce"),
    L("CrossEntropyLoss", [Tensor(np.linspace(0.5, 2, 7, dtype=np.float32))],
      [R(6, 7), np.array([0, 3, 6, 1, 2, 2])], tol="reduce", tag="weight"),
    L("CrossEntropyLoss", [], [R(6, 7), U(0, 1, 6, 7)], soft_label=True,
      reduction="sum", tol="reduce", tag="soft"),
    L("CrossEntropyLoss", [], [R(2, 3, 7), I(0, 7, 2, 3)],
      label_smoothing=0.1, reduction="none", tol="reduce", tag="smooth"),
    L("BCELoss", [], [U(0.02, 0.98, 4, 5), U(0, 1, 4, 5)], tol="reduce"),
    L("BCEWithLogitsLoss", [], [R(4, 5), U(0, 1, 4, 5)], tol="reduce",
      pos_weight=Tensor(np.linspace(0.5, 3, 5, dtype=np.float32))),
    L("NLLLoss", [], [R(6, 5), np.array([0, 4, -100, 2, 2, 1])],
      tol="reduce"),
    L("MSELoss", [], [R(4, 5), R(4, 5)], tol="reduce"),
    L("L1Loss", ["sum"], [R(4, 5), R(4, 5)], tol="reduce"),
    L("SmoothL1Loss", ["mean", 0.7], [R(4, 5), R(4, 5)], tol="reduce"),
    L("KLDivLoss", ["batchmean"], [R(4, 5), U(0.05, 1, 4, 5)],
      tol="reduce"),
    L("MarginRankingLoss", [0.2], [R(6), R(6), np.array(
        [1, -1, 1, 1, -1, -1], np.float32)], tol="reduce"),
    L("HingeEmbeddingLoss", [], [R(6), np.array([1, -1, 1, 1, -1, -1],
                                                np.float32)], tol="reduce"),
    L("CosineEmbeddingLoss", [0.1], [R(5, 4), R(5, 4),
                                     np.array([1, -1, 1, -1, 1])],
      tol="reduce"),
    L("CTCLoss", [], [np.log(np.random.RandomState(3).dirichlet(
        np.ones(5), (7, 3)).astype(np.float32)),
        np.array([[1, 2, 2], [3, 1, 0], [4, 4, 4]]), np.array([7, 6, 7]),
        np.array([3, 2, 3])], tol="reduce"),
    L("SigmoidFocalLoss", [], [R(4, 6), U(0, 1, 4, 6)], tol="reduce"),
    L("TripletMarginLoss", [], [R(5, 4), R(5, 4), R(5, 4)], tol="reduce"),
    L("TripletMarginWithDistanceLoss", [], [R(5, 4), R(5, 4), R(5, 4)],
      tol="reduce"),
    L("TripletMarginWithDistanceLoss", [], [R(5, 4), R(5, 4), R(5, 4)],
      distance_function=lambda a, b: (a - b).abs().sum(-1), swap=True,
      tol="reduce", tag="custom"),
    L("MultiLabelSoftMarginLoss", [], [R(4, 5), U(0, 1, 4, 5)],
      tol="reduce"),
    L("SoftMarginLoss", [], [R(4, 5), np.sign(np.random.RandomState(4)
                                              .randn(4, 5)).astype(
        np.float32)], tol="reduce"),
    L("PoissonNLLLoss", [], [R(4, 5), U(0, 5, 4, 5)], tol="reduce"),
    L("GaussianNLLLoss", [], [R(4, 5), R(4, 5), U(0.1, 2, 4, 5)],
      tol="reduce"),
    L("HSigmoidLoss", [4, 6], [R(5, 4), I(0, 6, 5)], tol="reduce"),
]

LOSS_LAYERS = (
    "HSigmoidLoss", "CrossEntropyLoss", "BCELoss", "BCEWithLogitsLoss",
    "NLLLoss", "MSELoss", "L1Loss", "SmoothL1Loss", "KLDivLoss",
    "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
    "CTCLoss", "SigmoidFocalLoss", "TripletMarginLoss",
    "TripletMarginWithDistanceLoss", "MultiLabelSoftMarginLoss",
    "SoftMarginLoss", "PoissonNLLLoss", "GaussianNLLLoss")


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_layer_matches_jax(case):
    arrays, rng = _draw(case)
    jp.seed(0)
    state_seed = int(rng.randint(0, 2 ** 31 - 1))
    layer, out, gin, gparam, w = _run_jax(case, arrays, state_seed)
    state = {k: np.asarray(v.numpy()) for k, v in
             layer.state_dict().items()}
    tout, tgin, tgparam = _run_torch(case, arrays, state, w)
    tol = TOLS[case.tol]
    close(tout, out, tol, f"{case.id} out")
    for i, (g, want) in enumerate(zip(tgin, gin)):
        if want is not None:
            close(g, want, tol, f"{case.id} grad[{i}]")
    assert sorted(tgparam) == sorted(gparam)
    for k in gparam:
        close(tgparam[k], gparam[k], tol, f"{case.id} grad {k}")


def test_every_loss_layer_and_common_layer_has_a_case():
    from paddle_tpu.nn.layer import common, loss
    done = {"Linear", "Dropout", "Embedding", "Upsample",
            "UpsamplingNearest2D", "UpsamplingBilinear2D"}
    cased = {c.cls for c in CASES}
    assert sorted(set(loss.__all__) - cased) == []
    assert sorted(set(LOSS_LAYERS) ^ set(loss.__all__)) == []
    assert sorted(set(common.__all__) - done - cased) == []


def test_hapi_quick_start_takes_the_loss_layer():
    """Paddle 2.0's quick start, model.prepare(opt,
    paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy()), in both
    packages from the same weights and rows: fit's losses at 1e-4 (as
    tests/test_torch_hapi.py holds the lambda-loss form) and the same
    evaluation."""
    rng = np.random.RandomState(0)
    xs = rng.randn(20, 6).astype(np.float32)
    ys = rng.randint(0, 3, (20, 1)).astype(np.int64)

    def rows(pkg):
        class Rows(pkg.io.Dataset):
            def __len__(self):
                return 20

            def __getitem__(self, i):
                return xs[i], ys[i]
        return Rows()

    losses = {}
    evals = {}
    jp.seed(0)
    jnet = jnn.Linear(6, 3)
    tnet = tnn.Linear(6, 3)
    load_jax_params(tnet, {k: np.asarray(v.numpy())
                           for k, v in jnet.state_dict().items()})
    for name, pkg, net in (("jax", jp, jnet), ("torch", pt, tnet)):
        class Rec(pkg.hapi.Callback):
            seen = []

            def on_train_batch_end(self, step, logs=None):
                self.seen.append(logs["loss"][0])
        rec = Rec()
        rec.seen = []
        model = pkg.Model(net)
        model.prepare(pkg.optimizer.SGD(learning_rate=0.5,
                                        parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
        model.fit(rows(pkg), batch_size=4, epochs=2, shuffle=False,
                  verbose=0, callbacks=[rec])
        losses[name] = rec.seen
        evals[name] = model.evaluate(rows(pkg), batch_size=5, verbose=0)
    assert len(losses["torch"]) == 10
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-4)
    np.testing.assert_allclose(evals["torch"]["loss"], evals["jax"]["loss"],
                               rtol=1e-4)
    assert evals["torch"]["acc"] == evals["jax"]["acc"]

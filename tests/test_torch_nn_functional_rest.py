"""The rest of paddle.nn.functional against the JAX package's: the common
functionals (dropouts, im2col/col2im, the shuffles, similarity,
bilinear, label smoothing, sequence masks, the temporal shift, the npair
loss, zero padding), the vision sampling ops F exports (affine_grid,
grid_sample, max_unpool2d, diag_embed), nn.functional.extension, and
every loss of nn/functional/loss.py beyond cross_entropy.

One parametrised case per configuration, run by tests/torch_ops_parity.py
through both packages on the CPU from one numpy seed: values, and the
gradients of sum(out * w) with respect to every float input. Tolerances
as the op tables: "elem" 1e-6 x max(1, |ref|) for element-wise results,
"reduce" 1e-5 for reductions and products. The random functionals
(dropout2d/3d, alpha_dropout) cannot match JAX's bits: their eval and
p = 0 forms are held against the JAX package, their masks by statistics.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from torch_ops_cases import ARG, Case, I, R, U
from torch_ops_parity import check_case

CASES = []


def C(fn, *args, tol="elem", grad=True, tag=None, **kwargs):
    """A case of nn.functional.<fn> (a dotted name below it for the
    extension module)."""
    name = f"nn.functional.{fn}"
    cid = f"{fn}-{tag or sum(c.fn == name for c in CASES) + 1}"
    CASES.append(Case(name, args, kwargs, tol, grad, cid,
                      "nn.functional"))


def _log_softmax(x, axis):
    x = x - x.max(axis, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis, keepdims=True))).astype(
        np.float32)


_RNG = np.random.RandomState(17)

# -- common -----------------------------------------------------------------
C("unfold", R(2, 3, 6, 7), ARG([2, 3]), tol="reduce")
C("unfold", R(2, 2, 7, 6), ARG(3), ARG(2), ARG(1), ARG(1), tol="reduce")
C("unfold", R(1, 2, 6, 6), ARG([2, 2]), ARG(1), ARG([1, 0, 2, 1]), ARG(2),
  tol="reduce", tag="pad4")
C("fold", R(2, 12, 25), ARG([6, 7]), ARG([2, 3]), tol="reduce")
C("fold", R(1, 18, 16), ARG([7, 7]), ARG(3), ARG(2), ARG(1), tol="reduce",
  tag="strided")
C("pixel_shuffle", R(2, 8, 3, 4), ARG(2))
C("pixel_shuffle", R(2, 3, 4, 18), ARG(3), ARG("NHWC"))
C("pixel_unshuffle", R(2, 3, 6, 4), ARG(2))
C("channel_shuffle", R(2, 6, 3, 2), ARG(3))
C("cosine_similarity", R(4, 5), R(4, 5), tol="reduce")
C("cosine_similarity", R(3, 4, 6), R(3, 4, 6), axis=2, tol="reduce")
C("bilinear", R(4, 3), R(4, 5), R(6, 3, 5), R(6), tol="reduce")
C("bilinear", R(4, 3), R(4, 5), R(2, 3, 5), tol="reduce", tag="nobias")
C("label_smooth", U(0, 1, 4, 6))
C("label_smooth", U(0, 1, 4, 6), U(0, 1, 1, 6), epsilon=0.2, tag="prior")
C("sequence_mask", I(0, 6, 5), maxlen=6, grad=False)
C("sequence_mask", I(0, 4, 2, 3), maxlen=4, dtype="float32", grad=False)
C("temporal_shift", R(6, 8, 2, 3), ARG(3))
C("temporal_shift", R(4, 2, 3, 10), ARG(2), 0.2, "NHWC", tag="nhwc")
C("npair_loss", R(5, 4), R(5, 4), I(0, 3, 5), tol="reduce")
C("zeropad2d", R(2, 3, 4, 5), ARG([1, 2, 0, 3]))

# -- vision sampling (ops/extras.py) and the extension module --------------
C("affine_grid", R(2, 2, 3), ARG([2, 3, 4, 5]), tol="reduce")
C("affine_grid", R(2, 2, 3), ARG([2, 3, 4, 5]), align_corners=False,
  tol="reduce", tag="unaligned")
for mode in ("bilinear", "nearest"):
    for padding in ("zeros", "border", "reflection"):
        for align in (True, False):
            C("grid_sample", R(2, 3, 5, 6), U(-1.3, 1.3, 2, 4, 3, 2),
              mode=mode, padding_mode=padding, align_corners=align,
              tol="reduce", tag=f"{mode}-{padding}-{align}")
C("max_unpool2d", R(2, 2, 2, 2),
  np.array([[[0, 3, 9, 14], [1, 6, 8, 15]],
            [[5, 2, 12, 11], [4, 7, 10, 13]]]).reshape(2, 2, 2, 2),
  ARG(2))
C("max_unpool2d", R(1, 2, 2, 3),
  np.array([[[1, 2, 10, 11, 20, 22], [0, 4, 9, 13, 18, 23]]]).reshape(
      1, 2, 2, 3), ARG(2), output_size=ARG([5, 5]), tag="sized")
C("diag_embed", R(3, 4))
C("diag_embed", R(2, 3), offset=1, tag="above")
C("diag_embed", R(2, 3), offset=-2, tag="below")
C("diag_embed", R(2, 3, 4), 0, 0, 2, tag="dims")
C("extension.sequence_mask", I(0, 7, 5), grad=False)
C("extension.gather_tree", I(0, 9, 4, 2, 3), I(0, 3, 4, 2, 3), grad=False)

# -- losses -------------------------------------------------------------------
for red in ("mean", "sum", "none"):
    C("binary_cross_entropy", U(0.02, 0.98, 4, 5), U(0, 1, 4, 5),
      reduction=red, tol="reduce", tag=red)
    C("mse_loss", R(4, 5), R(4, 5), reduction=red, tol="reduce", tag=red)
    C("l1_loss", R(4, 5), R(4, 5), reduction=red, tol="reduce", tag=red)
C("binary_cross_entropy", U(0.02, 0.98, 4, 5), U(0, 1, 4, 5), U(0, 2, 5),
  tol="reduce", tag="weight")
C("binary_cross_entropy_with_logits", R(4, 5), U(0, 1, 4, 5), tol="reduce")
C("binary_cross_entropy_with_logits", R(4, 5), U(0, 1, 4, 5), U(0, 2, 5),
  "sum", U(0.5, 3, 5), tol="reduce", tag="weights")
C("nll_loss", R(6, 5), np.array([0, 4, -100, 2, 2, 1]), tol="reduce")
C("nll_loss", R(6, 5), np.array([0, 4, 3, 2, 2, 1]), U(0.5, 2, 5),
  tol="reduce", tag="weight")
C("nll_loss", R(6, 5), np.array([0, 4, 7, 2, 2, 1]), ignore_index=7,
  reduction="sum", tol="reduce", tag="sum")
C("smooth_l1_loss", R(4, 5), R(4, 5), tol="reduce")
C("smooth_l1_loss", R(4, 5), R(4, 5), "none", 0.5, tol="reduce",
  tag="delta")
C("kl_div", R(4, 5), U(0.05, 1, 4, 5), tol="reduce")
C("kl_div", R(4, 5), R(4, 5), "batchmean", True, tol="reduce", tag="log")
C("margin_ranking_loss", R(6), R(6), np.array([1, -1, 1, 1, -1, -1],
                                               np.float32), 0.3,
  tol="reduce")
C("hinge_embedding_loss", R(6), np.array([1, -1, 1, 1, -1, -1],
                                          np.float32), tol="reduce")
C("cosine_embedding_loss", R(5, 4), R(5, 4), np.array([1, -1, 1, -1, 1]),
  0.2, tol="reduce")
C("log_loss", U(0.05, 0.95, 5, 1), U(0, 1, 5, 1), tol="reduce")
C("square_error_cost", R(4, 3), R(4, 3))
C("sigmoid_focal_loss", R(4, 6), U(0, 1, 4, 6), tol="reduce")
C("sigmoid_focal_loss", R(4, 6), U(0, 1, 4, 6), U(1, 3, 1), -1.0, 1.5,
  "mean", tol="reduce", tag="normalizer")
C("dice_loss", U(0, 1, 3, 4, 5), I(0, 5, 3, 4, 1), tol="reduce")
C("soft_margin_loss", R(4, 5), np.sign(_RNG.randn(4, 5)).astype(np.float32),
  tol="reduce")
C("multi_label_soft_margin_loss", R(4, 5), U(0, 1, 4, 5), tol="reduce")
C("multi_label_soft_margin_loss", R(4, 5), U(0, 1, 4, 5), U(0.5, 2, 4),
  "sum", tol="reduce", tag="weight")
C("triplet_margin_loss", R(5, 4), R(5, 4), R(5, 4), tol="reduce")
C("triplet_margin_loss", R(5, 4), R(5, 4), R(5, 4), 0.5, 1.0, 1e-6, True,
  "sum", tol="reduce", tag="swap-p1")
C("triplet_margin_with_distance_loss", R(5, 4), R(5, 4), R(5, 4),
  tol="reduce")
C("poisson_nll_loss", R(4, 5), U(0, 5, 4, 5), tol="reduce")
C("poisson_nll_loss", U(0.1, 3, 4, 5), U(0, 5, 4, 5), False, True,
  tol="reduce", tag="full")
C("gaussian_nll_loss", R(4, 5), R(4, 5), U(0.1, 2, 4, 5), tol="reduce")
C("gaussian_nll_loss", R(4, 5), R(4, 5), U(0.1, 2, 4, 5), True,
  reduction="sum", tol="reduce", tag="full")
C("ctc_loss", _log_softmax(_RNG.randn(7, 3, 5).astype(np.float32), 2),
  np.array([[1, 2, 2], [3, 1, 0], [4, 4, 4]]), np.array([7, 6, 7]),
  np.array([3, 2, 3]), tol="reduce")
C("ctc_loss", _log_softmax(_RNG.randn(6, 2, 4).astype(np.float32), 2),
  np.array([[1, 3], [2, 0]]), np.array([6, 4]), np.array([2, 1]),
  blank=0, reduction="sum", norm_by_times=True, tol="reduce", tag="norm")
C("softmax_with_cross_entropy_label_smooth", R(5, 7), I(0, 7, 5),
  tol="reduce")
C("hsigmoid_loss", R(6, 4), I(0, 5, 6), ARG(5), R(4, 4), R(4),
  tol="reduce")
C("hsigmoid_loss", R(6, 4), I(0, 8, 6), ARG(8), R(7, 4), tol="reduce",
  tag="nobias")


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_matches_jax(case):
    check_case(case)


def test_every_new_name_has_a_case():
    """Every name of nn/functional/common.py's and loss.py's __all__
    beyond those already ported has a case here (or is random or
    raises: tested below), and so does each ops/extras.py name F
    exports."""
    from paddle_tpu.nn.functional import common, loss
    done = {"linear", "dropout", "embedding", "one_hot", "interpolate",
            "upsample", "pad", "cross_entropy", "softmax_with_cross_entropy",
            "linear_cross_entropy"}
    elsewhere = {"dropout2d", "dropout3d", "alpha_dropout",
                 "class_center_sample"}
    cased = {c.fn.split(".")[-1] for c in CASES}
    want = (set(common.__all__) | set(loss.__all__)
            | {"affine_grid", "grid_sample", "max_unpool2d", "diag_embed",
               "gather_tree"}) - done - elsewhere
    assert sorted(want - cased) == []


def test_ported_names_are_the_same_objects():
    import paddle_tpu_torch.nn as nn
    assert F.abs is pt.abs and F.sqrt is pt.sqrt and F.square is pt.square
    assert F.pad is pt.pad and F.gather_tree is pt.gather_tree
    assert F.diag_embed is pt.diag_embed and F.grid_sample is pt.grid_sample
    assert nn.ParamAttr is pt.ParamAttr
    assert pt.sequence_mask is F.extension.sequence_mask


def test_raising_forms_match_jax():
    import paddle_tpu.nn.functional as JF
    x = np.arange(4)
    with pytest.raises(ValueError, match="maxlen"):
        F.sequence_mask(torch.from_numpy(x))
    # the JAX package wraps the op's ValueError in its EnforceNotMet
    with pytest.raises(Exception, match="maxlen"):
        JF.sequence_mask(jp.to_tensor(x))
    for mod in (F, JF):
        with pytest.raises(NotImplementedError, match="dynamic shapes"):
            mod.class_center_sample(None, 10, 4)


# -- the random functionals -------------------------------------------------

@pytest.mark.parametrize("fn,shape,kw", [
    ("dropout2d", (2, 3, 4, 5), {}),
    ("dropout2d", (2, 4, 5, 3), {"data_format": "NHWC"}),
    ("dropout3d", (2, 3, 2, 4, 5), {}),
    ("alpha_dropout", (4, 6), {}),
])
def test_random_dropouts_eval_and_p0_match_jax(fn, shape, kw):
    import paddle_tpu.nn.functional as JF
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    for args in ({"training": False}, {"p": 0.0}):
        got = getattr(F, fn)(torch.from_numpy(x), **args, **kw)
        want = getattr(JF, fn)(jp.to_tensor(x), **args, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_dropout2d_drops_whole_channels_seeded():
    x = torch.ones(64, 32, 3, 4)
    pt.seed(5)
    a = F.dropout2d(x, 0.25)
    pt.seed(5)
    b = F.dropout2d(x, 0.25)
    assert torch.equal(a, b)
    per = a.reshape(64, 32, -1)
    # each (sample, channel) plane is all kept (1/0.75) or all dropped
    assert torch.all((per == per[..., :1]).all(-1))
    assert set(torch.unique(per).tolist()) <= {
        0.0, float(np.float32(1.0) / np.float32(0.75))}
    kept = (per[..., 0] > 0).float().mean().item()
    assert abs(kept - 0.75) < 0.04
    nhwc = F.dropout2d(torch.ones(8, 3, 4, 16), 0.5, data_format="NHWC")
    assert torch.all((nhwc == nhwc[:, :1, :1, :]).all())
    d3 = F.dropout3d(torch.ones(8, 16, 2, 3, 4), 0.5).reshape(8, 16, -1)
    assert torch.all((d3 == d3[..., :1]).all(-1))


def test_alpha_dropout_keeps_mean_and_variance():
    pt.seed(7)
    x = torch.randn(400, 500)
    y = F.alpha_dropout(x, 0.2)
    assert abs(y.mean().item()) < 0.02
    assert abs(y.std().item() - 1.0) < 0.02
    dropped = y == y.flatten().mode().values
    assert abs(dropped.float().mean().item() - 0.2) < 0.01


def test_dropout_axis_draws_one_mask_entry_per_index():
    """F.dropout(axis=...) (no longer NotImplementedError): the mask
    varies along the listed axes only."""
    pt.seed(2)
    y = F.dropout(torch.ones(40, 6, 50), 0.5, axis=[0, 2])
    assert torch.all((y == y[:, :1, :]).all(1))
    assert 0.4 < (y[:, 0, :] > 0).float().mean().item() < 0.6

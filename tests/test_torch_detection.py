"""The port's detection ops (paddle_tpu_torch/ops/detection.py and the
greedy-NMS plain version of ops/nms.py) against the JAX package's
paddle_tpu/ops/detection.py, on the CPU.

Inputs come from numpy seeds. Tolerances, float32: values within 1e-6 x
max(1, |ref|) elementwise; integer outputs, keep masks, indices, labels
and counts exact. yolov3_loss is held at 1e-5 relative and its gradient
(against jax.grad of the JAX loss) at 1e-4 of the gradient's max: the
port sums the same terms in another order. The NMS inputs carry many
duplicated scores (rounded to two decimals), so the tie order of top-k
(the lower index first, as jax.lax.top_k) is exercised, and boxes that
overlap at every IoU, so suppression decides often.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import detection as jdet
from paddle_tpu_torch.ops import detection as tdet
from paddle_tpu_torch.ops import nms as tnms

VAL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: tier-1 runs several workers on the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pure(op):
    return getattr(op, "__pure_fn__", op)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "_data", x))


def _close(got, want, tol=VAL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max()
                                                         if want.size
                                                         else 0.0)))


def _exact(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _boxes(rng, n, scale=1.0, lead=()):
    """xyxy boxes with centres in [0, scale] and sides in [0.05, 0.5] x
    scale: neighbours overlap at every IoU."""
    c = rng.rand(*lead, n, 2) * scale
    s = (rng.rand(*lead, n, 2) * 0.45 + 0.05) * scale
    return np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)


# -- geometry -------------------------------------------------------------------

@pytest.mark.parametrize("normalized", [True, False])
def test_iou_similarity(normalized):
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 7, 10.0), _boxes(rng, 5, 10.0)
    _close(tdet.iou_similarity(_t(a), _t(b), box_normalized=normalized),
           _pure(jdet.iou_similarity)(a, b, box_normalized=normalized))


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("var", ["tensor", "list", None])
def test_box_coder_encode(normalized, var):
    rng = np.random.RandomState(1)
    prior, target = _boxes(rng, 6, 5.0), _boxes(rng, 4, 5.0)
    pv = (rng.rand(6, 4).astype(np.float32) + 0.1) if var == "tensor" \
        else None
    variance = [0.1, 0.1, 0.2, 0.2] if var == "list" else None
    kw = dict(code_type="encode_center_size", box_normalized=normalized,
              variance=variance)
    _close(tdet.box_coder(_t(prior), None if pv is None else _t(pv),
                          _t(target), **kw),
           _pure(jdet.box_coder)(prior, pv, target, **kw))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("rank", [2, 3])
def test_box_coder_decode(axis, rank):
    rng = np.random.RandomState(2)
    prior = _boxes(rng, 4, 3.0)
    pv = rng.rand(4, 4).astype(np.float32) + 0.1
    target = (rng.randn(4, 4) if rank == 2 else rng.randn(4, 4, 4)) \
        .astype(np.float32) * 0.3
    kw = dict(code_type="decode_center_size", box_normalized=False,
              axis=axis)
    _close(tdet.box_coder(_t(prior), _t(pv), _t(target), **kw),
           _pure(jdet.box_coder)(prior, pv, target, **kw))
    kw["variance"] = [0.1, 0.1, 0.2, 0.2]
    _close(tdet.box_coder(_t(prior), None, _t(target), **kw),
           _pure(jdet.box_coder)(prior, None, target, **kw))


def test_box_coder_refuses_an_unknown_code_type():
    with pytest.raises(ValueError, match="code_type"):
        tdet.box_coder(torch.zeros(1, 4), None, torch.zeros(1, 4),
                       code_type="other")


@pytest.mark.parametrize("per_image", [False, True])
def test_box_clip(per_image):
    rng = np.random.RandomState(3)
    boxes = (rng.randn(2, 6, 4) * 40 + 20).astype(np.float32)
    info = np.array([[32, 48, 1.0], [40, 30, 2.0]], np.float32)
    if not per_image:
        boxes, info = boxes[0], info[0]
    _close(tdet.box_clip(_t(boxes), _t(info)),
           _pure(jdet.box_clip)(boxes, info))


# -- YOLO -----------------------------------------------------------------------

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
           116, 90, 156, 198, 373, 326]


@pytest.mark.parametrize("clip,scale_xy,thresh", [(True, 1.0, 0.5),
                                                  (False, 1.05, 0.3),
                                                  (True, 1.2, 0.0)])
def test_yolo_box(clip, scale_xy, thresh):
    rng = np.random.RandomState(4)
    c, an = 4, 3
    x = rng.randn(2, an * (5 + c), 5, 6).astype(np.float32)
    img = np.array([[160, 192], [150, 170]], np.int32)
    kw = dict(anchors=ANCHORS[:6], class_num=c, conf_thresh=thresh,
              downsample_ratio=32, clip_bbox=clip, scale_x_y=scale_xy)
    tb, ts = tdet.yolo_box(_t(x), _t(img), **kw)
    jb, js = _pure(jdet.yolo_box)(x, img, **kw)
    _close(tb, jb)
    _close(ts, js)
    # candidates under the threshold are zeros on both sides
    _exact(_np(tb) == 0, np.asarray(jb) == 0)


def _gt(rng, n=2, slots=50, valid=(12, 5)):
    """[n, slots, 4] normalised cx, cy, w, h with `valid[i]` valid rows in
    image i (the rest padding: w = h = 0, any centre), labels int32.
    Image 0's rows 0 and 1 share a cell at every stride; row 2 has a w
    of 0 and a non-zero h (invalid)."""
    box = np.zeros((n, slots, 4), np.float32)
    box[..., :2] = rng.rand(n, slots, 2)
    for i in range(n):
        k = valid[i]
        wh = rng.uniform(0.02, 0.6, (k, 2))
        box[i, :k, 2:] = wh
    box[0, 1, :2] = box[0, 0, :2] + 0.001
    box[0, 2, 2:] = [0.0, 0.3]
    lbl = rng.randint(0, 4, (n, slots)).astype(np.int32)
    return box, lbl


@pytest.mark.parametrize("level,smooth,score,scale_xy", [
    (0, False, False, 1.0), (1, True, False, 1.0), (2, False, True, 1.05)])
def test_yolov3_loss_value_and_gradient(level, smooth, score, scale_xy):
    rng = np.random.RandomState(5 + level)
    c = 4
    masks = ((6, 7, 8), (3, 4, 5), (0, 1, 2))
    down = (32, 16, 8)[level]
    hh, ww = ((2, 3), (4, 5), (8, 7))[level]
    x = (rng.randn(2, 3 * (5 + c), hh, ww) * 1.5).astype(np.float32)
    box, lbl = _gt(rng)
    gs = rng.rand(2, 50).astype(np.float32) if score else None
    kw = dict(anchors=ANCHORS, anchor_mask=list(masks[level]), class_num=c,
              ignore_thresh=0.5, downsample_ratio=down,
              use_label_smooth=smooth, scale_x_y=scale_xy)

    def jloss(xx):
        per_img = _pure(jdet.yolov3_loss)(
            xx, jnp.asarray(box), jnp.asarray(lbl),
            gt_score=None if gs is None else jnp.asarray(gs), **kw)
        return per_img.sum(), per_img

    (_, jv), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    tv = tdet.yolov3_loss(tx, _t(box), _t(lbl),
                          gt_score=None if gs is None else _t(gs), **kw)
    tv.sum().backward()
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-5)
    g = np.asarray(jg)
    np.testing.assert_allclose(_np(tx.grad), g, rtol=0,
                               atol=1e-4 * float(np.abs(g).max()))
    assert not torch.are_deterministic_algorithms_enabled()


def test_yolov3_loss_assigns_only_valid_in_level_gts():
    """With every gt padding the loss is objectness alone: the same as
    the JAX loss, and its gradient reaches no coordinate channel."""
    rng = np.random.RandomState(9)
    x = rng.randn(1, 3 * 9, 3, 3).astype(np.float32)
    box = np.zeros((1, 50, 4), np.float32)
    lbl = np.zeros((1, 50), np.int32)
    kw = dict(anchors=ANCHORS, anchor_mask=[6, 7, 8], class_num=4,
              ignore_thresh=0.7, downsample_ratio=32)
    tx = _t(x).requires_grad_(True)
    tv = tdet.yolov3_loss(tx, _t(box), _t(lbl), **kw)
    tv.sum().backward()
    want = jax.jit(functools.partial(_pure(jdet.yolov3_loss), **kw))(
        x, box, lbl)
    np.testing.assert_allclose(_np(tv), np.asarray(want), rtol=1e-5)
    g = _np(tx.grad).reshape(1, 3, 9, 3, 3)
    assert not g[:, :, :4].any() and not g[:, :, 5:].any()
    assert g[:, :, 4].all()


# -- NMS ------------------------------------------------------------------------

def _sorted_problem(rng, k, lead, scale, invalid_frac=0.2):
    """Candidates sorted by score (descending, ties kept in index order),
    with the last `invalid_frac` at -inf."""
    boxes = _boxes(rng, k, scale, lead)
    s = -np.sort(-np.round(rng.rand(*lead, k), 2), axis=-1)
    n_bad = int(k * invalid_frac)
    if n_bad:
        s[..., k - n_bad:] = -np.inf
    return boxes, s.astype(np.float32)


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("eta", [1.0, 0.9])
@pytest.mark.parametrize("thr", [0.3, 0.7])
def test_greedy_mask_plain_equals_jax(normalized, eta, thr):
    """The kernel's plain version, batched over 6 problems, against the
    JAX `_greedy_nms_mask` vmapped over them: the same mask bit for
    bit."""
    rng = np.random.RandomState(int(thr * 10) + int(eta * 100))
    scale = 1.0 if normalized else 40.0
    boxes, s = _sorted_problem(rng, 60, (2, 3), scale)
    jfn = jax.jit(jax.vmap(jax.vmap(functools.partial(
        jdet._greedy_nms_mask, iou_threshold=thr, normalized=normalized,
        eta=eta))))
    want = np.asarray(jfn(boxes, s))
    got = tnms.greedy_nms_mask(_t(boxes), _t(s), thr, normalized, eta)
    assert got.dtype == torch.bool
    _exact(got, want)
    assert want.any() and not want.all()


def test_greedy_mask_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(3)
    boxes, s = _sorted_problem(rng, 20, (4,), 1.0)
    before = dict(tnms.launches)
    _exact(tnms.greedy_nms_mask(_t(boxes), _t(s), 0.5),
           tnms.greedy_nms_mask_plain(_t(boxes), _t(s), 0.5))
    assert tnms.launches == before


@pytest.mark.parametrize("top_k", [-1, 12])
def test_nms(top_k):
    rng = np.random.RandomState(7)
    boxes = _boxes(rng, 30, 1.0)
    scores = np.round(rng.rand(30), 1).astype(np.float32)   # many ties
    ti, tk = tdet.nms(_t(boxes), _t(scores), iou_threshold=0.4,
                      top_k=top_k)
    ji, jk = jdet.nms(boxes, scores, iou_threshold=0.4, top_k=top_k)
    _exact(ti, _np(ji))
    _exact(tk, _np(jk))


def _mc_inputs(seed, n=2, m=40, c=5, scale=1.0):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, m, scale, (n,))
    scores = np.round(rng.rand(n, c, m), 2).astype(np.float32)
    scores[:, :, ::7] = 0.5          # a run of equal scores in every class
    return boxes, scores


@pytest.mark.parametrize("eta", [1.0, 0.9])
@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("background", [0, -1])
def test_multiclass_nms(eta, normalized, background):
    boxes, scores = _mc_inputs(11, scale=1.0 if normalized else 50.0)
    kw = dict(score_threshold=0.3, nms_top_k=25, keep_top_k=100,
              nms_threshold=0.45, normalized=normalized, nms_eta=eta,
              background_label=background, return_index=True)
    to, tc, ti = tdet.multiclass_nms(_t(boxes), _t(scores), **kw)
    jo, jc, ji = jdet.multiclass_nms(boxes, scores, **kw)
    jo, jc, ji = _np(jo), _np(jc), _np(ji)
    _exact(_np(to)[..., 0], jo[..., 0])        # labels
    _close(_np(to)[..., 1:], jo[..., 1:])      # scores, boxes
    _exact(tc, jc)
    _exact(ti, ji)
    assert tc.dtype == torch.int32 and ti.dtype == torch.int32
    assert (jc > 0).all()


def test_multiclass_nms_without_index_and_limits():
    boxes, scores = _mc_inputs(12, c=3, m=10)
    kw = dict(score_threshold=0.1, nms_top_k=-1, keep_top_k=-1,
              nms_threshold=0.5, background_label=1)
    to, tc = tdet.multiclass_nms(_t(boxes), _t(scores), **kw)
    jo, jc = jdet.multiclass_nms(boxes, scores, **kw)
    assert to.shape == (2, 30, 6)
    _exact(_np(to)[..., 0], _np(jo)[..., 0])
    _close(to, jo)
    _exact(tc, jc)


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("post,background", [(0.0, 0), (0.2, -1)])
def test_matrix_nms(gaussian, post, background):
    boxes, scores = _mc_inputs(13, scale=30.0)
    kw = dict(score_threshold=0.2, post_threshold=post, nms_top_k=20,
              keep_top_k=25, use_gaussian=gaussian, gaussian_sigma=2.0,
              background_label=background, normalized=False)
    to, tc = tdet.matrix_nms(_t(boxes), _t(scores), **kw)
    jo, jc = jdet.matrix_nms(boxes, scores, **kw)
    _exact(_np(to)[..., 0], _np(jo)[..., 0])
    _close(to, jo)
    _exact(tc, jc)

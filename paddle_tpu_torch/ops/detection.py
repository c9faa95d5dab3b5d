"""Detection ops, the YOLO and NMS families (counterpart of
paddle_tpu/ops/detection.py).

Static shapes as in the JAX package: the NMS ops return fixed-capacity
outputs (rows [label, score, x1, y1, x2, y2], padded rows label -1 and
score 0) with an explicit valid count, so a serving program keeps one
shape whatever the detections.

- Geometry: iou_similarity, box_coder, box_clip.
- YOLO: yolo_box (decode a head's output) and yolov3_loss (the training
  loss, with `_yolo_pred_boxes` and `_iou_cxcywh` for the ignore mask).
  The loss gathers its predictions at the gt cells through one flat
  index (nn/functional/common.py take_along), whose backward adds
  repeated cells (every invalid gt row reads cell (0, 0, 0), and two gts
  can share a cell) under torch's deterministic flag: a captured step is
  then bit-equal to its eager run.
- NMS: nms, multiclass_nms (with return_index) and matrix_nms. The
  greedy suppression loop is the hand-written kernel of ops/nms.py
  (csrc/nms.cu) on the card, its plain version on the CPU; matrix_nms
  is matrix arithmetic in torch ops.

Top-k keeps jax.lax.top_k's order: ties go to the lower index
(`_top_k`, a stable descending sort; torch.topk promises no order among
ties on CUDA, and yolo_box zeroes every candidate under its threshold,
so ties are the common case). Not ported yet (ROADMAP.md item 18.5):
prior boxes, anchors, the ROI ops, proposals, FPN, focal loss,
bipartite match and SSD's ops.
"""
from __future__ import annotations

import torch

from ..nn.functional.common import take_along
from .nms import greedy_nms_mask
from .nms import pairwise_iou as _pairwise_iou

__all__ = ["iou_similarity", "box_coder", "box_clip", "yolo_box",
           "yolov3_loss", "multiclass_nms", "matrix_nms", "nms"]

_CONSTS = {}


def _const(values, dtype, device):
    """A constant vector of Python numbers on `device`. Made once and
    kept (a captured step reads it, never writes it); inside a stream
    capture, where a host copy cannot go, one made of fill kernels."""
    device = torch.device(device)
    key = (tuple(values), dtype, str(device))
    t = _CONSTS.get(key)
    if t is not None:
        return t
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return torch.stack([torch.full((), v, dtype=dtype, device=device)
                            for v in values])
    t = _CONSTS[key] = torch.tensor(list(values), dtype=dtype).to(device)
    return t


def _top_k(x, k):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index (jax.lax.top_k's order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def iou_similarity(x, y, box_normalized=True, name=None):
    """IoU between every box in x [N, 4] and y [M, 4] -> [N, M]."""
    return _pairwise_iou(x, y, normalized=box_normalized)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              variance=None, name=None):
    """Encode or decode boxes against priors (box_coder_op.h).

    encode: target [R, 4], prior [C, 4] -> [R, C, 4] offsets.
    decode: target [R, C, 4] (or [R, 4]), prior broadcast on `axis` ->
    [R, C, 4]. prior_box_var is a [C, 4] tensor, or `variance` a list of
    4."""
    norm = 1.0 if box_normalized else 0.0
    off = 1.0 - norm

    def center_size(b):
        w = b[..., 2] - b[..., 0] + off
        h = b[..., 3] - b[..., 1] + off
        cx = b[..., 0] + w / 2
        cy = b[..., 1] + h / 2
        return cx, cy, w, h

    pcx, pcy, pw, ph = center_size(prior_box)
    if code_type == "encode_center_size":
        tcx = (target_box[..., 2] + target_box[..., 0]) / 2
        tcy = (target_box[..., 3] + target_box[..., 1]) / 2
        tw = target_box[..., 2] - target_box[..., 0] + off
        th = target_box[..., 3] - target_box[..., 1] + off
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ow = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        oh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([ox, oy, ow, oh], dim=-1)
        if prior_box_var is not None:
            out = out / prior_box_var[None, :, :]
        elif variance:
            out = out / _const(variance, out.dtype, out.device)
        return out
    if code_type == "decode_center_size":
        t = target_box
        if t.dim() == 2:
            t = t[:, None, :]
        if axis == 0:
            pcx_, pcy_, pw_, ph_ = (v[None, :] for v in (pcx, pcy, pw, ph))
            pvar = None if prior_box_var is None else prior_box_var[None]
        else:
            pcx_, pcy_, pw_, ph_ = (v[:, None] for v in (pcx, pcy, pw, ph))
            pvar = None if prior_box_var is None else \
                prior_box_var[:, None, :]
        if pvar is not None:
            t = t * pvar
        elif variance:
            t = t * _const(variance, t.dtype, t.device)
        dcx = t[..., 0] * pw_ + pcx_
        dcy = t[..., 1] * ph_ + pcy_
        dw = torch.exp(t[..., 2]) * pw_
        dh = torch.exp(t[..., 3]) * ph_
        return torch.stack([dcx - dw / 2, dcy - dh / 2,
                            dcx + dw / 2 - off, dcy + dh / 2 - off], dim=-1)
    raise ValueError(f"unknown code_type {code_type!r}")


def box_clip(input, im_info, name=None):
    """Clip boxes [..., 4] to image bounds. im_info: [H, W, scale], or
    one row of them per image (box_clip_op.h: to im_info / scale - 1)."""
    im_info = torch.as_tensor(im_info, device=input.device)
    if im_info.dim() == 1:
        h = im_info[0] / im_info[2] - 1
        w = im_info[1] / im_info[2] - 1
    else:
        h = im_info[:, 0] / im_info[:, 2] - 1
        w = im_info[:, 1] / im_info[:, 2] - 1
        shape = (-1,) + (1,) * (input.dim() - 2)
        h = h.reshape(shape)
        w = w.reshape(shape)
    zero = torch.zeros((), dtype=input.dtype, device=input.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi.to(v.dtype))
    return torch.stack([clip(input[..., 0], w), clip(input[..., 1], h),
                        clip(input[..., 2], w), clip(input[..., 3], h)],
                       dim=-1)


# -- YOLO ---------------------------------------------------------------------

def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0, name=None):
    """Decode a YOLOv3 head's output (yolo_box_op.h).

    x: [N, A*(5+C), H, W]; img_size: [N, 2] (h, w) int. Returns (boxes
    [N, A*H*W, 4] xyxy in image coordinates, scores [N, A*H*W, C]).
    Candidates whose objectness is under conf_thresh are zeroed."""
    n, _, h, w = x.shape
    an = len(anchors) // 2
    anc = _const(anchors, x.dtype, x.device).reshape(an, 2)
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    in_h = downsample_ratio * h
    in_w = downsample_ratio * w
    x = x.reshape(n, an, 5 + class_num, h, w)
    tx, ty, tw, th, tobj = (x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3],
                            x[:, :, 4])
    cls = x[:, :, 5:]
    gx = torch.arange(w, dtype=x.dtype, device=x.device)
    gy = torch.arange(h, dtype=x.dtype, device=x.device)
    img_h = img_size[:, 0].to(x.dtype).reshape(n, 1, 1, 1)
    img_w = img_size[:, 1].to(x.dtype).reshape(n, 1, 1, 1)
    cx = (gx[None, None, None, :] + torch.sigmoid(tx) * scale + bias) \
        * img_w / w
    cy = (gy[None, None, :, None] + torch.sigmoid(ty) * scale + bias) \
        * img_h / h
    bw = torch.exp(tw) * anc[None, :, 0, None, None] * img_w / in_w
    bh = torch.exp(th) * anc[None, :, 1, None, None] * img_h / in_h
    x1, y1 = cx - bw / 2, cy - bh / 2
    x2, y2 = cx + bw / 2, cy + bh / 2
    if clip_bbox:
        x1 = torch.clamp_min(x1, 0.0)
        y1 = torch.clamp_min(y1, 0.0)
        x2 = torch.minimum(x2, img_w - 1)
        y2 = torch.minimum(y2, img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    conf = torch.sigmoid(tobj)
    keep = (conf >= conf_thresh).to(x.dtype)
    boxes = boxes * keep[..., None]
    scores = torch.sigmoid(cls) * (conf * keep)[:, :, None]
    boxes = boxes.reshape(n, an * h * w, 4)
    scores = torch.movedim(scores, 2, -1).reshape(n, an * h * w, class_num)
    return boxes, scores


def _bce(logit, label):
    """Sigmoid cross-entropy with logits, the JAX package's form
    (torch.maximum splits a tie's gradient in half, as jnp.maximum
    does)."""
    zero = torch.zeros((), dtype=logit.dtype, device=logit.device)
    return (torch.maximum(logit, zero) - logit * label
            + torch.log1p(torch.exp(-torch.abs(logit))))


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=False, scale_x_y=1.0, name=None):
    """YOLOv3 training loss (yolov3_loss_op.h semantics, vectorised).

    x: [N, M*(5+C), H, W]; gt_box: [N, B, 4] (cx, cy, w, h, normalised
    to the image; a row with w or h 0 is padding); gt_label: [N, B] int.
    Returns the per-image loss [N]. Each gt is assigned to its best
    anchor over all anchors (shape-only IoU); a level takes the gts whose
    best anchor is in its mask. Objectness negatives are ignored where
    the predicted box's best IoU with any gt exceeds ignore_thresh."""
    n, _, h, w = x.shape
    mask = [int(a) for a in anchor_mask]
    m = len(mask)
    dev = x.device
    an_all = _const(anchors, torch.float32, dev).reshape(-1, 2)
    in_w = downsample_ratio * w
    in_h = downsample_ratio * h
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    ch = 5 + class_num
    x = x.reshape(n, m, ch, h, w).to(torch.float32)
    px, py, pw, ph, pobj = (x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3],
                            x[:, :, 4])
    gtb = gt_box.to(torch.float32)
    valid = (gtb[..., 2] > 0) & (gtb[..., 3] > 0)
    gw = gtb[..., 2] * in_w
    gh = gtb[..., 3] * in_h
    inter = (torch.minimum(gw[..., None], an_all[:, 0])
             * torch.minimum(gh[..., None], an_all[:, 1]))
    union = gw[..., None] * gh[..., None] + an_all[:, 0] * an_all[:, 1] \
        - inter
    best_anchor = torch.argmax(inter / torch.clamp_min(union, 1e-9), dim=-1)
    mask_arr = _const(mask, torch.int64, dev)
    hit = best_anchor[..., None] == mask_arr
    # the first True (argmax over a bool), 0 when none
    an_pos = torch.argmax(hit.to(torch.uint8), dim=-1)
    sel = hit.any(dim=-1) & valid
    gi = torch.clamp((gtb[..., 0] * w).to(torch.int32), 0, w - 1)
    gj = torch.clamp((gtb[..., 1] * h).to(torch.int32), 0, h - 1)
    sel_f = sel.to(torch.float32)

    b_idx = torch.arange(n, device=dev)[:, None].expand_as(gi)
    cell = ((b_idx * m + an_pos) * ch * h + gj.long()) * w + gi.long()
    # obj mask: a 1 at each assigned cell (sums of 0/1 are exact in any
    # order), clipped to 1
    pos = (((b_idx * m + an_pos) * h + gj.long()) * w + gi.long())
    obj_mask = torch.zeros(n * m * h * w, dtype=torch.float32, device=dev)
    obj_mask.index_add_(0, pos.reshape(-1), sel_f.reshape(-1))
    obj_mask = torch.clamp_max(obj_mask, 1.0).reshape(n, m, h, w)

    tx = gtb[..., 0] * w - gi
    ty = gtb[..., 1] * h - gj
    an_mask = an_all[mask_arr]
    an_w, an_h = an_mask[:, 0], an_mask[:, 1]
    tw_t = torch.log(torch.clamp_min(
        gw / torch.clamp_min(an_w[an_pos], 1e-9), 1e-9))
    th_t = torch.log(torch.clamp_min(
        gh / torch.clamp_min(an_h[an_pos], 1e-9), 1e-9))
    box_scale = 2.0 - gtb[..., 2] * gtb[..., 3]

    # one gather of channels 0-3 and the C class channels at each gt cell
    chans = torch.cat([torch.arange(4, device=dev),
                       torch.arange(5, ch, device=dev)])
    idx = cell[..., None] + chans * (h * w)                  # [N, B, 4+C]
    got = take_along(x.reshape(-1), idx.reshape(-1), 0).reshape(idx.shape)
    gx_, gy_, gw_, gh_ = got[..., 0], got[..., 1], got[..., 2], got[..., 3]
    pcls_g = got[..., 4:]
    loss_x = _bce(gx_, tx) * box_scale * sel_f
    loss_y = _bce(gy_, ty) * box_scale * sel_f
    loss_w = torch.abs(gw_ - tw_t) * box_scale * sel_f
    loss_h = torch.abs(gh_ - th_t) * box_scale * sel_f

    with torch.no_grad():   # a comparison: no gradient flows through it
        pred_boxes = _yolo_pred_boxes(px, py, pw, ph, an_mask, w, h, in_w,
                                      in_h, scale, bias)
        ious = _iou_cxcywh(pred_boxes.reshape(n, -1, 4), gtb, valid)
        best_iou = ious.amax(dim=-1).reshape(n, m, h, w)
        noobj_mask = ((best_iou <= ignore_thresh).to(torch.float32)
                      * (1.0 - obj_mask))
    loss_obj = _bce(pobj, 1.0) * obj_mask + _bce(pobj, 0.0) * noobj_mask

    # label smoothing, yolov3_loss_op.h:285-291
    sw = min(1.0 / class_num, 1.0 / 40) if use_label_smooth else 0.0
    onehot = (gt_label.long()[..., None] == torch.arange(
        class_num, device=dev)).to(torch.float32)
    onehot = onehot * (1.0 - 2.0 * sw) + sw
    score_w = sel_f if gt_score is None else sel_f * gt_score
    loss_cls = _bce(pcls_g, onehot).sum(-1) * score_w
    return (loss_x.sum(1) + loss_y.sum(1) + loss_w.sum(1) + loss_h.sum(1)
            + loss_obj.sum((1, 2, 3)) + loss_cls.sum(1))


def _yolo_pred_boxes(px, py, pw, ph, anc, w, h, in_w, in_h, scale, bias):
    gx = torch.arange(w, dtype=torch.float32, device=px.device)
    gy = torch.arange(h, dtype=torch.float32, device=px.device)
    cx = (gx[None, None, None, :] + torch.sigmoid(px) * scale + bias) / w
    cy = (gy[None, None, :, None] + torch.sigmoid(py) * scale + bias) / h
    bw = torch.exp(torch.clamp(pw, -10, 10)) * anc[None, :, 0, None, None] \
        / in_w
    bh = torch.exp(torch.clamp(ph, -10, 10)) * anc[None, :, 1, None, None] \
        / in_h
    return torch.stack([cx, cy, bw, bh], dim=-1)


def _iou_cxcywh(pred, gt, valid):
    """pred [N, P, 4], gt [N, B, 4], both cx, cy, w, h -> IoU [N, P, B]."""
    def xyxy(b):
        return torch.stack([b[..., 0] - b[..., 2] / 2,
                            b[..., 1] - b[..., 3] / 2,
                            b[..., 0] + b[..., 2] / 2,
                            b[..., 1] + b[..., 3] / 2], dim=-1)
    p = xyxy(pred)
    g = xyxy(gt)
    lt = torch.maximum(p[:, :, None, :2], g[:, None, :, :2])
    rb = torch.minimum(p[:, :, None, 2:], g[:, None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    pa = (torch.clamp_min(p[..., 2] - p[..., 0], 0)
          * torch.clamp_min(p[..., 3] - p[..., 1], 0))
    ga = (torch.clamp_min(g[..., 2] - g[..., 0], 0)
          * torch.clamp_min(g[..., 3] - g[..., 1], 0))
    union = pa[:, :, None] + ga[:, None, :] - inter
    zero = torch.zeros((), dtype=inter.dtype, device=inter.device)
    iou = torch.where(union > 0, inter / union, zero)
    return torch.where(valid[:, None, :], iou, zero)


# -- NMS ----------------------------------------------------------------------

def _greedy_nms_mask(boxes, scores, iou_threshold, normalized=True,
                     eta=1.0):
    """Greedy hard NMS over pre-sorted (descending) candidates: boxes
    [..., K, 4], scores [..., K] (-inf where invalid) -> keep [..., K]
    bool, for every leading index at once (the kernel, ops/nms.py)."""
    return greedy_nms_mask(boxes, scores, iou_threshold, normalized, eta)


def nms(boxes, scores, iou_threshold=0.3, top_k=-1, name=None):
    """Single-class hard NMS. Returns (keep_indices [K] in score order,
    -1 where suppressed, keep_mask [K]) with K = top_k or the box
    count."""
    k = boxes.shape[0] if top_k in (-1, None) else min(int(top_k),
                                                       boxes.shape[0])
    sc, order = _top_k(scores, k)
    keep = _greedy_nms_mask(boxes[order], sc, iou_threshold)
    order = order.to(torch.int32)
    idx = torch.where(keep, order, torch.full_like(order, -1))
    return idx, keep


def _pack(cb, cs, labels, bx_dtype, keep_top_k, cidx=None):
    """The per-image output of both NMS forms: the keep_top_k best of the
    flattened (class, candidate) scores, rows [label, score, box],
    padded rows label -1, score 0 and a zero box; the valid counts
    (int32); and, with cidx, each row's box index (-1 where padded)."""
    n = cs.shape[0]
    flat_s = cs.reshape(n, -1)
    flat_b = cb.reshape(n, -1, 4)
    flat_l = labels.reshape(n, -1)
    total = flat_s.shape[1]
    kk = min(int(keep_top_k), total) if keep_top_k > 0 else total
    s_top, sel = _top_k(flat_s, kk)
    good = s_top > 0
    lab = torch.gather(flat_l, 1, sel)
    box = torch.gather(flat_b, 1, sel[..., None].expand(n, kk, 4))
    out = torch.cat([
        torch.where(good, lab, torch.full_like(lab, -1)).to(bx_dtype)[
            ..., None],
        torch.where(good, s_top, torch.zeros_like(s_top))[..., None],
        box * good[..., None].to(bx_dtype)], dim=-1)
    counts = good.sum(-1).to(torch.int32)
    if cidx is None:
        return out, counts
    ind = torch.gather(cidx.reshape(n, -1), 1, sel)
    return out, counts, torch.where(good, ind, torch.full_like(ind, -1))


def _per_class(bboxes, scores, nms_top_k):
    """Each (image, class)'s nms_top_k best candidates: scores [N, C, k],
    their box indices and boxes [N, C, k, 4]."""
    n, num_boxes, _ = bboxes.shape
    num_cls = scores.shape[1]
    k = min(int(nms_top_k), num_boxes) if nms_top_k > 0 else num_boxes
    s, order = _top_k(scores, k)
    b = torch.gather(bboxes[:, None].expand(n, num_cls, num_boxes, 4), 2,
                     order[..., None].expand(n, num_cls, k, 4))
    labels = torch.arange(num_cls, device=scores.device)[None, :, None] \
        .expand(n, num_cls, k)
    return s, order, b, labels


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, return_index=False,
                   name=None):
    """Multi-class NMS (multiclass_nms_op.cc semantics, static shapes).

    bboxes [N, M, 4], scores [N, C, M]. Returns (out [N, keep_top_k, 6]
    rows [label, score, x1, y1, x2, y2], valid_counts [N] int32), and
    with return_index each row's box index [N, keep_top_k] (int32, -1
    where padded). Every (image, class) problem goes through one
    greedy-NMS launch."""
    s, order, b, labels = _per_class(bboxes, scores, nms_top_k)
    valid = s > score_threshold
    neg_inf = torch.full((), float("-inf"), dtype=s.dtype, device=s.device)
    keep = _greedy_nms_mask(b, torch.where(valid, s, neg_inf),
                            nms_threshold, normalized, eta=nms_eta) & valid
    minus1 = torch.full((), -1.0, dtype=s.dtype, device=s.device)
    cs = torch.where(keep, s, minus1)
    if background_label >= 0:
        cs = torch.where(labels == background_label, minus1, cs)
    res = _pack(b, cs, labels, bboxes.dtype, keep_top_k,
                order.to(torch.int32) if return_index else None)
    return res


def matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=400, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               name=None):
    """Matrix NMS (matrix_nms_op.cc): each score decays by its IoU with
    the higher-scored boxes of its class, compensated by theirs; matrix
    arithmetic, no sequential loop. Returns (out [N, keep_top_k, 6],
    valid_counts [N])."""
    s, _, b, labels = _per_class(bboxes, scores, nms_top_k)
    k = s.shape[-1]
    valid = s > score_threshold
    iou = _pairwise_iou(b, b, normalized)              # [N, C, k, k]
    below = torch.ones((k, k), dtype=torch.bool, device=s.device).tril(-1)
    zero = torch.zeros((), dtype=iou.dtype, device=iou.device)
    tri = torch.where(below, iou, zero)
    max_iou = tri.amax(dim=-1)                         # [N, C, k]
    if use_gaussian:
        # matrix_nms_op.cc:87: exp((max_iou^2 - iou^2) * sigma)
        decay = torch.exp((max_iou[..., None, :] * max_iou[..., None, :]
                           - tri * tri) * gaussian_sigma)
    else:
        decay = (1.0 - tri) / torch.clamp_min(1.0 - max_iou[..., None, :],
                                              1e-9)
    decay = torch.where(below, decay, torch.full((), float("inf"),
                                                 dtype=decay.dtype,
                                                 device=decay.device))
    # :154 starts min_decay at 1.0: a decay never amplifies
    dec = torch.clamp_max(decay.amin(dim=-1), 1.0)
    first = torch.arange(k, device=s.device) == 0
    dec = torch.where(first, torch.ones_like(dec), dec)
    minus1 = torch.full((), -1.0, dtype=s.dtype, device=s.device)
    s2 = torch.where(valid, s * dec, minus1)
    if post_threshold > 0:
        s2 = torch.where(s2 > post_threshold, s2, minus1)
    if background_label >= 0:
        s2 = torch.where(labels == background_label, minus1, s2)
    return _pack(b, s2, labels, bboxes.dtype, keep_top_k)

"""YOLOv3-class detector, BASELINE config 4's trainable workload
(counterpart of paddle_tpu/models/yolo.py).

A DarkNet-tiny backbone, an FPN-style top-down neck and three scale
heads, trained through static.TrainStep like every other model and
served through yolo_box + multiclass_nms (hard NMS: the greedy kernel
of ops/nms.py) or matrix_nms (ops/detection.py). Static shapes
throughout: gt boxes ride a fixed [N, B, 4] pad-to-max layout (the loss
masks invalid rows) and NMS returns fixed [N, keep_top_k, 6] rows with
valid counts. Variable input sizes go through the bucketing policy
(io/sampler.py BucketBatchSampler): one captured program per bucket.

The layers' state-dict names are the JAX model's
(`backbone.stem.conv.weight`, `neck4.bn._mean`, `head5.1.bias`, ...),
so models/convert.py load_jax_params carries the weights and the
BatchNorm statistics across. `device` is passed to every layer that
holds a tensor.
"""
from __future__ import annotations

import torch

from .. import nn
from ..nn import functional as F
from ..ops import detection as det

__all__ = ["YOLOv3", "DarkNetTiny", "yolov3_default_anchors"]

# COCO-style 9 anchors (w, h in input pixels), smallest to largest
yolov3_default_anchors = (10, 13, 16, 30, 33, 23,
                          30, 61, 62, 45, 59, 119,
                          116, 90, 156, 198, 373, 326)


class _ConvBN(nn.Layer):
    """conv -> BN -> leaky_relu, the darknet unit."""

    def __init__(self, cin, cout, k=3, stride=1, device=None):
        super().__init__(device=device)
        self.conv = nn.Conv2D(cin, cout, k, stride=stride, padding=k // 2,
                              bias_attr=False, device=device)
        self.bn = nn.BatchNorm2D(cout, device=device)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class DarkNetTiny(nn.Layer):
    """Compact darknet: returns (c3, c4, c5) at strides 8/16/32 with
    channels (4w, 8w, 16w). width=16 gives the darknet-tiny scale."""

    def __init__(self, width=16, device=None):
        super().__init__(device=device)
        w = width
        self.stem = _ConvBN(3, w, device=device)                   # /1
        self.d1 = _ConvBN(w, 2 * w, stride=2, device=device)       # /2
        self.d2 = _ConvBN(2 * w, 2 * w, device=device)
        self.d3 = _ConvBN(2 * w, 4 * w, stride=2, device=device)   # /4
        self.d4 = _ConvBN(4 * w, 4 * w, device=device)
        self.d5 = _ConvBN(4 * w, 4 * w, stride=2, device=device)   # /8
        self.d6 = _ConvBN(4 * w, 8 * w, device=device)
        self.d7 = _ConvBN(8 * w, 8 * w, stride=2, device=device)   # /16
        self.d8 = _ConvBN(8 * w, 16 * w, device=device)
        self.d9 = _ConvBN(16 * w, 16 * w, stride=2, device=device)  # /32
        self.out_channels = (4 * w, 8 * w, 16 * w)

    def forward(self, x):
        x = self.d2(self.d1(self.stem(x)))
        c3 = self.d5(self.d4(self.d3(x)))
        c4 = self.d7(self.d6(c3))
        c5 = self.d9(self.d8(c4))
        return c3, c4, c5


class YOLOv3(nn.Layer):
    """Three-scale YOLOv3 head over a feature backbone.

    forward(images [N, 3, H, W]) -> (p5, p4, p3): per-scale raw head
    outputs [N, A*(5+C), H/d, W/d] for d in (32, 16, 8), the layout
    yolov3_loss and yolo_box take."""

    downsamples = (32, 16, 8)

    def __init__(self, num_classes=80, anchors=yolov3_default_anchors,
                 anchor_masks=((6, 7, 8), (3, 4, 5), (0, 1, 2)),
                 width=16, ignore_thresh=0.7, backbone=None, device=None):
        super().__init__(device=device)
        self.num_classes = int(num_classes)
        self.anchors = tuple(anchors)
        self.anchor_masks = tuple(tuple(m) for m in anchor_masks)
        self.ignore_thresh = float(ignore_thresh)
        self.backbone = backbone or DarkNetTiny(width, device=device)
        c3, c4, c5 = self.backbone.out_channels

        def per(m):
            return len(m) * (5 + self.num_classes)

        def unit(cin, cout, k=3):
            return _ConvBN(cin, cout, k=k, device=device)

        self.neck5 = unit(c5, c5 // 2, k=1)
        self.head5 = nn.Sequential(
            unit(c5 // 2, c5),
            nn.Conv2D(c5, per(self.anchor_masks[0]), 1, device=device))
        self.lat4 = unit(c5 // 2, c4 // 2, k=1)
        self.neck4 = unit(c4 + c4 // 2, c4 // 2, k=1)
        self.head4 = nn.Sequential(
            unit(c4 // 2, c4),
            nn.Conv2D(c4, per(self.anchor_masks[1]), 1, device=device))
        self.lat3 = unit(c4 // 2, c3 // 2, k=1)
        self.neck3 = unit(c3 + c3 // 2, c3 // 2, k=1)
        self.head3 = nn.Sequential(
            unit(c3 // 2, c3),
            nn.Conv2D(c3, per(self.anchor_masks[2]), 1, device=device))

    def forward(self, images):
        c3, c4, c5 = self.backbone(images)
        t5 = self.neck5(c5)
        p5 = self.head5(t5)
        u4 = F.interpolate(self.lat4(t5), scale_factor=2, mode="nearest")
        t4 = self.neck4(torch.cat((c4, u4), dim=1))
        p4 = self.head4(t4)
        u3 = F.interpolate(self.lat3(t4), scale_factor=2, mode="nearest")
        t3 = self.neck3(torch.cat((c3, u3), dim=1))
        p3 = self.head3(t3)
        return p5, p4, p3

    # -- training ---------------------------------------------------------
    def loss(self, outputs, gt_box, gt_label, gt_score=None):
        """Sum of per-scale yolov3_loss means. gt_box [N, B, 4] cx, cy, w,
        h normalised to the image; invalid rows have w = h = 0."""
        total = None
        for out, mask, down in zip(outputs, self.anchor_masks,
                                   self.downsamples):
            per_img = det.yolov3_loss(
                out, gt_box, gt_label, anchors=list(self.anchors),
                anchor_mask=list(mask), class_num=self.num_classes,
                ignore_thresh=self.ignore_thresh, downsample_ratio=down,
                gt_score=gt_score)
            scale_loss = per_img.mean()
            total = scale_loss if total is None else total + scale_loss
        return total

    # -- inference --------------------------------------------------------
    def decode(self, outputs, im_size, conf_thresh=0.05):
        """yolo_box over the three scales: (boxes [N, P, 4] in image
        coordinates, scores [N, C, P]) with P the candidates of all
        scales."""
        boxes, scores = [], []
        for out, mask, down in zip(outputs, self.anchor_masks,
                                   self.downsamples):
            lvl_anchors = []
            for a in mask:
                lvl_anchors += [self.anchors[2 * a], self.anchors[2 * a + 1]]
            b, s = det.yolo_box(out, im_size, anchors=lvl_anchors,
                                class_num=self.num_classes,
                                conf_thresh=conf_thresh,
                                downsample_ratio=down)
            boxes.append(b)
            scores.append(s)
        return (torch.cat(boxes, dim=1),
                torch.cat(scores, dim=1).permute(0, 2, 1))

    def predict(self, outputs, im_size, conf_thresh=0.05,
                nms_threshold=0.45, keep_top_k=100, nms_type="hard"):
        """Decode + multi-class NMS. im_size [N, 2] int (h, w). Returns
        (dets [N, keep_top_k, 6] rows [label, score, x1, y1, x2, y2],
        valid_counts [N]), padded rows label -1.

        nms_type: "hard" (multiclass_nms, the greedy kernel: one launch
        for every (image, class) problem) or "matrix" (matrix_nms,
        PP-YOLOv2's default: score decay by max-IoU)."""
        if nms_type not in ("hard", "matrix"):
            raise ValueError(f"nms_type={nms_type!r}: must be 'hard' or "
                             "'matrix'")
        allb, alls = self.decode(outputs, im_size, conf_thresh)
        if nms_type == "matrix":
            return det.matrix_nms(
                allb, alls, score_threshold=conf_thresh,
                post_threshold=conf_thresh, keep_top_k=keep_top_k,
                background_label=-1, normalized=False)
        return det.multiclass_nms(
            allb, alls, score_threshold=conf_thresh,
            nms_threshold=nms_threshold, keep_top_k=keep_top_k,
            background_label=-1, normalized=False)

"""paddle.vision.ops (counterpart of paddle_tpu/vision/ops.py):
yolo_loss and yolo_box over ops/detection.py. deform_conv2d and the
DeformConv2D layer need ops/vision_extra.py's deformable convolution,
which is not ported yet (ROADMAP.md item 18.5): they raise."""
from __future__ import annotations

from ..ops.detection import yolo_box, yolov3_loss  # noqa: F401

__all__ = ["yolo_loss", "yolo_box", "deform_conv2d", "DeformConv2D"]


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """paddle.vision.ops.yolo_loss: the yolov3_loss op (label smoothing
    on by default, as the reference's)."""
    return yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask,
                       class_num, ignore_thresh, downsample_ratio,
                       gt_score=gt_score, use_label_smooth=use_label_smooth,
                       scale_x_y=scale_x_y)


def _deformable_later(what):
    return NotImplementedError(
        f"{what} needs ops/vision_extra.py's deformable convolution, which "
        "is not ported yet (ROADMAP.md item 18.5)")


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    raise _deformable_later("deform_conv2d")


class DeformConv2D:
    """The layer form of deform_conv2d: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _deformable_later("DeformConv2D")

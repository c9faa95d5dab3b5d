"""Greedy hard NMS: the CUDA kernel, its plain version and the wrapper.

The JAX package computes the suppression loop in XLA
(paddle_tpu/ops/detection.py `_greedy_nms_mask`, :488, a K-step
lax.fori_loop vmapped over (image, class)); no Pallas kernel lies on
this path. The port writes the loop as one hand-written kernel,
csrc/nms.cu (built with nvcc at first use, ops/_build.py, called
through ctypes), because in torch ops it is K dependent steps of
several launches each over a [P, K, K] IoU matrix. See the source's
note for its design and its bound.

- greedy_nms_mask(boxes [..., K, 4], scores [..., K], iou_threshold,
  normalized, eta) -> keep [..., K] bool, over candidates already sorted
  by score (descending), score -inf where invalid. On a CUDA tensor it
  launches the kernel (one launch for all leading dims) or raises; on a
  CPU tensor it runs greedy_nms_mask_plain. There is no fallback from
  one to the other.
- greedy_nms_mask_plain: the same loop batched over the leading dims in
  torch ops, `_pairwise_iou`'s arithmetic. The CPU tests run it, and
  chip_smoke.py holds the kernel against it on the card.
- launches counts kernel launches, so a run can show that its main path
  went through the kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["greedy_nms_mask", "greedy_nms_mask_plain", "pairwise_iou",
           "launches"]

launches = {"nms_greedy": 0}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_void_p]


def _box_area(boxes, normalized=True):
    off = 0.0 if normalized else 1.0
    w = torch.clamp_min(boxes[..., 2] - boxes[..., 0] + off, 0.0)
    h = torch.clamp_min(boxes[..., 3] - boxes[..., 1] + off, 0.0)
    return w * h


def pairwise_iou(a, b, normalized=True):
    """a [..., N, 4], b [..., M, 4] (xyxy) -> IoU [..., N, M], the JAX
    package's `_pairwise_iou` over any leading dims."""
    off = 0.0 if normalized else 1.0
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt + off, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (_box_area(a, normalized)[..., :, None]
             + _box_area(b, normalized)[..., None, :] - inter)
    return torch.where(union > 0, inter / union,
                       torch.zeros((), dtype=inter.dtype,
                                   device=inter.device))


def _f32(v):
    return float(np.float32(v))


def greedy_nms_mask_plain(boxes, scores, iou_threshold, normalized=True,
                          eta=1.0):
    """The JAX `_greedy_nms_mask` batched over the leading dims: one IoU
    matrix [..., K, K], then K steps each deciding candidate i for every
    problem at once."""
    k = scores.shape[-1]
    lead = scores.shape[:-1]
    bx = boxes.reshape(-1, k, 4)
    iou = pairwise_iou(bx, bx, normalized)            # [P, j, i]
    keep = scores.reshape(-1, k) > float("-inf")
    thr = torch.full((keep.shape[0],), _f32(iou_threshold),
                     dtype=iou.dtype, device=iou.device)
    below = torch.arange(k, device=iou.device)
    eta32 = _f32(eta)
    for i in range(k):
        sup = ((iou[:, :, i] > thr[:, None]) & keep
               & (below < i)).any(dim=-1)
        kept = ~sup & keep[:, i]
        if eta < 1.0:
            thr = torch.where(kept & (thr > 0.5), thr * eta32, thr)
        keep[:, i] = kept
    return keep.reshape(*lead, k)


def _entry():
    fn = _build.load("nms").pt_nms_greedy
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _kernel_input(t):
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _nms_cuda(boxes, scores, iou_threshold, normalized, eta):
    k = scores.shape[-1]
    lead = scores.shape[:-1]
    if boxes.shape != (*lead, k, 4):
        raise ValueError(f"nms_greedy: boxes {tuple(boxes.shape)} do not "
                         f"match scores {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_greedy kernel takes float32 boxes and "
                        f"scores, got {boxes.dtype} and {scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError("nms_greedy: boxes and scores on different "
                         "devices")
    p = int(np.prod(lead)) if lead else 1
    keep = torch.empty((*lead, k), dtype=torch.uint8, device=boxes.device)
    if p == 0 or k == 0:
        return keep.bool()
    bx, sc = _kernel_input(boxes), _kernel_input(scores)
    with torch.cuda.device(boxes.device):
        rc = _entry()(bx.data_ptr(), sc.data_ptr(), keep.data_ptr(), p, k,
                      _f32(iou_threshold), _f32(eta), int(bool(normalized)),
                      torch.cuda.current_stream(boxes.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms_greedy launch failed (code {rc})")
    launches["nms_greedy"] += 1
    return keep.bool()


def greedy_nms_mask(boxes, scores, iou_threshold, normalized=True,
                    eta=1.0):
    """Keep mask [..., K] of greedy NMS over sorted candidates: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if boxes.is_cuda:
        return _nms_cuda(boxes, scores, iou_threshold, normalized, eta)
    if boxes.device.type != "cpu":
        raise RuntimeError(f"nms_greedy: no kernel for device "
                           f"{boxes.device}")
    return greedy_nms_mask_plain(boxes, scores, iou_threshold, normalized,
                                 eta)

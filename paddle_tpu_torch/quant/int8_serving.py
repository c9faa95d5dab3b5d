"""int8 serving compute: the post-training-quantized weight path of the
serving engine (counterpart of paddle_tpu/quant/int8_serving.py).

Each block matmul weight ``<name>_w`` of the serving snapshot (a raw
params dict, models/generation._gpt_params) becomes a leaf ``{"q8": int8
[in, out], "s": f32 [out]}``: per-output-channel abs-max codes and the
dequant factor, ``w ~= q8 * s``. The leaves are tensors the captured
programs read in place, so a weight swap re-quantizes and copies into
them like any other leaf.

Activations quantize dynamically inside the program (per-row abs-max:
stateless, no calibration pass). Embeddings, layer norms, biases and the
weight-tied lm_head stay in the serving float dtype and sampling stays
f32: the int8 surface is the four block matmuls (qkv, proj, fc1, fc2).

The product is ``torch._int_mm``, int8 x int8 -> int32 (cuBLASLt's
integer GEMM on the card), as the JAX package's is an XLA ``dot_general``
with an int32 accumulator: no Pallas kernel stands behind it. On the
card ``_int_mm`` (torch 2.11, CUDA 12.8) refuses 16 rows or fewer and
a K or N that is not a multiple of 8: int8_gemm pads the rows of a small
batch (a decode bucket of 4 slots) with zero codes and slices the
result, and leaves any other refusal to raise. Weight codes are stored
column-major, the layout the GEMM reads as it is; row-major codes cost it
a copy's time (chip_smoke.py's ``int8_layout`` line times both on the
card).
"""
from __future__ import annotations

import torch

__all__ = ["quantize_weight", "quantize_params", "quantize_activation",
           "int8_gemm", "int8_matmul", "logits_drift_receipt",
           "QUANT_WEIGHT_KEYS"]

# the block matmuls that carry the int8 path (generation._mm consumers)
QUANT_WEIGHT_KEYS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")
# the fewest rows torch._int_mm takes on a CUDA tensor
_CUDA_MIN_ROWS = 17


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def quantize_weight(w, bits: int = 8):
    """Per-output-channel abs-max quantization of one ``[in, out]`` (or
    ``[..., out]``) matmul weight, data-free. Returns the leaf ``{"q8":
    int8 codes, "s": f32 dequant factor [out]}`` with ``w ~= q8 * s``
    (``s`` pre-divided by qmax, so dequant is one multiply). Rounds half
    to even, as numpy does, so the codes equal the JAX package's.

    ``q8`` is stored column-major (the transpose of a contiguous ``[out,
    in]`` tensor): the layout cuBLASLt's int8 GEMM reads without a copy."""
    qmax = _qmax(int(bits))
    arr = w.detach().float()
    scale = arr.abs().amax(dim=tuple(range(arr.dim() - 1))).clamp_min(1e-8)
    q = torch.clamp(torch.round(arr / scale * qmax), -qmax - 1,
                    qmax).to(torch.int8)
    return {"q8": q.transpose(-2, -1).contiguous().transpose(-2, -1),
            "s": scale / qmax}


def quantize_params(params, qcfg=None):
    """The engine's int8 build-time cast: every block's four matmul
    weights become int8 + scale leaves; everything else (embeddings,
    norms, biases) passes through as the same tensors. swap_weights
    re-runs this transform, so a new snapshot has the same structure."""
    bits = int(getattr(qcfg, "weight_bits", 8) or 8)
    out = dict(params)
    out["blocks"] = [
        {k: (quantize_weight(v, bits) if k in QUANT_WEIGHT_KEYS else v)
         for k, v in bp.items()}
        for bp in params["blocks"]]
    return out


def quantize_activation(x):
    """Dynamic per-row abs-max codes of ``x`` [..., K]: (int8 codes,
    f32 factor [..., 1]) with ``x ~= codes * factor``."""
    qmax = 127.0
    xf = x.float()
    sx = (xf.abs().amax(dim=-1, keepdim=True) / qmax).clamp_min(1e-12)
    codes = torch.clamp(torch.round(xf / sx), -128.0, qmax).to(torch.int8)
    return codes, sx


def int8_gemm(codes, q8):
    """int8 codes [M, K] x q8 [K, N] -> the exact int32 accumulator
    [M, N] through ``torch._int_mm``. On the card a batch of fewer than
    17 rows is padded with zero codes (``_int_mm`` refuses it) and the
    result sliced back."""
    m = codes.shape[0]
    if codes.is_cuda and m < _CUDA_MIN_ROWS:
        codes = torch.nn.functional.pad(codes, (0, 0, 0, _CUDA_MIN_ROWS - m))
    return torch._int_mm(codes, q8)[:m]


def int8_matmul(x, q8, s):
    """``x @ w`` through the int8 pipeline: dynamic per-row activation
    codes (quantize_activation), int8 x int8 -> int32 (int8_gemm), then
    one f32 rescale by ``s_x * s_w``. The output is in x's dtype, so the
    residual stream keeps the serving float dtype. No host
    synchronisation: it runs inside a captured program."""
    codes, sx = quantize_activation(x)
    acc = int8_gemm(codes.reshape(-1, codes.shape[-1]), q8)
    return (acc.reshape(*codes.shape[:-1], -1).float() * sx
            * s).to(x.dtype)


def logits_drift_receipt(params, eps, n_heads, ids, qcfg=None):
    """The accuracy receipt's numeric half: last-position logits of one
    f32 prompt forward, compared across the three serving casts. Returns
    the max-abs logit drift of int8 and of bf16 (the yardstick) against
    f32, and the share of prompts whose greedy top-1 token agrees
    between int8 and f32."""
    from ..models.generation import _cast_params, _ln, _prefill

    def last_logits(p):
        x, _ = _prefill(p, eps, n_heads, ids, ids.shape[1])
        h = _ln(x[:, -1:], p["lnf_w"], p["lnf_b"], eps)
        return (h[:, 0] @ p["wte"].T).float()

    with torch.no_grad():
        l32 = last_logits(params)
        l8 = last_logits(quantize_params(params, qcfg))
        lb = last_logits(_cast_params(params, torch.bfloat16))
        drift8 = float((l8 - l32).abs().max())
        driftb = float((lb - l32).abs().max())
        agree = float((l8.argmax(-1) == l32.argmax(-1)).float().mean())
    return {"logit_drift_int8": round(drift8, 6),
            "logit_drift_bf16": round(driftb, 6),
            "top1_agreement_last": round(agree, 4)}

"""paddle_tpu_torch.quant: the serving engine's int8 weight path
(counterpart of paddle_tpu/quant/int8_serving.py). The JAX package's
QAT/PTQ layers are not ported (ROADMAP.md queue A item 18)."""
from .int8_serving import (QUANT_WEIGHT_KEYS, int8_gemm,  # noqa: F401
                           int8_matmul, logits_drift_receipt,
                           quantize_activation, quantize_params,
                           quantize_weight)

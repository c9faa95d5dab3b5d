"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The port sits beside the JAX package and mirrors its module names
(core/place.py, nn/layer/common.py, models/ernie.py, ...). It imports
torch and never jax, and nothing of paddle_tpu. Tensor is torch.Tensor,
Parameter is nn.Parameter and no_grad is torch.no_grad; torch autograd
replaces the JAX package's tape. Every Pallas TPU kernel on a ported
path becomes a kernel written by hand for Hopper (paddle_tpu_torch/csrc,
built with nvcc at first use).

Entry points run on the CUDA card unless the caller asks for the CPU
(set_device("cpu"), or device="cpu" on a model constructor). Without
CUDA and without that request, the first entry point raises
RuntimeError; importing never touches the device.

Ported so far: ERNIE inference (models.ErnieForPretraining in eval
mode) through the flash-attention forward kernel, and ERNIE pretraining
(static.TrainStep with optimizer.AdamW under amp.auto_cast) through the
forward and both backward kernels with in-kernel Philox attention
dropout; GPT-2 generation (models.GPTForCausalLM, whose forward runs the
forward kernel causally, and generate(): greedy, sampling, ragged
prompts, beam search) and the continuous-batching engine over the paged
KV cache (serving.ServingEngine), whose bucket programs are captured as
CUDA graphs on the card, with the engine's raw-speed levers: int8
weights (quant.int8_serving), speculative decoding with a draft model
and copy-on-write prefix sharing, both on the paged chunk program.
"""
from . import (amp, core, device, models, nn, observability, ops,  # noqa: F401
               optimizer, quant, serving, static)
from .core.dtypes import get_default_dtype, set_default_dtype  # noqa: F401
from .core.generator import seed  # noqa: F401
from .core.place import (CPUPlace, CUDAPlace, get_device,  # noqa: F401
                         is_compiled_with_cuda, set_device)
from .framework import Parameter, Tensor, no_grad, to_tensor  # noqa: F401

__version__ = "0.1.0"

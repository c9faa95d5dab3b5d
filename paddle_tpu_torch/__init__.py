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
and copy-on-write prefix sharing, both on the paged chunk program; GPT-2
pretraining with the vocab-chunked CE head and scanned stacks. On the
card static.TrainStep captures each step as one CUDA graph per input
signature (the kernels read their dropout seed from device memory), with
remat (distributed.recompute) and the JAX package's ten optimizers.
The vision path: conv, pooling, BatchNorm (running statistics carried
through the captured step) and the vision.models zoo, with ResNet-50
trained through the captured TrainStep. Detection: models.YOLOv3 with
the YOLO and NMS ops (ops.detection; greedy NMS is a hand-written
kernel, ops.nms), interpolate, and the training surface PaddleDetection-
and PaddleClas-shaped users drive: io (datasets, samplers, DataLoader),
metric, jit.InputSpec and hapi.Model (fit, evaluate, predict). The
Paddle Tensor surface and the op library's first half: the creation,
math, manipulation, logic, search and stat ops at the top level with
Paddle's semantics (`import paddle_tpu_torch as paddle`;
paddle.reshape, paddle.concat, paddle.argmax, ...), the Paddle names
torch.Tensor lacks added to it as methods (ops/__init__.py says which
and why), paddle.grad, the grad modes, save and load, ParamAttr,
regularizer and paddle.batch; vision.datasets (synthetic when no file
is given), vision.transforms and vision.image, with which LeNet trains
on MNIST in dygraph and through Model.fit (BASELINE config 1). The
rest of paddle.nn: the losses and their layers, the remaining layers,
the RNNs, nn.Transformer (MultiHeadAttention on the flash kernels when
no mask is given), beam-search decoding and the weight norms, with
Transformer-base trained through the captured TrainStep and an LSTM
seq2seq trained and beam-decoded. The op library's second half: linalg
(and the paddle.linalg namespace), einsum, the control-flow ops (which
select on the device inside a CUDA-graph capture), tensor arrays, the
sequence ops, the long-tail misc and loss ops, the CRF and Viterbi
decoding with the rest of extras, and the AMP graph ops, with the op
library's AMP casts; paddle.text's datasets, with which the CoNLL-2005
semantic-role labeller (db-LSTM + linear-chain CRF) trains and decodes.
"""
from . import (amp, core, device, distributed, hapi, incubate,  # noqa: F401
               inference, io, jit, linalg, metric, models, nn,
               observability, ops, optimizer, profiler, quant, regularizer,
               serving, static, text, vision)
from . import ops as tensor  # noqa: F401
from .batch import batch  # noqa: F401
from .core.dtypes import get_default_dtype, set_default_dtype  # noqa: F401
from .core.generator import seed  # noqa: F401
from .core.place import (CPUPlace, CUDAPlace, get_device,  # noqa: F401
                         is_compiled_with_cuda, set_device)
from .distributed.parallel import DataParallel  # noqa: F401
from .framework import (Parameter, Tensor, enable_grad,  # noqa: F401
                        in_dygraph_mode, is_grad_enabled, no_grad,
                        set_grad_enabled, to_tensor)
from .hapi import Model, callbacks  # noqa: F401
from .nn.functional.extension import sequence_mask  # noqa: F401
from .nn.param_attr import ParamAttr  # noqa: F401
from .ops import *  # noqa: F401,F403
from .ops.detection import nms  # noqa: F401
from .serialization import load, save  # noqa: F401

import torch as _torch  # noqa: E402

bool8 = _torch.bool
bfloat16 = _torch.bfloat16
complex64 = _torch.complex64
complex128 = _torch.complex128
float16 = _torch.float16
float32 = _torch.float32
float64 = _torch.float64
int8 = _torch.int8
int16 = _torch.int16
int32 = _torch.int32
int64 = _torch.int64
uint8 = _torch.uint8

__version__ = "0.1.0"


def is_tensor(x):
    return isinstance(x, Tensor)


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def disable_static(place=None):
    """Back to dygraph (the default mode)."""
    from .static import program
    program._static_mode = False


def enable_static():
    """The static graph mode flag (static/program.py): paddle.static's
    Program, program_guard and Executor record and run programs; ops
    record into a Program inside a program_guard in either mode."""
    from .static import program
    program._static_mode = True


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad (autograd_utils.partial_grad over torch.autograd)."""
    from .autograd_utils import partial_grad
    return partial_grad(outputs, inputs, grad_outputs, retain_graph,
                        create_graph, allow_unused, no_grad_vars)


def summary(net, input_size=None, dtypes=None, input=None):
    from .hapi.summary import summary as _summary
    return _summary(net, input_size, dtypes, input)


def flops(net, input_size, custom_ops=None, print_detail=False):
    return 0


def monkey_patch_math_varbase():
    """Reference internal: the Tensor operator overloads. torch.Tensor
    has them; kept as an explicit no-op."""


def monkey_patch_variable():
    """Reference internal: static Variable operator overloads; kept as
    an explicit no-op."""

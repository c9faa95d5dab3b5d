"""paddle_tpu_torch.static (counterpart of paddle_tpu/static): TrainStep
(the captured training step) and the Program/Executor feed-fetch surface
(program.py), its passes (passes.py), the inference-model files (io.py)
and the compatibility layer (compat.py)."""
from ..jit.api import InputSpec  # noqa: F401
from .train_step import TrainStep  # noqa: F401
from .program import (Program, program_guard, default_main_program,
                      default_startup_program, data, Executor,
                      append_backward, gradients)  # noqa: F401
from .passes import (Pass, PassBuilder, apply_pass,  # noqa: F401
                     PASS_REGISTRY, register_pass)
from . import nn  # noqa: F401
from . import io  # noqa: F401
from .io import (save_inference_model, load_inference_model,  # noqa: F401
                 serialize_program, deserialize_program)
from .compat import (global_scope, scope_guard, Scope,  # noqa: F401
                     BuildStrategy, ExecutionStrategy, CompiledProgram,
                     ParallelExecutor, Print, py_func, name_scope,
                     WeightNormParamAttr, save, load, save_vars,
                     load_vars, load_program_state, set_program_state,
                     cpu_places, cuda_places, xpu_places, Variable,
                     accuracy, auc)


def _enable_static_mode():
    from . import program
    program._static_mode = True


def nn_placeholder(*a, **k):
    return data(*a, **k)

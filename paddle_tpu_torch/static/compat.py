"""Static-facade compatibility surface (counterpart of
paddle_tpu/static/compat.py; the reference's python/paddle/static
executor- and scope-era API).

Each entry is a thin layer over the Program/Executor: save and load of
a program's state, py_func (a host callback as one recorded op), Print,
accuracy and auc over the port's ops, the places; or a configuration
object that strategy-driven code builds and that changes nothing here
(BuildStrategy, ExecutionStrategy: the fusion and memory passes they
toggle are the CUDA graph and the kernels' job), with CompiledProgram
and ParallelExecutor delegating to the Executor.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import place as _place
from ..core.recordable import recordable
from .program import Executor, Program, Var, default_main_program

__all__ = [
    "global_scope", "scope_guard", "Scope", "BuildStrategy",
    "ExecutionStrategy", "CompiledProgram", "ParallelExecutor", "Print",
    "py_func", "name_scope", "WeightNormParamAttr", "save", "load",
    "save_vars", "load_vars", "load_program_state", "set_program_state",
    "cpu_places", "cuda_places", "xpu_places", "Variable", "accuracy",
    "auc",
]

Variable = Var  # the reference's fluid.framework.Variable


# -- places -------------------------------------------------------------------

def cpu_places(device_count=None):
    return [_place.CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    """The CUDAPlaces of this host's cards (device_ids, else every card;
    raises without one, as the default place does)."""
    if device_ids is None:
        n = torch.cuda.device_count()
        if n == 0:
            _place.resolve_device(None)   # raises: no card
        device_ids = range(n)
    return [_place.CUDAPlace(i) for i in device_ids]


def xpu_places(device_ids=None):
    raise NotImplementedError("xpu_places: the port runs on CUDA cards "
                              "and the CPU; there is no XPU place")


# -- scope --------------------------------------------------------------------

class Scope:
    """Name -> persistable view (reference Scope): resolves names across
    the Programs an Executor ran while this scope was current (weakly
    held: a scope does not keep a program alive)."""

    class _VarView:
        def __init__(self, tensor):
            self._t = tensor

        def get_tensor(self):
            t = self._t.detach()
            return (t.float() if t.dtype == torch.bfloat16 else t) \
                .cpu().numpy()

        def set(self, value, place=None):
            with torch.no_grad():
                self._t.copy_(torch.as_tensor(np.asarray(value)))

    def __init__(self):
        self._programs = weakref.WeakValueDictionary()
        self._order = 0

    def _attach(self, program: Program):
        if any(p is program for p in self._programs.values()):
            return
        self._programs[self._order] = program
        self._order += 1

    def find_var(self, name: str):
        for k in sorted(self._programs.keys(), reverse=True):
            prog = self._programs.get(k)
            if prog is None:
                continue
            for vid, t in prog.params.items():
                if prog.vars[vid].name == name:
                    return Scope._VarView(t)
        return None

    def var(self, name: str):
        return self.find_var(name)


_global_scope = Scope()
_scope_stack: List[Scope] = []


def global_scope() -> Scope:
    return _scope_stack[-1] if _scope_stack else _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


_executor_run = Executor._run


def _run_in_scope(self, program, *args, **kwargs):
    if isinstance(program, CompiledProgram):
        program = program._program
    prog = program if program is not None else default_main_program()
    global_scope()._attach(prog)
    return _executor_run(self, prog, *args, **kwargs)


Executor._run = _run_in_scope


# -- executor configuration ---------------------------------------------------

class BuildStrategy:
    """Reference BuildStrategy (details/build_strategy.h): graph-pass
    toggles (fusion, memory reuse, reduce strategy). Accepted and kept so
    strategy-driven code runs; the Executor's CUDA graph and the kernels
    own what they toggle."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.fuse_all_reduce_ops = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.build_cse = False
        self.debug_graphviz_path = ""


class ExecutionStrategy:
    """Reference ExecutionStrategy (op threads, drop-scope cadence):
    accepted for parity; a replayed graph has neither."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1


class CompiledProgram:
    """Reference CompiledProgram/with_data_parallel: carries the
    strategy objects; the Executor runs the wrapped program (data
    parallelism is TrainStep(mesh=) and DataParallel in the port)."""

    def __init__(self, program, build_strategy: Optional[BuildStrategy]
                 = None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._places = None
        self._loss_name = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._places = places
        return self


class ParallelExecutor:
    """Legacy ParallelExecutor facade: delegates to an Executor on the
    card (use_cuda) or the CPU."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        self._program = main_program or default_main_program()
        self._exe = Executor(None if use_cuda else _place.CPUPlace())
        self._loss_name = loss_name

    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy=True):
        feed = feed if feed is not None else feed_dict
        prog = self._program
        resolved = [prog.var_by_name(f) if isinstance(f, str) else f
                    for f in fetch_list]
        return self._exe.run(prog, feed=feed, fetch_list=resolved,
                             return_numpy=return_numpy)


# -- runtime ops --------------------------------------------------------------

def Print(input, first_n=-1, message="", summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """Reference print_op: the port's print op (ops/misc_ops.py)."""
    from ..ops.misc_ops import print_op
    return print_op(input, message=message or "print:", first_n=first_n,
                    summarize=summarize)


class _PyFunc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, backward_func, specs, *xs):
        ctx.backward_func = backward_func
        ctx.save_for_backward(*xs)
        res = func(*[x.detach().cpu().numpy() for x in xs])
        res = res if isinstance(res, (list, tuple)) else [res]
        dev = xs[0].device if xs else torch.device("cpu")
        return tuple(torch.as_tensor(np.asarray(r, dtype=np.dtype(dt))
                                     .reshape(shape), device=dev)
                     for r, (shape, dt) in zip(res, specs))

    @staticmethod
    def backward(ctx, *gs):
        xs = ctx.saved_tensors
        if ctx.backward_func is None:
            return (None, None, None) + (None,) * len(xs)
        r = ctx.backward_func(*[t.detach().cpu().numpy()
                                for t in (*xs, *gs)])
        r = r if isinstance(r, (list, tuple)) else [r]
        return (None, None, None) + tuple(
            torch.as_tensor(np.asarray(v), device=x.device).to(x.dtype)
            .reshape(x.shape) for v, x in zip(r, xs))


@recordable
def py_func_call(xs, func=None, backward_func=None, specs=()):
    """The host callback `func` over the tensors xs (numpy in, numpy
    out, shaped and typed by `specs`); one recorded op of a Program. On
    meta tensors (a Program's shapes) the outputs are empty ones of the
    specs."""
    if any(x.device.type == "meta" for x in xs):
        return tuple(torch.empty(shape, dtype=getattr(torch, dt),
                                 device="meta") for shape, dt in specs)
    return _PyFunc.apply(func, backward_func, tuple(specs), *xs)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Reference static.py_func: arbitrary Python inside the graph, on
    the host at run time (a host synchronisation, so not inside a CUDA
    graph). `out` declares the result: a Var, a (shape, dtype) pair, or
    a list of either; backward_func, when given, is the VJP."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]

    def _is_pair(o):
        if not (isinstance(o, tuple) and len(o) == 2):
            return False
        try:
            np.dtype(o[1])
            return True
        except TypeError:
            return False
    multi = isinstance(out, list) or (
        isinstance(out, tuple) and not _is_pair(out) and len(out) > 0
        and isinstance(out[0], (Var, tuple, list)))
    outs = list(out) if multi else [out]

    def spec_of(o):
        if isinstance(o, torch.Tensor):
            return (tuple(o.shape), str(o.dtype).replace("torch.", ""))
        shape, dtype = o
        return (tuple(shape), np.dtype(dtype).name)
    res = py_func_call(xs, func=func, backward_func=backward_func,
                       specs=tuple(spec_of(o) for o in outs))
    return tuple(res) if multi else res[0]


@contextlib.contextmanager
def name_scope(prefix):
    """Reference static.name_scope: a debugging aid that prefixes
    generated names; program var names here are tmp_<id>, so the scope
    only brackets the code."""
    yield


class WeightNormParamAttr:
    """Reference WeightNormParamAttr: carries the weight-norm request so
    reference code parses; the layers treat it as a plain attr."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable


# -- state save / load --------------------------------------------------------

def _to_numpy(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def load_program_state(path_prefix: str):
    """name -> numpy array from static.save's file."""
    path = path_prefix if path_prefix.endswith(".pdparams") \
        else path_prefix + ".pdparams"
    with open(path, "rb") as f:
        return pickle.load(f)


def set_program_state(program: Program, state: Dict[str, np.ndarray]):
    with torch.no_grad():
        for vid, t in program.params.items():
            nm = program.vars[vid].name
            if nm in state:
                t.copy_(torch.as_tensor(np.asarray(state[nm])).to(t.dtype))


def save(program: Program, path_prefix: str):
    """static.save: the program's persistables as <prefix>.pdparams (a
    pickled name -> numpy dict, the JAX package's layout)."""
    state = {program.vars[vid].name: _to_numpy(t)
             for vid, t in program.params.items()}
    with open(path_prefix + ".pdparams", "wb") as f:
        pickle.dump(state, f, protocol=4)


def load(program: Program, path_prefix: str, executor=None,
         var_list=None):
    set_program_state(program, load_program_state(path_prefix))


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    os.makedirs(dirname, exist_ok=True)
    save(main_program or default_main_program(),
         os.path.join(dirname, filename or "params"))


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    load(main_program or default_main_program(),
         os.path.join(dirname, filename or "params"))


# -- static metrics -----------------------------------------------------------

def accuracy(input, label, k=1, correct=None, total=None):
    """Reference accuracy_op: top-k accuracy of `input` against integer
    `label` [N] or [N, 1] (the port's metric.accuracy)."""
    from ..metric import accuracy as _metric_accuracy
    return _metric_accuracy(input, label, k=k, correct=correct,
                            total=total)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Reference auc_op, stateless batch form: the positive-class scores
    histogrammed into num_thresholds + 1 buckets, then the trapezoidal
    sweep (the JAX package's formula)."""
    x = input
    scores = x[:, 1] if x.dim() == 2 and x.shape[1] >= 2 else x.reshape(-1)
    lb = label.reshape(-1).to(torch.float32)
    idx = torch.clamp((scores * num_thresholds).to(torch.int32), 0,
                      num_thresholds).long()
    pos = torch.zeros(num_thresholds + 1, dtype=torch.float32,
                      device=x.device).index_add(0, idx, lb)
    neg = torch.zeros(num_thresholds + 1, dtype=torch.float32,
                      device=x.device).index_add(0, idx, 1.0 - lb)
    tot_pos = torch.cumsum(pos.flip(0), 0)
    tot_neg = torch.cumsum(neg.flip(0), 0)
    zero = torch.zeros(1, dtype=torch.float32, device=x.device)
    prev_neg = torch.cat([zero, tot_neg[:-1]])
    prev_pos = torch.cat([zero, tot_pos[:-1]])
    area = torch.sum((tot_neg - prev_neg) * (prev_pos + tot_pos) / 2.0)
    denom = torch.clamp_min(tot_pos[-1] * tot_neg[-1], 1e-12)
    return area / denom

"""paddle.jit (counterpart of paddle_tpu/jit/api.py; the reference's
to_static ProgramTranslator, jit.save and jit.load).

- InputSpec: a shape and dtype signature (a None dim is variable);
  hapi.Model reads its inputs=/labels= lists too.
- functionalize(fn, layer): fn as pure(state, seed, *args) -> (out,
  new_state), the layer's parameters and buffers taken from `state` (a
  name -> tensor dict) and the dropout draws from `seed`; a buffer the
  forward writes in place (BatchNorm's running statistics) comes back in
  new_state.
- to_static / StaticFunction: the function after dy2static's AST
  conversion (jit/dy2static.py). With grad on it runs under torch
  autograd (the port's tape: the JAX package tapes its compiled program
  as one op). On the card with grad off it replays one CUDA graph per
  (shapes, dtypes, training) signature (static/capture.py: the first
  call of a signature is its warm-up, which records the seed slots, then
  the capture), buffers written in place inside the graph; on the CPU it
  runs the converted function eagerly.
- export_forward / save / load / TranslatedLayer: a layer's eval forward
  as a torch.export program (None dims dynamic, torch.export.Dim; the
  flash-attention and NMS ops are named ops with shape functions, so the
  export traces them as one node each), written as the port's .pdmodel;
  .pdiparams keeps the JAX package's layout (a pickle of numpy arrays),
  so the port reads either package's. A .pdmodel that is not the port's
  is refused with a message that says so.
"""
from __future__ import annotations

import contextlib
import functools
import io
import os
import pickle
import warnings
from typing import Callable

import numpy as np
import torch

from ..core import dtypes as _dtypes
from ..core.enforce import EnforceNotMet

__all__ = ["InputSpec", "StaticFunction", "functionalize", "to_static",
           "not_to_static", "save", "load", "TranslatedLayer",
           "export_forward", "ExportedForward"]

# the first bytes of the port's .pdmodel (a torch.export archive follows)
PDMODEL_MAGIC = b"PADDLE_TPU_TORCH.pdmodel.v1\n"


class InputSpec:
    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = _dtypes.convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype, name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


def _layer_class():
    from ..nn.layer.layers import Layer
    return Layer


@contextlib.contextmanager
def _swapped_state(layer, state):
    """The layer's parameters and buffers read from `state` (by
    state_dict name) inside; restored after."""
    if layer is None or not state:
        yield
        return
    from torch.nn.utils.stateless import _reparametrize_module
    own = dict(layer.state_dict(keep_vars=True))
    with _reparametrize_module(layer, {k: v for k, v in state.items()
                                       if k in own}):
        yield


def functionalize(fn: Callable, layer=None):
    """pure(state, seed, *args, **kwargs) -> (out, new_state): fn with the
    layer's state from `state` (None: its own), grad off, every dropout
    draw derived from `seed` (core/generator.py seed_scope)."""
    from ..core.generator import seed_scope
    target = layer if layer is not None else getattr(fn, "__self__", None)

    def pure(state, seed, *args, **kwargs):
        with torch.no_grad(), seed_scope(int(seed)), \
                _swapped_state(target, state):
            out = fn(*args, **kwargs)
        if target is None:
            return out, {}
        new_state = dict(state) if state else dict(
            target.state_dict(keep_vars=True))
        return out, new_state
    return pure


def _tensor_leaves(tree):
    from ..static.capture import _leaves
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _signature(tree):
    def sig(x):
        if isinstance(x, torch.Tensor):
            return ("t", tuple(x.shape), x.dtype, x.device.type)
        if isinstance(x, (list, tuple)):
            return (type(x).__name__,) + tuple(sig(i) for i in x)
        if isinstance(x, dict):
            return ("dict",) + tuple(sorted((k, sig(v))
                                            for k, v in x.items()))
        try:
            hash(x)
            return ("lit", type(x).__name__, x)
        except TypeError:
            return ("obj", id(x))
    return sig(tree)


class _Program:
    pass


class StaticFunction:
    """The to_static callable (ProgramTranslator + StaticFunction): see
    the module's docstring. `programs` counts the captured graphs,
    `captures` and `replays` the calls that made and ran them."""

    def __init__(self, function, input_spec=None, layer=None,
                 build_strategy=None, enable_ast=True):
        self._function = function
        self._input_spec = input_spec
        self._layer = layer if layer is not None else getattr(
            function, "__self__", None)
        converted = function
        if enable_ast and not getattr(function, "_not_to_static", False):
            import inspect as _inspect
            from .dy2static import convert_function
            if _inspect.ismethod(function):
                conv = convert_function(function.__func__)
                if conv is not function.__func__:
                    self_obj = function.__self__

                    @functools.wraps(function)
                    def converted(*a, **k):
                        return conv(self_obj, *a, **k)
            else:
                converted = convert_function(function)
        self._converted = converted
        self._cache = {}
        self.captures = 0
        self.replays = 0
        functools.update_wrapper(self, function,
                                 assigned=("__name__", "__doc__"))

    @property
    def concrete_program(self):
        return self

    @property
    def programs(self) -> int:
        return len(self._cache)

    def _device(self, args, kwargs):
        ts = _tensor_leaves((args, kwargs))
        if ts:
            return ts[0].device
        if self._layer is not None:
            for t in self._layer.parameters():
                return t.device
        return torch.device("cpu")

    def __call__(self, *args, **kwargs):
        from .compat import ProgramTranslator
        if not ProgramTranslator.enabled():
            # ProgramTranslator().enable(False): the original function
            return self._function(*args, **kwargs)
        dev = self._device(args, kwargs)
        if dev.type != "cuda" or torch.is_grad_enabled():
            # eager: the converted function under torch autograd
            return self._converted(*args, **kwargs)
        return self._graph_call(dev, args, kwargs)

    def _graph_call(self, dev, args, kwargs):
        from ..core.generator import Draw, SeedSlots, next_seed, seed_scope
        from ..static.capture import (StaticInputs, capture, clone_outputs,
                                      warm_up)
        training = self._layer.training if self._layer is not None \
            else None
        key = (_signature((args, kwargs)), training)
        run_seed = next_seed(dev)
        prog = self._cache.get(key)
        if prog is not None:
            prog.inputs.fill((args, kwargs))
            prog.slots.fill(run_seed)
            prog.graph.replay()
            self.replays += 1
            return clone_outputs(prog.out)
        prog = _Program()
        prog.inputs = StaticInputs((args, kwargs), dev)
        prog.slots = SeedSlots(dev).record(run_seed)
        a, k = prog.inputs.tree

        def body():
            with seed_scope(Draw((), prog.slots)):
                return self._converted(*a, **k)
        first = warm_up(body, dev)
        prog.slots.freeze()
        prog.graph, prog.out = capture(body, dev,
                                       prog.slots.generators.values(),
                                       program="to_static")
        self._cache[key] = prog
        self.captures += 1
        return first

    def release(self):
        """Drop the captured graphs and their memory pools."""
        self._cache.clear()


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """@paddle.jit.to_static decorator / wrapper: a Layer keeps its
    object and gets a StaticFunction forward; a function becomes one."""

    def decorate(fn):
        if isinstance(fn, _layer_class()):
            fn.forward = StaticFunction(fn.forward, input_spec, layer=fn,
                                        build_strategy=build_strategy)
            return fn
        return StaticFunction(fn, input_spec,
                              build_strategy=build_strategy)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


# -- export --------------------------------------------------------------------

def state_arrays(layer):
    """name -> numpy array of a layer's state dict (bfloat16 as float32,
    its exact values: numpy has no bfloat16), the .pdiparams layout."""
    out = {}
    for k, v in layer.state_dict().items():
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        out[k] = v.cpu().numpy()
    return out


def _spec_meta(layer, input_spec):
    return {"class": type(layer).__name__,
            "input_spec": [{"shape": [None if d is None else int(d)
                                      for d in s.shape],
                            "dtype": str(s.dtype).replace("torch.", "")}
                           for s in (input_spec or [])]}


class _Forward(torch.nn.Module):
    """The layer's original forward as a module for torch.export (the
    layer sits under `m`, so its state names are `m.<name>`)."""

    def __init__(self, layer, fn):
        super().__init__()
        self.m = layer
        self._fn = fn

    def forward(self, *inputs):
        return self._fn(*inputs)


def _example(spec, device, size=2):
    shape = tuple(size if d is None else int(d) for d in spec.shape)
    return torch.zeros(shape, dtype=spec.dtype, device=device)


class ExportedForward:
    """A torch.export program of a layer's eval forward: `module()` runs
    it, `save`/`load` and `to_bytes`/`from_bytes` write and read the
    port's .pdmodel."""

    def __init__(self, ep, n_outputs=None):
        self.ep = ep
        self.n_outputs = n_outputs if n_outputs is not None else len(
            ep.graph_signature.user_outputs)
        self._module = None

    def module(self):
        if self._module is None:
            self._module = self.ep.module()
        return self._module

    def to(self, device):
        """The program moved to `device` (its weights and constants)."""
        from torch.export.passes import move_to_device_pass
        return ExportedForward(move_to_device_pass(self.ep, str(device)),
                               self.n_outputs)

    def state_names(self):
        """The program's state names as the layer's state_dict has them."""
        return [k[2:] if k.startswith("m.") else k
                for k in self.ep.state_dict]

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        torch.export.save(self.ep, buf)
        return PDMODEL_MAGIC + buf.getvalue()

    @staticmethod
    def from_bytes(blob: bytes) -> "ExportedForward":
        if not blob.startswith(PDMODEL_MAGIC):
            raise EnforceNotMet(
                "not a paddle_tpu_torch .pdmodel: the JAX package writes "
                "jax.export StableHLO there, which the port cannot run; "
                "load the .pdiparams weights into the model class "
                "instead (jit.load(path, weights_only=True))",
                op_type="pdmodel")
        ep = torch.export.load(io.BytesIO(blob[len(PDMODEL_MAGIC):]))
        return ExportedForward(ep)

    def save(self, path):
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    @staticmethod
    def load(path) -> "ExportedForward":
        with open(path, "rb") as f:
            return ExportedForward.from_bytes(f.read())


def export_forward(layer, input_spec):
    """torch.export of the layer's eval forward at `input_spec` (None
    dims dynamic, each its own torch.export.Dim), traced on the device
    of the layer's parameters, grad off."""
    fn = layer.forward
    if isinstance(fn, StaticFunction):
        fn = fn._function
    dev = next((t.device for t in layer.state_dict().values()),
               torch.device("cpu"))
    modes = [lyr.training for lyr in layer.modules()]
    layer.eval()
    try:
        args = tuple(_example(s, dev) for s in input_spec)
        dyn = []
        n = 0
        for s in input_spec:
            dims = {}
            for i, d in enumerate(s.shape):
                if d is None:
                    dims[i] = torch.export.Dim(f"d{n}", min=1)
                    n += 1
            dyn.append(dims or None)
        with torch.no_grad():
            # _Forward takes *inputs: one entry, the tuple of theirs
            dynamic = (tuple(dyn),) if any(dyn) else None
            ep = torch.export.export(_Forward(layer, fn), args,
                                     dynamic_shapes=dynamic, strict=False)
        return ExportedForward(ep)
    finally:
        for lyr, m in zip(layer.modules(), modes):
            lyr.training = m


def _load_state_into(module, names, state):
    """Copy `state` (numpy or tensors, by layer state name) into the
    exported module's weights in place."""
    own = module.state_dict(keep_vars=True)
    with torch.no_grad():
        for name in names:
            key = f"m.{name}"
            if name in state and key in own:
                src = state[name]
                src = src if isinstance(src, torch.Tensor) else \
                    torch.from_numpy(np.array(src))
                own[key].copy_(src.to(own[key].dtype))


class TranslatedLayer(_layer_class()):
    """A loaded inference layer (reference TranslatedLayer): the weights
    (as parameters named with "." replaced by "__"; `original_state`
    keeps the saved names) and, when the artifact has the port's
    .pdmodel, a runnable forward."""

    def __init__(self, state, meta, exported=None):
        super().__init__()
        self._meta = meta
        self._exported = exported
        self._keys = list(state.keys())
        for k, v in state.items():
            t = torch.from_numpy(np.array(v))
            self.register_parameter(k.replace(".", "__"),
                                    torch.nn.Parameter(t,
                                                       requires_grad=False))
        if exported is not None:
            _load_state_into(exported.module(), self._keys, state)

    def original_state(self):
        """name -> tensor under the names the layer was saved with."""
        return {k: getattr(self, k.replace(".", "__")) for k in self._keys}

    def forward(self, *args):
        if self._exported is None:
            raise RuntimeError(
                "artifact has no serialized program (saved without "
                "input_spec, or loaded with weights_only=True); rebuild "
                "the model class and use set_state_dict")
        return self._exported.module()(*args)


def save(layer, path, input_spec=None, **config):
    """paddle.jit.save: the weights (.pdiparams), and with input_spec the
    exported program (.pdmodel), so `load` returns a runnable layer. The
    export is best-effort, as in the JAX package: an untraceable forward
    warns and saves the weights only."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    is_layer = isinstance(layer, _layer_class())
    state = state_arrays(layer) if is_layer else {}
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({"state": state,
                     "meta": _spec_meta(layer, input_spec)}, f)
    if input_spec and is_layer:
        try:
            export_forward(layer, input_spec).save(path + ".pdmodel")
        except Exception as e:
            if os.path.exists(path + ".pdmodel"):
                os.remove(path + ".pdmodel")
            warnings.warn(
                f"jit.save: program export skipped ({type(e).__name__}: "
                f"{e}); weights saved, load() will be weights-only")


def load(path, weights_only=False, **config):
    """paddle.jit.load: a TranslatedLayer over the .pdiparams (of this
    package or the JAX package's: a pickle of numpy arrays) and, unless
    weights_only, the .pdmodel, which must be the port's."""
    with open(path + ".pdiparams", "rb") as f:
        data = pickle.load(f)
    exported = None
    if not weights_only and os.path.exists(path + ".pdmodel"):
        exported = ExportedForward.load(path + ".pdmodel")
    state = {k: np.asarray(v) for k, v in data["state"].items()}
    return TranslatedLayer(state, data.get("meta", {}), exported)

"""Static Program / Executor (counterpart of paddle_tpu/static/program.py,
the reference's ProgramDesc + Executor feed/fetch).

A Program is a recorded op graph. While a program_guard is active, a
TorchFunctionMode (the recording point; the JAX package records through
its registry's tracer hook) sees every torch function called with a
`Var`, a program variable, among its arguments, and appends an OpNode
(the function, its arguments with each tensor replaced by a slot, and
its outputs' var ids) instead of computing anything. A Var is a tensor
on the meta device, so the shapes come from running the op on meta
tensors (the InferShape pass; jax.eval_shape in the JAX package): the
named ops (flash attention, NMS) through their shape functions. A None
dim of `data()` is SYMBOLIC_DIM there, and an attribute equal to it
warns, as in the JAX package.

What the mode records, besides ops on Vars:
- live tensors an op touches (parameters, buffers) are captured, as the
  JAX package's capture_param does: kind "param" when they require grad,
  else "buffer";
- a live tensor computed outside the program from captured ones (a tied
  weight's `w.t()`, run before any Var met it) is recorded through the
  op that made it (its "shadow"), so its value is recomputed each run;
- factory ops asked for the meta device (`torch.arange(s,
  device=x.device)`) are recorded, and replay on the Executor's device;
- in-place ops on a Var rebind the Python object to the op's output; a
  recordable BatchNorm in training writes its running statistics in
  place at each run, and those writes are the program's _buffer_writes;
- port functions marked recordable (core/recordable.py: dropout,
  batch_norm, the attention functionals) are one op each, so a random
  draw happens at each run, inside the run's seed scope.

Ops are serialized by name (torch.overrides.resolve_name, or the
module and name of a port function); a callable with no stable name
raises EnforceNotMet ("not a registered op") in to_bytes.

Executor(place) runs on the card unless given CPUPlace(). It replays the
node list over real tensors; the backward is torch.autograd.grad over
the replay, and an optimize stage (Optimizer.minimize on a Var) applies
the optimizer's rule in place. On the card each feed signature is one
CUDA graph (static/capture.py: the first call runs eagerly as the
warm-up, records the seed slots, then captures; later calls copy the
feeds into the graph's static inputs, write the run's seeds and the lr,
and replay), the counterpart of the JAX package's one jitted executable
a signature. A program that cannot be captured raises, naming the
error; there is no eager fallback on the card.
"""
from __future__ import annotations

import contextlib
import importlib
import pickle
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode, resolve_name
from torch.utils.weak import WeakIdKeyDictionary

from ..core import dtypes as _dtypes
from ..core.enforce import EnforceNotMet, NotFoundError
from ..core.generator import Draw, SeedSlots, next_seed, seed_scope
from ..core.place import host_tensor, resolve_device

__all__ = ["Program", "program_guard", "default_main_program",
           "default_startup_program", "data", "Executor",
           "append_backward", "gradients", "Var", "OpNode",
           "backward_slice", "SYMBOLIC_DIM", "op_name", "resolve_op"]

_static_mode = False

# placeholder extent for None/-1 dims while recording (the JAX
# package's): not 1, so a batch-1 placeholder cannot silently specialize
# broadcasting or squeeze; a distinctive prime also lets the recorder
# warn when the value leaks into an op's attributes
SYMBOLIC_DIM = 509

PROGRAM_FORMAT = "paddle_tpu_torch"
PROGRAM_FORMAT_VERSION = 3


def _plain():
    """torch function handling off: ops run on meta tensors as they are."""
    return torch._C.DisableTorchFunction()


class Var(torch.Tensor):
    """A program variable: a meta tensor of its shape and dtype (data()
    None dims at SYMBOLIC_DIM). `orig_shape` keeps the declared shape;
    `symbolic_dims` indexes its None dims."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __new__(cls, program, name, shape, dtype, kind="intermediate"):
        dtype = _dtypes.convert_dtype(dtype)
        orig = tuple(None if (s is None or int(s) < 0) else int(s)
                     for s in shape)
        with _plain():
            meta = torch.empty(tuple(SYMBOLIC_DIM if s is None else s
                                     for s in orig), dtype=dtype,
                               device="meta")
        self = torch.Tensor._make_subclass(cls, meta, False)
        self.orig_shape = orig
        self.symbolic_dims = {i for i, s in enumerate(orig) if s is None}
        self.program = program
        self.kind = kind      # feed | param | buffer | intermediate | grad
        self.var_id = program._new_var_id(self, name)
        return self

    @property
    def name(self):
        return self.__dict__.get("_var_name")

    @name.setter
    def name(self, value):
        self.__dict__["_var_name"] = value

    def __repr__(self):
        return (f"Var(name={self.name}, shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, kind={self.kind})")


class _Slot:
    """The place of the i-th tensor argument of an op's recorded call."""
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i

    def __reduce__(self):
        return (_Slot, (self.i,))

    def __repr__(self):
        return f"<slot {self.i}>"


class OpNode:
    """One recorded op: `fn(*args, **kwargs)` with `template` holding the
    (args, kwargs) whose tensor places are _Slots of `in_ids`; `out_ids`
    the tensor outputs in order; `grad` the grad mode at recording."""
    __slots__ = ("op_type", "fn", "in_ids", "template", "out_ids",
                 "grad", "writes")

    def __init__(self, op_type, fn, in_ids, template, out_ids, grad=True,
                 writes=()):
        self.op_type = op_type
        self.fn = fn
        self.in_ids = in_ids
        self.template = template
        self.out_ids = out_ids
        self.grad = grad
        self.writes = tuple(writes)   # captured buffers written in place

    def copy(self):
        return OpNode(self.op_type, self.fn, list(self.in_ids),
                      self.template, list(self.out_ids), self.grad,
                      self.writes)

    def __repr__(self):
        return (f"OpNode({self.op_type}, in={self.in_ids}, "
                f"out={self.out_ids})")


def backward_slice(ops, target_ids):
    """Liveness slice shared by Program.prune and the
    dead_code_elimination_pass (static/passes.py): (kept_ops,
    needed_var_ids) for the ops that can reach `target_ids`."""
    needed = set(target_ids)
    kept: List[OpNode] = []
    for node in reversed(ops):
        if any(o in needed for o in node.out_ids):
            kept.append(node)
            needed.update(i for i in node.in_ids if i is not None)
    kept.reverse()
    return kept, needed


# -- op names ---------------------------------------------------------------

def _walk(obj, parts):
    for p in parts:
        obj = getattr(obj, p)
    return obj


def resolve_op(name: str):
    """The callable a serialized op name stands for: `torch.…` (a torch
    function), `paddle_tpu_torch.…` (a port function), or `ns.op` (a
    torch.ops op such as paddle_tpu.flash_attn_fwd)."""
    parts = name.split(".")
    if parts[0] == "torch":
        return _walk(torch, parts[1:])
    if parts[0] == "paddle_tpu_torch":
        for i in range(len(parts) - 1, 0, -1):
            try:
                mod = importlib.import_module(".".join(parts[:i]))
            except ImportError:
                continue
            if parts[-1] == "apply":
                owner = _walk(mod, parts[i:-1])
                if isinstance(owner, type) and \
                        issubclass(owner, torch.autograd.Function):
                    return FunctionApply(owner)
            return _walk(mod, parts[i:])
        raise NotFoundError(f"no op named {name!r}")
    return _walk(torch.ops, parts)


class FunctionApply:
    """A torch.autograd.Function's apply as one recorded op: its forward
    and its own backward run at each replay (recorded op by op, the
    forward's ops would run without grad and lose the Function's
    backward)."""

    def __init__(self, cls):
        self.cls = cls
        self.__module__ = cls.__module__
        self.__qualname__ = f"{cls.__qualname__}.apply"

    def __call__(self, *args, **kwargs):
        return _function_apply(self.cls, *args, **kwargs)

    def __eq__(self, other):
        return isinstance(other, FunctionApply) and other.cls is self.cls

    def __hash__(self):
        return hash(self.cls)


_function_apply = torch.autograd.Function.__dict__["apply"].__func__


def op_name(fn) -> Optional[str]:
    """The stable name of an op's callable, or None when it has none (a
    lambda, a closure, a bound method of an object)."""
    if isinstance(fn, FunctionApply):
        name = f"{fn.__module__}.{fn.__qualname__}"
        try:
            return name if resolve_op(name) == fn else None
        except (AttributeError, NotFoundError):
            return None
    name = resolve_name(fn)
    if name is None:
        mod = getattr(fn, "__module__", None) or ""
        qual = getattr(fn, "__qualname__", None) or ""
        if mod.split(".")[0] == "paddle_tpu_torch" and qual \
                and "<" not in qual:
            name = f"{mod}.{qual}"
    if name is None:
        return None
    try:
        got = resolve_op(name)
    except (AttributeError, NotFoundError, RuntimeError):
        return None
    if got is not fn and getattr(got, "__wrapped__", None) is not fn:
        return None
    return name


def _short(name):
    return (name or "").rsplit(".", 1)[-1]


_INPLACE_DUNDER = {"__iadd__", "__isub__", "__imul__", "__itruediv__",
                   "__ifloordiv__", "__imod__", "__ipow__", "__iand__",
                   "__ior__", "__ixor__", "__ilshift__", "__irshift__",
                   "__imatmul__", "__setitem__"}


# flag setters a program variable takes as no-ops while recording
_FLAG_OPS = {"requires_grad_", "retain_grad", "register_hook"}


def _is_inplace(fn) -> bool:
    nm = _short(resolve_name(fn) or getattr(fn, "__name__", ""))
    if nm in _INPLACE_DUNDER:
        return True
    return nm.endswith("_") and not nm.startswith("_")


# -- structures -------------------------------------------------------------

def _map(tree, fn):
    """fn over the leaves of nested lists, tuples and dicts."""
    if isinstance(tree, torch.Size):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        items = [_map(x, fn) for x in tree]
        if isinstance(tree, list):
            return items
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        if type(tree) is tuple:
            return tuple(items)
        return type(tree)(items)      # torch.return_types
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    out = []
    _map(tree, out.append)
    return out


def _tensor_leaves(tree):
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def _is_meta_device(x):
    if isinstance(x, torch.device):
        return x.type == "meta"
    return isinstance(x, str) and x == "meta"


_META = torch.device("meta")


def _is_device(x):
    if isinstance(x, torch.device):
        return True
    return isinstance(x, str) and (x in ("cpu", "cuda", "meta")
                                   or x.startswith("cuda:"))


def _leaks(v):
    if isinstance(v, bool):
        return False
    if isinstance(v, (int, np.integer)):
        return int(v) == SYMBOLIC_DIM
    if isinstance(v, (list, tuple)):
        return any(_leaks(x) for x in v)
    return False


class Program:
    """A recorded graph (ProgramDesc analogue)."""

    def __init__(self):
        self.vars: Dict[int, Var] = {}
        self.var_names: Dict[str, int] = {}
        self.ops: List[OpNode] = []
        self.feeds: List[int] = []
        self.params: Dict[int, torch.Tensor] = {}  # var_id -> live tensor
        self.buffer_ids: set = set()
        # (buffer var, producing op's output var): the buffers an op
        # writes in place at each run (BatchNorm's running statistics)
        self._buffer_writes: List[Tuple[int, int]] = []
        self._counter = 0
        self._optimize = None        # (optimizer, loss var)
        # the optimizer state of a deserialized program, restored into
        # its optimizer at the first run
        self._opt_state = None
        self.random_seed = None
        self._captured = WeakIdKeyDictionary()   # live tensor -> var id
        self._shadows = WeakIdKeyDictionary()    # live tensor -> op call
        self._aliases = WeakIdKeyDictionary()    # written buffer -> Var

    # -- vars ---------------------------------------------------------------
    def _new_var_id(self, var, name) -> int:
        vid = self._counter
        self._counter += 1
        var.name = name if name else f"tmp_{vid}"
        self.vars[vid] = var
        self.var_names[var.name] = vid
        return vid

    def var_by_name(self, name) -> Var:
        if name not in self.var_names:
            raise NotFoundError(f"var '{name}' not in program")
        return self.vars[self.var_names[name]]

    def global_block(self):
        return self

    def all_parameters(self):
        return [t for vid, t in self.params.items()
                if vid not in self.buffer_ids]

    def list_vars(self):
        return list(self.vars.values())

    # -- capture ------------------------------------------------------------
    def capture_param(self, t: torch.Tensor) -> Var:
        """Register a live tensor the program reads: kind "param" when it
        requires grad (trained), else "buffer" (no grads, no updates)."""
        vid = self._captured.get(t)
        if vid is not None:
            return self.vars[vid]
        own = getattr(t, "name", None)
        name = own if isinstance(own, str) and own not in self.var_names \
            else f"param_{len(self.params)}"
        kind = "param" if t.requires_grad else "buffer"
        v = Var(self, name, t.shape, t.dtype, kind=kind)
        self.params[v.var_id] = t
        self._captured[t] = v.var_id
        if kind == "buffer":
            self.buffer_ids.add(v.var_id)
        return v

    def _capture(self, t: torch.Tensor) -> Var:
        alias = self._aliases.get(t)
        if alias is not None:
            return alias
        if t in self._captured:
            return self.vars[self._captured[t]]
        shadow = self._shadows.get(t)
        if shadow is not None:
            v = self.add_op(*shadow)
            self._aliases[t] = v
            return v
        return self.capture_param(t)

    def _shadow(self, fn, args, kwargs, out):
        """Remember how an op outside the program made `out` from live
        tensors, so a later op on a Var records it instead of baking in
        its value."""
        ins = _tensor_leaves((args, kwargs))
        if not ins:
            return
        if _is_inplace(fn):
            for t in ins[:1]:
                self._shadows.pop(t, None)
            return
        if isinstance(out, torch.Tensor) and not isinstance(out, Var) \
                and not any(out is t for t in ins):
            self._shadows[out] = (fn, args, kwargs)

    # -- recording ----------------------------------------------------------
    def _record(self, fn, args, kwargs):
        leaves = _leaves((args, kwargs))
        if any(isinstance(x, Var) for x in leaves) or \
                any(_is_meta_device(x) for x in leaves):
            return self.add_op(fn, args, kwargs)
        out = fn(*args, **kwargs)
        self._shadow(fn, args, kwargs, out)
        return out

    def add_op(self, fn, args, kwargs):
        """Record fn(*args, **kwargs); returns its result with Vars for
        its tensors (nothing is computed on real data)."""
        name = op_name(fn)
        label = name or getattr(fn, "__qualname__", repr(fn))
        if _short(resolve_name(fn) or "") in _FLAG_OPS:
            return args[0] if _short(resolve_name(fn)) != "register_hook" \
                else None
        in_ids: List[int] = []

        def enc(x):
            if _is_device(x):
                # a program runs on one device, its Executor's: every
                # device argument stands for it
                return _META
            if isinstance(x, Var):
                if x.program is not self:
                    raise EnforceNotMet("a Var of another Program",
                                        op_type=label)
                in_ids.append(x.var_id)
                return _Slot(len(in_ids) - 1)
            if isinstance(x, torch.Tensor):
                in_ids.append(self._capture(x).var_id)
                return _Slot(len(in_ids) - 1)
            return x
        template = _map((tuple(args), dict(kwargs)), enc)
        consts = [x for x in _leaves(template) if not isinstance(x, _Slot)]
        if any(_leaks(c) for c in consts):
            # a SYMBOLIC_DIM-valued attribute came from reading a
            # placeholder dim (`x.shape[0]` of a data() var): it would
            # bake the placeholder where the real batch size belongs
            warnings.warn(
                f"static capture of op '{label}': an attribute equals "
                f"the symbolic-dim placeholder ({SYMBOLIC_DIM}); if this "
                "came from reading a data() placeholder's shape, derive "
                "it inside the op from the input instead (paddle.shape)",
                stacklevel=4)
        m_args, m_kwargs = _map(
            template, lambda x: self.vars[in_ids[x.i]]
            if isinstance(x, _Slot) else x)
        try:
            with _plain(), seed_scope(0), _inferring():
                res = fn(*m_args, **m_kwargs)
        except Exception as e:
            raise EnforceNotMet(
                f"cannot record {label} on the program's shapes "
                f"({type(e).__name__}: {e}); a Program reads no tensor's "
                "value while it records", op_type=label) from e
        inplace = _is_inplace(fn)
        outs = _tensor_leaves(res)
        ins = [self.vars[i] for i in in_ids]
        if inplace:
            target = args[0] if args else None
            if not isinstance(target, torch.Tensor):
                raise EnforceNotMet("an in-place op without a tensor "
                                    "target", op_type=label)
            meta_t = m_args[0]
            new = Var(self, None, meta_t.shape, meta_t.dtype)
            node = OpNode(name, fn, in_ids, template, [new.var_id],
                          torch.is_grad_enabled())
            self.ops.append(node)
            if isinstance(target, Var):
                self._rebind(target, new)
                return None if res is None else _map(
                    res, lambda x: target if x is meta_t else x)
            bvid = self._captured.get(target)
            if bvid is not None:
                self._buffer_writes.append((bvid, new.var_id))
                node.writes = (bvid,)
            self._aliases[target] = new
            return None if res is None else target
        if not outs:
            return res
        if len(outs) == 1 and any(outs[0] is v for v in ins):
            # the op returned its input (a no-op cast or contiguous)
            src = next(v for v in ins if outs[0] is v)
            return _map(res, lambda x: src if x is outs[0] else x)
        out_vars = {}
        for o in outs:
            v = Var(self, None, tuple(o.shape), o.dtype)
            v.symbolic_dims = {i for i, s in enumerate(o.shape)
                               if s == SYMBOLIC_DIM}
            v.orig_shape = tuple(None if i in v.symbolic_dims else s
                                 for i, s in enumerate(o.shape))
            out_vars[id(o)] = v
        node = OpNode(name, fn, in_ids, template,
                      [out_vars[id(o)].var_id for o in outs],
                      torch.is_grad_enabled(),
                      writes=self._writes_of(fn, m_args, m_kwargs, in_ids))
        self.ops.append(node)
        for bvid in node.writes:
            self._buffer_writes.append((bvid, node.out_ids[0]))
        return _map(res, lambda x: out_vars.get(id(x), x)
                    if isinstance(x, torch.Tensor) else x)

    def _writes_of(self, fn, m_args, m_kwargs, in_ids):
        """The captured buffers a recordable op writes in place: a
        training batch_norm's running mean and variance."""
        if _short(getattr(fn, "__qualname__", "")) != "batch_norm" or \
                not getattr(fn, "recordable", False):
            return ()
        import inspect
        bound = inspect.signature(fn).bind(*m_args, **m_kwargs)
        bound.apply_defaults()
        a = bound.arguments
        train = a["training"] and not (a["use_global_stats"] or False)
        if not train:
            return ()
        out = []
        for key in ("running_mean", "running_var"):
            t = a[key]
            if isinstance(t, Var) and t.var_id in self.buffer_ids:
                out.append(t.var_id)
        return tuple(out)

    def _rebind(self, target: Var, new: Var):
        """After an in-place op, the Python object `target` stands for
        the op's output: the two Vars swap their ids."""
        old_id, new_id = target.var_id, new.var_id
        if old_id in self.feeds:
            raise EnforceNotMet("an in-place op on a feed var",
                                op_type="in-place")
        target.var_id, new.var_id = new_id, old_id
        self.vars[old_id], self.vars[new_id] = new, target
        old_name = target.name
        target.name, new.name = new.name, old_name
        self.var_names[target.name] = new_id
        self.var_names[new.name] = old_id

    # -- clone / prune ------------------------------------------------------
    def _copy_meta(self, p: "Program"):
        p.vars = dict(self.vars)
        p.var_names = dict(self.var_names)
        p.feeds = list(self.feeds)
        p.params = dict(self.params)
        p.buffer_ids = set(self.buffer_ids)
        p._buffer_writes = list(self._buffer_writes)
        p._counter = self._counter
        p.random_seed = self.random_seed

    def clone(self, for_test=False):
        p = Program()
        self._copy_meta(p)
        p.ops = [n.copy() for n in self.ops]
        if not for_test:
            p._grad_target = getattr(self, "_grad_target", None)
            p._grad_pairs = list(getattr(self, "_grad_pairs", ()))
            p._var_grads = list(getattr(self, "_var_grads", ()))
            p._optimize = self._optimize
            p._opt_state = self._opt_state
            return p
        # the test program: dropout and attention dropout run their eval
        # forms, batch norm normalises with its running statistics and
        # writes nothing (the reference clone prunes/rewires the same)
        for node in p.ops:
            _to_eval(node)
        p._buffer_writes = []
        return p

    def prune(self, targets) -> "Program":
        """Backward-slice the graph to the ops needed for `targets`
        (framework/prune.cc analogue)."""
        target_ids = set()
        for t in targets if isinstance(targets, (list, tuple)) \
                else [targets]:
            target_ids.add(t.var_id if isinstance(t, Var)
                           else self.var_by_name(t).var_id)
        kept, needed = backward_slice(self.ops, target_ids)
        p = Program()
        self._copy_meta(p)
        p.ops = [n.copy() for n in kept]
        live = set(needed) | {o for n in kept for o in n.out_ids}
        p.vars = {vid: v for vid, v in self.vars.items() if vid in live}
        p.var_names = {nm: vid for nm, vid in self.var_names.items()
                       if vid in live}
        p.feeds = [f for f in self.feeds if f in needed]
        p.params = {vid: t for vid, t in self.params.items()
                    if vid in needed}
        p.buffer_ids = {b for b in self.buffer_ids if b in needed}
        p._buffer_writes = [(b, v) for b, v in self._buffer_writes
                            if b in needed and v in live]
        gt = getattr(self, "_grad_target", None)
        if gt is not None and gt in live:
            p._grad_target = gt
            p._grad_pairs = [(pv, gv)
                             for pv, gv in getattr(self, "_grad_pairs", ())
                             if pv.var_id in live]
            for _, gv in p._grad_pairs:
                p.vars.setdefault(gv.var_id, gv)
                p.var_names.setdefault(gv.name, gv.var_id)
        p._var_grads = [
            s for s in getattr(self, "_var_grads", ())
            if all(t in live for t in s["targets"])
            and all(i in live for i in s["inputs"])]
        for s in p._var_grads:
            for gid in s["grad_vars"]:
                gv = self.vars[gid]
                p.vars.setdefault(gid, gv)
                p.var_names.setdefault(gv.name, gid)
        return p

    # -- serialization ------------------------------------------------------
    def to_bytes(self, include_params: bool = True) -> bytes:
        """Serialize: ops by name with their recorded arguments, vars as
        metadata, params (optionally) as numpy arrays, and the backward
        and optimize sections. Round-trips through from_bytes."""
        ops = []
        for n in self.ops:
            if n.op_type is None:
                raise EnforceNotMet(
                    f"op '{getattr(n.fn, '__qualname__', n.fn)}' is not a "
                    "registered op; programs with ad-hoc functions cannot "
                    "be serialized", op_type=repr(n.fn))
            ops.append((n.op_type, list(n.in_ids), _map(n.template, _enc),
                        list(n.out_ids), n.grad, list(n.writes)))
        vars_meta = {vid: (v.name, tuple(v.shape), _dtype_name(v.dtype),
                           v.kind, v.orig_shape)
                     for vid, v in self.vars.items()}
        params = {vid: (self.vars[vid].name,
                        _to_numpy(t) if include_params else None,
                        _dtype_name(t.dtype))
                  for vid, t in self.params.items()}
        grad_pairs = [(pv.var_id, gv.var_id)
                      for pv, gv in getattr(self, "_grad_pairs", ())]
        var_grads = [
            {"targets": list(s["targets"]), "inputs": list(s["inputs"]),
             "grad_vars": list(s["grad_vars"]),
             "tgrads": [None if g is None else _to_numpy(g)
                        for g in s["tgrads"]]}
            for s in getattr(self, "_var_grads", ())]
        optimize = opt_state = None
        if self._optimize is not None:
            import copy
            opt, loss_var = self._optimize
            opt2 = copy.copy(opt)
            # live parameters and accumulators stay out of the artifact;
            # the state rides opt_state below
            opt2._parameters = None
            opt2._accumulators = {}
            optimize = (pickle.dumps(opt2, protocol=4), loss_var.var_id)
            opt_state = self._optimizer_state()
        return pickle.dumps({
            "format": PROGRAM_FORMAT, "version": PROGRAM_FORMAT_VERSION,
            "vars": vars_meta, "ops": ops, "feeds": list(self.feeds),
            "params": params, "buffer_ids": sorted(self.buffer_ids),
            "buffer_writes": list(self._buffer_writes),
            "counter": self._counter, "random_seed": self.random_seed,
            "grad_target": getattr(self, "_grad_target", None),
            "grad_pairs": grad_pairs, "var_grads": var_grads,
            "optimize": optimize, "opt_state": opt_state,
        }, protocol=4)

    def _optimizer_state(self):
        """{"step": the optimizer's step count, "params": {var id: {state
        name: array}}} of the trained params, or the deserialized state
        not yet handed to the optimizer."""
        if self._opt_state is not None:
            return self._opt_state
        opt = self._optimize[0]
        out = {}
        for vid, t in self.params.items():
            st = opt._accumulators.get(id(t))
            if st:
                out[vid] = {k: _to_numpy(v) for k, v in st.items()}
        return {"step": opt._step_count, "params": out}

    @staticmethod
    def from_bytes(blob: bytes) -> "Program":
        d = pickle.loads(blob)
        if d.get("format") != PROGRAM_FORMAT:
            raise EnforceNotMet(
                "not a paddle_tpu_torch program: this blob was written by "
                "another package (the JAX package writes jax programs); "
                "load its weights instead", op_type="Program.from_bytes")
        version = int(d.get("version", 1))
        if version > PROGRAM_FORMAT_VERSION:
            raise EnforceNotMet(
                f"program format v{version} is newer than this package "
                f"reads (v{PROGRAM_FORMAT_VERSION})",
                op_type="Program.from_bytes")
        p = Program()
        for vid, (name, shape, dtype, kind, orig) in sorted(
                d["vars"].items()):
            v = Var.__new__(Var, p, name, shape, dtype, kind)
            # keep the saved id: vars are numbered as when saved
            del p.vars[v.var_id]
            del p.var_names[v.name]
            v.var_id = vid
            v.name = name
            v.orig_shape = tuple(orig) if orig is not None else tuple(shape)
            v.symbolic_dims = {i for i, s in enumerate(v.orig_shape)
                               if s is None}
            p.vars[vid] = v
            p.var_names[name] = vid
        for op_type, in_ids, template, out_ids, grad, writes in d["ops"]:
            p.ops.append(OpNode(op_type, resolve_op(op_type), list(in_ids),
                                _map(template, _dec), list(out_ids), grad,
                                writes))
        p.feeds = list(d["feeds"])
        p.buffer_ids = set(d.get("buffer_ids", ()))
        p._buffer_writes = [tuple(x) for x in d.get("buffer_writes", ())]
        for vid, (name, value, dtype) in d["params"].items():
            dt = _dtypes.convert_dtype(dtype)
            t = (torch.from_numpy(np.array(value)).to(dt)
                 if value is not None
                 else torch.zeros(p.vars[vid].shape, dtype=dt))
            if vid not in p.buffer_ids:
                t = torch.nn.Parameter(t)
            p.params[vid] = t
            p._captured[t] = vid
        p._counter = d["counter"]
        p.random_seed = d.get("random_seed")
        gt = d.get("grad_target")
        if gt is not None:
            p._grad_target = gt
        pairs = [(p.vars[a], p.vars[b]) for a, b in d.get("grad_pairs")
                 or ()]
        if pairs:
            p._grad_pairs = pairs
        if d.get("var_grads"):
            p._var_grads = [dict(s) for s in d["var_grads"]]
        opt = d.get("optimize")
        if opt is not None:
            opt_blob, loss_vid = opt
            p._optimize = (pickle.loads(opt_blob), p.vars[loss_vid])
            p._opt_state = d.get("opt_state")
        return p

    def save(self, path: str, include_params: bool = True):
        with open(path, "wb") as f:
            f.write(self.to_bytes(include_params))

    @staticmethod
    def load(path: str) -> "Program":
        with open(path, "rb") as f:
            return Program.from_bytes(f.read())


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _enc(x):
    if isinstance(x, torch.Tensor):
        return ("__tensor__", _to_numpy(x), _dtype_name(x.dtype))
    return x


def _dec(x):
    if isinstance(x, tuple) and len(x) == 3 and x[0] == "__tensor__":
        return torch.from_numpy(np.array(x[1])).to(
            _dtypes.convert_dtype(x[2]))
    return x


_EVAL_FORMS = {"dropout", "dropout2d", "dropout3d", "alpha_dropout",
               "flash_attention", "scaled_dot_product_attention",
               "batch_norm"}


def _to_eval(node: OpNode):
    """Flip a training-mode op to its eval form in place: the dropouts
    and the attention functionals with training=False (no draw), batch
    norm with its running statistics (no write), a flash-attention op
    called directly with dropout 0."""
    if getattr(node.fn, "recordable", False) and \
            _short(node.op_type) in _EVAL_FORMS:
        import inspect
        bound = inspect.signature(node.fn).bind(*node.template[0],
                                                **node.template[1])
        bound.arguments["training"] = False
        node.template = (tuple(bound.args), dict(bound.kwargs))
        node.writes = ()
    elif node.op_type == "paddle_tpu.flash_attn_fwd":
        args = list(node.template[0])
        args[5], args[6] = 0.0, None
        node.template = (tuple(args), node.template[1])


# -- guards -----------------------------------------------------------------

_default_main = Program()
_default_startup = Program()
_guard_stack: List[Tuple[Program, Program]] = []


def default_main_program() -> Program:
    if _guard_stack:
        return _guard_stack[-1][0]
    return _default_main


def default_startup_program() -> Program:
    if _guard_stack:
        return _guard_stack[-1][1]
    return _default_startup


class _Recorder(TorchFunctionMode):
    """The recording point: every torch function called inside a
    program_guard reaches the innermost guard's Program."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return default_main_program()._record(func, args, kwargs or {})


_state = threading.local()


@contextlib.contextmanager
def _inferring():
    prev = getattr(_state, "inferring", False)
    _state.inferring = True
    try:
        yield
    finally:
        _state.inferring = prev


def _recording_apply(cls, *args, **kwargs):
    """torch.autograd.Function.apply while a program_guard is active: a
    call with a Var among its arguments is one recorded op."""
    if _guard_stack and not getattr(_state, "inferring", False) and any(
            isinstance(x, Var) for x in _leaves((args, kwargs))):
        return default_main_program().add_op(FunctionApply(cls), args,
                                             kwargs)
    return _function_apply(cls, *args, **kwargs)


class program_guard:
    def __init__(self, main_program=None, startup_program=None):
        self.main = main_program if main_program is not None else Program()
        self.startup = startup_program if startup_program is not None \
            else Program()
        self._mode = None

    def __enter__(self):
        if not _guard_stack:
            torch.autograd.Function.apply = classmethod(_recording_apply)
        _guard_stack.append((self.main, self.startup))
        self._mode = _Recorder()
        self._mode.__enter__()
        return self.main, self.startup

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        _guard_stack.pop()
        if not _guard_stack:
            torch.autograd.Function.apply = classmethod(_function_apply)


def data(name, shape, dtype="float32", lod_level=0):
    """Feed placeholder (paddle.static.data)."""
    prog = default_main_program()
    v = Var(prog, name, shape, dtype, kind="feed")
    prog.feeds.append(v.var_id)
    return v


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Mark loss for gradient computation; returns (param, grad_var)
    pairs. The grads are computed at Executor.run by torch.autograd.grad
    over the replayed program (backward.py:1337 analogue)."""
    prog = loss.program if isinstance(loss, Var) else default_main_program()
    if int(np.prod(tuple(loss.shape))) != 1:
        raise EnforceNotMet(
            f"append_backward loss must be a scalar, got shape "
            f"{tuple(loss.shape)} (reference backward.py enforces "
            "loss.shape == [1])", op_type="append_backward")
    prog._grad_target = loss.var_id

    def resolve(item):
        if isinstance(item, str):
            return item
        if isinstance(item, Var):
            return item.name
        vid = prog._captured.get(item) if isinstance(
            item, torch.Tensor) else None
        return prog.vars[vid].name if vid is not None else None
    skip = {resolve(i) for i in (no_grad_set or ())} - {None}
    keep = None
    if parameter_list is not None:
        keep = {resolve(p) for p in parameter_list} - {None}
    pairs = []
    for vid, p in prog.params.items():
        if vid in prog.buffer_ids:
            continue
        name = prog.vars[vid].name
        if name in skip or (keep is not None and name not in keep):
            continue
        gv = Var(prog, f"{name}@GRAD", p.shape, p.dtype, kind="grad")
        pairs.append((prog.vars[vid], gv))
    prog._grad_pairs = pairs
    return pairs


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Static d(targets)/d(inputs) for any program vars (backward.py:1932
    `paddle.static.gradients`). Returns grad Vars (`<input>@GRAD`)
    fetchable through Executor.run; for an intermediate input the graph
    is cut there (its upstream is a constant), as the reference's."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    prog = targets[0].program
    skip = {item if isinstance(item, str) else item.name
            for item in (no_grad_set or ())}
    inputs = [v for v in inputs if v.name not in skip]
    if target_gradients is not None:
        tg = target_gradients if isinstance(target_gradients,
                                            (list, tuple)) \
            else [target_gradients]
    else:
        tg = [None] * len(targets)
    grad_vars = [Var(prog, f"{v.name}@GRAD", v.shape, v.dtype, kind="grad")
                 for v in inputs]
    spec = {"targets": [t.var_id for t in targets],
            "inputs": [v.var_id for v in inputs],
            "grad_vars": [g.var_id for g in grad_vars],
            "tgrads": [None if g is None else np.asarray(
                _to_numpy(g) if isinstance(g, torch.Tensor) else g)
                for g in tg]}
    prog._var_grads = getattr(prog, "_var_grads", [])
    prog._var_grads.append(spec)
    return grad_vars


# -- replay -----------------------------------------------------------------

def _materialize(node, env, device, consts):
    def sub(x):
        if isinstance(x, _Slot):
            return env[node.in_ids[x.i]]
        if _is_meta_device(x):
            return device if isinstance(x, torch.device) else str(device)
        if isinstance(x, torch.Tensor):
            c = consts.get(id(x))
            if c is None:
                c = consts[id(x)] = (x, x.to(device))
            return c[1]
        return x
    return _map(node.template, sub)


def replay(ops, env, device, consts=None, cut=(), need_grad=False,
           free=None):
    """Run the recorded ops over `env` (var id -> tensor) on `device`.
    Outputs whose ids are in `cut` become leaves that require grad (the
    graph is cut there: gradients() wrt an intermediate). `free[i]`: the
    var ids env lets go of after op i (their last use), so a tensor
    autograd does not keep is freed as in an eager run."""
    consts = {} if consts is None else consts
    for i, node in enumerate(ops):
        args, kwargs = _materialize(node, env, device, consts)
        with torch.set_grad_enabled(need_grad and node.grad):
            try:
                res = node.fn(*args, **kwargs)
            except Exception as e:
                raise EnforceNotMet(f"{type(e).__name__}: {e}",
                                    op_type=node.op_type or repr(node.fn)
                                    ) from e
        if _is_inplace(node.fn):
            outs = [args[0]]
        else:
            outs = _tensor_leaves(res)
        for vid, r in zip(node.out_ids, outs):
            if vid in cut:
                r = r.detach().requires_grad_(True)
            env[vid] = r
        if free is not None:
            for vid in free[i]:
                env.pop(vid, None)
    return env


def _last_uses(ops, keep):
    """free[i] for replay: the var ids whose last reader (or, unread,
    whose producer) is op i, less those in `keep`."""
    last = {}
    for i, node in enumerate(ops):
        for vid in node.out_ids:
            last[vid] = i
        for vid in node.in_ids:
            last[vid] = i
    free = [[] for _ in ops]
    for vid, i in last.items():
        if vid not in keep:
            free[i].append(vid)
    return free


class _Plan:
    """What one (program, fetches, feed signature) runs."""

    def __init__(self, prog, fetch_ids, train):
        self.fetch_ids = fetch_ids
        self.train = train
        fetch = set(fetch_ids)
        self.param_ids = [vid for vid in prog.params
                          if vid not in prog.buffer_ids]
        pairs = getattr(prog, "_grad_pairs", ()) or ()
        self.grad_map = {pv.var_id: gv.var_id for pv, gv in pairs}
        want_pairs = any(g in fetch for g in self.grad_map.values())
        self.grad_target = (prog._optimize[1].var_id if train else
                            getattr(prog, "_grad_target", None))
        self.param_grads = train or (want_pairs
                                     and self.grad_target is not None)
        self.var_grads = [s for s in getattr(prog, "_var_grads", ()) or ()
                          if any(g in fetch for g in s["grad_vars"])]
        keep = fetch | set(prog.feeds) | set(prog.params)
        keep |= {v for _, v in prog._buffer_writes}
        if self.grad_target is not None:
            keep.add(self.grad_target)
        self.free = _last_uses(prog.ops, keep)


class Executor:
    """Feed/fetch runner (executor.py:475 analogue): on the card one
    CUDA graph per feed signature, on the CPU an eager replay."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache: Dict[Any, Any] = {}
        self._consts: Dict[int, Any] = {}
        self.captures = 0
        self.replays = 0
        self.last_launches = None

    def _fetch_ids(self, prog, fetch_list):
        ids = []
        for f in fetch_list:
            if isinstance(f, Var):
                ids.append(f.var_id)
            elif isinstance(f, str):
                ids.append(prog.var_by_name(f).var_id)
            else:
                raise NotFoundError(f"bad fetch entry {f!r}")
        computable = set(prog.feeds) | set(prog.params)
        for node in prog.ops:
            computable.update(node.out_ids)
        train = prog._optimize is not None
        if train or getattr(prog, "_grad_target", None) is not None:
            computable.update(gv.var_id for _, gv in
                              getattr(prog, "_grad_pairs", ()) or ())
        for s in getattr(prog, "_var_grads", ()) or ():
            computable.update(s["grad_vars"])
        for fid in ids:
            if fid not in computable:
                v = prog.vars.get(fid)
                name = getattr(v, "name", None) or f"<id {fid}>"
                kind = getattr(v, "kind", "?")
                hint = ""
                if kind == "grad":
                    hint = ("; this is a grad var but the program has no "
                            "active backward section (append_backward/"
                            "gradients bookkeeping absent)")
                raise NotFoundError(
                    f"fetch var '{name}' (id {fid}, kind={kind}) is not "
                    f"producible by this program: it is not a feed, "
                    f"captured parameter, or output of any of its "
                    f"{len(prog.ops)} ops{hint}", op_type="fetch")
        return ids

    def _place_params(self, prog):
        """Move a program's captured tensors to this Executor's device
        (a deserialized program's are on the CPU) and hand its saved
        optimizer state to its optimizer."""
        dev = self.device
        for vid, t in list(prog.params.items()):
            if t.device != dev:
                with torch.no_grad():
                    nt = t.detach().to(dev)
                    if isinstance(t, torch.nn.Parameter):
                        nt = torch.nn.Parameter(nt, t.requires_grad)
                prog.params[vid] = nt
                prog._captured[nt] = vid
        if prog._optimize is not None and prog._opt_state is not None:
            opt = prog._optimize[0]
            st = prog._opt_state
            opt._step_count = int(st.get("step", 0))
            for vid, states in st.get("params", {}).items():
                t = prog.params[vid]
                opt._accumulators[id(t)] = {
                    k: torch.from_numpy(np.array(v)).to(dev)
                    for k, v in states.items()}
            prog._opt_state = None

    def _body(self, prog, plan, feeds, slots, lr):
        env = dict(zip(prog.feeds, feeds))
        env.update(prog.params)
        cut = set()
        with seed_scope(Draw((), slots)):
            replay(prog.ops, env, self.device, self._consts,
                   need_grad=plan.param_grads, free=plan.free)
            grads = None
            if plan.param_grads:
                ps = [prog.params[v] for v in plan.param_ids]
                loss = env[plan.grad_target].float().sum()
                got = torch.autograd.grad(loss, ps, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(ps, got)]
                for vid, g in zip(plan.param_ids, grads):
                    if vid in plan.grad_map:
                        env[plan.grad_map[vid]] = g
            for spec in plan.var_grads:
                cut = set(spec["inputs"])
                e = dict(zip(prog.feeds, feeds))
                e.update(prog.params)
                for vid in cut:
                    if vid in e:
                        e[vid] = e[vid].detach().requires_grad_(True)
                replay(prog.ops, e, self.device, self._consts, cut=cut,
                       need_grad=True)
                total = None
                for tid, tg in zip(spec["targets"], spec["tgrads"]):
                    tv = e[tid].float()
                    part = tv.sum() if tg is None else (
                        tv * torch.as_tensor(tg, device=tv.device)).sum()
                    total = part if total is None else total + part
                xs = [e[i] for i in spec["inputs"]]
                gs = torch.autograd.grad(total, xs, allow_unused=True)
                for gid, g, x in zip(spec["grad_vars"], gs, xs):
                    env[gid] = torch.zeros_like(x) if g is None else g
            if plan.train:
                opt = prog._optimize[0]
                opt.apply_gradients(
                    [prog.params[v] for v in plan.param_ids], grads, lr=lr)
        return [env.get(i) for i in plan.fetch_ids]

    def _feeds(self, prog, feed):
        out = []
        for vid in prog.feeds:
            nm = prog.vars[vid].name
            if nm not in feed:
                raise NotFoundError(f"missing feed '{nm}'")
            v = feed[nm]
            t = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
            out.append(t.to(self.device))
        return out

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, seed=None):
        """Run the program once: the feeds by data() name, the fetches
        as Vars or names. `seed` pins the run's dropout seed (a new one
        from the device's stream when None)."""
        return self._run(program, feed, fetch_list, return_numpy, seed,
                         eager=False)

    def eager_run(self, program=None, feed=None, fetch_list=None,
                  return_numpy=True, seed=None):
        """The run without a CUDA graph: the replay a captured run is
        held against (on the CPU every run is this)."""
        return self._run(program, feed, fetch_list, return_numpy, seed,
                         eager=True)

    def _run(self, program, feed, fetch_list, return_numpy, seed, eager):
        from ..ops import flash_attention as _fa
        prog = program if program is not None else default_main_program()
        feed = feed or {}
        fetch_list = fetch_list or []
        if not prog.ops and not prog.params:
            return []
        fetch_ids = self._fetch_ids(prog, fetch_list)
        self._place_params(prog)
        train = prog._optimize is not None
        feeds = self._feeds(prog, feed)
        dev = self.device
        run_seed = next_seed(dev) if seed is None else int(seed)
        lr_value = prog._optimize[0].get_lr() if train else 0.0
        if dev.type != "cuda" or eager:
            plan = _Plan(prog, fetch_ids, train)
            lr = host_tensor(lr_value, torch.float32, dev) if train else None
            before = dict(_fa.launches)
            out = self._body(prog, plan, feeds,
                             SeedSlots(dev).record(run_seed), lr)
            self.last_launches = {k: _fa.launches[k] - before[k]
                                  for k in before}
            return _outputs(out, return_numpy)
        sig = (id(prog), len(prog.ops), train, tuple(fetch_ids)) + tuple(
            (tuple(t.shape), t.dtype) for t in feeds)
        entry = self._cache.get(sig)
        if entry is None:
            entry = self._capture(prog, fetch_ids, train, feeds, run_seed,
                                  lr_value)
            self._cache[sig] = entry
            return _outputs(entry.first, return_numpy)
        entry.inputs.fill(feeds)
        entry.slots.fill(run_seed)
        if train:
            entry.lr.fill_(lr_value)
        entry.graph.replay()
        if train:
            prog._optimize[0]._step_count += 1
        self.replays += 1
        from .capture import clone_outputs
        return _outputs(clone_outputs(entry.out), return_numpy)

    def _capture(self, prog, fetch_ids, train, feeds, run_seed, lr_value):
        from ..ops import flash_attention as _fa
        from .capture import StaticInputs, capture, warm_up
        dev = self.device
        entry = _Captured()
        plan = _Plan(prog, fetch_ids, train)
        entry.inputs = StaticInputs(feeds, dev)
        entry.slots = SeedSlots(dev).record(run_seed)
        entry.lr = host_tensor(lr_value, torch.float32, dev)

        def body():
            return self._body(prog, plan, entry.inputs.tree, entry.slots,
                              entry.lr)
        before = dict(_fa.launches)
        entry.first = warm_up(body, dev)
        self.last_launches = {k: _fa.launches[k] - before[k]
                              for k in before}
        entry.slots.freeze()
        opt = prog._optimize[0] if train else None
        steps = opt._step_count if train else None
        entry.graph, entry.out = capture(body, dev,
                                         entry.slots.generators.values(),
                                         program="executor")
        if train:
            opt._step_count = steps
        self.captures += 1
        return entry

    @property
    def programs(self) -> int:
        return len(self._cache)

    def close(self):
        self._cache.clear()
        self._consts.clear()


class _Captured:
    pass


def _outputs(out, return_numpy):
    if not return_numpy:
        return [None if f is None else f.detach() for f in out]
    return [None if f is None else _to_numpy(f) for f in out]

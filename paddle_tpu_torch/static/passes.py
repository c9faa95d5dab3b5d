"""Program passes (counterpart of paddle_tpu/static/passes.py, the
reference's framework/ir/pass.h concept): the registry, Pass and
PassBuilder, and the passes that shrink a recorded graph before it runs,
over the port's op names (static/program.py: torch functions by
torch.overrides name, port functions by module and name):

- constant_folding_pass: ops whose every input is a literal run once at
  pass time, and their consumers read the result as a literal; with
  freeze_buffers=True the captured buffers no op writes count as
  literals (the inference scenario: later changes to them no longer
  reach the program);
- cse_pass: an op equal to an earlier one (same op, inputs, attributes)
  is dropped and its consumers read the earlier one's outputs;
- identity_elimination_pass: multiplying by 1, adding or subtracting 0,
  dividing by 1, a reshape or view to the same shape and an eval-mode
  dropout drop out, their consumers reading the input;
- dead_code_elimination_pass(targets): the backward slice to the ops
  the targets need (Program.prune's liveness, in place).

Every pass returns a new Program and leaves its input as it was. Ops
that draw random numbers or write state are never folded or merged, and
the vars the backward, optimize and buffer-write bookkeeping name keep
their producers. The two quant passes of the JAX package need `quant`'s
QAT rewrite, which the port does not have yet: they raise (ROADMAP.md
queue A item 18.6).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from .program import (_Slot, _leaves, _map, _materialize, _short,
                      backward_slice)

__all__ = ["Pass", "PASS_REGISTRY", "register_pass", "apply_pass",
           "PassBuilder"]

PASS_REGISTRY: Dict[str, Callable] = {}


def register_pass(name: str):
    def deco(fn):
        PASS_REGISTRY[name] = fn
        fn.pass_name = name
        return fn
    return deco


def apply_pass(program, names, **kwargs):
    """Run one pass (a name) or a sequence of them over `program`;
    returns the transformed copy (ir.apply_pass analogue)."""
    if isinstance(names, str):
        names = [names]
    p = program
    for n in names:
        if n not in PASS_REGISTRY:
            raise KeyError(f"unknown pass '{n}' (registered: "
                           f"{sorted(PASS_REGISTRY)})")
        p = PASS_REGISTRY[n](p, **kwargs)
    return p


class Pass:
    """Subclassable form (reference ir::Pass): set name, override
    apply(program) -> program. Defining the subclass registers it."""

    name: str = ""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.name:
            PASS_REGISTRY[cls.name] = lambda prog, _c=cls, **k: \
                _c().apply(prog, **k)

    def apply(self, program, **kwargs):
        raise NotImplementedError


class PassBuilder:
    """An ordered pass pipeline (details/build_strategy's pass builder):
    append, insert and remove passes, then apply_all."""

    def __init__(self, passes: Optional[Sequence[str]] = None):
        self._passes: List[str] = list(passes or [])

    def append_pass(self, name: str):
        if name not in PASS_REGISTRY:
            raise KeyError(f"unknown pass '{name}'")
        self._passes.append(name)
        return self

    def insert_pass(self, idx: int, name: str):
        if name not in PASS_REGISTRY:
            raise KeyError(f"unknown pass '{name}'")
        self._passes.insert(idx, name)
        return self

    def remove_pass(self, name: str):
        self._passes = [p for p in self._passes if p != name]
        return self

    def all_passes(self) -> List[str]:
        return list(self._passes)

    def apply_all(self, program, **kwargs):
        return apply_pass(program, self._passes, **kwargs)


# -- helpers ----------------------------------------------------------------

def _target_ids(prog, targets) -> set:
    """Vars or names to keep producible (an eliminated var's fetch fails
    loudly in the Executor, never silently)."""
    return {t.var_id if hasattr(t, "var_id") else prog.var_by_name(t).var_id
            for t in (targets or ())}


def _protected_ids(prog) -> set:
    """Var ids a pass must keep producible: buffer writes, the grad
    bookkeeping, the optimizer's loss."""
    keep = {v for _, v in prog._buffer_writes}
    keep |= {b for b, _ in prog._buffer_writes}
    gt = getattr(prog, "_grad_target", None)
    if gt is not None:
        keep.add(gt)
    for _, gv in getattr(prog, "_grad_pairs", ()) or ():
        keep.add(gv.var_id)
    for s in getattr(prog, "_var_grads", ()) or ():
        keep.update(s.get("targets", ()))
        keep.update(s.get("inputs", ()))
        keep.update(s.get("grad_vars", ()))
    if prog._optimize is not None:
        keep.add(prog._optimize[1].var_id)
    return keep


def _rewire(node, mapping: Dict[int, int]):
    node.in_ids = [mapping.get(i, i) for i in node.in_ids]


def _rewire_const(node, folded: Dict[int, object]):
    """Turn the inputs in `folded` into literals of the node's call."""
    if not any(i in folded for i in node.in_ids):
        return
    old = list(node.in_ids)
    keep: List[int] = []
    renum = {}
    for k, vid in enumerate(old):
        if vid not in folded:
            renum[k] = len(keep)
            keep.append(vid)

    def sub(x):
        if isinstance(x, _Slot):
            if old[x.i] in folded:
                return folded[old[x.i]]
            return _Slot(renum[x.i])
        return x
    node.template = _map(node.template, sub)
    node.in_ids = keep


def _digest(c):
    if isinstance(c, _Slot):
        return ("slot", c.i)
    if isinstance(c, torch.Tensor):
        if c.numel() > 4096:          # no hashing of big literals
            return ("<big>", id(c))
        arr = c.detach().cpu()
        return ("tensor", str(arr.dtype), tuple(arr.shape),
                arr.float().numpy().tobytes() if arr.is_floating_point()
                else arr.numpy().tobytes())
    if isinstance(c, (list, tuple)):
        return (type(c).__name__,) + tuple(_digest(x) for x in c)
    if isinstance(c, dict):
        return ("dict",) + tuple(sorted((k, _digest(v))
                                        for k, v in c.items()))
    try:
        hash(c)
        # tag the python type: 2, 2.0 and True hash equal but promote
        # differently
        return ("lit", type(c).__name__, c)
    except TypeError:
        return ("<unhash>", id(c))


# random draws and state writes: never folded or merged
_RANDOM = {"rand", "randn", "randint", "rand_like", "randn_like",
           "randint_like", "bernoulli", "bernoulli_", "multinomial",
           "normal", "normal_", "uniform_", "randperm", "exponential_",
           "geometric_", "cauchy_", "log_normal_", "random_"}
_RECORDABLE_IMPURE = {"dropout", "dropout2d", "dropout3d", "alpha_dropout",
                      "flash_attention", "scaled_dot_product_attention",
                      "batch_norm"}


def _impure(node):
    short = _short(node.op_type)
    if node.writes or short in _RANDOM:
        return True
    if getattr(node.fn, "recordable", False) and \
            short in _RECORDABLE_IMPURE:
        return True
    return short.endswith("_") and not short.startswith("_")


# -- the passes ---------------------------------------------------------------

@register_pass("constant_folding_pass")
def constant_folding_pass(prog, freeze_buffers=False, targets=None, **_):
    """Run ops whose every input is a literal once, now; consumers get
    the result as a literal. freeze_buffers=True also takes the captured
    buffers no op writes as literals (their values now are baked in:
    never use it on a training program)."""
    p = prog.clone()
    folded: Dict[int, object] = {}
    if freeze_buffers:
        written = {b for b, _ in p._buffer_writes}
        for vid in p.buffer_ids:
            if vid not in written and vid in p.params:
                folded[vid] = p.params[vid].detach()
    protected = _protected_ids(p) | _target_ids(p, targets)
    kept = []
    for node in p.ops:
        _rewire_const(node, folded)
        if _impure(node) or node.in_ids or \
                any(o in protected for o in node.out_ids):
            kept.append(node)
            continue
        dev = next((t.device for t in _literal_tensors(node)),
                   torch.device("cpu"))
        args, kwargs = _materialize(node, {}, dev, {})
        with torch.no_grad():
            res = node.fn(*args, **kwargs)
        outs = [x for x in _leaves(res) if isinstance(x, torch.Tensor)]
        for vid, r in zip(node.out_ids, outs):
            folded[vid] = r
    p.ops = kept
    return p


def _literal_tensors(node):
    return [x for x in _leaves(node.template) if isinstance(x, torch.Tensor)]


@register_pass("cse_pass")
def cse_pass(prog, targets=None, **_):
    """Drop an op equal to an earlier one; its consumers read the
    earlier one's outputs. Protected vars and `targets` keep their
    producers."""
    p = prog.clone()
    protected = _protected_ids(p) | _target_ids(p, targets)
    seen: Dict[tuple, List[int]] = {}
    mapping: Dict[int, int] = {}
    kept = []
    for node in p.ops:
        _rewire(node, mapping)
        if _impure(node) or any(o in protected for o in node.out_ids):
            kept.append(node)
            continue
        key = (node.op_type or id(node.fn), tuple(node.in_ids),
               _digest(node.template), node.grad)
        prev = seen.get(key)
        if prev is None:
            seen[key] = node.out_ids
            kept.append(node)
        else:
            for old, new in zip(node.out_ids, prev):
                mapping[old] = new
    p.ops = kept
    return p


def _scalar_arg(node):
    """The op's second argument when it is a Python number."""
    args = node.template[0]
    if len(args) == 2 and isinstance(args[1], (int, float)) and \
            not isinstance(args[1], bool) and not node.template[1]:
        return args[1]
    return None


def _same_var(prog, node):
    src = prog.vars.get(node.in_ids[0]) if node.in_ids else None
    out = prog.vars.get(node.out_ids[0])
    return (src is not None and out is not None
            and tuple(src.shape) == tuple(out.shape)
            and src.dtype == out.dtype)


def _first_is_input(node):
    args = node.template[0]
    return bool(args) and isinstance(args[0], _Slot) and args[0].i == 0


def _ident_arith(node, prog):
    neutral = {"__mul__": 1, "mul": 1, "multiply": 1, "__rmul__": 1,
               "__truediv__": 1, "div": 1, "divide": 1, "__add__": 0,
               "add": 0, "__radd__": 0, "__sub__": 0, "sub": 0,
               "subtract": 0}
    want = neutral.get(_short(node.op_type))
    v = _scalar_arg(node)
    if want is None or v is None or v != want:
        return None
    return 0 if _first_is_input(node) and _same_var(prog, node) else None


def _ident_reshape(node, prog):
    return 0 if _first_is_input(node) and _same_var(prog, node) else None


def _ident_dropout(node, prog):
    """An eval-mode (or p 0) dropout in upscale mode is the identity."""
    import inspect
    bound = inspect.signature(node.fn).bind(*node.template[0],
                                            **node.template[1])
    bound.apply_defaults()
    a = bound.arguments
    if not isinstance(a.get("x"), _Slot):
        return None
    if a.get("mode", "upscale_in_train") == "downscale_in_infer" \
            and a.get("p", 0.5) != 0:
        return None
    if a.get("training", True) and a.get("p", 0.5) != 0:
        return None
    return a["x"].i


_IDENTITY = {"reshape": _ident_reshape, "view": _ident_reshape,
             "dropout": _ident_dropout}


@register_pass("identity_elimination_pass")
def identity_elimination_pass(prog, targets=None, **_):
    """Drop no-op arithmetic (x * 1, x + 0, x - 0, x / 1), same-shape
    reshapes and views, and eval-mode dropout; consumers read the
    input."""
    p = prog.clone()
    mapping: Dict[int, int] = {}
    protected = _protected_ids(p) | _target_ids(p, targets)
    kept = []
    for node in p.ops:
        _rewire(node, mapping)
        det = _IDENTITY.get(_short(node.op_type), _ident_arith)
        slot = det(node, p) if node.op_type and len(node.out_ids) == 1 \
            else None
        if slot is None or node.out_ids[0] in protected:
            kept.append(node)
            continue
        mapping[node.out_ids[0]] = node.in_ids[slot]
    p.ops = kept
    return p


@register_pass("quantization_transform_pass")
def quantization_transform_pass(prog, **_):
    raise NotImplementedError(
        "quantization_transform_pass: the QAT rewrite (quant's "
        "QuantizationTransformPass) is not ported yet (ROADMAP.md queue A "
        "item 18.6)")


@register_pass("quantization_freeze_pass")
def quantization_freeze_pass(prog, **_):
    raise NotImplementedError(
        "quantization_freeze_pass: the int8 freeze (quant's "
        "QuantizationFreezePass) is not ported yet (ROADMAP.md queue A "
        "item 18.6)")


@register_pass("dead_code_elimination_pass")
def dead_code_elimination_pass(prog, targets=None, **_):
    """Keep only the ops that `targets` and the protected state (buffer
    writes, grad bookkeeping, the optimizer's loss) need; Program.prune's
    liveness (backward_slice)."""
    p = prog.clone()
    needed = _protected_ids(p) | _target_ids(p, targets)
    if not needed:
        return p
    p.ops, _ = backward_slice(p.ops, needed)
    return p

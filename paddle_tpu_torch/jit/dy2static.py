"""dy2static: AST-level conversion of Python control flow (counterpart of
paddle_tpu/jit/dy2static.py; the reference's dygraph_to_static
transformer stack: ifelse_transformer.py, loop_transformer.py,
logical_transformer.py, break_continue_transformer.py,
return_transformer.py).

The AST transformer is the JAX package's, pure Python, unchanged: tensor
`if`/`while`/`for`, `and`/`or`/`not` in predicates, and `break` /
`continue` / early `return` through guard flags become calls to the
`jst` runtime below. The runtime is the port's. A predicate is "traced"
(its value cannot be read on the host) when it is a card tensor while a
CUDA-graph capture records (ops/control_flow.py `_capturing`), or a Var
of a Program being recorded (static/program.py). Then:
- `ifelse` goes to ops/control_flow.py `cond`: both branches run and
  torch.where selects (under a Program recording through
  `static_branches()`, so the select is recorded);
- `while_` goes to `while_loop`: under a capture a conditional WHILE
  node of the graph (csrc/graph_while.cu), the trip count decided on the
  card at each replay; a Program cannot record one and raises;
- `for_range` over traced bounds runs as a `while_`.
Otherwise every helper is Python control flow on `bool(tensor)` (a host
read), which is what an eager call, and the warm-up run before a
capture, do.

Supported rewrites:
  - `if`/`elif`/`else` over tensor predicates (assignment merging; both-
    branch returns)
  - `while` over tensor conditions
  - `for i in range(...)` with tensor bounds; `for x in <Tensor>` row
    iteration
  - `and`/`or`/`not` inside converted predicates (lazy logical helpers)
  - `break` / `continue` / early `return` via the guard-flag technique:
    a pre-pass rewrites them into boolean flags, guards the trailing
    statements, folds the flags into loop conditions, and appends one
    final `return`; the flag-form loops then convert like any other.
Restrictions (clear errors, the reference's documented limits):
  - vars assigned under traced control flow should exist beforehand
  - a traced early `return` must be matched (both if-branches return, or
    the fall-through path also returns)
  - `break` inside `for x in <iterable>` (non-range) keeps Python
    semantics (eager only)
  - set_max_while_iters(n) turns a traced `while` into the
    differentiable bounded_while_loop of n iterations
"""
from __future__ import annotations

import ast
import contextlib
import functools
import inspect
import textwrap
import warnings
from typing import Any, Callable, Dict, List, Set

import torch

from ..ops import control_flow as _cf

Tensor = torch.Tensor

__all__ = ["convert_function", "ConversionError", "jst"]


class ConversionError(Exception):
    pass


class _Undef:
    """Sentinel for a name unbound before tensor control flow. Any actual
    USE raises, mirroring Python's UnboundLocalError instead of letting
    the sentinel leak into downstream computation."""
    __slots__ = ()

    def __repr__(self):
        return "<pd-undefined>"

    def _raise(self, *a, **k):
        raise UnboundLocalError(
            "variable assigned only inside a conditional branch was used "
            "before assignment (dy2static)")

    __getattr__ = __bool__ = __add__ = __radd__ = __sub__ = __rsub__ = \
        __mul__ = __rmul__ = __truediv__ = __rtruediv__ = __lt__ = \
        __gt__ = __le__ = __ge__ = __call__ = __getitem__ = __iter__ = \
        __neg__ = _raise


UNDEF = _Undef()

# when set, converted tensor-dependent `while` loops run as the
# differentiable bounded_while_loop of this many iterations instead of
# while_loop (which has no reverse mode), as in the JAX package
_max_while_iters = None


def set_max_while_iters(n):
    """Enable differentiable converted `while` loops, bounded at n
    iterations (iterations past the dynamic exit are masked out; loops
    that would genuinely run longer than n are truncated). Pass None to
    restore the unbounded forward-only while_loop."""
    global _max_while_iters
    _max_while_iters = None if n is None else int(n)


import contextlib as _contextlib


@_contextlib.contextmanager
def max_while_iters_guard(n):
    global _max_while_iters
    old = _max_while_iters
    _max_while_iters = None if n is None else int(n)
    try:
        yield
    finally:
        _max_while_iters = old


def _recording(x):
    from ..static.program import Var
    return isinstance(x, Var)


def _is_traced(x):
    """True when x's value cannot be read on the host: a Var of a Program
    being recorded, or a card tensor while a CUDA graph captures."""
    if not isinstance(x, Tensor):
        return False
    if _recording(x):
        return True
    return x.device.type == "cuda" and _cf._capturing()


def _value(x):
    return bool(x.item() if isinstance(x, Tensor) else x)


# ---------------------------------------------------------------------------
# runtime helpers (the convert_operators.py analogue) — generated code
# calls these through the `_jst` module alias injected into globals
# ---------------------------------------------------------------------------

class jst:
    UNDEF = UNDEF

    @staticmethod
    def _check_defined(vals, names, what):
        for v, n in zip(vals, names):
            if v is UNDEF:
                raise ConversionError(
                    f"variable '{n}' is assigned inside a tensor-"
                    f"dependent {what} but not defined before it; "
                    "initialize it first (dy2static restriction)")

    @staticmethod
    def ifelse(pred, true_fn, false_fn, init_vals, names):
        if not _is_traced(pred):
            p = _value(pred)
            return tuple(true_fn(*init_vals) if p
                         else false_fn(*init_vals))
        # traced: UNDEF slots may not cross the select; both branches
        # must assign them (checked by the original code's own semantics)
        defined_idx = [i for i, v in enumerate(init_vals)
                       if v is not UNDEF]

        def wrap(fn):
            def pure(*defined):
                full = list(init_vals)
                for i, v in zip(defined_idx, defined):
                    full[i] = v
                out = fn(*full)
                jst._check_defined(out, names, "if")
                return tuple(out)
            return pure
        operands = tuple(init_vals[i] for i in defined_idx)
        selecting = _cf.static_branches() if _recording(pred) else \
            contextlib.nullcontext()
        with selecting:
            out = _cf.cond(pred, wrap(true_fn), wrap(false_fn),
                           operands=operands)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)

    @staticmethod
    def while_(cond_fn, body_fn, init_vals, names):
        vals = tuple(init_vals)
        cur = cond_fn(*vals)
        while not _is_traced(cur):
            if not _value(cur):
                return vals
            vals = tuple(body_fn(*vals))
            cur = cond_fn(*vals)
        # the condition is (or became: a traced break-flag merged into
        # the carry mid-unroll) traced: hand the remainder to the device
        # loop from the current values
        init_vals = vals
        jst._check_defined(init_vals, names, "while")
        if _recording(cur) and _max_while_iters is None:
            raise ConversionError(
                "a tensor-dependent while cannot be recorded into a "
                "Program (the port's while_loop is a CUDA-graph WHILE "
                "node); bound it with jit.set_max_while_iters(n)")
        if _max_while_iters is not None:
            # differentiable bounded form (masked scan) — needed whenever
            # the converted loop sits under backward(); see
            # set_max_while_iters
            out = _cf.bounded_while_loop(
                cond_fn, lambda *vs: tuple(body_fn(*vs)),
                list(init_vals), _max_while_iters)
            return tuple(out)
        out = _cf.while_loop(cond_fn, lambda *vs: tuple(body_fn(*vs)),
                             list(init_vals))
        return tuple(out)

    @staticmethod
    def for_range(start, stop, step, body_fn, init_vals, names):
        traced = any(_is_traced(v) for v in (start, stop, step))
        if not traced:
            vals = tuple(init_vals)
            s, e, st = (int(v.item() if isinstance(v, Tensor) else v)
                        for v in (start, stop, step))
            for i in range(s, e, st):
                vals = tuple(body_fn(i, *vals))
            return vals
        jst._check_defined(init_vals, names, "for")
        # tensor bounds: a while over the index
        dev = next(v.device for v in (start, stop, step)
                   if isinstance(v, Tensor))
        i0 = start if isinstance(start, Tensor) else torch.tensor(
            start, device=dev)

        def cond_fn(i, *vs):
            # the direction follows the (possibly traced) step's sign
            s = torch.as_tensor(step, device=dev)
            return torch.where(s > 0, i < stop, i > stop)

        def body(i, *vs):
            out = body_fn(i, *vs)
            return (i + step,) + tuple(out)
        out = _cf.while_loop(cond_fn, body, [i0] + list(init_vals))
        return tuple(out[1:])

    @staticmethod
    def for_iter(seq, body_fn, init_vals, names):
        if isinstance(seq, Tensor) and seq.ndim > 0:
            n = seq.shape[0]
            vals = tuple(init_vals)
            for i in range(int(n)):   # static length: unrolled trace
                vals = tuple(body_fn(seq[i], *vals))
            return vals
        vals = tuple(init_vals)
        for item in seq:
            vals = tuple(body_fn(item, *vals))
        return vals

    @staticmethod
    def final_ret(rf, rv):
        """Function epilogue for flag-form returns: falls through to
        Python's implicit None when no return fired (eager); traced, the
        merged return value is authoritative (a traced function that may
        not return has no consistent output structure anyway)."""
        if _is_traced(rf):
            return rv
        if not _value(rf):
            return None
        return rv

    @staticmethod
    def and_(lhs, rhs_fn):
        if isinstance(lhs, Tensor):
            return torch.logical_and(lhs, torch.as_tensor(
                rhs_fn(), device=lhs.device))
        return lhs and rhs_fn()

    @staticmethod
    def or_(lhs, rhs_fn):
        if isinstance(lhs, Tensor):
            return torch.logical_or(lhs, torch.as_tensor(
                rhs_fn(), device=lhs.device))
        return lhs or rhs_fn()

    @staticmethod
    def not_(x):
        if isinstance(x, Tensor):
            return torch.logical_not(x)
        return not x


# ---------------------------------------------------------------------------
# AST analysis helpers
# ---------------------------------------------------------------------------

def _assigned_names(stmts: List[ast.stmt]) -> Set[str]:
    """Names bound by simple assignments/aug-assigns/for-targets within
    the statement list (not descending into nested defs)."""
    names: Set[str] = set()

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            # don't descend. Helper defs generated by this transformer
            # (__pd_true_*, __pd_body_*...) are re-created inside each
            # branch/body where they're used, so they must never become
            # cond/while operands; user-level conditional `def`s
            # remain merged stores (eager path rebinds them; traced path
            # errors as before — functions can't cross cond boundaries)
            if not node.name.startswith("__pd_"):
                names.add(node.name)

        def visit_Lambda(self, node):  # lambda params aren't assignments
            pass

        # comprehension targets are scoped to the comprehension in py3 —
        # they are NOT branch-assigned variables
        def visit_ListComp(self, node):
            pass

        visit_SetComp = visit_DictComp = visit_GeneratorExp = \
            visit_ListComp

        def visit_Name(self, node):
            # __pd_* names are bound by this transformer itself (init
            # captures, helper defs of already-converted inner control
            # flow); they never need to cross an outer cond/while
            if isinstance(node.ctx, (ast.Store,)) and \
                    not node.id.startswith("__pd_"):
                names.add(node.id)

    v = V()
    for s in stmts:
        v.visit(s)
    return names


def _contains(stmts, types) -> bool:
    class V(ast.NodeVisitor):
        found = False

        def visit_FunctionDef(self, node):
            pass

        def generic_visit(self, node):
            if isinstance(node, types):
                self.found = True
            super().generic_visit(node)
    v = V()
    for s in stmts:
        v.visit(s)
    return v.found


def _names_tuple(names):
    return ast.Tuple(
        elts=[ast.Name(id=n, ctx=ast.Store()) for n in names],
        ctx=ast.Store())


def _names_load_tuple(names):
    return ast.Tuple(
        elts=[ast.Name(id=n, ctx=ast.Load()) for n in names],
        ctx=ast.Load())


def _jst_attr(name):
    return ast.Attribute(value=ast.Name(id="_jst", ctx=ast.Load()),
                         attr=name, ctx=ast.Load())


def _init_stmts(names, uid):
    """try/except preamble capturing possibly-unbound initial values."""
    out = []
    for k, n in enumerate(names):
        out.append(ast.Try(
            body=[ast.Assign(
                targets=[ast.Name(id=f"__pd_i{uid}_{k}",
                                  ctx=ast.Store())],
                value=ast.Name(id=n, ctx=ast.Load()))],
            handlers=[ast.ExceptHandler(
                type=ast.Tuple(elts=[
                    ast.Name(id="NameError", ctx=ast.Load()),
                    ast.Name(id="UnboundLocalError", ctx=ast.Load())],
                    ctx=ast.Load()),
                name=None,
                body=[ast.Assign(
                    targets=[ast.Name(id=f"__pd_i{uid}_{k}",
                                      ctx=ast.Store())],
                    value=_jst_attr("UNDEF"))])],
            orelse=[], finalbody=[]))
    return out


def _init_load_tuple(names, uid):
    return ast.Tuple(
        elts=[ast.Name(id=f"__pd_i{uid}_{k}", ctx=ast.Load())
              for k in range(len(names))], ctx=ast.Load())


RET_F = "_pde_rf"
RET_V = "_pde_rv"


def _exit_kinds_at_level(stmts) -> Set[str]:
    """Which of {break, continue} occur at THIS loop level (not inside
    nested loops/functions) and whether any `return` occurs anywhere
    below (returns propagate through nested loops)."""
    found: Set[str] = set()

    class R(ast.NodeVisitor):
        def visit_FunctionDef(self, n):
            pass
        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, n):
            pass

        def visit_Return(self, n):
            found.add("return")

    class V(R):
        def visit_While(self, n):
            r = R()
            for s in n.body + n.orelse:
                r.visit(s)
        visit_For = visit_While

        def visit_Break(self, n):
            found.add("break")

        def visit_Continue(self, n):
            found.add("continue")

    v = V()
    for s in stmts:
        v.visit(s)
    return found


def _always_returns(stmts) -> bool:
    """Every control path through `stmts` ends in `return`."""
    for s in stmts:
        if isinstance(s, ast.Return):
            return True
        if isinstance(s, ast.If) and s.orelse \
                and _always_returns(s.body) and _always_returns(s.orelse):
            return True
    return False


def _assign_const(name, value):
    return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                      value=ast.Constant(value=value))


def _assign_expr(name, expr):
    return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                      value=expr)


def _not_or(flags: List[str]):
    """`not (f1 or f2 or ...)` — converted lazily by _BoolOpInPred when
    it lands in a tensor-if predicate."""
    if len(flags) == 1:
        inner = ast.Name(id=flags[0], ctx=ast.Load())
    else:
        inner = ast.BoolOp(op=ast.Or(), values=[
            ast.Name(id=f, ctx=ast.Load()) for f in flags])
    return ast.UnaryOp(op=ast.Not(), operand=inner)


class _EarlyExit:
    """Pre-pass: rewrite break/continue/early-return into guard flags
    (reference break_continue_transformer.py / return_transformer.py),
    producing flag-form loops/ifs the main _Transformer converts."""

    def __init__(self):
        self.uid = 0
        self.flagify_returns = False

    def run(self, fdef):
        kinds_all = _exit_kinds_at_level(fdef.body)
        nested_ret = self._has_nested_return(fdef.body)
        loops_exit = self._any_loop_needs_flags(fdef.body)
        if not nested_ret and not loops_exit:
            return
        self.flagify_returns = nested_ret
        body = self.block(fdef.body, None, None)
        if nested_ret:
            epilogue = ast.Return(value=ast.Call(
                func=_jst_attr("final_ret"),
                args=[ast.Name(id=RET_F, ctx=ast.Load()),
                      ast.Name(id=RET_V, ctx=ast.Load())],
                keywords=[]))
            body = ([_assign_const(RET_F, False),
                     _assign_expr(RET_V, _jst_attr("UNDEF"))]
                    + body + [epilogue])
        for s in body:
            # synthesized statements get the function's first line; the
            # user's own statements keep their real locations
            if getattr(s, "lineno", None) is None:
                ast.copy_location(s, fdef.body[0])
            ast.fix_missing_locations(s)
        fdef.body = body
        _ = kinds_all

    # -- analysis ------------------------------------------------------------
    @staticmethod
    def _has_nested_return(body) -> bool:
        for s in body:
            if isinstance(s, ast.Return):
                continue                      # top-level return is fine…
            if "return" in _exit_kinds_at_level([s]):
                return True                   # …nested ones need flags
        return False

    @staticmethod
    def _any_loop_needs_flags(stmts) -> bool:
        class V(ast.NodeVisitor):
            found = False

            def visit_FunctionDef(self, n):
                pass
            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_While(self, n):
                kinds = _exit_kinds_at_level(n.body)
                if kinds & {"break", "continue"}:
                    self.found = True
                self.generic_visit(n)
            visit_For = visit_While
        v = V()
        for s in stmts:
            v.visit(s)
        return v.found

    def _flags_set_by(self, stmt, brk, cont) -> List[str]:
        kinds = _exit_kinds_at_level([stmt])
        flags = []
        if brk and "break" in kinds:
            flags.append(brk)
        if cont and "continue" in kinds:
            flags.append(cont)
        if self.flagify_returns and "return" in kinds:
            flags.append(RET_F)
        return flags

    # -- rewriting -----------------------------------------------------------
    def block(self, stmts, brk, cont) -> List[ast.stmt]:
        out: List[ast.stmt] = []
        for i, s in enumerate(stmts):
            if isinstance(s, ast.Break) and brk:
                out.append(_assign_const(brk, True))
                return out                      # rest is unreachable
            if isinstance(s, ast.Continue) and cont:
                out.append(_assign_const(cont, True))
                return out
            if isinstance(s, ast.Return) and self.flagify_returns:
                out.append(_assign_expr(
                    RET_V, s.value if s.value is not None
                    else ast.Constant(value=None)))
                out.append(_assign_const(RET_F, True))
                return out
            if isinstance(s, ast.If):
                # `if p: …return…` followed by more code where the body
                # always returns ≡ `if p: … else: <rest>` — the else-form
                # assigns the return flag/value on BOTH sides, so traced
                # predicates merge a consistent structure (the reference's
                # return_transformer does the same hoisting)
                if (self.flagify_returns and not s.orelse
                        and _always_returns(s.body) and i + 1 < len(stmts)):
                    folded = ast.If(test=s.test, body=s.body,
                                    orelse=list(stmts[i + 1:]))
                    ast.copy_location(folded, s)
                    out.extend(self.block([folded], brk, cont))
                    return out
                ns = ast.If(
                    test=s.test,
                    body=self.block(s.body, brk, cont) or [ast.Pass()],
                    orelse=self.block(s.orelse, brk, cont))
                ast.copy_location(ns, s)
                out.append(ns)
                flags = self._flags_set_by(s, brk, cont)
                if flags:
                    rest = self.block(stmts[i + 1:], brk, cont)
                    if rest:
                        guard = ast.If(test=_not_or(flags), body=rest,
                                       orelse=[])
                        ast.copy_location(guard, s)
                        out.append(guard)
                    return out
                continue
            if isinstance(s, (ast.While, ast.For)):
                out.extend(self.loop(s))
                if self.flagify_returns and \
                        "return" in _exit_kinds_at_level([s]):
                    rest = self.block(stmts[i + 1:], brk, cont)
                    if rest:
                        guard = ast.If(test=_not_or([RET_F]), body=rest,
                                       orelse=[])
                        ast.copy_location(guard, s)
                        out.append(guard)
                    return out
                continue
            out.append(s)
        return out

    def loop(self, node) -> List[ast.stmt]:
        if node.orelse:
            return [node]                       # loop-else: keep python
        kinds = _exit_kinds_at_level(node.body)
        has_b = "break" in kinds
        has_c = "continue" in kinds
        has_r = self.flagify_returns and "return" in kinds
        if not (has_b or has_c or has_r):
            new_body = self.block(node.body, None, None)
            repl = type(node)(**{**{f: getattr(node, f)
                                    for f in node._fields},
                                 "body": new_body})
            ast.copy_location(repl, node)
            return [repl]

        self.uid += 1
        uid = self.uid
        bf = f"_pde_b{uid}" if has_b else None
        cf = f"_pde_c{uid}" if has_c else None
        cond_flags = ([bf] if has_b else []) + ([RET_F] if has_r else [])

        if isinstance(node, ast.While):
            new_test = (ast.BoolOp(op=ast.And(),
                                   values=[_not_or(cond_flags), node.test])
                        if cond_flags else node.test)
            new_body = (([_assign_const(cf, False)] if has_c else [])
                        + self.block(node.body, bf, cf))
            repl = ast.While(test=new_test, body=new_body, orelse=[])
            ast.copy_location(repl, node)
            # flags are loop-carried stores: initialize both before the
            # loop so the converted while's captures are defined
            return ([_assign_const(bf, False)] if has_b else []) \
                + ([_assign_const(cf, False)] if has_c else []) + [repl]

        # for-loop over non-range iterables: the guard-flag form would
        # drain the whole iterator (wrong cost, non-termination on
        # infinite generators) — keep CPython semantics; a real `return`
        # inside exits the function directly, which composes with the
        # flag epilogue (flags simply never fire)
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and isinstance(node.target, ast.Name))
        if not is_range:
            return [node]

        # range-for: keep the `for` shape (stays unrolled under trace —
        # reverse-differentiable) and guard the whole body with the
        # break/return flags; iterations after the exit are no-ops.
        # Deviation from CPython: the loop variable keeps iterating to
        # the end of the range after a `break` (its post-loop value
        # differs) — all *guarded* state matches exactly.
        guard_flags = ([bf] if has_b else []) + ([RET_F] if has_r else [])
        inner = (([_assign_const(cf, False)] if has_c else [])
                 + self.block(node.body, bf, cf))
        new_body = ([ast.If(test=_not_or(guard_flags),
                            body=inner or [ast.Pass()], orelse=[])]
                    if guard_flags else inner)
        repl = ast.For(target=node.target, iter=node.iter,
                       body=new_body, orelse=[])
        ast.copy_location(repl, node)
        return ([_assign_const(bf, False)] if has_b else []) \
            + ([_assign_const(cf, False)] if has_c else []) + [repl]


class _BoolOpInPred(ast.NodeTransformer):
    """Rewrite and/or/not inside a (potentially tensor) predicate into
    lazy _jst helpers (logical_transformer.py analogue)."""

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = "and_" if isinstance(node.op, ast.And) else "or_"
        out = node.values[0]
        for rhs in node.values[1:]:
            out = ast.Call(
                func=_jst_attr(fn),
                args=[out, ast.Lambda(
                    args=ast.arguments(posonlyargs=[], args=[],
                                       vararg=None, kwonlyargs=[],
                                       kw_defaults=[], kwarg=None,
                                       defaults=[]),
                    body=rhs)],
                keywords=[])
        return out

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=_jst_attr("not_"), args=[node.operand],
                            keywords=[])
        return node


class _Transformer(ast.NodeTransformer):
    def __init__(self):
        self.uid = 0

    def _next(self):
        self.uid += 1
        return self.uid

    # -- if/else -------------------------------------------------------------
    def visit_If(self, node: ast.If):
        self.generic_visit(node)
        uid = self._next()
        test = _BoolOpInPred().visit(node.test)

        body_ret = _contains(node.body, ast.Return)
        else_ret = _contains(node.orelse, ast.Return)
        if body_ret or else_ret:
            # supported shape: both branches are single `return expr`
            if (body_ret and else_ret
                    and len(node.body) == 1 and len(node.orelse) == 1
                    and isinstance(node.body[0], ast.Return)
                    and isinstance(node.orelse[0], ast.Return)):
                # ifelse expects branch fns returning the merged-vars
                # tuple; here that tuple is just (return-value,)
                def one_tuple_lambda(expr):
                    return ast.Lambda(args=_no_args(), body=ast.Tuple(
                        elts=[expr], ctx=ast.Load()))
                call = ast.Call(
                    func=_jst_attr("ifelse"),
                    args=[test,
                          one_tuple_lambda(node.body[0].value),
                          one_tuple_lambda(node.orelse[0].value),
                          ast.Tuple(elts=[], ctx=ast.Load()),
                          ast.Tuple(elts=[], ctx=ast.Load())],
                    keywords=[])
                ret = ast.Return(value=ast.Subscript(
                    value=call,
                    slice=ast.Constant(value=0), ctx=ast.Load()))
                return ast.copy_location(ret, node)
            return node  # leave python `if` (eager ok; traced will error)

        stores = sorted(_assigned_names(node.body)
                        | _assigned_names(node.orelse))
        if not stores:
            # side-effect-only branch (e.g. list.append): keep python
            return node
        args = _fn_args(stores)
        t_name, f_name = f"__pd_true_{uid}", f"__pd_false_{uid}"
        true_def = ast.FunctionDef(
            name=t_name, args=args,
            body=list(node.body) + [ast.Return(
                value=_names_load_tuple(stores))],
            decorator_list=[], returns=None)
        false_def = ast.FunctionDef(
            name=f_name, args=_fn_args(stores),
            body=(list(node.orelse) or [ast.Pass()]) + [ast.Return(
                value=_names_load_tuple(stores))],
            decorator_list=[], returns=None)
        call = ast.Call(
            func=_jst_attr("ifelse"),
            args=[test,
                  ast.Name(id=t_name, ctx=ast.Load()),
                  ast.Name(id=f_name, ctx=ast.Load()),
                  _init_load_tuple(stores, uid),
                  ast.Constant(value=tuple(stores))],
            keywords=[])
        assign = ast.Assign(targets=[_names_tuple(stores)], value=call)
        out = _init_stmts(stores, uid) + [true_def, false_def, assign]
        for s in out:
            ast.copy_location(s, node)
            ast.fix_missing_locations(s)
        return out

    # -- while ---------------------------------------------------------------
    def visit_While(self, node: ast.While):
        self.generic_visit(node)
        if node.orelse:
            return node
        if _contains(node.body, (ast.Break, ast.Continue, ast.Return)):
            return node  # python semantics (eager fine; traced errors)
        uid = self._next()
        test = _BoolOpInPred().visit(node.test)
        stores = sorted(_assigned_names(node.body))
        if not stores:
            return node
        c_name, b_name = f"__pd_cond_{uid}", f"__pd_body_{uid}"
        cond_def = ast.FunctionDef(
            name=c_name, args=_fn_args(stores),
            body=[ast.Return(value=test)], decorator_list=[],
            returns=None)
        body_def = ast.FunctionDef(
            name=b_name, args=_fn_args(stores),
            body=list(node.body) + [ast.Return(
                value=_names_load_tuple(stores))],
            decorator_list=[], returns=None)
        call = ast.Call(
            func=_jst_attr("while_"),
            args=[ast.Name(id=c_name, ctx=ast.Load()),
                  ast.Name(id=b_name, ctx=ast.Load()),
                  _init_load_tuple(stores, uid),
                  ast.Constant(value=tuple(stores))],
            keywords=[])
        assign = ast.Assign(targets=[_names_tuple(stores)], value=call)
        out = _init_stmts(stores, uid) + [cond_def, body_def, assign]
        for s in out:
            ast.copy_location(s, node)
            ast.fix_missing_locations(s)
        return out

    # -- for -----------------------------------------------------------------
    def visit_For(self, node: ast.For):
        self.generic_visit(node)
        if node.orelse or not isinstance(node.target, ast.Name):
            return node
        if _contains(node.body, (ast.Break, ast.Continue, ast.Return)):
            return node
        uid = self._next()
        stores = sorted(_assigned_names(node.body) - {node.target.id})
        if not stores:
            return node
        b_name = f"__pd_forbody_{uid}"
        body_def = ast.FunctionDef(
            name=b_name,
            args=_fn_args([node.target.id] + stores),
            body=list(node.body) + [ast.Return(
                value=_names_load_tuple(stores))],
            decorator_list=[], returns=None)
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range")
        if is_range:
            r = node.iter.args
            start = r[0] if len(r) >= 2 else ast.Constant(value=0)
            stop = r[1] if len(r) >= 2 else r[0]
            step = r[2] if len(r) == 3 else ast.Constant(value=1)
            call = ast.Call(
                func=_jst_attr("for_range"),
                args=[start, stop, step,
                      ast.Name(id=b_name, ctx=ast.Load()),
                      _init_load_tuple(stores, uid),
                      ast.Constant(value=tuple(stores))],
                keywords=[])
        else:
            call = ast.Call(
                func=_jst_attr("for_iter"),
                args=[node.iter,
                      ast.Name(id=b_name, ctx=ast.Load()),
                      _init_load_tuple(stores, uid),
                      ast.Constant(value=tuple(stores))],
                keywords=[])
        assign = ast.Assign(targets=[_names_tuple(stores)], value=call)
        out = _init_stmts(stores, uid) + [body_def, assign]
        for s in out:
            ast.copy_location(s, node)
            ast.fix_missing_locations(s)
        return out


def _no_args():
    return ast.arguments(posonlyargs=[], args=[], vararg=None,
                         kwonlyargs=[], kw_defaults=[], kwarg=None,
                         defaults=[])


def _fn_args(names):
    return ast.arguments(
        posonlyargs=[],
        args=[ast.arg(arg=n, annotation=None) for n in names],
        vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
        defaults=[])


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

_cache: Dict[Any, Callable] = {}


def convert_function(fn: Callable) -> Callable:
    """AST-convert `fn`'s tensor control flow. Returns the converted
    function (or `fn` itself when conversion is impossible — e.g. no
    source available)."""
    key = getattr(fn, "__wrapped__", fn)
    if key in _cache:
        return _cache[key]
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
        fdef = tree.body[0]
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            raise ConversionError("not a function def")
        fdef.decorator_list = []  # strip @to_static etc.
        _EarlyExit().run(fdef)
        _Transformer().visit(fdef)
        ast.fix_missing_locations(tree)
        try:  # jit.set_code_level(>0): show the transformed source
            from .compat import _code_level
            if _code_level() > 0:
                print(f"[dy2static] transformed source of "
                      f"{fn.__name__}:\n{ast.unparse(tree)}")
        except Exception:
            pass
        code = compile(tree, filename=f"<dy2static {fn.__name__}>",
                       mode="exec")
        glb = dict(fn.__globals__)
        glb["_jst"] = jst
        # rebind the original closure by turning freevars into defaults?
        # simpler: exec and wrap with original closure cells when present
        if fn.__closure__:
            # re-close over the original cells: build a wrapper that
            # injects the free variables into globals at call time
            freevars = fn.__code__.co_freevars
            cells = {n: c for n, c in zip(freevars, fn.__closure__)}

            def make(glb=glb):
                loc: Dict[str, Any] = {}
                exec(code, glb, loc)
                return loc[fdef.name]

            inner = None

            @functools.wraps(fn)
            def converted(*args, **kwargs):
                nonlocal inner
                for n, c in cells.items():
                    glb[n] = c.cell_contents
                if inner is None:
                    inner = make()
                return inner(*args, **kwargs)
            _cache[key] = converted
            return converted
        loc: Dict[str, Any] = {}
        exec(code, glb, loc)
        out = functools.wraps(fn)(loc[fdef.name])
        _cache[key] = out
        return out
    except (OSError, TypeError, SyntaxError, ConversionError) as e:
        # no source (REPL, builtins, lambdas) is routine — trace as-is
        # silently; only a real conversion failure is worth a warning
        if isinstance(e, ConversionError):
            warnings.warn(f"dy2static: could not convert {fn!r} "
                          f"({type(e).__name__}: {e}); tracing it as-is")
        _cache[key] = fn
        return fn

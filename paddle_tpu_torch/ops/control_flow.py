"""Control-flow ops (counterpart of paddle_tpu/ops/control_flow.py):
cond, while_loop, bounded_while_loop, fori_loop, scan, case and
switch_case.

Eagerly they branch and loop in Python over torch, as the JAX package's
eager path does. Inside a CUDA-graph capture (a captured TrainStep or
program) the host cannot read a device predicate, so the ops take the
JAX traced path's contract instead:

- cond, case and switch_case run every branch and select the result
  with torch.where on the predicate or index, so every branch must
  return the same structure of tensors (cond needs false_fn, case needs
  default, as lax.cond has no "do nothing" branch);
- bounded_while_loop, fori_loop and scan have static bounds and run as a
  fixed loop (bounded_while_loop masks the iterations past its exit, in
  both modes, as the JAX op does);
- while_loop runs as a device-side loop: a CUDA conditional WHILE node
  (csrc/graph_while.cu, CUDA 12.4 or later) whose body graph is the
  loop's body captured once, run again by the card for as long as the
  condition holds, as lax.while_loop runs inside the compiled step. The
  host never reads the predicate. Below CUDA 12.4 it raises, naming the
  card's versions; there is no host loop under a capture. Like
  lax.while_loop it has no reverse mode: carries that require grad
  raise.

A predicate that is a Python value, or a CPU tensor, is read on the host
in every mode. `static_branches()` makes the select path run for CPU
tensors outside a capture too (the CPU tests use it); while_loop there
refuses carries that require grad, as under a capture, and loops on the
host, since the CPU has no graph to capture into.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

__all__ = ["cond", "while_loop", "bounded_while_loop", "case",
           "switch_case", "scan", "fori_loop"]

#: launches of csrc/graph_while.cu's kernel, counted where a captured
#: while_loop records it (before its WHILE node and as its body's last
#: kernel); a replay runs them on the card without passing here
launches = {"graph_while_set_condition": 0}

_state = threading.local()


@contextlib.contextmanager
def static_branches():
    """Run cond, case and switch_case as inside a CUDA-graph capture:
    every branch, then a torch.where select."""
    prev = getattr(_state, "forced", False)
    _state.forced = True
    try:
        yield
    finally:
        _state.forced = prev


def _capturing():
    return getattr(_state, "forced", False) or (
        torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def _selecting(pred):
    """True where `pred` cannot be read on the host: a tensor under
    static_branches(), or a card tensor while a CUDA-graph capture is in
    progress. A Python value, or a CPU tensor in a capture, is read."""
    if not isinstance(pred, torch.Tensor):
        return False
    if getattr(_state, "forced", False):
        return True
    return pred.device.type == "cuda" and _capturing()


def _flag(pred):
    """A 0-d bool tensor of a tensor predicate."""
    return pred.reshape(()).to(torch.bool)


def _select(pred, a, b):
    """torch.where(pred, a, b) leaf by leaf over one structure."""
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            raise ValueError("the branches must return the same structure "
                             f"under a capture, got {type(a).__name__} of "
                             f"{len(a)} and {b!r}")
        return type(a)(_select(pred, x, y) for x, y in zip(a, b))
    if a is None or b is None:
        raise ValueError("the branches must return tensors under a "
                         "capture, got None")
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.where(pred.to(a.device), a, b.to(a.dtype))


def cond(pred, true_fn, false_fn=None, operands=(), name=None):
    """paddle.static.nn.cond: true_fn(*operands) where pred holds, else
    false_fn(*operands) (None without one). Under a capture both run and
    the result is selected, so false_fn is required."""
    operands = tuple(operands)
    if not _selecting(pred):
        if bool(pred):
            return true_fn(*operands)
        return false_fn(*operands) if false_fn is not None else None
    if false_fn is None:
        raise ValueError(
            "paddle.cond under a CUDA-graph capture requires both true_fn "
            "and false_fn (branches must return the same structure); got "
            "false_fn=None")
    return _select(_flag(pred), true_fn(*operands), false_fn(*operands))


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """paddle.static.nn.while_loop: body_fn while cond_fn holds; returns
    the loop variables as a list. Eagerly the host reads the predicate
    at every iteration. Under a CUDA-graph capture, with card tensors,
    the loop is a conditional WHILE node of the graph (_graph_while):
    the trip count is decided on the card at every replay."""
    vals = _as_list(loop_vars)
    if _capturing():
        if torch.is_grad_enabled() and any(
                isinstance(v, torch.Tensor) and v.requires_grad
                for v in vals):
            raise RuntimeError(
                "while_loop under a CUDA-graph capture has no reverse mode "
                "(as lax.while_loop): its carries must not require grad; "
                "use bounded_while_loop(..., max_iters) for a "
                "differentiable loop")
        if torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            return _graph_while(cond_fn, body_fn, vals)
    while bool(cond_fn(*vals)):
        vals = _as_list(body_fn(*vals))
    return vals


# -- the device-side loop (csrc/graph_while.cu) -------------------------------

#: the CUDA runtime and driver a conditional WHILE node needs (12.4)
_MIN_CUDA = 12040
_graph_lib_checked = []


def _graph_lib():
    """csrc/graph_while.cu, loaded (built at first use), its argument
    types set, and the card's CUDA runtime and driver checked once."""
    from . import _build
    lib = _build.load("graph_while")
    if not _graph_lib_checked:
        vp, ull = ctypes.c_void_p, ctypes.c_ulonglong
        for fn, args in (
                ("pt_graph_versions", [ctypes.POINTER(ctypes.c_int)] * 2),
                ("pt_graph_while_begin",
                 [vp, vp, ctypes.POINTER(vp), ctypes.POINTER(ull)]),
                ("pt_graph_while_set", [vp, ull, vp]),
                ("pt_graph_capture_to", [vp, vp]),
                ("pt_graph_capture_end", [vp, vp])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        rt, drv = ctypes.c_int(), ctypes.c_int()
        _graph_call(lib.pt_graph_versions(ctypes.byref(rt),
                                          ctypes.byref(drv)), "versions")
        if min(rt.value, drv.value) < _MIN_CUDA:
            raise RuntimeError(
                "while_loop under a CUDA-graph capture runs as a CUDA "
                "conditional WHILE node, which needs CUDA 12.4: this "
                f"card's runtime is {rt.value}, its driver {drv.value}")
        _graph_lib_checked.append((rt.value, drv.value))
    return lib


def _graph_call(rc, what):
    if rc != 0:
        raise RuntimeError(f"while_loop's graph node: {what} failed "
                           f"(CUDA error {rc})")


def _pool_calls():
    """torch's allocate-to-pool entry points: (begin, end, release) over
    (device index, pool id); begin routes the current stream's (older
    torch) or the current thread's allocations to the pool."""
    c = torch._C
    begin = (getattr(c, "_cuda_beginAllocateCurrentStreamToPool", None)
             or getattr(c, "_cuda_beginAllocateCurrentThreadToPool", None))
    end = (getattr(c, "_cuda_endAllocateCurrentStreamToPool", None)
           or getattr(c, "_cuda_endAllocateToPool", None))
    release = getattr(c, "_cuda_releasePool", None)
    if begin is None or end is None or release is None:
        raise RuntimeError(
            "while_loop under a CUDA-graph capture needs torch's "
            "allocate-to-pool entry points (torch._C._cuda_beginAllocate"
            "*ToPool), which this torch lacks")
    return begin, end, release


class _LoopNode:
    """What a captured loop keeps alive for as long as its graph: the
    body's stream and its private memory pool (released with the graph,
    static/capture.py)."""

    def __init__(self, device, pool, stream, release):
        self.device, self.pool, self.stream = device, pool, stream
        self._release = release

    def release(self):
        if self._release is not None:
            self._release(self.device, self.pool)
            self._release = None


def _bit_copy(dst, src):
    """dst <- src bit for bit with an elementwise kernel (no memcpy node:
    a conditional node's body graph holds kernels)."""
    src = src.to(dst.dtype).expand_as(dst)
    if dst.dtype == torch.bool:
        torch.logical_or(src, False, out=dst)
        return
    if dst.is_floating_point() or dst.is_complex():
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[dst.element_size()]
        dst, src = dst.view(ints), src.view(ints)
    torch.bitwise_or(src, 0, out=dst)


def _fresh(t):
    """A bit copy of t in new memory (a kernel, as _bit_copy)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    _bit_copy(out, t)
    return out


def _device_flag(pred, what):
    """A 0-d int32 card tensor of a loop predicate (non-zero: go on)."""
    if not isinstance(pred, torch.Tensor) or pred.device.type != "cuda":
        raise RuntimeError(
            f"while_loop under a CUDA-graph capture: {what} must return a "
            f"tensor on the card, got {type(pred).__name__}"
            + (f" on {pred.device}" if isinstance(pred, torch.Tensor)
               else ""))
    return pred.reshape(()).ne(0).to(torch.int32)


def _graph_while(cond_fn, body_fn, vals):
    """The loop as a conditional WHILE node of the graph the current
    stream is capturing (csrc/graph_while.cu's steps). The carries are
    copied into buffers of the outer graph; the body, captured once on
    a second stream into the node's body graph, writes its results back
    into them, evaluates cond_fn again and sets the node's condition.
    The body's temporaries come from a private pool of the caching
    allocator, held with the outer graph. Returns the carry buffers."""
    from ..static import capture as _capture
    for v in vals:
        if not isinstance(v, torch.Tensor) or v.device.type != "cuda":
            raise RuntimeError(
                "while_loop under a CUDA-graph capture takes tensors on "
                f"the card as loop_vars, got {type(v).__name__}"
                + (f" on {v.device}" if isinstance(v, torch.Tensor) else ""))
    lib = _graph_lib()
    begin, end, release = _pool_calls()
    dev = vals[0].device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    main = torch.cuda.current_stream(dev)
    bufs = [v.detach().clone() for v in vals]
    flag = _device_flag(cond_fn(*bufs), "cond_fn")
    body, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
    _graph_call(lib.pt_graph_while_begin(
        ctypes.c_void_p(main.cuda_stream), ctypes.c_void_p(flag.data_ptr()),
        ctypes.byref(body), ctypes.byref(handle)), "adding the WHILE node")
    launches["graph_while_set_condition"] += 1
    side = torch.cuda.Stream(dev)
    pool = torch.cuda.graph_pool_handle()
    node = _LoopNode(idx, pool, side, release)
    _capture.hold(node)
    with torch.cuda.stream(side):
        begin(idx, pool)
        try:
            _graph_call(lib.pt_graph_capture_to(
                ctypes.c_void_p(side.cuda_stream), body), "capturing the body")
            try:
                out = _as_list(body_fn(*bufs))
                if len(out) != len(bufs):
                    raise ValueError(
                        f"while_loop's body returned {len(out)} values for "
                        f"{len(bufs)} loop_vars")
                out = [torch.as_tensor(o, device=dev) for o in out]
                for o, b in zip(out, bufs):
                    if o.requires_grad and torch.is_grad_enabled():
                        raise RuntimeError(
                            "while_loop under a CUDA-graph capture has no "
                            "reverse mode: its body returned a tensor "
                            "that requires grad")
                    if o.shape != b.shape:
                        raise ValueError(
                            "while_loop's body changed a carry's shape "
                            f"from {tuple(b.shape)} to {tuple(o.shape)}")
                # a result that shares a carry's memory is copied out
                # first: the copies below overwrite the carries in turn
                held = {b.untyped_storage().data_ptr() for b in bufs}
                out = [_fresh(o) if o.untyped_storage().data_ptr() in held
                       else o for o in out]
                for o, b in zip(out, bufs):
                    _bit_copy(b, o)
                again = _device_flag(cond_fn(*bufs), "cond_fn")
                _graph_call(lib.pt_graph_while_set(
                    ctypes.c_void_p(side.cuda_stream), handle.value,
                    ctypes.c_void_p(again.data_ptr())),
                    "setting the condition")
                launches["graph_while_set_condition"] += 1
            finally:
                _graph_call(lib.pt_graph_capture_end(
                    ctypes.c_void_p(side.cuda_stream), body),
                    "ending the body's capture")
        finally:
            end(idx, pool)
    return bufs


def bounded_while_loop(cond_fn, body_fn, loop_vars, max_iters: int,
                       name=None):
    """A while loop of exactly max_iters iterations in which the ones
    past the exit condition pass the carry through unchanged
    (differentiable, and capture-safe: no host read). The same as
    while_loop as long as the true iteration count never exceeds
    max_iters."""
    vals = _as_list(loop_vars)
    for _ in range(int(max_iters)):
        pred = torch.as_tensor(cond_fn(*vals)).reshape(()).to(torch.bool)
        out = _as_list(body_fn(*vals))
        vals = [torch.where(pred.to(v.device), o.to(v.dtype), v)
                for o, v in zip(out, vals)]
    return vals


def fori_loop(lower, upper, body_fn, init, name=None):
    """val = body_fn(i, val) for i in [lower, upper); i is a 0-d int64
    tensor on init's device."""
    lo, hi = int(lower), int(upper)
    val = init
    dev = init.device if isinstance(init, torch.Tensor) else None
    for i in range(lo, hi):
        val = body_fn(torch.full((), i, dtype=torch.int64, device=dev), val)
    return val


def scan(f, init, xs, name=None):
    """(carry, ys): carry, y = f(carry, x) over the leading axis of xs,
    the ys stacked."""
    carry, ys = init, []
    for x in xs.unbind(0):
        carry, y = f(carry, x)
        ys.append(y)
    return carry, torch.stack(ys)


def case(pred_fn_pairs, default=None, name=None):
    """paddle.static.nn.case: the first branch whose predicate holds,
    else default. Under a capture every branch runs and the result is
    selected, so default is required."""
    pairs = list(pred_fn_pairs)
    if not any(_selecting(p) for p, _ in pairs):
        for pred, fn in pairs:
            if bool(pred):
                return fn()
        if default is not None:
            return default()
        raise ValueError("no case matched and no default given")
    if default is None:
        raise ValueError("paddle.case under a CUDA-graph capture requires "
                         "default= (every branch runs; no case can be "
                         "refused on the device)")
    out = default()
    for pred, fn in reversed(pairs):
        if not isinstance(pred, torch.Tensor):
            # a host predicate: this branch is taken or skipped outright
            out = fn() if bool(pred) else out
            continue
        out = _select(_flag(pred), fn(), out)
    return out


def switch_case(branch_index, branch_fns, default=None, name=None):
    """paddle.static.nn.switch_case: the branch of branch_index (a list
    index or a dict key), else default (None without one). Under a
    capture every branch runs and the result is selected, with
    lax.switch's rule where no default is given: the index is clamped
    into the list (a dict key goes to the first key not below it)."""
    if not _selecting(branch_index):
        i = int(branch_index)
        if isinstance(branch_fns, dict):
            fn = branch_fns.get(i)
        else:
            fns = list(branch_fns)
            fn = fns[i] if 0 <= i < len(fns) else None
        if fn is not None:
            return fn()
        return default() if default else None
    idx = torch.as_tensor(branch_index).reshape(()).to(torch.int64)
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
        karr = torch.tensor(keys, dtype=torch.int64, device=idx.device)
        pos = torch.searchsorted(karr, idx.reshape(1)).reshape(())
        matched = (pos < len(keys)) & (
            karr[pos.clamp(max=len(keys) - 1)] == idx)
    else:
        fns = list(branch_fns)
        pos = idx
        matched = (idx >= 0) & (idx < len(fns))
    if default is not None:
        pos = torch.where(matched, pos, torch.full_like(pos, len(fns)))
        fns = fns + [default]
    pos = pos.clamp(0, len(fns) - 1)
    outs = [fn() for fn in fns]
    out = outs[0]
    for i in range(1, len(outs)):
        out = _select(pos == i, outs[i], out)
    return out

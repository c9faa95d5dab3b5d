"""CUDA-graph capture of a whole program (the port's counterpart of one
jax.jit executable), shared by TrainStep's step and eval programs,
generate's programs and the serving engine's.

The rules of a captured program, which every body run under `capture`
keeps (serving/programs.py keeps the same for the engine):
- static buffers: inputs are copied into buffers the graph was captured
  on (StaticInputs), outputs are read from the graph's own tensors;
- in-place state: parameters, optimizer state, loss-scale state and
  gradients are written in place, never rebound (set_state_dict copies
  into them), since the graph holds their addresses;
- seeds in slots: random draws read their seeds from device memory that
  is written before each replay (core/generator.py SeedSlots), never
  from host ints baked in at capture;
- no host synchronisation inside (.item(), host copies, nonzero);
- no fallback: a capture that fails raises, naming the op.
Python's cyclic collector is held off during a capture: a collection
there can run an earlier graph's destructor, whose cudaGraphExecDestroy
is not permitted while a stream captures and invalidates the capture
(torch.cuda.graph no longer collects before it begins).
What a capture's ops must keep alive for as long as its graph (a
while_loop's body stream and memory pool, ops/control_flow.py) is handed
to `hold` and released when the graph is collected.
"""
from __future__ import annotations

import gc
import threading
import time
import weakref

import torch

from ..observability.sentinel import count_capture

__all__ = ["StaticInputs", "warm_up", "capture", "clone_outputs", "hold"]

_held = threading.local()
# what was held outside a `capture` (a torch.cuda.graph of the caller's
# own): kept for the life of the process
_held_forever = []


def hold(obj):
    """Keep obj alive for as long as the graph being captured, and call
    its release() when that graph is collected."""
    getattr(_held, "items", _held_forever).append(obj)


def _release(items):
    for obj in items:
        obj.release()


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k])
    else:
        yield tree


def _rebuild(tree, it):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree, key=str)}
    return next(it) if isinstance(tree, torch.Tensor) else tree


def clone_outputs(out):
    """A replay's outputs (a tensor, or tuples and lists of them) cloned
    out of the graph's own tensors, which the next replay overwrites."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (list, tuple)):
        return type(out)(clone_outputs(x) for x in out)
    return out


class StaticInputs:
    """Static device buffers for the tensor leaves of `tree` (nested
    tuples, lists and dicts), and the tree rebuilt over them. Non-tensor
    leaves stay as they are: the caller keys its programs on them."""

    def __init__(self, tree, device):
        device = torch.device(device)
        for t in _leaves(tree):
            if isinstance(t, torch.Tensor) and t.device != device:
                raise ValueError(
                    f"a captured program takes its inputs on {device}, "
                    f"got a tensor on {t.device}")
        self.buffers = [torch.empty_like(t) for t in _leaves(tree)
                        if isinstance(t, torch.Tensor)]
        self.tree = _rebuild(tree, iter(self.buffers))
        self.fill(tree)

    def fill(self, tree):
        """Copy the tensor leaves of `tree` into the buffers (device to
        device, on the current stream)."""
        src = [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]
        if len(src) != len(self.buffers):
            raise ValueError(f"{len(src)} tensors for {len(self.buffers)} "
                             "static buffers")
        for b, t in zip(self.buffers, src):
            b.copy_(t, non_blocking=True)


_side_streams = {}


def _side_stream(dev):
    """The device's one warm-up stream. cuBLAS keeps a workspace for
    every stream it has run on, so a new stream per warm-up would leave
    a workspace behind for each captured program."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    side = _side_streams.get(idx)
    if side is None:
        side = _side_streams[idx] = torch.cuda.Stream(idx)
    return side


def warm_up(fn, device):
    """fn() on the device's side stream (lazy library state and
    workspaces are made outside the capture), the current stream joined
    to it after; returns fn's result."""
    dev = torch.device(device)
    cur = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


def capture(fn, device, generators=(), program="train", pool=None):
    """(graph, out): fn() captured as one torch.cuda.CUDAGraph on
    `device` (into the memory pool `pool`, a graph_pool_handle(), when
    given), with every generator in `generators` registered, so that a
    replay draws from its state as set before the replay (manual_seed).
    A failure raises RuntimeError naming the captured program's error;
    nothing runs eagerly instead. The capture is counted under
    `program` (observability.sentinel.count_capture)."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    t0 = time.perf_counter()
    collecting = gc.isenabled()
    gc.disable()
    outer = getattr(_held, "items", None)
    _held.items = items = []
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool):
            out = fn()
    except RuntimeError as e:
        _release(items)
        raise RuntimeError(f"CUDA graph capture failed: {e}") from e
    finally:
        if outer is None:
            del _held.items
        else:
            _held.items = outer
        if collecting:
            gc.enable()
    if items:
        graph._held = items
        weakref.finalize(graph, _release, items)
    count_capture(program, time.perf_counter() - t0)
    return graph, out

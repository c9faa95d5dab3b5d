"""CUDA-graph capture of a whole program (the port's counterpart of one
jax.jit executable), shared by TrainStep's step and eval programs.

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
"""
from __future__ import annotations

import torch

__all__ = ["StaticInputs", "warm_up", "capture"]


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


def warm_up(fn, device):
    """fn() on a side stream (lazy library state and workspaces are made
    outside the capture), the current stream joined to it after; returns
    fn's result."""
    dev = torch.device(device)
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


def capture(fn, device, generators=()):
    """(graph, out): fn() captured as one torch.cuda.CUDAGraph on
    `device`, with every generator in `generators` registered, so that a
    replay draws from its state as set before the replay (manual_seed).
    A failure raises RuntimeError naming the captured program's error;
    nothing runs eagerly instead."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph):
            out = fn()
    except RuntimeError as e:
        raise RuntimeError(f"CUDA graph capture failed: {e}") from e
    return graph, out

"""recordable: a port function a Program records as one op.

A static Program (static/program.py) records every torch function a
TorchFunctionMode sees. A port function that is not a torch function is
seen only through the torch calls inside it, which is wrong for three
kinds of function: those that draw random numbers (the draw would be
baked into the Program at its recording, and every run would repeat it),
those that write state in place (BatchNorm's running statistics), and
those whose mode a test clone flips (training). `recordable` makes such
a function a torch function: with a mode active, a call reaches the
mode as one op named by the function's module and name, and the mode
runs it whole (so the draw happens at each replay, inside the replay's
seed scope). Without a mode, a call costs one check.
"""
from __future__ import annotations

import functools

import torch
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["recordable"]


def _tensor_args(args, kwargs):
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def recordable(fn):
    """fn as a torch function (see the module's docstring)."""

    @functools.wraps(fn)
    def op(*args, **kwargs):
        tensors = _tensor_args(args, kwargs)
        if tensors and has_torch_function(tensors):
            return handle_torch_function(op, tensors, *args, **kwargs)
        return fn(*args, **kwargs)
    op.recordable = True
    return op

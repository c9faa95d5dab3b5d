"""shard_parallel: run a function SPMD over mesh axes (counterpart of
paddle_tpu/distributed/shard_map_util.py).

In the JAX package shard_parallel wraps the function in jax.shard_map.
In the port each rank is a process, so a rank's process is the body of
that shard_map: every rank takes its block of each global input by the
input specs, runs the function on its blocks under axis_context (so
collectives find their axes) and no_grad, then all-gathers each output
by the output specs. Every rank returns the global arrays the JAX
shard_map returns. Every rank of the mesh calls the wrapper, with the
same global inputs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import collective as _c
from .env import Mesh, axis_context, ensure_mesh, get_rank

__all__ = ["PartitionSpec", "P", "shard_parallel", "sp_shard_map"]


class PartitionSpec(tuple):
    """jax.sharding.PartitionSpec: one entry per leading dim, each None
    (not split), an axis name, or a tuple of axis names (split over their
    product, the first one outermost)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _axes_of(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _block_index(mesh: Mesh, coords, axes) -> int:
    idx = 0
    for ax in axes:
        idx = idx * mesh.shape[ax] + coords[ax]
    return idx


def _n_blocks(mesh: Mesh, axes) -> int:
    n = 1
    for ax in axes:
        n *= mesh.shape[ax]
    return n


def _local_block(x, spec, mesh: Mesh, coords):
    if not isinstance(x, torch.Tensor) or spec is None:
        return x
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if not axes:
            continue
        n = _n_blocks(mesh, axes)
        size = x.shape[dim] // n
        i = _block_index(mesh, coords, axes)
        x = x.narrow(dim, i * size, size)
    return x.contiguous()


def _assemble(local, spec, mesh: Mesh, coords):
    """The global array whose blocks (by `spec`) the ranks hold."""
    if not isinstance(local, torch.Tensor):
        return local
    spec = spec if spec is not None else PartitionSpec()
    named = {ax for entry in spec for ax in _axes_of(entry)}
    if _c._dist() is None:
        if any(mesh.shape[ax] > 1 for ax in named):
            raise RuntimeError(
                f"shard_parallel over {mesh} needs a process group: "
                "start every rank (init_parallel_env)")
        return local
    world = _c._dist().group.WORLD
    every = _c._gather_flat(local, world)          # [W, *local.shape]
    shape = list(local.shape)
    for dim, entry in enumerate(spec):
        shape[dim] *= _n_blocks(mesh, _axes_of(entry))
    full = local.new_empty(shape)
    for r in range(every.shape[0]):
        rc = mesh.coords(r)
        # replicated over the axes the spec does not name: take this
        # rank's own copy
        if any(rc[ax] != coords[ax] for ax in mesh.axis_names
               if ax not in named):
            continue
        view = full
        for dim, entry in enumerate(spec):
            axes = _axes_of(entry)
            if axes:
                i = _block_index(mesh, rc, axes)
                view = view.narrow(dim, i * local.shape[dim],
                                   local.shape[dim])
        view.copy_(every[r])
    return full


def _per_arg(specs, n):
    if specs is None or isinstance(specs, PartitionSpec):
        return [specs] * n
    specs = list(specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for {n} values")
    return specs


def shard_parallel(fn, mesh: Optional[Mesh] = None, in_specs=None,
                   out_specs=None, axes: Sequence[str] = None,
                   check_vma=False):
    """Wrap `fn(tensors) -> tensor(s)` for SPMD execution over `mesh`
    (default: the global mesh). in_specs and out_specs are
    PartitionSpecs: one for every value, or a tuple with one per value.
    Inside, collectives resolve their axes (`axes`, default all of the
    mesh's) and `fn` sees this rank's blocks."""
    mesh = mesh or ensure_mesh()
    axes = tuple(axes) if axes is not None else tuple(mesh.axis_names)

    def wrapper(*args):
        coords = mesh.coords(get_rank()) if _c._dist() is not None else \
            {ax: 0 for ax in mesh.axis_names}
        ins = [_local_block(a, s, mesh, coords)
               for a, s in zip(args, _per_arg(in_specs, len(args)))]
        with axis_context(*axes), torch.no_grad():
            out = fn(*ins)
        if isinstance(out, (list, tuple)):
            return tuple(_assemble(o, s, mesh, coords) for o, s in zip(
                out, _per_arg(out_specs, len(out))))
        return _assemble(out, out_specs, mesh, coords)
    return wrapper


def sp_shard_map(fn, mesh=None, seq_dim=1):
    """q, k and v split over the 'sp' axis on `seq_dim`, running a
    context-parallel attention body."""
    mesh = mesh or ensure_mesh()
    spec = P(*(None if i != seq_dim else "sp" for i in range(4)))
    return shard_parallel(fn, mesh, in_specs=(spec, spec, spec),
                          out_specs=spec, axes=("sp",))


"""Distributed environment: the mesh, the axis context, rank and world
(counterpart of paddle_tpu/distributed/env.py).

The JAX package's world is one process over a jax.sharding.Mesh, and a
collective is live only inside a shard_map trace over its axis. The
port's world is one process per rank (torch.distributed), so each
rank's process is the body of that shard_map: a Mesh here names the
world's ranks in ordered axes, and holds, for each axis, the process
group of the ranks that share this rank's coordinates on the other axes.
Collectives (collective.py) find their group through it. With a process
group initialised the axes' groups come from a
torch.distributed.device_mesh.DeviceMesh over the world; without one the
mesh has no groups and every collective is the world-size-1 identity.
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_state = threading.local()
_global_mesh: Optional["Mesh"] = None
# every Mesh that holds process groups, so that a teardown can drop them
# (parallel.py _destroy_at_exit) wherever a Mesh is still referenced
_meshes_with_groups: "weakref.WeakSet" = weakref.WeakSet()

# the canonical axis names, the reference's parallelism taxonomy
DATA_AXIS = "dp"
TENSOR_AXIS = "tp"
PIPE_AXIS = "pp"
SEQUENCE_AXIS = "sp"
EXPERT_AXIS = "ep"

__all__ = ["Mesh", "build_mesh", "set_mesh", "get_mesh", "ensure_mesh",
           "axis_context", "current_axes", "current_axis_name",
           "axis_group", "get_rank", "get_world_size", "device_count",
           "DATA_AXIS", "TENSOR_AXIS", "PIPE_AXIS", "SEQUENCE_AXIS",
           "EXPERT_AXIS"]


def _dist():
    """torch.distributed when a process group is initialised, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


class Mesh:
    """Named axes over the world's ranks (the jax.sharding.Mesh of the
    JAX package, one rank standing for one device).

    ``axis_names`` and ``shape`` ({name: size}) keep the JAX Mesh's
    order; ``devices`` is the array of global ranks in that shape.
    ``group(axis)`` is this rank's process group along `axis` (None
    without an initialised process group), ``coords(rank)`` a rank's
    coordinate on each axis."""

    def __init__(self, mesh_shape: Dict[str, int],
                 ranks: Optional[Sequence[int]] = None):
        self.axis_names: Tuple[str, ...] = tuple(mesh_shape)
        sizes = tuple(int(v) for v in mesh_shape.values())
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        n = int(np.prod(sizes)) if sizes else 1
        ranks = list(range(n)) if ranks is None else list(ranks)[:n]
        if len(ranks) < n:
            raise ValueError(
                f"mesh {self.shape} needs {n} ranks, have {len(ranks)}")
        self.devices = np.asarray(ranks, dtype=np.int64).reshape(sizes)
        self.size = n
        self.device_mesh = None
        self._groups: Dict[str, object] = {}
        dist = _dist()
        if dist is not None:
            world = dist.get_world_size()
            if n != world or ranks != list(range(world)):
                raise ValueError(
                    f"mesh {self.shape} must cover the world's {world} "
                    "ranks in order (one process per rank)")
            from torch.distributed.device_mesh import init_device_mesh
            kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self.device_mesh = init_device_mesh(
                kind, sizes, mesh_dim_names=self.axis_names)
            for name in self.axis_names:
                self._groups[name] = self.device_mesh.get_group(name)
            _meshes_with_groups.add(self)

    def _drop_groups(self):
        """Forget this mesh's process groups (after they are destroyed)."""
        self._groups.clear()
        self.device_mesh = None

    def __contains__(self, axis) -> bool:
        return axis in self.shape

    def group(self, axis: str):
        return self._groups.get(axis)

    def coords(self, rank: int) -> Dict[str, int]:
        idx = np.argwhere(self.devices == int(rank))[0]
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def __repr__(self):
        return f"Mesh({self.shape})"


def build_mesh(mesh_shape: Dict[str, int] = None,
               devices: Sequence[int] = None) -> Mesh:
    """A named mesh over the world's ranks, e.g. {"dp": 2, "tp": 4}.
    `devices` are the ranks it covers (default: every rank in order);
    the default shape is {"dp": world size}. With a process group
    initialised, every rank builds the same mesh (the groups are made
    collectively)."""
    ranks = list(devices) if devices is not None else \
        list(range(get_world_size()))
    if not mesh_shape:
        mesh_shape = {DATA_AXIS: len(ranks)}
    return Mesh(dict(mesh_shape), ranks)


def set_mesh(mesh: Optional[Mesh]):
    global _global_mesh
    _global_mesh = mesh
    return mesh


def get_mesh() -> Optional[Mesh]:
    return _global_mesh


def ensure_mesh(mesh_shape=None) -> Mesh:
    global _global_mesh
    if _global_mesh is None or mesh_shape is not None:
        _global_mesh = build_mesh(mesh_shape)
    return _global_mesh


def axis_group(axis: Optional[str]):
    """The process group of `axis` for this rank: the mesh's, or, with
    no mesh set, the world's for DATA_AXIS (build_mesh's default mesh).
    None when the axis has no group (no process group, or an axis the
    mesh lacks): a collective over it is then the identity, as one over
    an axis out of scope is in the JAX package."""
    if axis is None:
        return None
    mesh = get_mesh()
    if mesh is not None:
        return mesh.group(axis) if axis in mesh else None
    dist = _dist()
    if dist is not None and axis == DATA_AXIS:
        return dist.group.WORLD
    return None


# -- the axis context: the axes a region runs "inside the shard_map" of --

def _axis_stack() -> List[Tuple[str, ...]]:
    if not hasattr(_state, "axes"):
        _state.axes = []
    return _state.axes


class axis_context:
    """Marks a region as running over the given mesh axes, so collectives
    with no group pick their axis from it (the ring_id analogue)."""

    def __init__(self, *axes: str):
        self.axes = axes

    def __enter__(self):
        _axis_stack().append(self.axes)
        return self

    def __exit__(self, *exc):
        _axis_stack().pop()


def current_axes() -> Tuple[str, ...]:
    out = []
    for axes in _axis_stack():
        out.extend(axes)
    return tuple(out)


def current_axis_name(preferred: str = None) -> Optional[str]:
    axes = current_axes()
    if not axes:
        return None
    if preferred is not None and preferred in axes:
        return preferred
    return axes[0]


# -- process-level rank info ------------------------------------------------

def get_rank() -> int:
    """PADDLE_TRAINER_ID, else the initialised process group's rank, else 0."""
    env = os.environ.get("PADDLE_TRAINER_ID")
    if env:
        return int(env)
    dist = _dist()
    return int(dist.get_rank()) if dist is not None else 0


def get_world_size() -> int:
    """PADDLE_TRAINERS_NUM, else the process group's size, else 1."""
    env = os.environ.get("PADDLE_TRAINERS_NUM")
    if env:
        return int(env)
    dist = _dist()
    return int(dist.get_world_size()) if dist is not None else 1


def device_count() -> int:
    """The devices a mesh can cover: the world's ranks, one device each
    (the JAX package counts jax.devices() of its one process)."""
    return get_world_size()

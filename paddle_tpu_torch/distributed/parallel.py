"""init_parallel_env and DataParallel (counterpart of
paddle_tpu/distributed/parallel.py) on torch.distributed.

The JAX package runs one process over all devices: DataParallel shards
the global batch over the dp axis and the partitioner all-reduces the
gradients of the global batch. The port runs one process per rank:
init_parallel_env starts the process group from the launcher's
environment (distributed/launch.py: MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE, LOCAL_RANK), each rank's forward takes its local batch, and
apply_collective_grads averages the gradients over dp, which gives the
global batch's gradients for a loss that is a mean over equal local
batches.
"""
from __future__ import annotations

import atexit
import os
import socket
import time
from typing import Optional

import torch

from ..nn.functional.norm import batch_stat_scope
from .collective import Group as _Group
from .env import (DATA_AXIS, axis_group, build_mesh, get_rank,
                  get_world_size, set_mesh)

__all__ = ["init_parallel_env", "start_process_group", "DataParallel",
           "ParallelEnv"]


def _env_int(*names, default=0) -> int:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_process_group(backend: Optional[str] = None):
    """Start this rank's process group from the launcher's environment,
    unless one runs.

    The rank, world size and local rank come from RANK/PADDLE_TRAINER_ID,
    WORLD_SIZE/PADDLE_TRAINERS_NUM and LOCAL_RANK/PADDLE_LOCAL_RANK, the
    rendezvous from MASTER_ADDR and MASTER_PORT (127.0.0.1 and a free
    port for a world of one). The backend is NCCL when the rank has a
    card, gloo otherwise; a rank with a card takes card LOCAL_RANK (the
    only one it sees under the launcher) as torch's current device and
    the port's. The group is destroyed at interpreter exit, if it still
    runs then."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    world = _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1)
    rank = _env_int("RANK", "PADDLE_TRAINER_ID", default=0)
    local = _env_int("LOCAL_RANK", "PADDLE_LOCAL_RANK", default=0)
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        from ..core.place import set_device
        card = local % torch.cuda.device_count()
        torch.cuda.set_device(card)
        set_device(f"gpu:{card}")
    addr = os.environ.get("MASTER_ADDR") or "127.0.0.1"
    port = os.environ.get("MASTER_PORT")
    if not port:
        if world > 1:
            raise RuntimeError(
                f"no MASTER_PORT for a world of {world}: start the ranks "
                "with python -m paddle_tpu_torch.distributed.launch")
        port = str(_free_port())
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    atexit.register(_destroy_at_exit)


#: seconds a rank waits at exit for its peers (to arrive, and, on the rank
#: that serves the store, to leave) before it tears down anyway: a peer
#: that crashed never arrives
EXIT_WAIT_S = 60.0


def _store_count(store, key, add, expect, deadline):
    """Add `add` to the store counter `key`, then wait until it reaches
    `expect` or `deadline` passes; True when it reached it."""
    n = store.add(key, add)
    while n < expect and time.monotonic() < deadline:
        time.sleep(0.005)
        n = store.add(key, 0)
    return n >= expect


def _destroy_at_exit():
    """Tear every process group down, threads and all, while the
    interpreter is still whole.

    destroy_process_group() only takes the groups out of torch's
    registry. A gloo group's C++ object, and with it its threads (a tcp
    loop and two workers a group, plus the store's server on rank 0),
    lives on while anything references it: the global mesh, every Mesh
    built over the world, the Groups of new_group, a TrainStep's or a
    DataParallel's groups held in a cycle. Those references died only in
    interpreter finalization, where the groups' destructors ran in
    whatever order teardown reached them, with their threads still
    running: now and then, under load, that aborted a rank whose work
    was done ("terminate called without an active exception", exit 250
    from the launcher). So: every rank arrives (a counter in the world's
    store) before any rank destroys its groups; the groups are destroyed,
    the port's references to them dropped and the cycles collected, which
    joins their threads here; and the rank that serves the store leaves
    last, once every rank has counted itself out."""
    import gc

    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return
    from torch.distributed import distributed_c10d as c10d
    from . import collective, env
    world, rank = dist.get_world_size(), dist.get_rank()
    store = c10d._get_default_store() if world > 1 else None
    deadline = time.monotonic() + EXIT_WAIT_S
    if store is not None:
        _store_count(store, "paddle_tpu_torch/exit/arrived", 1, world,
                     deadline)
    dist.destroy_process_group()
    env.set_mesh(None)
    for mesh in list(env._meshes_with_groups):
        mesh._drop_groups()
    for g in collective._groups.values():
        g.pg = None
    gc.collect()
    if store is not None:
        _store_count(store, "paddle_tpu_torch/exit/left", 1,
                     world if rank == 0 else 0, deadline)
        del store
        gc.collect()


def init_parallel_env(mesh_shape=None, backend: Optional[str] = None):
    """Start this rank's process group (start_process_group), then build
    and install the global mesh (default {"dp": world size})."""
    start_process_group(backend)
    set_mesh(build_mesh(mesh_shape))
    return ParallelEnv()


class ParallelEnv:
    """Reference fluid/dygraph/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return torch.cuda.current_device() if torch.cuda.is_available() \
            else 0

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return _env_int("LOCAL_RANK", "PADDLE_LOCAL_RANK", default=0)


def dp_average_(tensors, group=None) -> None:
    """Average each tensor over the dp ranks, in place (one all-reduce
    AVG a tensor; nothing without a dp group)."""
    from . import collective as _c
    pg = group if group is not None else axis_group(DATA_AXIS)
    if pg is None:
        return
    for t in tensors:
        _c._all_reduce_(t, _c.ReduceOp.AVG, pg)


def dp_max_(t, group=None) -> None:
    """`t` reduced with MAX over the dp ranks, in place."""
    from . import collective as _c
    pg = group if group is not None else axis_group(DATA_AXIS)
    if pg is not None:
        _c._all_reduce_(t, _c.ReduceOp.MAX, pg)


def dp_size(group=None) -> int:
    """The number of dp ranks (1 without a dp group)."""
    from . import collective as _c
    pg = group if group is not None else axis_group(DATA_AXIS)
    return 1 if pg is None else _c._size(pg)


class DataParallel(torch.nn.Module):
    """paddle.DataParallel: wrap a layer for data-parallel training.

    Wrapping broadcasts rank 0's parameters and buffers over dp, so the
    replicas start equal. Each rank's forward takes its local batch.
    After backward, apply_collective_grads averages every trainable
    parameter's grad over dp (one all-reduce a grad), or, with a
    ``comm_config`` (a comm.CommConfig), through the bucketed, planned,
    optionally quantized GradSynchronizer: its sum of the grads divided
    by the dp size first, with the int8_ef residuals kept across steps.
    A BatchNorm in the layer averages its batch moments over dp (the
    global batch's, as the JAX DataParallel's SPMD forward has them).
    scale_loss is the identity (the average is in the grads). With
    ``plan`` (a MeshPlan), the grads are averaged over the plan's data
    axes, dp and fsdp, and the replicas start equal over each."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, comm_config=None, plan=None):
        super().__init__()
        self._layers = layers
        # a MeshPlan: the plan's data axes (dp, fsdp) carry the batch, so
        # the grads are averaged over each; the layer keeps its whole
        # parameters (fsdp's sharded state is TrainStep's, sharding.py)
        self._plan = plan
        self.find_unused_parameters = find_unused_parameters
        self._group = group
        self._comm_sync = None
        self._comm_state = None
        if comm_config is not None:
            from .comm import CommConfig, GradSynchronizer
            if not isinstance(comm_config, CommConfig):
                raise TypeError(
                    f"comm_config must be a distributed.comm.CommConfig,"
                    f" got {type(comm_config).__name__}")
            self._comm_sync = GradSynchronizer(
                comm_config,
                group=group if isinstance(group, (str, _Group)) else None)
        self._sync_params()

    def _dp_group(self):
        g = self._group
        if g is None or isinstance(g, str):
            return axis_group(g or DATA_AXIS)
        return g.process_group if isinstance(g, _Group) else g

    def _data_groups(self):
        """The groups the grads are averaged over: the plan's data axes
        (dp, fsdp) on its mesh, else the dp group."""
        if self._plan is None:
            pg = self._dp_group()
            return [] if pg is None else [pg]
        mesh = self._plan.mesh
        return [mesh.group(a) for a in ("dp", "fsdp")
                if self._plan.sizes[a] > 1 and mesh.group(a) is not None]

    @torch.no_grad()
    def _sync_params(self):
        from . import collective as _c
        for pg in self._data_groups():
            for t in list(self._layers.parameters()) + \
                    list(self._layers.buffers()):
                _c.broadcast(t.data, src=0, group=pg)

    def forward(self, *inputs, **kwargs):
        """The layer on this rank's batch; a BatchNorm in it averages its
        batch moments over the data groups of more than one rank, so it
        normalises over the global batch as the JAX package's does."""
        groups = [pg for pg in self._data_groups() if dp_size(pg) > 1]
        with batch_stat_scope(groups):
            return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average every trainable parameter's grad over dp, in place."""
        named = [(k, p) for k, p in self._layers.named_parameters()
                 if p.requires_grad and p.grad is not None]
        if not named:
            return None
        if self._comm_sync is None:
            for pg in self._data_groups():
                dp_average_([p.grad for _, p in named], pg)
            return None
        pg = self._dp_group()
        n = dp_size(pg)
        grads = {k: p.grad / n if n > 1 else p.grad for k, p in named}
        if self._comm_state is None:
            self._comm_state = self._comm_sync.init_state(grads)
        synced, self._comm_state = self._comm_sync(grads, self._comm_state)
        for k, p in named:
            p.grad.copy_(synced[k])
        return None

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        return self._layers.set_state_dict(state_dict, *a, **k)

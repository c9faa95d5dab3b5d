"""Distributed (counterpart of paddle_tpu/distributed) on
torch.distributed: one process per rank, NCCL on the card, gloo on the
CPU.

- env.py: the mesh over the world's ranks (a process group per axis),
  the axis context, rank and world;
- collective.py: the collectives, each resolving its group from the
  call, the axis context, then the world;
- comm.py: the gradient-sync planner (buckets, algorithms, bf16 and
  int8-EF wire tiers);
- parallel.py: init_parallel_env and DataParallel; shard_map_util.py:
  shard_parallel; rendezvous.py: the rank-0 bootstrap;
- fleet/: the strategy, the meta-optimizers, the fleet metrics and
  utilities;
- activation recomputation, and the elastic plane: checkpoints
  (checkpoint.py), the supervisor's state machine (elastic.py), chaos
  hooks (chaos.py), the launcher (launch.py) and its drill worker
  (elastic_worker.py).

The planner (MeshPlan, sharding.py) and the parallel forms (pipeline,
ring attention, MoE, parallel layers, the parameter server) come with
ROADMAP.md item 14.
"""
from . import chaos, checkpoint, elastic  # noqa: F401
from . import fleet  # noqa: F401
from .collective import (ReduceOp, Group, all_gather, all_reduce,  # noqa: F401
                         alltoall, all_to_all, barrier, broadcast,
                         get_group, new_group, p2p_shift, recv, reduce,
                         reduce_scatter, scatter, send, wait)
from .comm import (CommConfig, GradSynchronizer,  # noqa: F401
                   ParamSynchronizer, planned_all_reduce)
from .env import (Mesh, build_mesh, ensure_mesh, get_mesh,  # noqa: F401
                  set_mesh, get_rank, get_world_size, axis_context,
                  current_axis_name, DATA_AXIS, TENSOR_AXIS, PIPE_AXIS,
                  SEQUENCE_AXIS, EXPERT_AXIS)
from .parallel import (DataParallel, ParallelEnv,  # noqa: F401
                       init_parallel_env)
from .recompute import (RecomputeFunction, recompute,  # noqa: F401
                        recompute_sequential)
from .shard_map_util import (P, PartitionSpec,  # noqa: F401
                             shard_parallel, sp_shard_map)


def get_world_size_compat():
    return get_world_size()


def spawn(func, args=(), nprocs=-1, **kwargs):
    """paddle.distributed.spawn: in this process, init_parallel_env and
    then func(*args). Several ranks start through
    python -m paddle_tpu_torch.distributed.launch."""
    init_parallel_env()
    return func(*args)

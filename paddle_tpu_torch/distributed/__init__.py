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
- sharding.py: ShardingPlan and the MeshPlan planner (specs, the cost
  model, layout="auto");
- the parallel forms: parallel_layers.py (tensor parallel), moe.py
  (experts over ep), ring.py (ring and Ulysses attention over sp);
- fleet/: the strategy, the meta-optimizers, the fleet metrics and
  utilities;
- activation recomputation, and the elastic plane: checkpoints
  (checkpoint.py), the supervisor's state machine (elastic.py), chaos
  hooks (chaos.py), the launcher (launch.py) and its drill worker
  (elastic_worker.py).

The pipeline (pipeline.py, pipeline_engine.py) comes with ROADMAP.md
item 14b, the parameter-server pair (async_ps.py, embedding_kv.py)
with item 14c.
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
from .moe import MoELayer, moe_dispatch  # noqa: F401
from .parallel import (DataParallel, ParallelEnv,  # noqa: F401
                       init_parallel_env)
from .parallel_layers import (ColumnParallelLinear,  # noqa: F401
                              RowParallelLinear, VocabParallelEmbedding,
                              split)
from .recompute import (RecomputeFunction, recompute,  # noqa: F401
                        recompute_sequential)
from .ring import (RingAttention, ring_flash_attention,  # noqa: F401
                   ulysses_attention)
from .shard_map_util import (P, PartitionSpec,  # noqa: F401
                             shard_parallel, sp_shard_map)
from .sharding import (NamedSharding, ShardingPlan, MeshPlan,  # noqa: F401
                       ModelDims, LayoutCost, candidate_layouts,
                       choose_layout, estimate_layout, shard_tensor)


def get_world_size_compat():
    return get_world_size()


def spawn(func, args=(), nprocs=-1, **kwargs):
    """paddle.distributed.spawn: in this process, init_parallel_env and
    then func(*args). Several ranks start through
    python -m paddle_tpu_torch.distributed.launch."""
    init_parallel_env()
    return func(*args)

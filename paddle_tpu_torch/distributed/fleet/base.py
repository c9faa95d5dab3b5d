"""Fleet facade: init, the strategy, distributed_optimizer and
distributed_model (counterpart of paddle_tpu/distributed/fleet/base.py).

Reference: fleet_base.py (Fleet), base/distributed_strategy.py,
base/strategy_compiler.py and meta_optimizers/. The chosen strategies
compose into a mesh shape over the world's ranks and TrainStep options
(meta_optimizers.py):

  amp_optimizer            -> TrainStep(amp_level=...)
  recompute_optimizer      -> TrainStep(remat=True)
  gradient_merge           -> TrainStep(grad_accum_steps=...)
  graph_execution (DP)     -> TrainStep(mesh=<dp>): the dp average
  dgc/fp16_allreduce/comm  -> TrainStep(grad_transform=...)
  localsgd                 -> LocalSGDStep
  lars/lamb                -> the optimizer swapped
  sharding                 -> TrainStep(sharding_plan=<ZeRO stage>)
  tensor_parallel          -> the mesh's tp axis (the layers' annotations)
  pipeline above degree 1  -> ROADMAP.md item 14b
"""
from __future__ import annotations

from typing import Dict, Optional

from ..env import (DATA_AXIS, PIPE_AXIS, SEQUENCE_AXIS, TENSOR_AXIS,
                   build_mesh, get_rank, get_world_size, set_mesh)

__all__ = ["DistributedStrategy", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "fleet", "init", "worker_num",
           "worker_index", "is_first_worker", "distributed_optimizer",
           "distributed_model", "DistributedOptimizer", "Fleet"]


def _item14b(what):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with ROADMAP.md item 14b "
        "(the pipeline: pipeline.py, pipeline_engine.py)")


class DistributedStrategy:
    """The python surface of distributed_strategy.proto."""

    def __init__(self):
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_fp16": False,
                            "custom_white_list": [],
                            "custom_black_list": []}
        self.recompute = False
        self.recompute_configs = {"checkpoints": [], "enable_offload": False}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "fuse_broadcast_MB": 32.0,
                                 "hybrid_dp": False}
        self.pipeline = False
        self.pipeline_configs = {"micro_batch_size": 1,
                                 "accumulate_steps": 1}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.hybrid_configs = {"dp_degree": -1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "fsdp_degree": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01}
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001,
                             "lars_weight_decay": 0.0005}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = {"init_k_steps": 1,
                                          "begin_step": 1}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "rampup_step": 1,
                            "sparsity": [0.999]}
        self.fp16_allreduce = False
        # the comm planner (distributed/comm.py) as a strategy: compress
        # picks the wire tier (f32|bf16|int8_ef), algorithm forces one
        # (auto|flat|rs_ag|hierarchical), hierarchy names the factored
        # mesh axes
        self.comm_opt = False
        self.comm_opt_configs = {"algorithm": "auto", "bucket_mb": 4.0,
                                 "compress": "f32",
                                 "flat_threshold_kb": 128,
                                 "hierarchy": None, "int8_block": 256}
        # the parameter-server consistency mode (AsyncConfig); read by
        # the parameter-server pair, which comes with ROADMAP.md item 14c
        self.a_sync = False
        self.a_sync_configs = {"k_steps": 0, "max_merge_var_num": 20,
                               "send_queue_size": 16,
                               "independent_recv_thread": False,
                               "thread_pool_size": 1,
                               "send_wait_times": 1,
                               "launch_barrier": True}
        self.find_unused_parameters = False
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.nccl_comm_num = 1
        self.fuse_all_reduce_ops = True
        self.execution_strategy = {}
        self.build_strategy = {}

    def mesh_shape(self, n_devices: int) -> Dict[str, int]:
        """The named mesh from the hybrid and strategy degrees, over
        `n_devices` ranks."""
        h = self.hybrid_configs
        mp = max(int(h.get("mp_degree", 1)), 1)
        if self.tensor_parallel:
            mp = max(mp, int(self.tensor_parallel_configs.get(
                "tensor_parallel_degree", 1)))
        pp = max(int(h.get("pp_degree", 1)), 1) if (
            self.pipeline or h.get("pp_degree", 1) > 1) else 1
        sp = max(int(h.get("sep_degree", 1)), 1)
        fsdp = max(int(h.get("fsdp_degree", 1)), 1)
        dp = h.get("dp_degree", -1)
        if dp in (-1, 0, None):
            dp = max(n_devices // (mp * pp * sp * fsdp), 1)
        shape = {}
        if dp > 1 or (mp == pp == sp == fsdp == 1):
            shape[DATA_AXIS] = dp
        if fsdp > 1:
            shape["fsdp"] = fsdp
        if mp > 1:
            shape[TENSOR_AXIS] = mp
        if pp > 1:
            shape[PIPE_AXIS] = pp
        if sp > 1:
            shape[SEQUENCE_AXIS] = sp
        return shape

    def mesh_plan(self, n_devices: int, rules=None):
        """The strategy's degrees as one MeshPlan declaration
        (Fleet.build_mesh_plan adds the layout='auto' path)."""
        from ..sharding import MeshPlan
        shape = self.mesh_shape(n_devices)
        return MeshPlan(dp=shape.get(DATA_AXIS, 1),
                        fsdp=shape.get("fsdp", 1),
                        tp=shape.get(TENSOR_AXIS, 1),
                        pp=shape.get(PIPE_AXIS, 1), rules=rules)

    def __repr__(self):
        on = [k for k in ("amp", "recompute", "sharding", "pipeline",
                          "tensor_parallel", "gradient_merge", "lamb",
                          "lars", "localsgd", "dgc", "comm_opt")
              if getattr(self, k)]
        return f"DistributedStrategy(enabled={on})"


class RoleMakerBase:
    def worker_num(self):
        return get_world_size()

    def worker_index(self):
        return get_rank()

    def is_worker(self):
        return True

    def is_first_worker(self):
        return get_rank() == 0


class PaddleCloudRoleMaker(RoleMakerBase):
    """The environment-driven role maker (reference base/role_maker.py)."""

    def __init__(self, is_collective=True, **kwargs):
        self.is_collective = is_collective


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, worker_num=1, **kwargs):
        self._id = current_id
        self._num = worker_num

    def worker_index(self):
        return self._id

    def worker_num(self):
        return self._num


class DistributedOptimizer:
    """The user's optimizer with the strategy: step and minimize work as
    usual (after DataParallel.apply_collective_grads); build_train_step
    compiles the strategy into a step."""

    def __init__(self, optimizer, strategy: DistributedStrategy):
        self.inner_opt = optimizer
        self.user_defined_strategy = strategy

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)

    def step(self):
        return self.inner_opt.step()

    def clear_grad(self, *a, **k):
        return self.inner_opt.clear_grad(*a, **k)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self.inner_opt.minimize(loss, startup_program, parameters,
                                       no_grad_set)

    def build_train_step(self, layer, loss_fn):
        return fleet.build_train_step(layer, loss_fn, self.inner_opt,
                                      self.user_defined_strategy)


class Fleet:
    """The singleton facade (reference fleet_base.py)."""

    def __init__(self):
        self._role_maker = None
        self.strategy: Optional[DistributedStrategy] = None
        self._is_collective = True
        self.mesh = None
        self._initialized = False

    def init(self, role_maker=None, is_collective=False, strategy=None):
        """Set the role maker and the strategy, start the process group
        when the launcher's environment names a world of more than one
        rank and none runs yet, and install the strategy's mesh over the
        world's ranks."""
        from ..parallel import start_process_group
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._is_collective = is_collective or isinstance(
            role_maker, PaddleCloudRoleMaker)
        self.strategy = strategy or DistributedStrategy()
        if get_world_size() > 1:
            start_process_group()
        self.mesh = build_mesh(self.strategy.mesh_shape(get_world_size()))
        set_mesh(self.mesh)
        self._initialized = True
        return self

    # -- role info ----------------------------------------------------------
    def worker_num(self):
        return self._role_maker.worker_num() if self._role_maker else 1

    def worker_index(self):
        return self._role_maker.worker_index() if self._role_maker else 0

    def is_first_worker(self):
        return self.worker_index() == 0

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def barrier_worker(self):
        from ..collective import barrier
        barrier()

    # -- model and optimizer --------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self.strategy = strategy
        return DistributedOptimizer(optimizer,
                                    self.strategy or DistributedStrategy())

    def distributed_model(self, model):
        from ..parallel import DataParallel
        return DataParallel(model)

    def build_mesh_plan(self, strategy=None, rules=None, dims=None,
                        hbm_bytes_per_chip=None, layout=None, num_micro=4):
        """One MeshPlan from the strategy's hybrid degrees over the
        world's ranks, or, with layout='auto', ModelDims and an HBM
        budget, from the cost model (sharding.choose_layout)."""
        from ..sharding import MeshPlan
        strategy = strategy or self.strategy or DistributedStrategy()
        n = get_world_size()
        if layout == "auto":
            if dims is None or hbm_bytes_per_chip is None:
                raise ValueError(
                    "layout='auto' needs dims= (ModelDims) and "
                    "hbm_bytes_per_chip= — the cost model scores "
                    "layouts against the model's bytes and the chip's "
                    "memory")
            compress = "none"
            if strategy.comm_opt:
                compress = strategy.comm_opt_configs.get(
                    "compress", "none")
            return MeshPlan.auto(n, dims, hbm_bytes_per_chip,
                                 rules=rules, compress=compress,
                                 num_micro=num_micro)
        return strategy.mesh_plan(n, rules=rules)

    def build_pipeline(self, stages, loss_fn, optimizer, strategy=None,
                       schedule="spmd_1f1b", exec_mode=None, plan=None):
        raise _item14b("Fleet.build_pipeline")

    def build_sharding_plan(self, strategy=None):
        """A ShardingPlan over the fleet's mesh: the strategy's ZeRO
        stage, and the fsdp axis when the mesh has one."""
        from ..sharding import ShardingPlan
        strategy = strategy or self.strategy or DistributedStrategy()
        if self.mesh is None:
            self.init(strategy=strategy)
        zero = 0
        if strategy.sharding:
            zero = int(strategy.sharding_configs.get("stage", 1))
        fsdp = "fsdp" if "fsdp" in self.mesh.axis_names else None
        return ShardingPlan(self.mesh, zero_stage=zero, fsdp_axis=fsdp)

    def build_train_step(self, layer, loss_fn, optimizer, strategy=None):
        """The strategy compiler: the compatible meta-optimizer chain
        rewrites a TrainStepSpec, then one step is built over the mesh."""
        from .meta_optimizers import (StrategyCompiler, TrainStepSpec,
                                      build_from_spec)
        strategy = strategy or self.strategy or DistributedStrategy()
        if not self._initialized:
            self.init()
        inner = optimizer.inner_opt if isinstance(
            optimizer, DistributedOptimizer) else optimizer
        spec = TrainStepSpec(layer=layer, loss_fn=loss_fn, optimizer=inner)
        StrategyCompiler().compile(spec, strategy, self)
        self._last_applied = list(spec.applied)
        # the one source of the zero stage: the compiled spec
        from ..sharding import ShardingPlan
        plan = ShardingPlan(
            self.mesh, zero_stage=spec.zero_stage,
            fsdp_axis="fsdp" if "fsdp" in self.mesh.axis_names else None)
        return build_from_spec(spec, mesh=self.mesh, sharding_plan=plan)

    def state_dict(self):
        return {}

    def stop_worker(self):
        pass


fleet = Fleet()


# module-level conveniences, as paddle.distributed.fleet.* has them
def init(role_maker=None, is_collective=False, strategy=None):
    return fleet.init(role_maker, is_collective, strategy)


def worker_num():
    return fleet.worker_num()


def worker_index():
    return fleet.worker_index()


def is_first_worker():
    return fleet.is_first_worker()


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def distributed_model(model):
    return fleet.distributed_model(model)

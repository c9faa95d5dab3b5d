"""Fleet meta-optimizers and the StrategyCompiler (counterpart of
paddle_tpu/distributed/fleet/meta_optimizers.py).

Reference: python/paddle/distributed/fleet/meta_optimizers/ and
base/strategy_compiler.py (generate_optimizer picks a compatible chain).
A meta-optimizer is a transform over a TrainStepSpec, the recipe one
TrainStep is built from:
  - allreduce insertion      -> TrainStep(mesh=): the dp average
  - cast-op insertion (AMP)  -> amp_level on the forward
  - gradient merge           -> grad_accum_steps
  - DGC / fp16-allreduce / comm sync -> a grad_transform between the
                                backward and the update
  - LocalSGD                 -> LocalSGDStep: a replica per rank,
                                parameters averaged every k steps

The chain's order and its conflict resolution are the JAX package's.
The sharding meta-optimizer sets the ZeRO stage of the step's
ShardingPlan and the tensor-parallel one leaves the tp axis to the
mesh, as in the JAX package; the pipeline meta-optimizer raises
NotImplementedError above degree 1: a pp axis over ranks comes with
ROADMAP.md item 14d (the SPMD pipeline; the host-driven engine is
Fleet.build_pipeline).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["TrainStepSpec", "MetaOptimizerBase", "StrategyCompiler",
           "META_OPTIMIZERS", "LocalSGDStep", "make_dgc_transform",
           "make_fp16_allreduce_transform", "make_comm_sync_transform",
           "chain_grad_transforms", "build_from_spec"]


def _item14d(what):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with ROADMAP.md item 14d "
        "(the SPMD pipeline)")


@dataclasses.dataclass
class TrainStepSpec:
    """The train-step recipe the meta-optimizer chain rewrites."""
    layer: Any
    loss_fn: Callable
    optimizer: Any
    amp_level: Optional[str] = None
    amp_dtype: str = "bfloat16"
    scaler: Any = None  # amp.GradScaler -> in-step loss scaling
    grad_accum_steps: int = 1
    zero_stage: int = 0
    remat: bool = False
    remat_policy: Any = None
    sharding_rules: Optional[Dict[str, Any]] = None
    # list of (name, init_fn(params)->state, fn(grads, state, params)
    #          -> (grads, state))
    grad_transforms: List[Tuple[str, Callable, Callable]] = \
        dataclasses.field(default_factory=list)
    localsgd_k_steps: int = 0      # >0 => the replica-mode LocalSGD step
    localsgd_begin_step: int = 1   # sync every step until this step count
    localsgd_adaptive: bool = False  # adapt k to the loss trajectory
    applied: List[str] = dataclasses.field(default_factory=list)


def chain_grad_transforms(transforms):
    """Compose [(name, init, fn), ...] into one (init, fn) pair keyed by
    transform name in the strategy-state dict. The chained fn carries
    ``syncs_dp_grads`` when a member does (it then does the dp
    reduction)."""
    if not transforms:
        return None, None

    def init(params):
        return {name: ini(params) for name, ini, _ in transforms}

    def fn(grads, state, params):
        state = dict(state)
        for name, _, f in transforms:
            grads, state[name] = f(grads, state[name], params)
        return grads, state
    fn.syncs_dp_grads = any(getattr(f, "syncs_dp_grads", False)
                            for _, _, f in transforms)
    return init, fn


# -- grad transforms ------------------------------------------------------------

def make_dgc_transform(sparsity=0.999, momentum: float = 0.9,
                       rampup_begin_step: int = 0, rampup_step: int = 1):
    """Deep Gradient Compression (reference dgc_op + dgc_optimizer.py):
    momentum correction, error feedback and top-k selection. Before
    rampup_begin_step grads pass uncompressed (momentum-corrected); over
    the next rampup_step steps the sparsity walks the `sparsity` stages.
    Only the top (1 - sparsity) of the corrected gradient mass flows to
    the optimizer each step; the rest accumulates. Every stage's top-k
    threshold is computed and the step's stage picked on the device (no
    host read, so the transform runs inside a captured step)."""
    stages = list(sparsity) if isinstance(sparsity, (list, tuple)) \
        else [float(sparsity)]
    rampup_step = max(1, int(rampup_step))

    def init(params):
        dev = next(iter(params.values())).device if params else None
        return {"u": {k: torch.zeros_like(v) for k, v in params.items()},
                "e": {k: torch.zeros_like(v) for k, v in params.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def one(g, u, e, stage_idx, compress):
        u = momentum * u + g
        e_acc = e + u
        flat = e_acc.abs().reshape(-1)
        ks = [max(1, int(round(flat.numel() * (1.0 - s)))) for s in stages]
        thr = torch.stack([torch.topk(flat, k).values[-1]
                           for k in ks])[stage_idx]
        mask = (e_acc.abs() >= thr).to(g.dtype)
        out = torch.where(compress, e_acc * mask, u)
        new_u = torch.where(compress, u * (1.0 - mask), u)
        new_e = torch.where(compress, e_acc * (1.0 - mask), e)
        return out, new_u, new_e

    def fn(grads, state, params):
        step = state["step"]
        compress = step >= rampup_begin_step
        per_stage = max(1, rampup_step // len(stages))
        stage_idx = torch.clamp(torch.div(step - rampup_begin_step,
                                          per_stage, rounding_mode="floor"),
                                0, len(stages) - 1).long()
        outs, new_u, new_e = {}, {}, {}
        for name, g in grads.items():
            outs[name], new_u[name], new_e[name] = one(
                g, state["u"][name], state["e"][name], stage_idx, compress)
        return outs, {"u": new_u, "e": new_e, "step": step + 1}
    return init, fn


def make_fp16_allreduce_transform(dtype=torch.bfloat16):
    """fp16_allreduce_optimizer.py: grads cross the wire in half
    precision. The semantic kept is the precision of the exchanged
    gradient (a cast there and back); the dp sum itself is the step's."""

    def init(params):
        return {}

    def fn(grads, state, params):
        return {k: g.to(dtype).to(torch.float32) if g.is_floating_point()
                else g for k, g in grads.items()}, state
    return init, fn


def make_comm_sync_transform(config=None, axes=None):
    """The comm planner as a grad transform: grads fused into buckets and
    summed over dp with the planned algorithm and wire tier, the int8_ef
    residuals riding the strategy state. Returns (init, fn); fn is marked
    ``syncs_dp_grads``, so a TrainStep over a dp mesh lets it do the dp
    reduction (of grads divided by the dp size)."""
    from ..comm import GradSynchronizer
    return GradSynchronizer(config, axes=axes).as_grad_transform()


# -- meta-optimizers ------------------------------------------------------------

class MetaOptimizerBase:
    """One strategy transform. `order` fixes its place in the chain;
    `conflicts` are the reference's compatibility rules."""
    name = "base"
    order = 0
    conflicts: Tuple[str, ...] = ()

    def can_apply(self, strategy) -> bool:
        raise NotImplementedError

    def apply(self, spec: TrainStepSpec, strategy, fleet=None) -> None:
        raise NotImplementedError

    def disable(self, strategy) -> None:
        if hasattr(strategy, self.name):
            setattr(strategy, self.name, False)


class RecomputeOptimizer(MetaOptimizerBase):
    name = "recompute"
    order = 10

    def can_apply(self, strategy):
        return strategy.recompute

    def apply(self, spec, strategy, fleet=None):
        spec.remat = True
        # offload: save nothing, recompute everything; else keep the
        # matmul outputs
        spec.remat_policy = "nothing_saveable" if \
            strategy.recompute_configs.get("enable_offload") else \
            "checkpoint_dots"
        spec.applied.append(self.name)


class AMPOptimizer(MetaOptimizerBase):
    name = "amp"
    order = 20

    def can_apply(self, strategy):
        return strategy.amp

    def apply(self, spec, strategy, fleet=None):
        cfg = strategy.amp_configs
        pure = cfg.get("use_pure_fp16")
        spec.amp_level = "O2" if pure else "O1"
        if pure:
            spec.amp_dtype = "float16"
            # loss scaling is an fp16 mechanism (amp_optimizer.py's
            # check_finite/update_loss_scaling), compiled into the step
            from ...amp import GradScaler
            spec.scaler = GradScaler(
                init_loss_scaling=float(
                    cfg.get("init_loss_scaling", 32768.0)),
                incr_every_n_steps=int(
                    cfg.get("incr_every_n_steps", 1000)),
                decr_every_n_nan_or_inf=int(
                    cfg.get("decr_every_n_nan_or_inf", 2)),
                incr_ratio=float(cfg.get("incr_ratio", 2.0)),
                decr_ratio=float(cfg.get("decr_ratio", 0.5)),
                use_dynamic_loss_scaling=bool(
                    cfg.get("use_dynamic_loss_scaling", True)))
        spec.applied.append(self.name)


class ShardingOptimizer(MetaOptimizerBase):
    name = "sharding"
    order = 30
    conflicts = ("localsgd",)

    def can_apply(self, strategy):
        return strategy.sharding

    def apply(self, spec, strategy, fleet=None):
        spec.zero_stage = int(strategy.sharding_configs.get("stage", 1))
        spec.applied.append(self.name)


class TensorParallelOptimizer(MetaOptimizerBase):
    name = "tensor_parallel"
    order = 40
    conflicts = ("localsgd",)

    def can_apply(self, strategy):
        return strategy.tensor_parallel or \
            strategy.hybrid_configs.get("mp_degree", 1) > 1

    def apply(self, spec, strategy, fleet=None):
        spec.applied.append(self.name)  # the tp axis: mesh_shape()


class PipelineOptimizer(MetaOptimizerBase):
    name = "pipeline"
    order = 50
    conflicts = ("localsgd",)

    def can_apply(self, strategy):
        return strategy.pipeline

    def apply(self, spec, strategy, fleet=None):
        degree = int(strategy.hybrid_configs.get("pp_degree", 1))
        if degree > 1:
            raise _item14d(f"the pipeline meta-optimizer (degree {degree})")
        spec.grad_accum_steps = max(
            spec.grad_accum_steps,
            int(strategy.pipeline_configs.get("accumulate_steps", 1)))
        spec.applied.append(self.name)


class GradientMergeOptimizer(MetaOptimizerBase):
    name = "gradient_merge"
    order = 60

    def can_apply(self, strategy):
        return strategy.gradient_merge

    def apply(self, spec, strategy, fleet=None):
        spec.grad_accum_steps = max(
            spec.grad_accum_steps,
            int(strategy.gradient_merge_configs.get("k_steps", 1)))
        spec.applied.append(self.name)


class DGCOptimizer(MetaOptimizerBase):
    name = "dgc"
    order = 70
    # reference dgc_optimizer._can_apply: momentum family only, and off
    # under AMP
    conflicts = ("amp", "fp16_allreduce", "localsgd")

    def can_apply(self, strategy):
        return strategy.dgc

    def apply(self, spec, strategy, fleet=None):
        cfg = getattr(strategy, "dgc_configs", None) or {}
        from ...optimizer import SGD, Momentum
        opt = spec.optimizer
        if not isinstance(opt, (SGD, Momentum)):
            # DGC's own momentum would stack on another optimizer's
            import warnings
            warnings.warn(
                f"DGC requires a Momentum/SGD inner optimizer, got "
                f"{type(opt).__name__}; disabling dgc")
            return
        momentum = 0.9
        if isinstance(opt, Momentum):
            # DGC owns the momentum: the update becomes plain SGD
            momentum = float(getattr(opt, "_momentum", 0.9))
            spec.optimizer = SGD(learning_rate=opt.get_lr(),
                                 parameters=opt._parameters)
        init, fn = make_dgc_transform(
            sparsity=cfg.get("sparsity", [0.999]),
            momentum=float(cfg.get("momentum", momentum)),
            rampup_begin_step=int(cfg.get("rampup_begin_step", 0)),
            rampup_step=int(cfg.get("rampup_step", 1)))
        spec.grad_transforms.append((self.name, init, fn))
        spec.applied.append(self.name)


class FP16AllReduceOptimizer(MetaOptimizerBase):
    name = "fp16_allreduce"
    order = 75
    conflicts = ("dgc",)

    def can_apply(self, strategy):
        return strategy.fp16_allreduce

    def apply(self, spec, strategy, fleet=None):
        init, fn = make_fp16_allreduce_transform()
        spec.grad_transforms.append((self.name, init, fn))
        spec.applied.append(self.name)


class CommOptimizer(MetaOptimizerBase):
    """strategy.comm_opt -> the comm planner's gradient sync. DGC and
    fp16_allreduce already own the grad wire (two compressions would
    quantize twice), and LocalSGD's replica step has no transform."""
    name = "comm_opt"
    order = 74
    conflicts = ("dgc", "fp16_allreduce", "localsgd")

    def can_apply(self, strategy):
        return getattr(strategy, "comm_opt", False)

    def apply(self, spec, strategy, fleet=None):
        from ..comm import CommConfig
        cfg = getattr(strategy, "comm_opt_configs", None) or {}
        hierarchy = cfg.get("hierarchy")
        config = CommConfig(
            algorithm=str(cfg.get("algorithm", "auto")),
            bucket_bytes=int(float(cfg.get("bucket_mb", 4.0)) * (1 << 20)),
            compress=str(cfg.get("compress", "f32")),
            flat_threshold=int(cfg.get("flat_threshold_kb", 128)) << 10,
            hierarchy=tuple(hierarchy) if hierarchy else None,
            int8_block=int(cfg.get("int8_block", 256)))
        init, fn = make_comm_sync_transform(config)
        spec.grad_transforms.append((self.name, init, fn))
        spec.applied.append(self.name)


class LocalSGDOptimizer(MetaOptimizerBase):
    name = "localsgd"
    order = 80
    conflicts = ("sharding", "pipeline", "dgc", "tensor_parallel",
                 "gradient_merge", "fp16_allreduce")

    def can_apply(self, strategy):
        return strategy.localsgd

    def apply(self, spec, strategy, fleet=None):
        cfg = getattr(strategy, "localsgd_configs", None) or {}
        spec.localsgd_k_steps = max(1, int(cfg.get("k_steps", 1)))
        spec.localsgd_begin_step = max(1, int(cfg.get("begin_step", 1)))
        spec.applied.append(self.name)


class AdaptiveLocalSGDOptimizer(MetaOptimizerBase):
    """LocalSGD whose sync period follows the loss: often early, rarely
    later (reference AdaptiveLocalSGDOptimizer)."""
    name = "adaptive_localsgd"
    order = 81
    conflicts = ("sharding", "pipeline", "dgc", "tensor_parallel",
                 "gradient_merge", "fp16_allreduce", "localsgd")

    def can_apply(self, strategy):
        return getattr(strategy, "adaptive_localsgd", False)

    def apply(self, spec, strategy, fleet=None):
        cfg = getattr(strategy, "adaptive_localsgd_configs", None) or {}
        spec.localsgd_k_steps = max(1, int(cfg.get("init_k_steps", 1)))
        spec.localsgd_begin_step = max(1, int(cfg.get("begin_step", 1)))
        spec.localsgd_adaptive = True
        spec.applied.append(self.name)


class LambOptimizer(MetaOptimizerBase):
    name = "lamb"
    order = 90
    conflicts = ("lars", "dgc")

    def can_apply(self, strategy):
        return strategy.lamb

    def apply(self, spec, strategy, fleet=None):
        from ...optimizer import Lamb
        opt = spec.optimizer
        cfg = getattr(strategy, "lamb_configs", {})
        spec.optimizer = Lamb(
            learning_rate=opt.get_lr(), parameters=opt._parameters,
            lamb_weight_decay=float(cfg.get("lamb_weight_decay", 0.01)))
        spec.applied.append(self.name)


class LarsOptimizer(MetaOptimizerBase):
    name = "lars"
    order = 91
    conflicts = ("lamb", "dgc")

    def can_apply(self, strategy):
        return strategy.lars

    def apply(self, spec, strategy, fleet=None):
        from ...optimizer import Lars
        opt = spec.optimizer
        cfg = getattr(strategy, "lars_configs", {})
        spec.optimizer = Lars(
            learning_rate=opt.get_lr(), parameters=opt._parameters,
            lars_coeff=float(cfg.get("lars_coeff", 0.001)),
            lars_weight_decay=float(cfg.get("lars_weight_decay", 0.0005)))
        spec.applied.append(self.name)


class GraphExecutionOptimizer(MetaOptimizerBase):
    """The always-on dp terminal (graph_execution_optimizer.py): dp is the
    mesh's dp axis, averaged inside the TrainStep."""
    name = "graph_execution"
    order = 100

    def can_apply(self, strategy):
        return True

    def apply(self, spec, strategy, fleet=None):
        spec.applied.append(self.name)


META_OPTIMIZERS: List[MetaOptimizerBase] = [
    RecomputeOptimizer(), AMPOptimizer(), ShardingOptimizer(),
    TensorParallelOptimizer(), PipelineOptimizer(),
    GradientMergeOptimizer(), DGCOptimizer(), CommOptimizer(),
    FP16AllReduceOptimizer(),
    LocalSGDOptimizer(), AdaptiveLocalSGDOptimizer(), LambOptimizer(),
    LarsOptimizer(), GraphExecutionOptimizer(),
]


class StrategyCompiler:
    """The longest mutually compatible meta-optimizer chain
    (strategy_compiler.py maximum_path_len_algo): applicable transforms
    in chain order; a later one that conflicts is dropped and its
    strategy flag disabled."""

    def generate_optimizer(self, strategy) -> List[MetaOptimizerBase]:
        applicable = [m for m in META_OPTIMIZERS if m.can_apply(strategy)]
        chain: List[MetaOptimizerBase] = []
        for m in sorted(applicable, key=lambda m: m.order):
            clash = any(m.name in c.conflicts or c.name in m.conflicts
                        for c in chain)
            if clash:
                m.disable(strategy)
                continue
            chain.append(m)
        return chain

    def compile(self, spec: TrainStepSpec, strategy,
                fleet=None) -> TrainStepSpec:
        for m in self.generate_optimizer(strategy):
            m.apply(spec, strategy, fleet)
        return spec


# -- LocalSGD -------------------------------------------------------------------

class LocalSGDStep:
    """localsgd_optimizer.py over torch.distributed: each dp rank is one
    replica, keeps its own parameters and optimizer state and steps on
    its local batch; every k steps (every step before begin_step) the
    parameters are averaged over dp, in place. The JAX package holds the
    replicas as a dp-sharded leading axis and vmaps the step over it.
    Returns the replicas' mean loss. With ``adaptive`` the period follows
    the loss: k = ceil(k0 * sqrt(loss / loss_0)), clamped to
    [1, max_k_steps], recomputed at each average."""

    def __init__(self, layer, loss_fn, optimizer, k_steps: int = 4,
                 mesh=None, dp_axis: str = "dp", begin_step: int = 1,
                 amp_level=None, amp_dtype="bfloat16", remat=False,
                 remat_policy=None, adaptive: bool = False,
                 max_k_steps: int = 16):
        from ...static.train_step import TrainStep
        self.inner = TrainStep(layer, loss_fn, optimizer, donate=False,
                               amp_level=amp_level, amp_dtype=amp_dtype,
                               remat=remat, remat_policy=remat_policy)
        self.k_steps = max(1, int(k_steps))
        self.init_k_steps = self.k_steps
        self.begin_step = max(1, int(begin_step))
        self.adaptive = adaptive
        self.max_k_steps = max_k_steps
        self._loss0 = None
        self.mesh = mesh
        self.optimizer = optimizer
        self.dp_axis = dp_axis
        self._group = mesh.group(dp_axis) if (
            mesh is not None and dp_axis in mesh) else None
        from ..parallel import dp_size
        self.dp = dp_size(self._group) if self._group is not None else 1
        self.params = self.inner.params
        self._calls = 0

    def __call__(self, inputs, labels=()):
        from ..parallel import dp_average_
        self._calls += 1
        if self._calls < self.begin_step:
            average = True
        else:
            average = ((self._calls - self.begin_step + 1)
                       % self.k_steps) == 0
        loss = self.inner(inputs, labels)
        if self._group is not None:
            loss = loss.clone()
            dp_average_([loss], self._group)
            if average:
                with torch.no_grad():
                    dp_average_([p.data for p in self.params], self._group)
        if self.adaptive and average:
            lt = float(loss)
            if self._loss0 is None:
                self._loss0 = max(lt, 1e-12)
            ratio = max(lt, 0.0) / self._loss0
            self.k_steps = int(np.clip(
                np.ceil(self.init_k_steps * np.sqrt(ratio)),
                1, self.max_k_steps))
        return loss


def build_from_spec(spec: TrainStepSpec, mesh=None, sharding_plan=None):
    """The compiled spec as a step object: a LocalSGDStep, or a TrainStep
    over `mesh` (or `sharding_plan`'s) with the chained grad transforms
    (their state made from the layer's trainable parameters)."""
    if spec.localsgd_k_steps > 0:
        return LocalSGDStep(spec.layer, spec.loss_fn, spec.optimizer,
                            k_steps=spec.localsgd_k_steps, mesh=mesh,
                            begin_step=spec.localsgd_begin_step,
                            amp_level=spec.amp_level,
                            amp_dtype=spec.amp_dtype,
                            remat=spec.remat,
                            remat_policy=spec.remat_policy,
                            adaptive=spec.localsgd_adaptive)
    from ...static.train_step import TrainStep
    init, fn = chain_grad_transforms(spec.grad_transforms)
    strategy_state = None
    if fn is not None:
        params = {k: p for k, p in spec.layer.named_parameters()
                  if p.requires_grad}
        strategy_state = init(params)
    return TrainStep(spec.layer, spec.loss_fn, spec.optimizer,
                     amp_level=spec.amp_level, amp_dtype=spec.amp_dtype,
                     mesh=mesh, sharding_plan=sharding_plan,
                     grad_accum_steps=spec.grad_accum_steps,
                     grad_transform=fn, strategy_state=strategy_state,
                     remat=spec.remat, remat_policy=spec.remat_policy,
                     scaler=spec.scaler)

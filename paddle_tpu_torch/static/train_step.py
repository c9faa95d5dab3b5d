"""TrainStep: one training step, one captured program per input
signature (counterpart of paddle_tpu/static/train_step.py).

The JAX package compiles forward + loss + backward + optimizer update +
loss scaling into one XLA executable (`jax.jit` of `_build`'s `step`).
The port's counterpart is one torch.cuda.CUDAGraph per input signature
(the shapes and dtypes of the inputs and labels, observability
signature_of): the first call of a signature on the card runs the step
body eagerly on a side stream (the warm-up; it is that call's step),
then captures the body into a graph over static input buffers; every
later call copies its inputs, its learning rate and its dropout seeds
into the graph's buffers and replays it. The capture rules are
static/capture.py's. On the CPU the same body runs eagerly (the tests'
path). A capture that fails raises; there is no eager fallback on the
card. The eager body stays callable (eager_step), the reference a
replay is held against.

The body, as the JAX `_build`'s `step`:

- AMP: the forward and the loss run under amp.auto_cast(amp_level,
  amp_dtype). O2 casts the floating params down and keeps f32 master
  weights in the optimizer, taken from the ORIGINAL f32 values.
- grad_accum_steps: the batch is cut along dim 0 into microbatches
  (_microslice; unrolled inside the graph); gradients and losses are
  averaged over them.
- scaler (amp.GradScaler/AmpScaler): the loss is scaled, the gradients
  unscaled and checked for non-finite values, and on overflow the
  params and optimizer state stay exactly as they were, while the scale
  adapts and strategy_state["amp_skipped"] counts the skip, all in
  place on the device: the step never reads a value back to the host.
- dropout: every random draw of one step comes from one seed of the
  global stream (core/generator.py seed_scope; one per microbatch).
  Inside a captured step each draw is a slot of the program's
  SeedSlots, written before each replay, so every replay draws new
  masks and equals the eager step of the same step seed bit for bit.
- lr: the optimizer's get_lr() at each call, passed as a 0-d f32 device
  tensor (the graph's own lr buffer, filled before each replay), so an
  LRScheduler takes effect.
- remat (with remat_policy None, "nothing_saveable" or
  "checkpoint_dots"): forward and loss run as one recompute region
  (distributed/recompute.py checkpointed), as jax.checkpoint wraps
  `_forward_loss`.
- buffers (BatchNorm's running statistics, and every other state entry
  that takes no gradient, as the JAX step threads its `buffers`): the
  forward writes them in place (nn/functional/norm.py). Where the JAX
  step differs from that, the step makes it equal: under
  grad_accum_steps every microbatch starts from the step's initial
  buffers and the step keeps the last microbatch's (the buffers are
  restored before each later microbatch); a remat recompute writes no
  second update (frozen_running_stats); a loss-scale skip keeps the
  params and the optimizer state but the buffers advance, as the JAX
  step's new_buffers do. On the card they are written inside the
  captured graph, at the addresses the layer holds; state_dict and
  set_state_dict carry them, and build_eval_fn normalises with them.
- __call__ returns the loss as a device tensor (no .item()).
- donate is accepted for the JAX signature: the step updates the params
  and the optimizer state in place anyway.

The RecompileSentinel("train") observes the program count every call,
expected 1: a second signature captures a second graph and records an
event, as a retrace does in the JAX package.

Telemetry, as the JAX __call__ has it: each step, eager or replayed,
is bracketed by the flight recorder's step_begin/step_end (the hang
watchdog's progress clock and goodput's train bucket; with sync_steps()
the bracket closes after the card finished the step), counts
``train.steps_total`` when metrics are on, and sits behind the OOM
sentry (observability.memory.handle_dispatch_oom, then re-raise). With a
scaler and a plane armed (metrics or the flight recorder), the step's
found_inf and scale are read back to the host for the
``amp.loss_scale.skipped_total`` counter, the ``loss_scale.skip``
breadcrumb and the ``amp.loss_scale.scale`` gauge; with both planes off
nothing is read from the card.

Data parallel (mesh=, a distributed.env.Mesh with a dp axis): each rank
calls the step on its local batch; between the unscale and the update,
where the JAX step calls its grad_transform, the grads are averaged over
the data axes (dp, and fsdp when the mesh has it: one all-reduce AVG a
grad and axis, NCCL on the card, captured in the step's graph), and so
is the returned loss; a BatchNorm in the forward averages its batch
moments over the same axes where they span more than one rank
(nn/functional/norm.py batch_stat_scope). That is the JAX step on the
global batch.
grad_transform (grads, strategy_state, params) -> (grads,
strategy_state) then runs by parameter name, its state riding
strategy_state (and so state_dict); a comm sync transform
(``syncs_dp_grads``) does the dp reduction itself.

sharding_plan (a distributed.ShardingPlan, or a MeshPlan) over the axes
dp, fsdp, tp, ep and sp: the mesh is the plan's, and the global mesh the
layers find their groups in. The model axes (tp, ep) are split where
the layers are made (sharding.annotate), sp splits attention's
sequence (models/ernie.py); the step takes this rank's batch
(plan.place_batch). Under ZeRO stage >= 1, or an fsdp axis, each
parameter whose state spec names a data axis is updated as a shard: the
optimizer holds this rank's block of it (and its moments and master
weight) along that axis, takes the same block of the averaged grad, and
under stage 1 and 2 the updated blocks are all-gathered back into the
parameter; a data axis of one rank still runs that path (a one-rank
gather). Lamb's and Lars's norms are whole-tensor norms: each block's
squared norms are summed over its ranks first (Optimizer._norms). Under
stage 3 and fsdp (the param spec names the same data layout) the layer's
parameter IS its block between steps: the body all-gathers the whole
tensor for the forward and backward (inside the captured graph on the
card) and drops it after, and the gradient goes through one
reduce-scatter per axis instead of an all-reduce and a slice (with a
grad_transform, which sees whole gradients as the JAX step's does, the
all-reduce and slice stay). Outside the step a forward under no_grad
(build_eval_fn's, hapi's evaluate and predict) gathers them the same
way, and the layer's state_dict() gives whole tensors. Over
several ranks every rank calls the step, state_dict
and set_state_dict, in the same order. state_dict() returns full
tensors, the JAX step's global arrays: the model's, and the optimizer's
state, gathered over the model and data axes (checkpoints keep one
layout whatever the mesh); set_state_dict takes full tensors and keeps this
rank's blocks. A scaler's overflow flag is the MAX over every axis of
the mesh. The pp axis (the SPMD pipeline, ROADMAP.md item 14d; the
host-driven pipeline is distributed/pipeline_engine.py's
PipelineParallel) raises NotImplementedError, as does an optimizer with a
grad_clip (the JAX package's compiled step does not clip).

sentry (an observability.sentry.NumericSentry): its state (the sentry's
step counter and fingerprint) rides strategy_state; inside the step,
after the loss-scale unscale and before the gradient sync and
grad_transform, the per-scope statistics of the pre-sync gradients are
taken, and after the update NumericSentry.instrument adds the new
parameters' statistics and the every-K fingerprint, all on the card and
captured with the step. After each call, eager or replayed, consume
reads them in one copy to the host and feeds the monitor. The sentry only
reads: the parameters after N steps are bit-equal to a sentry-less
step's. set_state_dict re-seeds the sentry's entries a restored state
lacks, as the JAX step does.

grad_hook (an attribute, None by default): a host callable that takes
the unscaled gradients by name and returns them, run between the
backward and the sentry's statistics (the host callback of the JAX
drill worker, where numeric chaos strikes). A step called while one is
set runs the eager body, since a captured replay runs no host code; the
eager body is the one a replay is held against, so the trajectory is
the same.

Anatomy: the unscale and the scale update run under the
``loss_scale`` scope, the update under ``optimizer``
(observability.anatomy), the JAX step's scopes.

aot_lower(inputs, labels): the step traced from shapes alone, the JAX
step's lower from avals: a twin of this step (the layer, optimizer,
scaler and sentry, without a mesh or grad_transform) on the meta device,
whose run() goes through the body once allocating nothing;
observability.memory.train_step_memory reads it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..amp.auto_cast import auto_cast
from ..amp.functional import (check_finite_and_unscale_tree,
                              update_loss_scaling_state)
from ..core import generator as _generator
from ..core.generator import Draw, SeedSlots, mix_seed, next_seed, seed_scope
from ..core.place import host_tensor
from ..distributed import collective as _c
from ..distributed import sharding as _sh
from ..distributed.env import get_mesh, set_mesh
from ..distributed.parallel import dp_average_, dp_max_, dp_size
from ..distributed.recompute import check_policy, checkpointed
from ..nn.functional.norm import batch_stat_scope
from ..observability import flight_recorder as _fr
from ..observability import memory as _mem
from ..observability import metrics as _obs
from ..observability.anatomy import scope as _scope
from ..observability.sentinel import RecompileSentinel, signature_of
from ..observability.sentry import stats_by_scope
from ..ops import flash_attention as _fa
from ..optimizer.optimizer import Optimizer
from ..serialization import from_numpy
from .capture import StaticInputs, capture, clone_outputs, warm_up

__all__ = ["TrainStep"]


def _microslice(a, idx, accum):
    """Microbatch idx of `accum` along the batch dim (scalars pass)."""
    if not isinstance(a, torch.Tensor) or a.dim() == 0:
        return a
    micro = a.shape[0] // accum
    return a[idx * micro:(idx + 1) * micro]


#: the mesh axes a TrainStep runs over; pp (the SPMD pipeline) comes with
#: ROADMAP.md item 14d
_STEP_AXES = ("dp", "fsdp", "tp", "ep", "sp")


def _check_axes(mesh):
    """Refuse mesh axes above size 1 that the step does not run."""
    if mesh is None:
        return
    wide = [ax for ax in mesh.axis_names
            if ax not in _STEP_AXES and mesh.shape[ax] > 1]
    if "pp" in wide:
        raise NotImplementedError(
            "TrainStep(mesh=...) over a pp axis of size > 1: the SPMD "
            "pipeline comes with ROADMAP.md item 14d; one process runs "
            "stages through distributed.PipelineParallel")
    if wide:
        raise NotImplementedError(
            f"TrainStep(mesh=...) over axes {wide} of size > 1: the step "
            f"runs over {list(_STEP_AXES)}")


def _plan_of(plan):
    """A ShardingPlan from a ShardingPlan or a MeshPlan (None passes)."""
    if isinstance(plan, _sh.MeshPlan):
        return plan.sharding_plan()
    return plan


def _clone_tree(tree):
    """A copy of a state tree (nested dicts, lists, tuples) whose tensors
    are detached clones."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree


def _load_state(dst: dict, src: dict, device, prune: bool = False):
    """src written into dst: tensors (or the numpy arrays a checkpoint
    gives back) copied into dst's tensors of the same shape in place, as
    a captured graph holds their addresses; anything else set. With
    prune (a grad transform's new state) the keys src lacks go too."""
    for k, v in src.items():
        old = dst.get(k)
        if isinstance(v, dict):
            if not isinstance(old, dict):
                old = dst[k] = {}
            _load_state(old, v, device, prune)
            continue
        if isinstance(v, np.ndarray):
            v = from_numpy(v).to(device)
        if isinstance(v, torch.Tensor) and isinstance(old, torch.Tensor) \
                and old.shape == v.shape:
            if old is not v:
                old.copy_(v)
        else:
            dst[k] = v.detach().clone() if isinstance(v, torch.Tensor) else v
    if prune:
        for k in [k for k in dst if k not in src]:
            del dst[k]


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else from_numpy(v)


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


def _program_key(inputs, labels):
    """(signature, non-tensor leaves): a new key is a new program."""
    sig = signature_of(inputs, labels)
    consts = tuple(repr(x) for x in (*inputs, *labels)
                   if not isinstance(x, torch.Tensor))
    return sig, (sig, consts)


def _launch_counts():
    return dict(_fa.launches)


def _delta(before):
    return {k: v - before[k] for k, v in _fa.launches.items()}


class _Program:
    """One captured step: graph, static inputs, seed slots, the 0-d f32
    lr buffer and the loss output."""
    __slots__ = ("graph", "inputs", "slots", "lr", "loss", "found_inf",
                 "sentry_out")


class TrainStep:
    """One training step of `layer`, captured per input signature on the
    card.

    loss_fn(outputs, *labels) -> scalar tensor. Usage:
        step = TrainStep(model, loss_fn, optimizer, amp_level="O1")
        loss = step(inputs, labels)

    Counts: ``captures``, ``replays``, ``programs`` (the executable
    count the sentinel observes), ``last_launches`` (the flash-attention
    kernel launches the wrappers counted in the last call: an eager
    step's, or the warm-up's for a capturing call; None after a replay,
    which does not pass through the wrappers: count a replay's kernels
    on the device, with torch.profiler), ``capture_launches`` (the
    launches the last capture recorded into its graph) and ``last_lr``
    (the 0-d device tensor the last replay read its learning rate from;
    None after an eager step)."""

    def __init__(self, layer, loss_fn: Callable, optimizer: Optimizer,
                 amp_level: Optional[str] = None, amp_dtype="bfloat16",
                 mesh=None, sharding_plan=None, donate: bool = True,
                 grad_accum_steps: int = 1,
                 grad_transform: Optional[Callable] = None,
                 strategy_state: Optional[Dict[str, Any]] = None,
                 remat: bool = False, remat_policy=None, scaler=None,
                 sentry=None):
        plan = _plan_of(sharding_plan)
        if plan is not None:
            if mesh is not None and mesh is not plan.mesh:
                raise ValueError("TrainStep(mesh=, sharding_plan=): the "
                                 "plan's mesh and mesh= differ")
            mesh = plan.mesh
        _check_axes(mesh)
        if mesh is not None and get_mesh() is None:
            # the layers find their groups in the global mesh: tp, ep,
            # sp, and the data axes a MoE layer's slot order spans
            set_mesh(mesh)
        self.mesh = mesh
        self.sharding_plan = plan
        # the data axes' groups (batch order), and every axis group: the
        # grads and the loss are averaged over the first, a scaler's
        # overflow flag is the MAX over the second
        self._data_axes = [] if mesh is None else [
            (ax, mesh.group(ax)) for ax in _sh.DATA_AXES
            if ax in mesh and mesh.group(ax) is not None]
        self._data_groups = [pg for _, pg in self._data_axes]
        self._all_groups = [] if mesh is None else [
            mesh.group(ax) for ax in mesh.axis_names
            if mesh.group(ax) is not None]
        if getattr(optimizer, "_grad_clip", None) is not None:
            # the JAX TrainStep updates through apply_gradients_tree,
            # which never calls the optimizer's _grad_clip: its compiled
            # step does not clip. Refuse rather than differ in silence.
            raise NotImplementedError(
                "TrainStep with an optimizer that carries a grad_clip: the "
                "JAX package's compiled step never applies it (its "
                "apply_gradients_tree skips _grad_clip; ROADMAP.md queue "
                "C), so the port refuses it rather than clip or not in "
                "silence. Clip in an eager loop with optimizer.step().")
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{grad_accum_steps}")
        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.grad_accum_steps = int(grad_accum_steps)
        self.remat = bool(remat)
        self.remat_policy = check_policy(remat_policy)
        self.strategy_state = strategy_state if strategy_state is not None \
            else {}
        self.grad_transform = grad_transform
        named = [(k, p) for k, p in layer.named_parameters()
                 if p.requires_grad]
        self._param_names = [k for k, _ in named]
        self.params = [p for _, p in named]
        # a step built before over these parameters gives them back whole
        for old in {id(o): o for o in (
                getattr(p, "_resident_of", None) for p in self.params)
                if o is not None}.values():
            old._hand_back()
        # the JAX step's `buffers`: every state entry without a gradient
        trainable = set(self._param_names)
        self._state_buffers = [
            t for k, t in layer.state_dict(keep_vars=True).items()
            if k not in trainable and isinstance(t, torch.Tensor)]
        # the data groups a BatchNorm averages its moments over: those of
        # more than one rank
        self._stat_groups = [pg for pg in self._data_groups
                             if dp_size(pg) > 1]
        if optimizer._parameters is None:
            optimizer._parameters = list(self.params)
        if amp_level == "O2":
            self._cast_down(amp_dtype)
        for p in self.params:
            # the optimizer state exists from the start, as the JAX step's
            # init_state_tree makes it (and a snapshot taken before the
            # first step restores it)
            optimizer._state_of(p)
        # ZeRO / fsdp: {param index: (data layout, the optimizer's shard)};
        # _resident: the indices whose parameter IS its shard between
        # steps (stage 3, fsdp)
        self._shards: Dict[int, Any] = {}
        self._resident: set = set()
        self._gathered = False
        if plan is not None:
            self._make_shards(plan)
        self._scaler_cfg = None
        if scaler is not None and getattr(scaler, "_enable", True):
            self._scaler_cfg = {
                "init_scale": float(scaler._scale),
                "incr_ratio": float(scaler._incr_ratio),
                "decr_ratio": float(scaler._decr_ratio),
                "incr_every_n": int(scaler._incr_every_n),
                "decr_every_n": int(scaler._decr_every_n),
                "dynamic": bool(scaler._dynamic),
            }
            self._init_scaler_state()
        # numeric-integrity sentry (observability.sentry.NumericSentry):
        # its state rides strategy_state as card tensors
        self.sentry = sentry
        if sentry is not None:
            sentry.init_state(self.strategy_state, self._device())
        self._sentry_out = None
        self.grad_hook = None
        self.recompile_sentinel = RecompileSentinel("train")
        self._programs: Dict[Any, Optional[_Program]] = {}
        self.captures = 0
        self.replays = 0
        self.last_launches: Optional[Dict[str, int]] = {}
        self.capture_launches: Dict[str, int] = {}
        self.last_lr: Optional[torch.Tensor] = None
        self._steps_done = 0
        # the last step's overflow flag (a device tensor; None without a
        # scaler), read only when a telemetry plane is armed
        self._found_inf: Optional[torch.Tensor] = None

    def _device(self):
        return self.params[0].device

    @torch.no_grad()
    def _make_shards(self, plan):
        """Under ZeRO >= 1 or fsdp: for each parameter whose state spec
        names a data axis with a process group, the optimizer's param is
        this rank's block of it, and its state (moments, master weight)
        moves to that block; a norm rule (Lamb, Lars) sums the block's
        squared norms over the layout's groups (shard_norms_over). Where
        the param spec names the same data layout (stage 3, fsdp), the
        layer's parameter becomes that block between steps: its
        storage is the shard's (_resident), and hooks on the layer give
        whole tensors outside the step (_install_whole_views)."""
        opt = self.optimizer
        mesh = self.mesh
        for i, (name, p) in enumerate(zip(self._param_names, self.params)):
            layout = _sh.layout_of(plan.state_spec(name, p), mesh,
                                   _sh.DATA_AXES, min_size=1)
            if not layout:
                continue
            shard = _sh.block_of(p.detach(), layout, mesh).clone()
            st = opt._accumulators.pop(id(p))
            opt._accumulators[id(shard)] = {
                k: (_sh.block_of(v, layout, mesh).clone()
                    if v.dim() > 0 else v) for k, v in st.items()}
            if hasattr(opt, "shard_norms_over"):
                opt.shard_norms_over(
                    [shard] + [v for k, v in opt._accumulators[id(shard)]
                               .items() if k == "master_weight"],
                    [mesh.group(a) for _, axes in layout for a in axes])
            self._shards[i] = (layout, shard)
            if _sh.layout_of(plan.param_spec(name, p), mesh, _sh.DATA_AXES,
                             min_size=1) == layout:
                p.data = shard
                p._resident_of = self
                self._resident.add(i)
        if self._resident:
            self._install_whole_views()

    def _hand_back(self):
        """Another step is built over this one's layer: the resident
        parameters become whole again and this step goes on as under
        stage 1 (its shards are their blocks; programs re-captured)."""
        self._gather_params()
        for i in self._resident:
            del self.params[i]._resident_of
        for h in self._hooks:
            h.remove()
        self._resident, self._gathered = set(), False
        self._programs.clear()

    def _install_whole_views(self):
        """Outside the step the layer acts as if it held its whole
        parameters, as the JAX layer's global arrays do: a forward under
        no_grad (an eval, hapi's evaluate and predict) gathers them and
        drops them after, and state_dict() gives whole tensors
        (state_dict(keep_vars=True), the live tensors, gives the shards).
        Both are collectives: every rank calls them. A forward that
        records a graph over parameters split across ranks raises: it
        trains through the step."""
        split = any(self.mesh.shape[a] > 1 for i in self._resident
                    for _, axes in self._shards[i][0] for a in axes)
        by_call = []

        def gather(layer, args):
            if self._gathered:
                return
            if torch.is_grad_enabled():
                if split:
                    raise RuntimeError(
                        "the layer's parameters are this rank's ZeRO-3 / "
                        "fsdp shards between steps: train it through its "
                        "TrainStep, or run the forward under no_grad")
                return
            self._gather_params()
            by_call.append(True)

        def release(layer, args, out):
            if by_call:
                by_call.clear()
                self._release_params()

        def whole_state(layer, state, prefix, meta):
            for i in self._resident:
                k = prefix + self._param_names[i]
                p = self.params[i]
                if k in state and state[k] is not p and not self._gathered:
                    state[k] = _sh.gather_of(p.detach(), self._shards[i][0],
                                             self.mesh)

        self._hooks = (
            self.layer.register_forward_pre_hook(gather),
            self.layer.register_forward_hook(release, always_call=True),
            self.layer._register_state_dict_hook(whole_state))

    def _gather_params(self):
        """Each resident parameter's whole tensor (its model block),
        all-gathered from the shards for the forward and backward (inside
        the captured graph on the card)."""
        for i in self._resident:
            layout, shard = self._shards[i]
            self.params[i].data = _sh.gather_of(shard, layout, self.mesh)
        self._gathered = bool(self._resident)

    def _release_params(self):
        """The resident parameters back to their shards; the whole
        tensors and their gradients are dropped (freed)."""
        for i in self._resident:
            p = self.params[i]
            p.grad = None
            p.data = self._shards[i][1]
        self._gathered = False

    @property
    def _scattered(self):
        """The indices whose gradient the sync reduce-scatters into its
        block: the resident ones, unless a grad_transform runs (it sees
        whole gradients, as the JAX step's does)."""
        return self._resident if self.grad_transform is None else set()

    def _full_param(self, i, p):
        """Parameter i's full tensor: gathered over its data layout when
        resident, then over its model axes (every rank calls it)."""
        v = p.detach()
        if i in self._resident:
            v = _sh.gather_of(v, self._shards[i][0], self.mesh)
        return _sh.gather_of(v, _sh.model_layout(p, self.mesh), self.mesh)

    def _opt_param(self, i):
        sh = self._shards.get(i)
        return sh[1] if sh is not None else self.params[i]

    def optimizer_states(self):
        """Each parameter's optimizer state dict as this rank holds it
        (a shard's under ZeRO / fsdp)."""
        return [self.optimizer._state_of(self._opt_param(i))
                for i in range(len(self.params))]

    def _apply(self, grads, lr, skip):
        """The update: whole parameters in place, and under ZeRO / fsdp
        the shards from their block of the grad (a reduce-scattered grad
        already is one); a shard that is not resident is gathered back
        into its parameter."""
        if not self._shards:
            self.optimizer.apply_gradients(self.params, grads, lr=lr,
                                           skip=skip)
            return
        mesh = self.mesh
        ps = [self._opt_param(i) for i in range(len(self.params))]
        scattered = self._scattered
        gs = [g if i not in self._shards or i in scattered
              else _sh.block_of(g, self._shards[i][0], mesh)
              for i, g in enumerate(grads)]
        self.optimizer.apply_gradients(ps, gs, lr=lr, skip=skip)
        with torch.no_grad():
            for i, (layout, shard) in self._shards.items():
                if i not in self._resident:
                    self.params[i].copy_(_sh.gather_of(shard, layout, mesh))

    @torch.no_grad()
    def _cast_down(self, amp_dtype):
        """O2: floating params cast to the AMP dtype; the optimizer keeps
        f32 masters made from the ORIGINAL values (a round trip through
        bf16 would quantize every weight at init)."""
        from ..core import dtypes as _dtypes
        dt = _dtypes.convert_dtype(amp_dtype)
        self.optimizer._multi_precision = True
        for p in self.params:
            if not p.is_floating_point() or p.dtype == dt:
                continue
            orig = p.detach().clone()
            p.data = p.data.to(dt)
            self.optimizer._accumulators[id(p)] = \
                self.optimizer.init_param_state(p, master=orig)

    def _init_scaler_state(self):
        dev = self._device()
        cfg = self._scaler_cfg
        st = self.strategy_state
        st.setdefault("amp_scale", torch.tensor(cfg["init_scale"],
                                                dtype=torch.float32,
                                                device=dev))
        for k in ("amp_good", "amp_bad", "amp_skipped"):
            st.setdefault(k, torch.zeros((), dtype=torch.int32, device=dev))

    # -- the body -------------------------------------------------------------
    def _forward_loss_plain(self, inputs, labels):
        if self.amp_level:
            with auto_cast(level=self.amp_level, dtype=self.amp_dtype):
                out = self.layer(*inputs)
                loss = self.loss_fn(out, *labels)
        else:
            out = self.layer(*inputs)
            loss = self.loss_fn(out, *labels)
        return loss.to(torch.float32)

    def _forward_loss(self, inputs, labels):
        if not self.remat:
            return self._forward_loss_plain(inputs, labels)
        n = len(inputs)
        return checkpointed(
            lambda *a: self._forward_loss_plain(a[:n], a[n:]),
            *inputs, *labels, policy=self.remat_policy)

    def _body(self, inputs, labels, lr, seed):
        """The step on `inputs`/`labels` with learning rate `lr` (a 0-d
        f32 device tensor) and dropout seed `seed` (the step seed, an
        int; or a SeedSlots, whose Draws stand for it): forward, loss,
        backward, unscale and finite check, the update with the skip
        select, the scale update. Returns the loss (f32 device tensor)."""
        scale = self.strategy_state["amp_scale"] \
            if self._scaler_cfg is not None else None
        for p in self.params:
            p.grad = None
        self._gather_params()
        try:
            loss = self._microbatches(inputs, labels, seed, scale)
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        finally:
            self._release_params()
        found_inf = None
        if scale is not None:
            with _scope("loss_scale"):
                found_inf = check_finite_and_unscale_tree(grads, scale)
                if self._all_groups:
                    # one rank's overflow skips the step on every rank
                    # (the averaged grads carry it everywhere)
                    flag = found_inf.to(torch.float32)
                    for pg in self._all_groups:
                        dp_max_(flag, pg)
                    found_inf = flag > 0
        if self.grad_hook is not None:
            named = self.grad_hook(dict(zip(self._param_names, grads)))
            grads = [named[k] for k in self._param_names]
        # the sentry's pre-sync tell: after the sync every replica holds
        # the same (possibly already poisoned) gradients
        gstats = None
        if self.sentry is not None:
            with torch.no_grad():
                gstats = stats_by_scope(dict(zip(self._param_names, grads)))
        grads = self._sync_and_transform(grads)
        if self._data_groups:
            loss = loss.clone()
            for pg in self._data_groups:
                dp_average_([loss], pg)
        with _scope("optimizer"):
            self._apply(grads, lr, found_inf)
        if found_inf is not None:
            with _scope("loss_scale"):
                self._update_scaler(found_inf)
        self._found_inf = found_inf
        if self.sentry is not None:
            with torch.no_grad():
                self._sentry_out, _ = self.sentry.instrument(
                    None, dict(zip(self._param_names, self.params)), loss,
                    self.strategy_state, grad_stats=gstats)
        return loss

    def _microbatches(self, inputs, labels, seed, scale):
        """Forward, loss and backward of each microbatch, the gradients
        summed in .grad; returns the mean loss. Each microbatch starts
        from the step's initial buffers (restored in place before every
        later one), so the step keeps the last one's update, as the JAX
        step's scan over microbatches does."""
        accum = self.grad_accum_steps
        initial = None
        if accum > 1 and self._state_buffers:
            with torch.no_grad():
                initial = [b.detach().clone() for b in self._state_buffers]
        loss_sum = None
        for idx in range(accum):
            if idx and initial is not None:
                with torch.no_grad():
                    for b, b0 in zip(self._state_buffers, initial):
                        b.copy_(b0)
            ins = tuple(_microslice(a, idx, accum) for a in inputs)
            lbls = tuple(_microslice(a, idx, accum) for a in labels)
            path = () if accum == 1 else (idx,)
            if isinstance(seed, SeedSlots):
                base = Draw(path, seed)
            else:
                base = seed if accum == 1 else mix_seed(seed, idx)
            with seed_scope(base), batch_stat_scope(self._stat_groups):
                loss = self._forward_loss(ins, lbls)
            scaled = loss / accum if accum > 1 else loss
            if scale is not None:
                scaled = scaled * scale
            scaled.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum / accum if accum > 1 else loss_sum

    @torch.no_grad()
    def _sync_and_transform(self, grads):
        """Between the unscale and the update, where the JAX step calls
        its grad_transform: over a dp mesh the grads are averaged over
        the data ranks (the JAX partitioner's global-batch gradients), then
        grad_transform(grads, strategy_state, params) -> (grads, state)
        runs on them by name. A transform marked ``syncs_dp_grads`` (the
        comm sync) does the dp reduction itself: it gets the grads
        divided by the dp size and sums them. The state it returns is
        written into strategy_state's tensors in place (a captured
        graph holds their addresses)."""
        fn = self.grad_transform
        scatter = self._scattered
        for ax, pg in self._data_axes:
            if fn is not None and getattr(fn, "syncs_dp_grads", False) \
                    and pg is self.mesh.group("dp"):
                n = dp_size(pg)
                if n > 1:
                    grads = [g / n for g in grads]
                continue
            todo = [g for i, g in enumerate(grads) if not (
                i in scatter and ax in self._layout_axes(i))]
            if not todo:
                continue
            done = _c._record("allreduce_avg", ax, *todo)
            dp_average_(todo, pg)
            done and done()
        for i in scatter:
            grads[i] = self._reduce_scatter(grads[i], self._shards[i][0])
        if fn is None:
            return grads
        names = self._param_names
        new, state = fn(dict(zip(names, grads)), dict(self.strategy_state),
                        dict(zip(names, self.params)))
        _load_state(self.strategy_state, state, self._device(), prune=True)
        return [new[k] for k in names]

    def _layout_axes(self, i):
        return {a for _, axes in self._shards[i][0] for a in axes}

    def _reduce_scatter(self, g, layout):
        """This rank's block of the average of `g` over the layout's
        axes: one reduce-scatter (SUM, then / n) per axis, outer axis
        first, along the layout's dim (block_of's order)."""
        for dim, axes in layout:
            for a in axes:
                pg = self.mesh.group(a)
                done = _c._record("reduce_scatter", a, g)
                part = _c._reduce_scatter_dim0(g.movedim(dim, 0),
                                               _c.ReduceOp.SUM, pg)
                done and done()
                g = part.movedim(0, dim).div_(_c._size(pg))
        return g

    @torch.no_grad()
    def _update_scaler(self, found_inf):
        """The scale update, written into the strategy_state tensors in
        place (a captured graph holds their addresses)."""
        st, cfg = self.strategy_state, self._scaler_cfg
        if cfg["dynamic"]:
            new = update_loss_scaling_state(
                st["amp_scale"], st["amp_good"], st["amp_bad"], found_inf,
                incr_ratio=cfg["incr_ratio"], decr_ratio=cfg["decr_ratio"],
                incr_every_n=cfg["incr_every_n"],
                decr_every_n=cfg["decr_every_n"])
            for k, v in zip(("amp_scale", "amp_good", "amp_bad"), new):
                st[k].copy_(v)
        st["amp_skipped"].add_(found_inf.to(torch.int32))

    # -- the step call --------------------------------------------------------
    def eager_step(self, inputs, labels=(), seed=None):
        """The step body run eagerly, without any capture: the reference
        a replay is held against. seed: the step's dropout seed (None
        draws the next from the device's stream, as __call__ does)."""
        inputs, labels = _as_tuple(inputs), _as_tuple(labels)
        step_seed = next_seed(self._device()) if seed is None else int(seed)
        lr = host_tensor(self.optimizer.get_lr(), torch.float32,
                         self._device())
        before = _launch_counts()
        loss = self._body(inputs, labels, lr, step_seed)
        self.last_launches = _delta(before)
        self.last_lr = None
        return loss

    def __call__(self, inputs, labels=(), seed=None):
        """One step; returns the loss as a device tensor. seed: the
        step's dropout seed (None draws the next from the device's
        stream, as the JAX step draws next_key())."""
        inputs, labels = _as_tuple(inputs), _as_tuple(labels)
        sig, key = _program_key(inputs, labels)
        tok = _fr.step_begin("train_step", self._steps_done)
        try:
            loss = self._dispatch(key, inputs, labels, seed)
        except Exception as e:
            _mem.handle_dispatch_oom("train_step", e, step=self._steps_done)
            raise
        if tok is not None and _fr.sync_steps() and loss.is_cuda:
            # the card finished the step before the bracket closes
            torch.cuda.synchronize(loss.device)
        _fr.step_end("train_step", self._steps_done, tok)
        if self._found_inf is not None and (_obs._enabled or _fr._enabled):
            # the gated host read: a plane nobody armed costs no sync
            skipped = bool(self._found_inf)
            scale_v = float(self.strategy_state["amp_scale"])
            if skipped:
                _obs.counter("amp.loss_scale.skipped_total",
                             _always=True).add(1)
                _fr.record("loss_scale.skip", step=self._steps_done,
                           scale=scale_v)
            if _obs._enabled:
                _obs.gauge("amp.loss_scale.scale").set(scale_v)
        if self.sentry is not None:
            self.sentry.consume(self._steps_done, self._sentry_out)
        self._steps_done += 1
        if _obs._enabled:
            _obs.counter("train.steps_total").add(1)
        self.recompile_sentinel.observe(len(self._programs), expected=1,
                                        signature=sig)
        return loss

    def _dispatch(self, key, inputs, labels, seed):
        if self._device().type != "cuda":
            self._programs.setdefault(key, None)
            return self.eager_step(inputs, labels, seed)
        if self.grad_hook is not None:
            # host code between the backward and the update: eager
            return self.eager_step(inputs, labels, seed)
        step_seed = next_seed(self._device()) if seed is None else int(seed)
        prog = self._programs.get(key)
        if prog is None:
            return self._capture(key, inputs, labels, step_seed)
        return self._replay(prog, inputs, labels, step_seed)

    def _capture(self, key, inputs, labels, step_seed):
        """The first call of a signature on the card: the warm-up (this
        call's step, eager, recording the seed slots), then the capture.
        Returns the warm-up's loss."""
        dev = self._device()
        prog = _Program()
        prog.inputs = StaticInputs((inputs, labels), dev)
        ins, lbls = prog.inputs.tree
        prog.slots = SeedSlots(dev).record(step_seed)
        prog.lr = host_tensor(self.optimizer.get_lr(), torch.float32, dev)
        before = _launch_counts()
        loss = warm_up(lambda: self._body(ins, lbls, prog.lr, prog.slots),
                       dev)
        self.last_launches = _delta(before)
        self.last_lr = None
        warm_grads = [p.grad for p in self.params]
        warm_sentry = self._sentry_out
        prog.slots.freeze()
        steps = self.optimizer._step_count
        before = _launch_counts()
        warm_found_inf = self._found_inf
        prog.graph, prog.loss = capture(
            lambda: self._body(ins, lbls, prog.lr, prog.slots), dev,
            prog.slots.generators.values())
        # the graph's own flag; this call's step is the warm-up's
        prog.found_inf = self._found_inf
        self._found_inf = warm_found_inf
        prog.sentry_out, self._sentry_out = self._sentry_out, warm_sentry
        self.capture_launches = _delta(before)
        self.optimizer._step_count = steps
        with torch.no_grad():
            # the gradients now live in the graph's pool; give them the
            # warm-up step's values, as an eager step leaves them
            for p, g in zip(self.params, warm_grads):
                if p.grad is not None and g is not None:
                    p.grad.copy_(g)
        self._programs[key] = prog
        self.captures += 1
        return loss

    def _replay(self, prog, inputs, labels, step_seed):
        prog.inputs.fill((inputs, labels))
        prog.slots.fill(step_seed)
        prog.lr.fill_(self.optimizer.get_lr())
        prog.graph.replay()
        self._found_inf = prog.found_inf
        self._sentry_out = prog.sentry_out
        self.optimizer._step_count += 1
        self.replays += 1
        self.last_launches = None
        self.last_lr = prog.lr
        return prog.loss.clone()

    @property
    def programs(self) -> int:
        return len(self._programs)

    def release(self):
        """Drop the captured programs and their memory pools (the
        gradients live there too, so they are dropped as well)."""
        self._programs.clear()
        for p in self.params:
            p.grad = None

    # -- the step from shapes alone ------------------------------------------
    def aot_lower(self, inputs, labels=()):
        """The step traced from shapes alone (the JAX step's lower from
        avals): a _LoweredStep holding a twin of this step on the meta
        device (the layer deep-copied with every parameter and buffer
        replaced by a meta tensor of its shape and dtype, the optimizer
        and its hyperparameters with empty state, the scaler and the
        sentry; no mesh, no grad_transform) and meta inputs of the
        inputs' shapes. Nothing of the step's own state is touched and
        nothing is allocated."""
        import copy
        memo = {}
        for t in list(self.layer.parameters()) + list(self.layer.buffers()):
            meta = torch.empty_like(t, device="meta")
            if isinstance(t, torch.nn.Parameter):
                meta = torch.nn.Parameter(meta,
                                          requires_grad=t.requires_grad)
            memo[id(t)] = meta
        layer = copy.deepcopy(self.layer, memo)
        opt = copy.copy(self.optimizer)
        opt._accumulators, opt._parameters = {}, None
        twin = TrainStep(layer, self.loss_fn, opt, amp_level=self.amp_level,
                         amp_dtype=self.amp_dtype,
                         grad_accum_steps=self.grad_accum_steps,
                         remat=self.remat, remat_policy=self.remat_policy,
                         sentry=self.sentry)
        if self._scaler_cfg is not None:
            twin._scaler_cfg = dict(self._scaler_cfg)
            twin._init_scaler_state()
        meta = lambda t: (torch.empty_like(t, device="meta")  # noqa: E731
                          if isinstance(t, torch.Tensor) else t)
        return _LoweredStep(twin, tuple(meta(t) for t in _as_tuple(inputs)),
                            tuple(meta(t) for t in _as_tuple(labels)))

    # -- eval -----------------------------------------------------------------
    def build_eval_fn(self):
        """The eval forward (paddle_tpu's build_eval_fn): ev(inputs) ->
        the layer's outputs in eval mode under no_grad, the layer's
        training flag restored after. On the card each input signature
        is captured once and replayed (outputs cloned out)."""
        return _EvalFn(self)

    # -- checkpoints ----------------------------------------------------------
    def _layouts(self, i):
        """(model layout, data layout) of parameter i: how its stored
        block and its optimizer shard were cut."""
        model = _sh.model_layout(self.params[i], self.mesh)
        data = self._shards[i][0] if i in self._shards else []
        return model, data

    def _full_opt_state(self):
        """optimizer.state_dict() with every parameter's state as full
        tensors (gathered over its data, then its model axes)."""
        opt = self.optimizer
        out = opt.state_dict()
        index = {id(p): j for j, p in enumerate(opt._parameters or [])}
        for i, p in enumerate(self.params):
            model, data = self._layouts(i)
            if not (model or data) or id(p) not in index:
                continue
            st = opt._accumulators.get(id(self._opt_param(i)), {})
            out[f"param_{index[id(p)]}"] = {
                k: (_sh.gather_of(_sh.gather_of(v.detach(), data,
                                                self.mesh),
                                  model, self.mesh).clone()
                    if v.dim() > 0 else v.detach().clone())
                for k, v in st.items()}
        return out

    def state_dict(self):
        """A snapshot (copies) of full tensors: the live ones are updated
        in place by later steps, and a parameter split over the mesh is
        gathered (every rank calls it). Beside the model, the optimizer
        (moments, its step count, the lr scheduler) and strategy_state,
        it carries the dropout seed stream (core.generator.get_state)
        and the number of steps taken, so a step restored from it draws
        the masks the uninterrupted run drew at that step."""
        own = self.layer.state_dict(keep_vars=True)
        index = {id(p): i for i, p in enumerate(self.params)}
        return {"model": {k: (self._full_param(index[id(v)], v)
                              if id(v) in index else
                              _sh.full_value(v, self.mesh)).detach().clone()
                          for k, v in own.items()},
                "opt": self._full_opt_state(),
                "strategy_state": _clone_tree(self.strategy_state),
                "seed": _generator.get_state(),
                "step": self._steps_done}

    @torch.no_grad()
    def _set_opt_state(self, state):
        """optimizer.set_state_dict, with the split and sharded
        parameters' full state cut to this rank's blocks, in place."""
        opt = self.optimizer
        state = dict(state)
        index = {id(p): j for j, p in enumerate(opt._parameters or [])}
        special = {}
        for i, p in enumerate(self.params):
            model, data = self._layouts(i)
            key = f"param_{index.get(id(p), -1)}"
            if (model or data) and key in state:
                special[i] = state.pop(key)
        opt.set_state_dict(state)
        for i, full in special.items():
            model, data = self._layouts(i)
            own = opt._state_of(self._opt_param(i))
            for k, v in full.items():
                v = _as_tensor(v).to(self._device())
                if v.dim() > 0:
                    v = _sh.block_of(_sh.block_of(v, model, self.mesh),
                                     data, self.mesh)
                if k in own and own[k].shape == v.shape:
                    own[k].copy_(v)
                else:
                    own[k] = v.clone()

    @torch.no_grad()
    def set_state_dict(self, state):
        """Restore a state_dict() checkpoint (tensors, or the numpy
        arrays a checkpoint file gives back; full tensors, cut to this
        rank's blocks). Every tensor that exists is written in place
        (the model's, the optimizer's, strategy_state's), so a captured
        program goes on reading the restored values."""
        if state.get("model"):
            own = self.layer.state_dict(keep_vars=True)
            index = {id(p): i for i, p in enumerate(self.params)}
            for k, v in state["model"].items():
                if k in own:
                    v = _as_tensor(v).to(own[k].device)
                    v = _sh.block_of(v, _sh.model_layout(own[k], self.mesh),
                                     self.mesh)
                    i = index.get(id(own[k]))
                    if i in self._resident:
                        v = _sh.block_of(v, self._shards[i][0], self.mesh)
                    own[k].copy_(v)
            for i, (layout, shard) in self._shards.items():
                if i not in self._resident:
                    shard.copy_(_sh.block_of(self.params[i].detach(),
                                             layout, self.mesh))
        if state.get("opt") is not None:
            self._set_opt_state(state["opt"])
        if state.get("strategy_state") is not None:
            _load_state(self.strategy_state, state["strategy_state"],
                        self._device())
            if self._scaler_cfg is not None:
                self._init_scaler_state()
            if self.sentry is not None:
                self.sentry.init_state(self.strategy_state, self._device())
        if state.get("seed") is not None:
            _generator.set_state(state["seed"])
        if state.get("step") is not None:
            self._steps_done = int(state["step"])


class _LoweredStep:
    """TrainStep.aot_lower's result: the meta twin and its inputs.
    run() goes through the twin's body once (forward, backward, unscale,
    update, sentry) on meta tensors and returns the loss; arguments()
    names every tensor the step holds before it runs."""

    def __init__(self, step: "TrainStep", inputs, labels):
        self.step, self.inputs, self.labels = step, inputs, labels

    def arguments(self):
        """{name: meta tensor}: the parameters and buffers (by state-dict
        name), each parameter's optimizer state (name/key), the strategy
        state (strategy/key) and the inputs (input/i, label/i)."""
        st = self.step
        out = {k: v for k, v in
               st.layer.state_dict(keep_vars=True).items()
               if isinstance(v, torch.Tensor)}
        for name, state in zip(st._param_names, st.optimizer_states()):
            out.update({f"{name}/{k}": v for k, v in state.items()
                        if isinstance(v, torch.Tensor)})
        out.update({f"strategy/{k}": v
                    for k, v in st.strategy_state.items()
                    if isinstance(v, torch.Tensor)})
        out.update({f"input/{i}": t for i, t in enumerate(self.inputs)
                    if isinstance(t, torch.Tensor)})
        out.update({f"label/{i}": t for i, t in enumerate(self.labels)
                    if isinstance(t, torch.Tensor)})
        return out

    def run(self):
        lr = torch.empty((), dtype=torch.float32, device="meta")
        return self.step._body(self.inputs, self.labels, lr, 0)


class _EvalFn:
    """TrainStep.build_eval_fn's callable; counts ``programs`` and
    ``replays`` like the step."""

    def __init__(self, step: TrainStep):
        self.step = step
        self._programs: Dict[Any, Any] = {}
        self.replays = 0

    @property
    def programs(self) -> int:
        return len(self._programs)

    def _forward(self, inputs):
        step = self.step
        layer = step.layer
        mode = layer.training
        layer.eval()
        try:
            with torch.no_grad():
                return layer(*inputs)
        finally:
            layer.train(mode)

    def __call__(self, inputs):
        inputs = _as_tuple(inputs)
        dev = self.step._device()
        if dev.type != "cuda":
            self._programs.setdefault(_program_key(inputs, ())[1], None)
            return self._forward(inputs)
        key = _program_key(inputs, ())[1]
        ent = self._programs.get(key)
        if ent is None:
            static = StaticInputs(inputs, dev)
            warm_up(lambda: self._forward(static.tree), dev)
            graph, out = capture(lambda: self._forward(static.tree), dev,
                                 program="eval")
            ent = self._programs[key] = (graph, static, out)
        graph, static, out = ent
        static.fill(inputs)
        graph.replay()
        self.replays += 1
        return clone_outputs(out)

"""ShardingPlan and MeshPlan: one layout declaration for the whole mesh
(counterpart of paddle_tpu/distributed/sharding.py).

The spec derivation, the cost model and the planner are the JAX
package's, line for line: LOGICAL_AXES, ShardingPlan's param, state and
data specs (ZeRO stages 0-3, the fsdp axis), ModelDims, LayoutCost,
candidate_layouts, estimate_layout, choose_layout and MeshPlan (auto,
axis_names, param/state/data/activation specs, the stacked specs,
sharding_plan, predict, describe). PartitionSpec is the port's tuple
type (shard_map_util.py) and a mesh is env.Mesh over the world's ranks.

What a spec means differs with the runtime. The JAX package hands the
specs to the partitioner as NamedShardings and computes with global
arrays. The port runs one process per rank, so a spec says which block
of a full tensor a rank holds:

- the model axes, tp and ep, are sharded where the parameter is made
  (``annotate``): the layer keeps this rank's contiguous block along
  every dim the spec splits over a model axis, and its forward is
  written for the block (parallel_layers.py, moe.py, models/ernie.py);
- the data axes, dp and fsdp, shard the batch (``place_batch``) and,
  under ZeRO or fsdp, the optimizer's state and update: TrainStep keeps
  a shard of each such parameter for the optimizer, within the model
  block, and gathers the updated shards back into the layer's tensor.

A dim split over a model and a data axis (MeshPlan's embedding table
over ('fsdp', 'tp')) keeps the model axis's contiguous block and the
data axis's shard within it: only the storage order differs from the
JAX layout, and every full tensor (``full_value``, TrainStep.state_dict)
is the same. Without a process group a mesh has no groups, and nothing
is split: every rank is the whole world.

SERVING_TP_RULES, SERVING_POOL_SPEC, permute_qkv_heads and
serving_param_specs are carried as data and functions; the serving
engine's tp mode that uses them, and ``MeshPlan.resync_assignments``
(the elastic regrown slot), come with ROADMAP.md item 14c.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .env import EXPERT_AXIS, TENSOR_AXIS, get_mesh, get_rank
from .shard_map_util import PartitionSpec

__all__ = ["ShardingPlan", "PartitionSpec", "shard_tensor",
           "NamedSharding", "MeshPlan", "ModelDims", "LayoutCost",
           "candidate_layouts", "estimate_layout", "choose_layout",
           "LOGICAL_AXES", "MODEL_AXES", "DATA_AXES", "annotate",
           "full_value", "SERVING_TP_RULES", "SERVING_POOL_SPEC",
           "permute_qkv_heads", "serving_param_specs"]

P = PartitionSpec

#: the planner's logical axis taxonomy, outermost to innermost:
#: 'pp' (stage ring), 'dp' (pure replication), 'fsdp' (data axis that
#: ALSO shards params/grads/opt state), 'tp' (operator sharding —
#: innermost so the heaviest collectives ride the fastest links)
LOGICAL_AXES = ("dp", "fsdp", "tp", "pp")

#: axes a layer's parameters are split over where they are made
MODEL_AXES = (TENSOR_AXIS, EXPERT_AXIS)
#: axes the batch is split over (and, under ZeRO or fsdp, the state)
DATA_AXES = ("dp", "fsdp")


class NamedSharding:
    """A spec on a mesh (jax.sharding.NamedSharding's two fields)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _shape_of(tensor) -> Tuple[int, ...]:
    """The FULL shape of a parameter (a sharded one remembers it), or
    any array's shape."""
    full = getattr(tensor, "_pd_full_shape", None)
    if full is not None:
        return tuple(full)
    return tuple(int(s) for s in getattr(tensor, "shape", ()))


def _spec_for_param(name: str, tensor, rules):
    # explicit layer annotation wins (TP layers set `.sharding_spec`)
    spec = getattr(tensor, "sharding_spec", None) if tensor is not None \
        else None
    if spec is None:
        for pattern, s in rules.items():
            if re.search(pattern, name):
                spec = P(*s) if not isinstance(s, P) else s
                break
    return spec if spec is not None else P()


def _add_axis(spec: P, tensor, axis: str, axis_size: int):
    parts = list(spec) if len(spec) else []
    shape = _shape_of(tensor)
    while len(parts) < len(shape):
        parts.append(None)
    if axis in [p for p in parts if p is not None]:
        return P(*parts)
    # choose the largest dim not already sharded and evenly divisible
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if parts[i] is None and shape[i] > 1 and \
                shape[i] % max(axis_size, 1) == 0:
            parts[i] = axis
            return P(*parts)
    return P(*parts)


# -- blocks of a full tensor, per spec -----------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def layout_of(spec, mesh, kinds=MODEL_AXES + DATA_AXES, min_size=2):
    """[(dim, axes)] of `spec` on `mesh`: the axes of `kinds` that split
    each dim and have a process group of at least `min_size` ranks,
    model axes first (the storage order: a data axis shards within the
    model block)."""
    if mesh is None or spec is None:
        return []
    out = []
    for dim, entry in enumerate(spec):
        axes = [a for a in _entry_axes(entry) if a in kinds and a in mesh
                and mesh.shape[a] >= min_size
                and mesh.group(a) is not None]
        axes.sort(key=lambda a: 0 if a in MODEL_AXES else 1)
        if axes:
            out.append((dim, tuple(axes)))
    return out


def _coords(mesh):
    return mesh.coords(get_rank())


def block_of(t, layout, mesh):
    """This rank's block of the full tensor `t` under `layout`."""
    if not layout:
        return t
    coords = _coords(mesh)
    for dim, axes in layout:
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if t.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of size {t.shape[dim]} does not split evenly "
                f"over {axes} ({n} ranks)")
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t


def gather_of(t, layout, mesh):
    """The full tensor whose blocks (block_of) the ranks hold; every rank
    of the axes' groups calls it."""
    from . import collective as _c
    for dim, axes in layout:
        for a in reversed(axes):
            g = _c._gather_flat(t, mesh.group(a))
            t = torch.cat(list(g.unbind(0)), dim=dim)
    return t


@torch.no_grad()
def annotate(param, spec: PartitionSpec, mesh=None):
    """Set `param.sharding_spec` and, on a mesh (default: the global one)
    whose model axes named by `spec` span more than one rank, keep only
    this rank's block of the parameter (its full shape kept in
    ``_pd_full_shape``). The full tensor is made first on every rank from
    the same generator, so the blocks are the unsplit layer's values."""
    param.sharding_spec = spec
    mesh = mesh if mesh is not None else get_mesh()
    layout = layout_of(spec, mesh, MODEL_AXES)
    if layout and getattr(param, "_pd_full_shape", None) is None:
        full = tuple(param.shape)
        param.data = block_of(param.data, layout, mesh).contiguous()
        param._pd_full_shape = full
    return param


def is_split(param) -> bool:
    full = getattr(param, "_pd_full_shape", None)
    return full is not None and tuple(full) != tuple(param.shape)


def model_layout(param, mesh=None):
    """The layout `param`'s stored block was cut by (empty when whole)."""
    if not is_split(param):
        return []
    mesh = mesh if mesh is not None else get_mesh()
    return layout_of(getattr(param, "sharding_spec", None), mesh,
                     MODEL_AXES)


def full_value(param, mesh=None):
    """The full tensor of a parameter annotate split (every rank of its
    model axes calls it); the tensor itself when whole."""
    mesh = mesh if mesh is not None else get_mesh()
    layout = model_layout(param, mesh)
    return gather_of(param.detach(), layout, mesh) if layout else param


class ShardingPlan:
    """Derives the specs of params / optimizer state / data.

    zero_stage: 0 = plain DP (state replicated), 1/2 = optimizer state
    sharded over dp, 3 = params sharded too (FSDP).
    """

    def __init__(self, mesh, rules: Dict[str, P] = None,
                 zero_stage: int = 0, dp_axis="dp", data_axes=("dp",),
                 batch_dim: int = 0, fsdp_axis: Optional[str] = None):
        self.mesh = mesh
        self.rules = rules or {}
        self.zero_stage = zero_stage
        self.dp_axis = dp_axis if dp_axis in mesh.axis_names else None
        self.fsdp_axis = fsdp_axis if (fsdp_axis and
                                       fsdp_axis in mesh.axis_names) \
            else None
        if self.fsdp_axis and self.fsdp_axis not in data_axes:
            data_axes = tuple(data_axes) + (self.fsdp_axis,)
        self.data_axes = tuple(a for a in data_axes
                               if a in mesh.axis_names)
        self.batch_dim = batch_dim

    def named(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    def replicated(self) -> NamedSharding:
        return self.named(P())

    def _dp_size(self) -> int:
        if self.dp_axis is None:
            return 1
        return int(self.mesh.shape[self.dp_axis])

    def _sanitize(self, spec: P) -> P:
        """Drop spec axes absent from this plan's mesh, so a model
        annotated for (say) tp degrades to replicated on a dp-only mesh."""
        names = set(self.mesh.axis_names)

        def keep(p):
            if p is None:
                return None
            if isinstance(p, (tuple, list)):
                kept = tuple(a for a in p if a in names)
                return kept if kept else None
            return p if p in names else None
        return P(*[keep(p) for p in spec])

    def param_spec(self, name: str, tensor) -> P:
        # sanitize BEFORE the ZeRO-3 axis addition: a stale 'tp' label on
        # a dp-only mesh must not block _add_axis from dp-sharding the dim
        spec = self._sanitize(_spec_for_param(name, tensor, self.rules))
        if self.fsdp_axis:
            spec = _add_axis(spec, tensor, self.fsdp_axis,
                             int(self.mesh.shape[self.fsdp_axis]))
        if self.zero_stage >= 3 and self.dp_axis:
            spec = _add_axis(spec, tensor, self.dp_axis, self._dp_size())
        return spec

    def state_spec(self, name: str, tensor) -> P:
        """Optimizer-state sharding: ZeRO>=1 shards moments over dp."""
        base = self.param_spec(name, tensor)
        if self.zero_stage >= 1 and self.dp_axis:
            return _add_axis(base, tensor, self.dp_axis, self._dp_size())
        return base

    def data_spec(self, array) -> P:
        nd = len(array.shape) if hasattr(array, "shape") \
            else np.ndim(array)
        if nd == 0 or not self.data_axes:
            return P()
        parts = [None] * nd
        parts[self.batch_dim] = (self.data_axes if len(self.data_axes) > 1
                                 else self.data_axes[0])
        return P(*parts)

    # -- TrainStep integration ----------------------------------------------
    def step_shardings(self, train_step):
        """({param name: NamedSharding}, {param name: {state name:
        NamedSharding}}) of a TrainStep: each param's spec, and its
        optimizer state's (0-d state replicated)."""
        p_shard, opt_shard = {}, {}
        for name, p, st in zip(train_step._param_names, train_step.params,
                               train_step.optimizer_states()):
            p_shard[name] = self.named(self.param_spec(name, p))
            opt_shard[name] = {
                n: (self.named(self.state_spec(name, p)) if v.dim() > 0
                    else self.replicated()) for n, v in st.items()}
        return p_shard, opt_shard

    def place(self, array, spec: P):
        """This rank's block of the full `array` under `spec`."""
        t = array if isinstance(array, torch.Tensor) else \
            torch.as_tensor(np.asarray(array))
        return block_of(t, layout_of(spec, self.mesh,
                                     tuple(self.mesh.axis_names)), self.mesh)

    def place_batch(self, arrays):
        """This rank's block of a global batch (a tensor or a list/tuple
        of them) along the data axes: the DataLoader's placement stage."""
        if isinstance(arrays, (list, tuple)):
            return type(arrays)(self.place_batch(a) for a in arrays)
        return self.place(arrays, self.data_spec(arrays))


def shard_tensor(tensor, mesh=None, placements=None, spec: P = None):
    """paddle.distributed.shard_tensor: this rank's block of `tensor`
    under the spec (or placements) on the mesh (default: the global
    mesh), with the spec recorded on it."""
    from .env import ensure_mesh
    mesh = mesh or ensure_mesh()
    spec = spec if spec is not None else P(*placements) \
        if placements else P()
    out = block_of(tensor, layout_of(spec, mesh, tuple(mesh.axis_names)),
                   mesh).contiguous()
    out.sharding_spec = spec
    return out


# ---------------------------------------------------------------------------
# MeshPlan: the unified planner. One layout declaration -> every spec.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelDims:
    """The handful of numbers the cost model needs about a model.

    Everything is in *elements* except dtype_bytes. ``opt_slots`` counts
    f32 optimizer moments per param (Adam = 2). ``largest_layer_params``
    bounds the transient full-layer all-gather FSDP materializes — when
    0 we approximate with n_params / n_layers.
    """
    n_params: int
    hidden: int
    n_layers: int
    vocab: int = 0
    seq: int = 128
    batch: int = 8
    dtype_bytes: int = 4
    opt_slots: int = 2
    largest_layer_params: int = 0

    @property
    def layer_params(self) -> int:
        if self.largest_layer_params:
            return self.largest_layer_params
        return max(self.n_params // max(self.n_layers, 1), 1)

    @classmethod
    def from_state_dict(cls, state, hidden: int, n_layers: int,
                        seq: int = 128, batch: int = 8,
                        dtype_bytes: int = 4, opt_slots: int = 2):
        sizes = [int(np.prod(_shape_of(v) or (1,)))
                 for v in state.values()]
        return cls(n_params=int(sum(sizes)), hidden=hidden,
                   n_layers=n_layers, seq=seq, batch=batch,
                   dtype_bytes=dtype_bytes, opt_slots=opt_slots,
                   largest_layer_params=int(max(sizes) if sizes else 0))

    @classmethod
    def infer(cls, state, batch: int = 8, seq: int = 128,
              n_layers: Optional[int] = None, opt_slots: int = 2):
        """Best-effort dims from a bare state dict: hidden = the widest
        trailing dim of any matrix, n_layers = the matrix count unless
        given."""
        shapes = [_shape_of(v) or (1,) for v in state.values()]
        sizes = [int(np.prod(s)) for s in shapes]
        mats = [s for s in shapes if len(s) >= 2]
        hidden = max((s[-1] for s in mats), default=1)
        return cls(n_params=int(sum(sizes)), hidden=int(hidden),
                   n_layers=int(n_layers if n_layers is not None
                                else max(len(mats), 1)),
                   seq=seq, batch=batch, opt_slots=opt_slots,
                   largest_layer_params=int(max(sizes) if sizes
                                            else 0))


@dataclasses.dataclass(frozen=True)
class LayoutCost:
    """One candidate layout scored by the cost model: the byte ranks
    (``cost``), the analytic absolute step time, ``used`` naming the
    estimate that ranked it, and the wire bytes per axis with their
    collective-call counts."""
    sizes: Dict[str, int]
    hbm_per_chip: float      # params+grads+opt shards + gather ws + acts
    wire_per_chip: float     # collective bytes moved per step per chip
    bubble_penalty: float    # pp idle time expressed in byte-equivalents
    feasible: bool
    wire_by_axis: Dict[str, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)
    analytic_step_time_s: float = 0.0
    calibrated_step_time_s: Optional[float] = None
    used: str = "analytic"   # which estimate ranked this candidate

    @property
    def cost(self) -> float:
        return self.wire_per_chip + self.bubble_penalty

    @property
    def step_time_s(self) -> float:
        if self.used == "calibrated" and \
                self.calibrated_step_time_s is not None:
            return self.calibrated_step_time_s
        return self.analytic_step_time_s

    def as_dict(self) -> Dict[str, Any]:
        return {"sizes": dict(self.sizes),
                "hbm_per_chip": round(self.hbm_per_chip),
                "wire_per_chip": round(self.wire_per_chip),
                "bubble_penalty": round(self.bubble_penalty),
                "feasible": self.feasible,
                "cost": round(self.cost),
                "wire_by_axis": {a: dict(r) for a, r in
                                 self.wire_by_axis.items()},
                "analytic_step_time_s": self.analytic_step_time_s,
                "calibrated_step_time_s": self.calibrated_step_time_s,
                "used": self.used}


def _factorizations(n: int) -> List[Tuple[int, int, int, int]]:
    """All (dp, fsdp, tp, pp) with dp*fsdp*tp*pp == n."""
    out = []
    for dp in range(1, n + 1):
        if n % dp:
            continue
        m = n // dp
        for fsdp in range(1, m + 1):
            if m % fsdp:
                continue
            k = m // fsdp
            for tp in range(1, k + 1):
                if k % tp:
                    continue
                out.append((dp, fsdp, tp, k // tp))
    return out


def candidate_layouts(n_devices: int, max_tp: int = 8,
                      max_pp: int = 8) -> List[Dict[str, int]]:
    """Enumerate logical-axis factorizations of the device count, tp and
    pp capped."""
    cands = []
    for dp, fsdp, tp, pp in _factorizations(n_devices):
        if tp > max_tp or pp > max_pp:
            continue
        cands.append({"dp": dp, "fsdp": fsdp, "tp": tp, "pp": pp})
    return cands


#: matmul FLOPs a chip retires per byte of interconnect bandwidth — the
#: JAX package's exchange rate (a TPU v4-class chip), kept so both
#: packages rank alike
_FLOPS_PER_WIRE_BYTE = 128.0


def _wire_tier(compress: str) -> float:
    """Bytes-on-the-wire per f32 element for a grad wire tier, from
    comm.py's accounting."""
    from .comm import _wire_bytes
    n = 1 << 20
    return _wire_bytes("flat", compress, n, 4, 256) / float(4 * n)


def estimate_layout(sizes: Dict[str, int], dims: ModelDims,
                    hbm_bytes_per_chip: float,
                    compress: str = "none",
                    num_micro: int = 4,
                    calibration=None) -> LayoutCost:
    """Score one layout: per-chip HBM residency vs bytes moved per step
    (the JAX package's formulas; see its docstring)."""
    dp, fsdp, tp, pp = (sizes.get(a, 1) for a in LOGICAL_AXES)
    B = dims.dtype_bytes
    n_dev = dp * fsdp * tp * pp
    model_shard = dims.n_params * B / (fsdp * tp * pp)
    opt_shard = dims.opt_slots * dims.n_params * 4 / (fsdp * tp * pp)
    gather_ws = (dims.layer_params * B / tp) if fsdp > 1 else 0.0
    local_batch = dims.batch / (dp * fsdp)
    layers_local = math.ceil(dims.n_layers / pp)
    acts = local_batch * dims.seq * dims.hidden * B * 2 * layers_local
    hbm = 2 * model_shard + opt_shard + gather_ws + acts

    tier = _wire_tier(compress)
    act_bytes = local_batch * dims.seq * dims.hidden * B
    wire = 0.0
    wire_by_axis: Dict[str, Dict[str, float]] = {}
    if dp > 1:
        b = 2 * (dp - 1) / dp * model_shard * tier
        wire += b
        wire_by_axis["dp"] = {"bytes": b, "calls": 1}   # fused ring AR
    if fsdp > 1:
        full_on_tp_pp = dims.n_params * B / (tp * pp)
        b = (2 + tier) * (fsdp - 1) / fsdp * full_on_tp_pp
        wire += b
        wire_by_axis["fsdp"] = {"bytes": b, "calls": 3}  # ag+ag+rs
    if tp > 1:
        b = 4 * layers_local * 2 * (tp - 1) / tp * act_bytes
        wire += b
        wire_by_axis["tp"] = {"bytes": b, "calls": 4 * layers_local}
    if pp > 1:
        b = 2 * act_bytes
        wire += b
        wire_by_axis["pp"] = {"bytes": b,
                              "calls": 2 * max(num_micro, 1)}

    bubble = (pp - 1) / (num_micro + pp - 1) if pp > 1 else 0.0
    flops = 6.0 * dims.n_params * dims.batch * dims.seq
    compute_equiv = flops / _FLOPS_PER_WIRE_BYTE / n_dev
    penalty = bubble / max(1.0 - bubble, 1e-6) * compute_equiv

    # absolute estimates ride every candidate: analytic always, the
    # calibrated one when a table matched
    from ..observability import calibration as _calibration
    analytic_t = _calibration.predict_step_time_s(
        sizes, dims, wire_by_axis, None, num_micro=num_micro,
        compress=compress)["total_s"]
    calibrated_t = None
    used = "analytic"
    if calibration is not None:
        calibrated_t = _calibration.predict_step_time_s(
            sizes, dims, wire_by_axis, calibration, num_micro=num_micro,
            compress=compress)["total_s"]
        used = "calibrated"

    return LayoutCost(sizes={a: sizes.get(a, 1) for a in LOGICAL_AXES},
                      hbm_per_chip=hbm, wire_per_chip=wire,
                      bubble_penalty=penalty,
                      feasible=hbm <= hbm_bytes_per_chip,
                      wire_by_axis=wire_by_axis,
                      analytic_step_time_s=analytic_t,
                      calibrated_step_time_s=calibrated_t, used=used)


def choose_layout(n_devices: int, dims: ModelDims,
                  hbm_bytes_per_chip: float, compress: str = "none",
                  num_micro: int = 4, max_tp: int = 8, max_pp: int = 8,
                  calibration=None
                  ) -> Tuple[Dict[str, int], List[LayoutCost]]:
    """Pick the cheapest feasible layout; raise with the full report if
    nothing fits. With a matching observability.calibration.Calibration
    the rank key is the calibrated absolute step time; without one, the
    analytic byte cost. Feasibility is byte math either way."""
    reports = [estimate_layout(c, dims, hbm_bytes_per_chip,
                               compress=compress, num_micro=num_micro,
                               calibration=calibration)
               for c in candidate_layouts(n_devices, max_tp=max_tp,
                                          max_pp=max_pp)]
    feasible = [r for r in reports if r.feasible]
    if not feasible:
        tight = min(reports, key=lambda r: r.hbm_per_chip)
        raise ValueError(
            "no layout of %d devices fits %d bytes/chip; closest %s "
            "needs %d" % (n_devices, int(hbm_bytes_per_chip),
                          tight.sizes, int(tight.hbm_per_chip)))
    # deterministic tie-break: prefer fewer pipeline stages, then less
    # tp, then less fsdp — the simplest layout that is also cheapest
    if calibration is not None:
        best = min(feasible,
                   key=lambda r: (r.calibrated_step_time_s,
                                  r.sizes["pp"], r.sizes["tp"],
                                  r.sizes["fsdp"]))
    else:
        best = min(feasible, key=lambda r: (r.cost, r.sizes["pp"],
                                            r.sizes["tp"],
                                            r.sizes["fsdp"]))
    return dict(best.sizes), reports


_EMBED_RE = re.compile(r"(embed|mlm_head\.decoder)", re.I)


class MeshPlan:
    """One layout declaration -> every PartitionSpec in the program.

    >>> plan = MeshPlan(dp=2, tp=2)
    >>> mesh = plan.build_mesh()                 # env.Mesh over the ranks
    >>> plan.param_spec("blk.qkv.weight", t)     # row/col from annotation
    >>> plan.data_spec(batch)                    # batch over (dp, fsdp)
    >>> plan.stacked_param_spec("qkv.weight", t) # P('pp', *param spec)

    Axis semantics (LOGICAL_AXES): 'dp' replicates params and shards the
    batch; 'fsdp' shards the batch AND params/grads/opt state; 'tp'
    follows the layer annotations (qkv col-, out row-sharded, embeddings
    fsdp x tp on the vocab dim); 'pp' shards the stacked stage dim of
    the SPMD pipeline (its engine comes with ROADMAP.md item 14d).
    """

    def __init__(self, dp: int = 1, fsdp: int = 1, tp: int = 1,
                 pp: int = 1, *, rules: Dict[str, P] = None,
                 batch_dim: int = 0, compress: str = "none"):
        sizes = {"dp": int(dp), "fsdp": int(fsdp), "tp": int(tp),
                 "pp": int(pp)}
        for a, s in sizes.items():
            if s < 1:
                raise ValueError("axis %r size must be >= 1, got %d"
                                 % (a, s))
        self.sizes = sizes
        self.rules = dict(rules or {})
        self.batch_dim = batch_dim
        self.compress = compress
        self._mesh = None
        self.report: List[LayoutCost] = []
        #: the calibration that ranked this plan (None = analytic) and
        #: the dims it was planned for — both feed .predict()
        self.calibration = None
        self.dims: Optional[ModelDims] = None
        self.receipt = None

    # -- construction -------------------------------------------------------
    @classmethod
    def auto(cls, n_devices: int, dims: ModelDims,
             hbm_bytes_per_chip: float, *, rules: Dict[str, P] = None,
             compress: str = "none", num_micro: int = 4,
             max_tp: int = 8, max_pp: int = 8,
             calibration="auto") -> "MeshPlan":
        """layout="auto": cost-model search over the factorizations of
        the device count; the losing candidates ride along in .report.
        ``calibration="auto"`` reads the committed table when it matches
        the live (device_kind, topology): a mismatch warns and ranks with
        the analytic constants. None forces the analytic ranking; a
        Calibration pins one."""
        calib = calibration
        if isinstance(calib, str) and calib == "auto":
            from ..observability import calibration as _calibration
            try:
                calib = _calibration.load_for(n_devices=n_devices)
            except Exception:
                calib = None
        sizes, reports = choose_layout(
            n_devices, dims, hbm_bytes_per_chip, compress=compress,
            num_micro=num_micro, max_tp=max_tp, max_pp=max_pp,
            calibration=calib)
        plan = cls(rules=rules, compress=compress, **sizes)
        plan.report = reports
        plan.calibration = calib
        plan.dims = dims
        cls._ledger_layout(n_devices, dims, hbm_bytes_per_chip,
                           compress, num_micro, max_tp, max_pp,
                           calib, sizes, reports)
        return plan

    @staticmethod
    def _ledger_layout(n_devices, dims, hbm_bytes_per_chip, compress,
                       num_micro, max_tp, max_pp, calib, sizes,
                       reports):
        """Ledger the layout pick (observability.decisions): the losing
        candidates and the ranking rule are the evidence."""
        from ..observability import decisions as _dec
        if not _dec.enabled():
            return
        from ..observability import metrics as _obs

        def _probe():
            g = _obs.get("planner.prediction_error", metric="step_time")
            if g is None:
                return None
            return {"prediction_error": abs(float(g.value()))}

        def _judge(pre, post):
            err = post.get("prediction_error")
            if err is None:
                return "neutral"
            return "improved" if abs(err) <= 0.2 else "worse"

        _dec.record(
            "planner.layout", "layout",
            rule=("calibrated step-time ranking" if calib is not None
                  else "analytic byte-cost ranking"),
            evidence={
                "inputs": {
                    "n_devices": int(n_devices),
                    "dims": dataclasses.asdict(dims),
                    "hbm_bytes_per_chip": float(hbm_bytes_per_chip),
                    "compress": compress,
                    "num_micro": int(num_micro),
                    "max_tp": int(max_tp), "max_pp": int(max_pp),
                    "calibration": (dict(calib.table)
                                    if calib is not None else None)},
                "decision": {
                    "action": "layout", "sizes": dict(sizes),
                    "candidates": [r.as_dict() for r in reports]}},
            signals={"prediction_error": 0.0},
            settle_s=600.0, probe=_probe, judge=_judge)

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.sizes.values():
            n *= s
        return n

    def axis_names(self) -> Tuple[str, ...]:
        """Mesh axes, outermost first: pp, dp, fsdp, tp (size-1 axes are
        dropped — absent from the mesh means absent from every spec)."""
        order = ("pp", "dp", "fsdp", "tp")
        return tuple(a for a in order if self.sizes[a] > 1)

    def mesh_shape(self) -> Dict[str, int]:
        return {a: self.sizes[a] for a in self.axis_names()}

    def build_mesh(self, devices=None):
        """env.Mesh over the world's ranks (`devices`: the ranks, default
        0..n-1); with a process group, a DeviceMesh and a group per
        axis."""
        from .env import build_mesh
        shape = self.mesh_shape() or {"dp": 1}
        devices = devices if devices is not None \
            else list(range(self.n_devices))
        self._mesh = build_mesh(shape, devices=devices)
        return self._mesh

    @property
    def mesh(self):
        if self._mesh is None:
            self.build_mesh()
        return self._mesh

    def _axis(self, a: str) -> Optional[str]:
        return a if self.sizes[a] > 1 else None

    # -- spec derivation ----------------------------------------------------
    def _sanitize(self, spec: P) -> P:
        """Drop spec axes absent from this layout: pure layout math
        against the declared axis names, no mesh needed."""
        names = set(self.axis_names())

        def keep(p):
            if p is None:
                return None
            if isinstance(p, (tuple, list)):
                kept = tuple(a for a in p if a in names)
                return kept if kept else None
            return p if p in names else None
        return P(*[keep(p) for p in spec])

    def param_spec(self, name: str, tensor) -> P:
        """annotation -> rules -> P(), then fsdp on the largest free dim;
        an embedding table already tp-split on its vocab dim gains fsdp
        on the same dim (('fsdp', 'tp'))."""
        spec = self._sanitize(_spec_for_param(name, tensor, self.rules))
        fsdp = self._axis("fsdp")
        if fsdp is None:
            return spec
        shape = _shape_of(tensor)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if (_EMBED_RE.search(name) and len(shape) == 2
                and parts and parts[0] is not None
                and parts[0] == self._axis("tp")
                and shape[0] % (self.sizes["fsdp"] * self.sizes["tp"])
                == 0):
            parts[0] = (fsdp, parts[0])
            return P(*parts)
        return _add_axis(P(*parts), tensor, fsdp, self.sizes["fsdp"])

    def state_spec(self, name: str, tensor) -> P:
        """Optimizer moments mirror the param layout exactly."""
        return self.param_spec(name, tensor)

    def data_spec(self, array) -> P:
        nd = len(array.shape) if hasattr(array, "shape") \
            else np.ndim(array)
        if nd == 0:
            return P()
        data_axes = tuple(a for a in ("dp", "fsdp") if self.sizes[a] > 1)
        if not data_axes:
            return P()
        parts = [None] * nd
        parts[self.batch_dim] = (data_axes if len(data_axes) > 1
                                 else data_axes[0])
        return P(*parts)

    def activation_spec(self, ndim: int, batch_dim: int = 0) -> P:
        """Per-microbatch activation spec inside the step body."""
        parts = [None] * ndim
        data_axes = tuple(a for a in ("dp", "fsdp") if self.sizes[a] > 1)
        if data_axes and ndim > batch_dim:
            parts[batch_dim] = (data_axes if len(data_axes) > 1
                                else data_axes[0])
        return P(*parts)

    def stacked_param_spec(self, name: str, tensor) -> P:
        """Spec for a stage-stacked [S, ...] param: leading dim over
        'pp', trailing dims per param_spec."""
        base = self.param_spec(name, tensor)
        return P(self._axis("pp"), *base)

    def stacked_activation_spec(self, ndim: int) -> P:
        """[S, batch, ...] ring buffers: stage dim over pp, batch over
        the data axes."""
        inner = self.activation_spec(ndim - 1, batch_dim=0)
        return P(self._axis("pp"), *inner)

    # -- integration surfaces ----------------------------------------------
    def sharding_plan(self) -> ShardingPlan:
        """A ShardingPlan over this plan's mesh (TrainStep's
        sharding_plan=, the fleet's older interface)."""
        cached = getattr(self, "_splan", None)
        if cached is None or cached.mesh is not self.mesh:
            cached = ShardingPlan(
                self.mesh, rules=self.rules, dp_axis="dp",
                data_axes=tuple(a for a in ("dp", "fsdp")
                                if self.sizes[a] > 1),
                batch_dim=self.batch_dim,
                fsdp_axis=self._axis("fsdp"))
            self._splan = cached
        return cached

    def resync_assignments(self, named_params) -> Dict[str, str]:
        raise NotImplementedError(
            "MeshPlan.resync_assignments (the elastic worker's regrown-"
            "slot resync) is not ported yet: it comes with ROADMAP.md "
            "item 14c")

    def predict(self, dims: Optional[ModelDims] = None, *,
                num_micro: int = 4, calibration="inherit",
                hbm_bytes_per_chip: float = float("inf")):
        """Score THIS plan's layout and return the PlanReceipt (step
        time, HBM peak and wire bytes). auto() plans carry their dims;
        manual plans pass them (or ModelDims.infer).
        ``calibration="inherit"`` uses whatever ranked the plan; "auto"
        re-resolves the committed table; None forces analytic."""
        from ..observability import calibration as _calibration
        dims = dims if dims is not None else self.dims
        if dims is None:
            raise ValueError(
                "MeshPlan.predict needs ModelDims — auto() plans carry "
                "them; manual plans must pass dims= (see "
                "ModelDims.infer)")
        calib = calibration
        if isinstance(calib, str) and calib == "inherit":
            calib = self.calibration
        elif isinstance(calib, str) and calib == "auto":
            try:
                calib = _calibration.load_for(n_devices=self.n_devices)
            except Exception:
                calib = None
        cost = estimate_layout(self.sizes, dims, hbm_bytes_per_chip,
                               compress=self.compress,
                               num_micro=num_micro, calibration=calib)
        if calib is not None:
            kind, topo = calib.device_kind, calib.topology
        else:
            ident = _calibration.device_identity()
            kind = ident["device_kind"]
            topo = _calibration.topology_fingerprint(kind,
                                                     ident["n_devices"])
        receipt = _calibration.PlanReceipt(
            sizes=dict(self.sizes),
            predicted_step_time_s=cost.step_time_s,
            predicted_hbm_bytes=cost.hbm_per_chip,
            predicted_wire_bytes=cost.wire_per_chip,
            analytic_step_time_s=cost.analytic_step_time_s,
            calibrated_step_time_s=cost.calibrated_step_time_s,
            used=cost.used,
            device_kind=kind,
            topology=topo,
            calibration_match=calib is not None,
            breakdown={"wire_by_axis": {a: dict(r) for a, r in
                                        cost.wire_by_axis.items()},
                       "bubble_penalty": round(cost.bubble_penalty),
                       "num_micro": num_micro})
        self.receipt = receipt
        self.dims = dims
        return receipt

    def describe(self) -> Dict[str, Any]:
        d = {"sizes": dict(self.sizes), "axes": list(self.axis_names()),
             "n_devices": self.n_devices, "compress": self.compress}
        if self.report:
            d["report"] = [r.as_dict() for r in self.report]
        if self.calibration is not None:
            d["calibration"] = {"topology": self.calibration.topology,
                                "synthetic": self.calibration.synthetic}
        if self.receipt is not None:
            d["receipt"] = self.receipt.as_dict()
        return d


# ---------------------------------------------------------------------------
# serving spec derivation (tensor-parallel serving: ROADMAP.md item 14c)
# ---------------------------------------------------------------------------

#: per-leaf tp specs, keyed by the serving-snapshot block leaf name
SERVING_TP_RULES = {
    "qkv_w": P(None, "tp"), "qkv_b": P("tp"),
    "proj_w": P("tp", None), "proj_b": P(),
    "fc1_w": P(None, "tp"), "fc1_b": P("tp"),
    "fc2_w": P("tp", None), "fc2_b": P(),
}

#: the paged K/V page pools [n_blocks, block_size, n_heads, hd] shard
#: over the heads axis
SERVING_POOL_SPEC = P(None, None, "tp", None)


def permute_qkv_heads(arr, n_heads):
    """Reorder a fused-qkv weight's output columns (or the bias) from
    (3, n_heads, hd) to (n_heads, 3, hd), so that a contiguous tp shard
    of the last dim carries whole heads with their q, k and v. Values
    move unchanged; shapes are preserved. Takes a torch tensor or a
    numpy array and returns the same kind."""
    out = arr.shape[-1]
    hd = out // (3 * n_heads)
    x = arr.reshape(tuple(arr.shape[:-1]) + (3, n_heads, hd))
    x = x.swapaxes(-3, -2) if isinstance(x, np.ndarray) else \
        x.transpose(-3, -2)
    return x.reshape(tuple(arr.shape))


def serving_param_specs(params):
    """PartitionSpec tree matching a serving snapshot (float or int8
    ``{"q8","s"}`` leaves): block weights per SERVING_TP_RULES,
    everything else replicated; q8 mirrors the float weight's spec, the
    per-column scale shards over 'tp' exactly when the out dim does."""
    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, names + [str(i)])
                              for i, v in enumerate(node))
        if names and names[-1] in ("q8", "s") and len(names) >= 2:
            base = SERVING_TP_RULES.get(names[-2], P(None, None))
            if names[-1] == "q8":
                return base
            return P("tp") if (len(base) > 1 and base[1] == "tp") \
                else P()
        return SERVING_TP_RULES.get(names[-1] if names else "", P())
    return walk(params, [])

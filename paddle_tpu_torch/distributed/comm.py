"""The gradient-sync planner: bucketing, algorithm choice and quantized
wire tiers (counterpart of paddle_tpu/distributed/comm.py), on
torch.distributed.

Three levers, each optional:

1. **The algorithm planner.** Per payload: the flat all-reduce for small
   payloads (latency-bound), reduce-scatter then all-gather for large
   ones (bandwidth-bound), and on a factored mesh such as ("host",
   "chip") the hierarchical schedule: reduce-scatter inside the inner
   axis, all-reduce of the shards over the outer axis, all-gather
   inside the inner axis, so the outer wire carries 1/n_inner of the
   bytes.
2. **Bucketing.** Named grads are packed, in sorted-name order, into
   size-targeted flat buckets (4 MiB by default), one collective a
   bucket.
3. **Wire tiers.** ``compress="bf16"`` casts, reduces and casts back
   (half the bytes); ``compress="int8_ef"`` sends block-scaled int8 codes
   and their f32 scales (all-gathered, summed after decoding) and keeps
   an error-feedback residual that is added back next step.

Bucket specs, the algorithm chosen, the int8 codes and scales (both
packages round half to even) and the ``comm.wire_bytes`` receipts equal
the JAX package's for the same grads. The axes a sync runs over are
those of the process mesh that have a group (env.axis_group); with none
every path is the identity and only the codecs run, as in the JAX
package outside a shard_map.

Receipts: ``comm.algo{algo,compress}``, ``comm.fused_buckets`` and
``comm.wire_bytes`` through the metrics plane, and a collective.enter/
exit pair with a per-(axis, op) seq through the flight recorder, per
fused collective, each under the JAX package's anatomy scope
("grad_sync", "param_gather"; observability.anatomy.scope).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import metrics as _obs
from ..observability.anatomy import scope as _scope
from . import collective as _c
from .collective import Group, _record
from .env import DATA_AXIS, axis_group, current_axis_name

__all__ = ["CommConfig", "GradSynchronizer", "ParamSynchronizer",
           "planned_all_reduce", "choose_algorithm", "build_buckets",
           "flatten_bucket", "unflatten_bucket", "BucketSpec",
           "purge_residual_state"]

_MiB = 1 << 20
_COMPRESS = ("f32", "bf16", "int8_ef")
_ALGORITHMS = ("auto", "flat", "rs_ag", "hierarchical")


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Gradient-sync plan knobs (the JAX package's, field for field).

    algorithm       "auto" plans per payload; "flat", "rs_ag" or
                    "hierarchical" force one ("hierarchical" needs two
                    axes, outer first).
    bucket_bytes    the fused-bucket target size.
    compress        "f32" (exact), "bf16" (half the wire), "int8_ef"
                    (block-scaled int8 with error feedback; flat and
                    rs_ag axes only, lowered as a quantized all-gather
                    sum, label "q_ag").
    flat_threshold  payloads below this stay flat under "auto".
    hierarchy       the factored mesh axes (outer, inner).
    int8_block      elements per int8 scale.
    """
    algorithm: str = "auto"
    bucket_bytes: int = 4 * _MiB
    compress: str = "f32"
    flat_threshold: int = 128 << 10
    hierarchy: Optional[Tuple[str, str]] = None
    int8_block: int = 256

    def __post_init__(self):
        if self.algorithm not in _ALGORITHMS:
            raise ValueError(
                f"algorithm={self.algorithm!r}: pick one of {_ALGORITHMS}")
        if self.compress not in _COMPRESS:
            raise ValueError(
                f"compress={self.compress!r}: pick one of {_COMPRESS}")
        if self.bucket_bytes <= 0:
            raise ValueError("bucket_bytes must be positive")
        if self.int8_block <= 0:
            raise ValueError("int8_block must be positive")
        if self.hierarchy is not None and len(self.hierarchy) != 2:
            raise ValueError(
                "hierarchy names exactly (outer, inner) mesh axes, "
                f"got {self.hierarchy!r}")
        if self.compress == "int8_ef" and (
                self.algorithm == "hierarchical"
                or self.hierarchy is not None):
            raise ValueError(
                "int8_ef inside the hierarchical schedule is not "
                "supported (the error-feedback residual would have to "
                "live per intra-host shard); use compress='bf16' for "
                "factored meshes or algorithm='auto' on one axis")


def choose_algorithm(nbytes: int, axes: Sequence[str],
                     config: CommConfig) -> str:
    """The planner: "flat", "rs_ag", "hier" or "q_ag".

      compress=int8_ef              -> q_ag
      2 axes (factored mesh)        -> hier
      an explicit algorithm         -> as forced
      nbytes < flat_threshold       -> flat
      else                          -> rs_ag
    """
    axes = tuple(axes)
    if config.compress == "int8_ef":
        if config.algorithm == "hierarchical" or len(axes) > 1:
            raise ValueError(
                "int8_ef + hierarchical schedule is unsupported "
                "(CommConfig rejects this combination)")
        return "q_ag"
    if len(axes) <= 1 and config.algorithm == "hierarchical":
        # one axis or none: a correct reduction over what there is
        return "flat"
    if config.algorithm == "hierarchical":
        if len(axes) != 2:
            raise ValueError(
                f"hierarchical all-reduce needs 2 live mesh axes "
                f"(outer, inner), have {axes!r}")
        return "hier"
    if config.algorithm == "flat":
        return "flat"
    if config.algorithm == "rs_ag":
        if len(axes) > 1:
            raise ValueError(
                f"rs_ag decomposes over ONE axis, have {axes!r} — "
                "use algorithm='hierarchical' (or 'auto') for "
                "factored meshes")
        return "rs_ag"
    if len(axes) > 2:
        raise ValueError(
            f"no schedule spans {len(axes)} axes ({axes!r}): the "
            "hierarchical form is (outer, inner) — pass axes=/"
            "hierarchy= naming the two levels to reduce over")
    if len(axes) == 2:
        return "hier"
    if nbytes < config.flat_threshold:
        return "flat"
    return "rs_ag"


# -- bucketing ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One fused bucket: its tensors, in order, and their sizes. Pure
    metadata. ``dtype`` is the numpy dtype the JAX package names
    ("bfloat16" for bfloat16)."""
    index: int
    dtype: Any
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]          # element counts, aligned with names

    @property
    def num_elements(self) -> int:
        return int(sum(self.sizes))

    @property
    def nbytes(self) -> int:
        return self.num_elements * _itemsize(self.dtype)

    @property
    def floating(self) -> bool:
        return isinstance(self.dtype, str) or np.dtype(self.dtype).kind == "f"

    @property
    def residual_key(self) -> str:
        """The strategy-state key of this bucket's error-feedback
        residual, fingerprinted on the member layout (names and shapes),
        so a rebuilt layout never inherits another's residual; crc32,
        the same in every process and in both packages."""
        fp = zlib.crc32(repr((self.names, self.shapes)).encode())
        return f"residual_{self.index}_{fp:08x}"


def _dtype_key(dt):
    """A tensor's dtype as the JAX package's bucket specs name it: the
    numpy dtype, or the string "bfloat16" (which numpy lacks)."""
    if isinstance(dt, torch.dtype):
        if dt == torch.bfloat16:
            return "bfloat16"
        return np.dtype(str(dt).replace("torch.", ""))
    dt = np.dtype(dt)
    return "bfloat16" if dt.name == "bfloat16" else dt


def _itemsize(dt) -> int:
    return 2 if isinstance(dt, str) else np.dtype(dt).itemsize


def _leaf_meta(v) -> Tuple[Tuple[int, ...], Any]:
    if isinstance(v, torch.Tensor):
        return tuple(int(d) for d in v.shape), _dtype_key(v.dtype)
    arr = np.asarray(v)
    return tuple(arr.shape), _dtype_key(arr.dtype)


def build_buckets(grads: Dict[str, Any],
                  bucket_bytes: int) -> List[BucketSpec]:
    """Pack named grads into size-targeted buckets, one open bucket per
    dtype, in sorted-name order. A bucket closes when it reaches
    ``bucket_bytes``; a tensor larger than that gets its own bucket
    (never split across collectives)."""
    grads = {k: grads[k] for k in sorted(grads)}
    open_by_dtype: Dict[Any, List[Tuple[str, Tuple[int, ...], int]]] = {}
    open_bytes: Dict[Any, int] = {}
    specs: List[BucketSpec] = []

    def close(dt):
        entries = open_by_dtype.pop(dt, [])
        open_bytes.pop(dt, None)
        if not entries:
            return
        specs.append(BucketSpec(
            index=len(specs), dtype=dt,
            names=tuple(e[0] for e in entries),
            shapes=tuple(e[1] for e in entries),
            sizes=tuple(e[2] for e in entries)))

    for name, v in grads.items():
        shape, dt = _leaf_meta(v)
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        open_by_dtype.setdefault(dt, []).append((name, shape, size))
        open_bytes[dt] = open_bytes.get(dt, 0) + size * _itemsize(dt)
        if open_bytes[dt] >= bucket_bytes:
            close(dt)
    for dt in list(open_by_dtype):
        close(dt)
    return specs


def flatten_bucket(grads: Dict[str, torch.Tensor],
                   spec: BucketSpec) -> torch.Tensor:
    """The bucket's grads as one flat vector (reshape and concatenate:
    exact)."""
    parts = [grads[name].reshape(-1) for name in spec.names]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unflatten_bucket(flat: torch.Tensor,
                     spec: BucketSpec) -> Dict[str, torch.Tensor]:
    out = {}
    off = 0
    for name, shape, size in zip(spec.names, spec.shapes, spec.sizes):
        out[name] = flat[off:off + size].reshape(shape)
        off += size
    return out


# -- codecs -------------------------------------------------------------------

def _pad_to(v: torch.Tensor, multiple: int) -> torch.Tensor:
    rem = (-v.shape[0]) % multiple
    if rem:
        v = torch.cat([v, v.new_zeros((rem,))])
    return v


def _quantize_int8(y: torch.Tensor, block: int):
    """Block-scaled int8: one f32 scale per `block` elements, symmetric
    round to nearest (half to even) into [-127, 127]."""
    n = y.shape[0]
    blocks = _pad_to(y, block).reshape(-1, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32), n


def _dequantize_int8(q, scale, n: int) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


def _wire_bytes(algo: str, compress: str, num_elements: int,
                itemsize: int, int8_block: int) -> int:
    """Payload bytes a rank puts on the wire for one fused collective
    (the payload, not the algorithm's per-link traffic)."""
    if compress == "bf16":
        return num_elements * 2
    if compress == "int8_ef":
        nblocks = -(-num_elements // int8_block)
        return num_elements + 4 * nblocks   # int8 codes + f32 scales
    return num_elements * itemsize


# -- the planned all-reduce body ------------------------------------------------

def _live(axes: Sequence[str]) -> Tuple[str, ...]:
    """Of the requested axes, those with a process group (none without
    a process group: the world-size-1 identity)."""
    return tuple(ax for ax in axes if axis_group(ax) is not None)


def _sum_flat(flat: torch.Tensor, axes: Tuple[str, ...],
              algo: str) -> torch.Tensor:
    """The sum of `flat` over `axes` by the planned algorithm; flat's
    dtype is the wire dtype."""
    if not axes:
        return flat
    if algo == "flat":
        out = flat.clone()
        for ax in axes:
            _c._all_reduce_(out, _c.ReduceOp.SUM, axis_group(ax))
        return out
    if algo == "rs_ag":
        (ax,) = axes
        pg = axis_group(ax)
        size = flat.shape[0]
        shard = _c._reduce_scatter_dim0(_pad_to(flat, _c._size(pg)),
                                        _c.ReduceOp.SUM, pg)
        return _c._gather_flat(shard, pg).reshape(-1)[:size]
    if algo == "hier":
        outer, inner = (axis_group(a) for a in axes)
        size = flat.shape[0]
        # inside the host: each rank owns a 1/n_inner shard
        shard = _c._reduce_scatter_dim0(_pad_to(flat, _c._size(inner)),
                                        _c.ReduceOp.SUM, inner)
        # across hosts: the slow wire moves 1/n_inner of the payload
        _c._all_reduce_(shard, _c.ReduceOp.SUM, outer)
        return _c._gather_flat(shard, inner).reshape(-1)[:size]
    raise ValueError(f"unknown algorithm {algo!r}")


def _q_ag_sum(y: torch.Tensor, axes: Tuple[str, ...], block: int):
    """The quantized all-reduce: every rank's int8 codes and scales are
    all-gathered (they are what crosses the wire) and summed after
    decoding. Returns (sum, this rank's decoded payload)."""
    q, scale, n = _quantize_int8(y, block)
    local = _dequantize_int8(q, scale, n)
    if not axes:
        return local, local
    (ax,) = axes
    pg = axis_group(ax)
    gq = _c._gather_flat(q, pg)              # [w, nb, blk]
    gs = _c._gather_flat(scale, pg)          # [w, nb, 1]
    dec = (gq.to(torch.float32) * gs).sum(dim=0)
    return dec.reshape(-1)[:n], local


def _allreduce_flat(flat, axes: Tuple[str, ...], algo: str, compress: str,
                    residual, int8_block: int):
    """One fused bucket's sync. Returns (reduced_flat, new_residual)."""
    if compress == "f32" or not flat.is_floating_point():
        return _sum_flat(flat, axes, algo), residual
    if compress == "bf16":
        wire = flat.to(torch.bfloat16)
        return _sum_flat(wire, axes, algo).to(flat.dtype), residual
    # int8_ef: the quantization error is carried to the next step
    y = flat if residual is None else flat + residual
    out, local_decoded = _q_ag_sum(y, axes, int8_block)
    return out.to(flat.dtype), y - local_decoded


def _record_fused(algo: str, compress: str, axes: Tuple[str, ...],
                  nbytes: int, elements: Optional[int] = None):
    """comm.* counters and one collective.enter/exit pair (seq per
    (axis, op)) per fused collective; `elements` rides the schedule
    capture. Returns the exit hook or None."""
    if _obs._enabled:
        _obs.counter("comm.algo", algo=algo, compress=compress).add(1)
        _obs.counter("comm.wire_bytes").add(nbytes)
    axis_label = "+".join(axes) if axes else None
    return _record(f"fused_allreduce_{algo}", axis_label, nbytes=nbytes,
                   meta={"algo": algo, "compress": compress,
                         "elements": elements})


# -- public surfaces ------------------------------------------------------------

def _resolve_axes(config: CommConfig, axes=None, group=None
                  ) -> Tuple[str, ...]:
    if axes is not None:
        want = tuple(axes)
    elif config.hierarchy is not None:
        want = tuple(config.hierarchy)
    elif isinstance(group, Group):
        want = (group.axis,)
    elif isinstance(group, str):
        want = (group,)
    else:
        # the same default as all_reduce: the innermost context axis,
        # else dp (never every axis: that would widen a dp x tp sum)
        want = (current_axis_name() or DATA_AXIS,)
    return _live(want)


def planned_all_reduce(tensor, config: Optional[CommConfig] = None,
                       axes=None, group=None):
    """A single-payload planned all-reduce (SUM) of `tensor`, in place:
    the algorithm planned for its size and the live axes, the configured
    wire tier, the comm receipts. Grads should prefer GradSynchronizer
    (bucketing and error feedback)."""
    config = config or CommConfig()
    live = _resolve_axes(config, axes=axes, group=group)
    nbytes = tensor.numel() * tensor.element_size()
    # non-floating payloads go uncompressed at full precision
    compress = config.compress if tensor.is_floating_point() else "f32"
    plan_cfg = config if compress == config.compress else \
        dataclasses.replace(config, compress="f32")
    algo = choose_algorithm(nbytes, live, plan_cfg)
    wire = _wire_bytes(algo, compress, tensor.numel(),
                       tensor.element_size(), config.int8_block)
    done = _record_fused(algo, compress, live, wire,
                         elements=tensor.numel())
    with _scope("grad_sync"):
        out, _ = _allreduce_flat(tensor.reshape(-1), live, algo, compress,
                                 None, config.int8_block)
        with torch.no_grad():
            tensor.copy_(out.reshape(tensor.shape))
    done and done()
    return tensor


def purge_residual_state(state: Dict[str, Any]) -> int:
    """Drop every int8-EF ``residual_*`` entry from a strategy-state dict
    in place; returns how many went. A restore that lands params without
    their strategy state calls it, so the residuals restart from zero (a
    reset is unbiased, a residual from another timeline is not)."""
    stale = [k for k in state if k.startswith("residual_")]
    for k in stale:
        del state[k]
    return len(stale)


class GradSynchronizer:
    """Bucketed, planned, optionally quantized gradient all-reduce (SUM).

    ``sync(grads, state) -> (grads, state)`` over a {name: tensor} dict;
    `state` carries the int8_ef residuals per bucket (``init_state()``,
    threaded through the steps). f32 mode keeps grads bit for bit where
    no axis is live (bucketing is reshape and concatenate). The fleet
    grad-transform surface is ``as_grad_transform()``; a TrainStep over a
    dp mesh lets such a transform do its dp reduction
    (``syncs_dp_grads``)."""

    def __init__(self, config: Optional[CommConfig] = None, axes=None,
                 group=None):
        self.config = config or CommConfig()
        self._axes = axes
        self._group = group
        self._buckets: Optional[List[BucketSpec]] = None
        self._bucket_key = None

    def buckets_for(self, grads: Dict[str, Any]) -> List[BucketSpec]:
        """The bucket layout, computed once per grads structure (names,
        shapes, dtypes; order-insensitive) and rebuilt when it changes."""
        key = tuple((name,) + _leaf_meta(grads[name])
                    for name in sorted(grads))
        if self._buckets is None or key != self._bucket_key:
            self._buckets = build_buckets(grads, self.config.bucket_bytes)
            self._bucket_key = key
        return self._buckets

    def init_state(self, grads: Dict[str, Any]) -> Dict[str, Any]:
        """Error-feedback residuals, one flat f32 vector per floating
        bucket, on the grads' device (empty for the exact tiers)."""
        if self.config.compress != "int8_ef":
            return {}
        dev = _device_of(grads)
        return {spec.residual_key: torch.zeros((spec.num_elements,),
                                               dtype=torch.float32,
                                               device=dev)
                for spec in self.buckets_for(grads) if spec.floating}

    def __call__(self, grads: Dict[str, torch.Tensor], state=None):
        state = dict(state or {})
        cfg = self.config
        live = _resolve_axes(cfg, axes=self._axes, group=self._group)
        specs = self.buckets_for(grads)
        if _obs._enabled:
            _obs.counter("comm.fused_buckets").add(len(specs))
        out = dict(grads)
        for spec in specs:
            compress = cfg.compress if spec.floating else "f32"
            algo = choose_algorithm(spec.nbytes, live,
                                    cfg if compress == cfg.compress
                                    else dataclasses.replace(
                                        cfg, compress="f32"))
            wire = _wire_bytes(algo, compress, spec.num_elements,
                               _itemsize(spec.dtype), cfg.int8_block)
            done = _record_fused(algo, compress, live, wire,
                                 elements=spec.num_elements)
            rkey = spec.residual_key
            res = state.get(rkey)
            flat = flatten_bucket(grads, spec)
            if compress == "int8_ef" and res is None:
                # no residual yet (no init_state, or a new layout):
                # start from zero, never drop the feedback
                res = torch.zeros((spec.num_elements,), dtype=torch.float32,
                                  device=flat.device)
            with _scope("grad_sync"):
                reduced, new_res = _allreduce_flat(
                    flat, live, algo, compress, res, cfg.int8_block)
                unflat = unflatten_bucket(reduced, spec)
            done and done()
            if new_res is not None:
                state[rkey] = new_res
            out.update(unflat)
        # residuals of layouts that no longer exist go
        valid = {s.residual_key for s in specs}
        for k in list(state):
            if k.startswith("residual_") and k not in valid:
                del state[k]
        return out, state

    def as_grad_transform(self):
        """(init_state, fn): fn(grads, state, params) -> (grads, state),
        the fleet grad-transform contract (params unused). fn carries
        ``syncs_dp_grads``: it is a sum over the dp ranks."""
        def fn(grads, state, params):
            return self(grads, state)
        fn.syncs_dp_grads = True
        return self.init_state, fn


def _device_of(tree: Dict[str, Any]):
    for v in tree.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


class ParamSynchronizer:
    """FSDP building block: bucketed param all-gather and grad
    reduce-scatter over the 'fsdp' axis (flat partitioning: each
    bucket's flat vector is zero-padded to a multiple of the world and
    cut in contiguous chunks, rank i owning chunk i). ``shard`` keeps the
    local chunk, ``gather`` reassembles full params (through the bf16
    wire when configured), ``scatter_grads`` turns full grads into owned
    chunks (reduce-scatter, or for int8_ef the quantized all-gather sum
    with its residual, then the local chunk). Every method is the
    identity with no live axis."""

    def __init__(self, config: Optional[CommConfig] = None,
                 axes: Sequence[str] = ("fsdp",)):
        self.config = config or CommConfig()
        self._axes = tuple(axes)
        self._buckets: Optional[List[BucketSpec]] = None
        self._bucket_key = None

    def buckets_for(self, tree: Dict[str, Any]) -> List[BucketSpec]:
        key = tuple((name,) + _leaf_meta(tree[name]) for name in sorted(tree))
        if self._buckets is None or key != self._bucket_key:
            self._buckets = build_buckets(tree, self.config.bucket_bytes)
            self._bucket_key = key
        return self._buckets

    def _live(self) -> Tuple[str, ...]:
        return _live(self._axes)

    @staticmethod
    def _world(live) -> int:
        n = 1
        for ax in live:
            n *= _c._size(axis_group(ax))
        return n

    @staticmethod
    def _index(live) -> int:
        idx = 0
        for ax in live:
            pg = axis_group(ax)
            idx = idx * _c._size(pg) + _c._rank(pg)
        return idx

    @staticmethod
    def _chunk_len(n: int, world: int) -> int:
        return -(-n // world)  # ceil: flat is zero-padded to world*len

    def shard(self, params: Dict[str, torch.Tensor]):
        """Full params -> {bucket key: local flat chunk} (the whole
        bucket with no live axis)."""
        live = self._live()
        out = {}
        for spec in self.buckets_for(params):
            flat = flatten_bucket(params, spec)
            if live:
                world = self._world(live)
                c = self._chunk_len(spec.num_elements, world)
                flat = torch.nn.functional.pad(
                    flat, (0, c * world - spec.num_elements))
                i = self._index(live)
                flat = flat[i * c:(i + 1) * c]
            out[spec.residual_key] = flat
        return out

    def gather(self, chunks: Dict[str, torch.Tensor],
               like: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Owned chunks -> full params (one all-gather per bucket and
        axis); ``like`` gives the layout (metadata only)."""
        live = self._live()
        cfg = self.config
        out = {}
        for spec in self.buckets_for(like):
            flat = chunks[spec.residual_key]
            if live:
                compress = "bf16" if (cfg.compress == "bf16"
                                      and spec.floating) else "f32"
                wire = _wire_bytes("flat", compress, spec.num_elements,
                                   _itemsize(spec.dtype), cfg.int8_block)
                done = _record_fused("all_gather", compress, live, wire,
                                     elements=spec.num_elements)
                with _scope("param_gather"):
                    dt = flat.dtype
                    y = flat.to(torch.bfloat16) if compress == "bf16" \
                        else flat
                    for ax in reversed(live):
                        y = _c._gather_flat(y, axis_group(ax)).reshape(-1)
                    flat = y[:spec.num_elements].to(dt)
                done and done()
            out.update(unflatten_bucket(flat, spec))
        return out

    def scatter_grads(self, grads: Dict[str, torch.Tensor], state=None):
        """Full grads -> (owned chunks, state)."""
        state = dict(state or {})
        live = self._live()
        cfg = self.config
        specs = self.buckets_for(grads)
        if _obs._enabled:
            _obs.counter("comm.fused_buckets").add(len(specs))
        out = {}
        for spec in specs:
            compress = cfg.compress if spec.floating else "f32"
            flat = flatten_bucket(grads, spec)
            if not live:
                out[spec.residual_key] = flat
                continue
            world = self._world(live)
            c = self._chunk_len(spec.num_elements, world)
            padded = torch.nn.functional.pad(
                flat, (0, c * world - spec.num_elements))
            i = self._index(live)
            wire = _wire_bytes("rs_ag" if compress != "int8_ef" else "flat",
                               compress, spec.num_elements,
                               _itemsize(spec.dtype), cfg.int8_block)
            done = _record_fused("reduce_scatter", compress, live, wire,
                                 elements=spec.num_elements)
            with _scope("grad_sync"):
                if compress == "int8_ef":
                    rkey = spec.residual_key
                    res = state.get(rkey)
                    if res is None:
                        res = torch.zeros((spec.num_elements,),
                                          dtype=torch.float32,
                                          device=flat.device)
                    summed, state[rkey] = _allreduce_flat(
                        flat, live, "flat", compress, res, cfg.int8_block)
                    summed = torch.nn.functional.pad(
                        summed, (0, c * world - spec.num_elements))
                    chunk = summed[i * c:(i + 1) * c]
                else:
                    y = padded.to(torch.bfloat16) if compress == "bf16" \
                        else padded
                    for ax in live:
                        y = _c._reduce_scatter_dim0(y, _c.ReduceOp.SUM,
                                                    axis_group(ax))
                    chunk = y.to(flat.dtype)
            done and done()
            out[spec.residual_key] = chunk
        return out, state

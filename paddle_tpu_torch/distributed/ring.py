"""Long-context parallelism: ring attention and Ulysses (counterpart of
paddle_tpu/distributed/ring.py).

- ring_flash_attention: each rank holds a shard of the sequence; the
  KV shards rotate around the 'sp' ring, one hop a step, and each hop
  streams the held shard through the same blockwise online-softmax
  update the blockwise attention uses (nn.functional.attention's
  _flash_carry_update), so no hop builds [s_loc, s_loc] logits beyond
  one [.., s_loc, block] tile. Causal masking uses the global positions
  of the shard's owner. comm_config(compress="bf16") carries K and V
  around the ring in bf16 (half the bytes a hop); the softmax math
  stays f32.
- ulysses_attention: an all-to-all reshards [b, s/P, n, d] to
  [b, s, n/P, d], attention runs over all tokens for n/P heads
  (F.flash_attention: the forward kernel on the card), and a second
  all-to-all reshards back.

The JAX package differentiates its ppermute and all_to_all through
jax's AD. Here each exchange is an autograd Function whose backward
runs the reverse exchange: a hop sends to the next rank and its
backward to the previous; an all-to-all's backward swaps its split and
concat axes. The carry update is torch ops, as it is XLA composition in
the JAX package, so autograd differentiates it.

A rank's process is the body of the JAX shard_map: the functions take
this rank's shard [b, s_local, n, d] and the group of the sp axis (a
process group, a Group, an axis name, or None for the axis context's).
With no axis at all they are flash_attention, as in the JAX package;
with a named axis they run their exchange code at any size, one rank
included (a ring of one hop, a one-rank all-to-all), and without a
process group the exchanges are the identity.
``sequence_parallel_attention`` is the wrapper ERNIE calls (the JAX
package's shard_map over 'sp' around either mode): q, k and v, whole
and replicated over sp, are split to this rank's sequence block, and the
output is all-gathered back (split backward: all-gather; gather
backward: this rank's block).
"""
from __future__ import annotations

import math
import os

import torch

from ..observability import metrics as _obs
from .env import SEQUENCE_AXIS, axis_group, current_axis_name
from .parallel_layers import (gather_from_group, group_rank, group_size,
                              split_to_group)

__all__ = ["ring_flash_attention", "ulysses_attention", "RingAttention",
           "sequence_parallel_attention"]


def _ring_block_size(s_loc):
    return int(os.environ.get("PD_RING_BK", 0)) or min(512, s_loc)


def _record_sp(op: str, axis, q, k, v):
    """Sequence-parallel telemetry through collective._record: the call
    and byte counters and the flight recorder's enter/exit with a
    per-(axis, op) seq. Returns the exit hook (or None)."""
    from .collective import _record
    return _record(op, axis, q, k, v)


def _record_ring_wire(axis, k, v, wire_dtype):
    """comm.* receipts for the ring's KV rotation: one per call, wire
    bytes = one hop's K+V payload in the wire dtype (the KV's own dtype
    without compression)."""
    if not _obs._enabled:
        return
    dt = wire_dtype if wire_dtype is not None else k.dtype
    nbytes = int((k.numel() + v.numel()) *
                 torch.empty((), dtype=dt).element_size())
    compress = "bf16" if dt == torch.bfloat16 else "f32"
    _obs.counter("comm.algo", algo="ring", compress=compress).add(1)
    _obs.counter("comm.wire_bytes").add(nbytes)


def _shift(x, shift, pg):
    """Rank i's x goes to rank (i + shift) mod n of `pg`: collective's
    p2p_shift without its telemetry (the JAX package records a ring
    call once, _record_sp, not its hops)."""
    if pg is None:
        return x
    import torch.distributed as dist
    n, me = group_size(pg), group_rank(pg)
    if shift % n == 0:
        return x.clone()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(pg, (me + shift) % n), pg),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(pg, (me - shift) % n), pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingHop(torch.autograd.Function):
    """One hop to the next rank; backward: the gradient one hop back."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _shift(x, 1, pg)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), -1, ctx.pg), None


def _all_to_all(x, split_axis, concat_axis, pg):
    """x cut into n blocks along split_axis, block j to rank j; the n
    blocks received joined along concat_axis in rank order (collective's
    all_to_all without its telemetry, as _shift)."""
    if pg is None:
        return x
    import torch.distributed as dist
    n = group_size(pg)
    xs = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=pg)
    blocks = [b.movedim(0, split_axis) for b in out.chunk(n, dim=0)]
    return torch.cat(blocks, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, pg):
        ctx.args = (split_axis, concat_axis, pg)
        return _all_to_all(x, split_axis, concat_axis, pg)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, pg = ctx.args
        return _all_to_all(g, concat_axis, split_axis, pg), None, None, None


def _resolve(group):
    """(axis label, process group) of a call: a process group, a Group,
    an axis name, or None (the axis context's sp axis). The label is
    None when no axis is named at all."""
    from .collective import Group
    if group is None:
        axis = current_axis_name(SEQUENCE_AXIS)
        return axis, axis_group(axis)
    if isinstance(group, str):
        return group, axis_group(group)
    if isinstance(group, Group):
        return group.axis, group.process_group
    return "sp", group


def _ring_attn_impl(q, k, v, pg, causal, scale, wire_dtype=None):
    """q, k, v this rank's shards [b, n, s_local, d] (head-major), the
    sequence split over `pg`'s ranks in rank order."""
    from ..nn.functional.attention import (_flash_carry_init,
                                           _flash_carry_update,
                                           _flash_finish)
    n_dev = group_size(pg)
    my = group_rank(pg)
    b, h, s_loc, d = q.shape
    q32 = q.to(torch.float32) * scale
    pos_q = my * s_loc + torch.arange(s_loc, device=q.device)
    blk = _ring_block_size(s_loc)
    if wire_dtype is not None:
        k = k.to(wire_dtype)
        v = v.to(wire_dtype)
    carry = _flash_carry_init(b, h, s_loc, d, q.device)
    kv_k, kv_v = k, v
    for i in range(n_dev):
        # the KV block held now came from rank (my - i) mod n
        src = (my - i) % n_dev
        kk, vv = ((kv_k, kv_v) if wire_dtype is None else
                  (kv_k.to(q32.dtype), kv_v.to(q32.dtype)))
        carry = _flash_carry_update(q32, kk, vv, carry, blk, pos_q,
                                    src * s_loc, s_loc, causal)
        # rotate KV around the ring (send to the next rank)
        kv_k = _RingHop.apply(kv_k, pg) if pg is not None else kv_k
        kv_v = _RingHop.apply(kv_v, pg) if pg is not None else kv_v
    return _flash_finish(carry, q.dtype)


def _wire_dtype(comm_config):
    if comm_config is None or comm_config.compress in ("f32", "none"):
        return None
    if comm_config.compress != "bf16":
        raise ValueError(
            f"ring KV rotation supports compress='bf16' (or the 'f32' "
            f"default), got {comm_config.compress!r}")
    return torch.bfloat16


def ring_flash_attention(query, key, value, causal=False, group=None,
                         name=None, comm_config=None):
    """Context-parallel attention. Layout [batch, seq_local, heads, dim]:
    this rank's shard of a sequence split over the sp axis."""
    wire = _wire_dtype(comm_config)
    axis, pg = _resolve(group)
    if axis is None:
        from ..nn.functional.attention import flash_attention
        return flash_attention(query, key, value, causal=causal)
    done = _record_sp("ring_attention", axis, query, key, value)
    _record_ring_wire(axis, key, value, wire)
    qh, kh, vh = (t.transpose(1, 2) for t in (query, key, value))
    out = _ring_attn_impl(qh, kh, vh, pg, causal,
                          1.0 / math.sqrt(query.shape[-1]), wire_dtype=wire)
    done and done()
    return out.transpose(1, 2)


def ulysses_attention(query, key, value, causal=False, group=None,
                      name=None):
    """DeepSpeed-Ulysses: all-to-all so each rank holds ALL tokens of
    n/P heads, attention, then all-to-all back to sequence shards."""
    from ..nn.functional.attention import flash_attention
    axis, pg = _resolve(group)
    if axis is None:
        return flash_attention(query, key, value, causal=causal)
    done = _record_sp("ulysses_attention", axis, query, key, value)

    def fwd(x):     # [b, s/P, n, d] -> [b, s, n/P, d]
        return _AllToAll.apply(x, 2, 1, pg) if pg is not None else x
    out = flash_attention(fwd(query), fwd(key), fwd(value), causal=causal)
    if pg is not None:
        out = _AllToAll.apply(out, 1, 2, pg)
    done and done()
    return out


class RingAttention:
    """Strategy handle selecting ring vs ulysses."""

    def __init__(self, mode="ring", group=None, comm_config=None):
        assert mode in ("ring", "ulysses")
        self.mode = mode
        self.group = group
        self.comm_config = comm_config

    def __call__(self, q, k, v, causal=False):
        if self.mode == "ring":
            return ring_flash_attention(q, k, v, causal, self.group,
                                        comm_config=self.comm_config)
        return ulysses_attention(q, k, v, causal, self.group)


def sequence_parallel_attention(q, k, v, mode="ring", causal=False):
    """q, k, v [b, s, n, d], whole on every rank of the sp axis: this
    rank's sequence block through ring or Ulysses attention, the output
    gathered back to [b, s, n, d] on every rank."""
    axis = SEQUENCE_AXIS
    pg = axis_group(axis)
    if pg is not None and q.shape[1] % group_size(pg):
        raise ValueError(f"sequence length {q.shape[1]} does not split "
                         f"over {group_size(pg)} sp ranks")
    q, k, v = (split_to_group(t, 1, pg) for t in (q, k, v))
    if mode == "ulysses":
        out = ulysses_attention(q, k, v, causal, group=axis)
    else:
        out = ring_flash_attention(q, k, v, causal, group=axis)
    return gather_from_group(out, 1, pg)

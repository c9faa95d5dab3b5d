"""Tensor-parallel (Megatron-style) layers (counterpart of
paddle_tpu/distributed/parallel_layers.py).

Reference: paddle.distributed.split (collective.py:566-713) and the
fleet mp helpers. The JAX package annotates parameters with specs over
'tp' and lets the partitioner place the collectives, or, inside a
shard_map over 'tp', runs the manual psum form on local shards. The
port runs one process per rank, so a layer made on a mesh whose tp axis
spans several ranks holds this rank's block of its weight
(sharding.annotate: the full weight is drawn on every rank from the same
generator, then cut) and runs the manual form:

- ColumnParallelLinear: weight [in, out/tp], bias [out/tp];
  y_local = f(x) @ w_local + b_local, then all-gathered along the last
  dim when gather_output;
- RowParallelLinear: weight [in/tp, out]; y = g(x_local @ w_local) + b,
  where x_local is this rank's block of the last dim of x (taken from a
  full x unless input_is_parallel);
- VocabParallelEmbedding: weight [vocab/tp, dim]; ids outside this
  rank's rows look up zeros, and the partial lookups are summed (g).

The exchanges are autograd Functions, so each has the gradient of the
global computation: f (identity forward, all-reduce SUM backward), g
(all-reduce SUM forward, identity backward), split (this rank's block
forward, all-gather backward) and gather (all-gather forward, this
rank's block backward; a reduce-scatter where the ranks go on to use
different parts of the gathered value). Each takes a torch ProcessGroup and is the
identity without one. On a mesh without tp (or without a process
group) the layers are the plain Linear and Embedding.
"""
from __future__ import annotations

import torch

from .. import nn
from ..nn import functional as F
from .env import TENSOR_AXIS, axis_group
from .sharding import PartitionSpec as P
from .sharding import annotate, is_split

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "split", "copy_to_group",
           "reduce_from_group", "split_to_group", "gather_from_group",
           "sum_over_group", "group_size", "group_rank"]


def _dist():
    import torch.distributed as dist
    return dist


def group_size(pg) -> int:
    return 1 if pg is None else _dist().get_world_size(pg)


def group_rank(pg) -> int:
    return 0 if pg is None else _dist().get_rank(pg)


def _all_reduce(t, pg):
    from .collective import _all_reduce_
    return _all_reduce_(t.contiguous(), "sum", pg)


def _all_gather(t, dim, pg):
    from .collective import _gather_flat
    g = _gather_flat(t, pg)
    return torch.cat(list(g.unbind(0)), dim=dim)


def _own_block(t, dim, pg):
    n, r = group_size(pg), group_rank(pg)
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size).contiguous()


class _Copy(torch.autograd.Function):
    """f: identity forward, all-reduce SUM backward."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.pg), None


class _Reduce(torch.autograd.Function):
    """g: all-reduce SUM forward, identity backward."""

    @staticmethod
    def forward(ctx, x, pg):
        return _all_reduce(x.clone(), pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """All-reduce SUM forward and backward: a sum over ranks whose
    per-rank losses differ (each rank's gradient of the summed value is
    the sum of every rank's)."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _all_reduce(x.clone(), pg)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.pg), None


class _Split(torch.autograd.Function):
    """This rank's block of dim `dim` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _own_block(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.dim, ctx.pg), None, None


class _Gather(torch.autograd.Function):
    """All-gather along dim `dim` forward; backward, this rank's block of
    the gradient (the ranks compute the same thing with the gathered
    value), or, when `partitioned` (each rank uses a different part of
    it), this rank's block of the gradients' sum over the ranks."""

    @staticmethod
    def forward(ctx, x, dim, pg, partitioned):
        ctx.dim, ctx.pg, ctx.partitioned = dim, pg, partitioned
        return _all_gather(x.contiguous(), dim, pg)

    @staticmethod
    def backward(ctx, g):
        if ctx.partitioned:
            g = _all_reduce(g.clone(), ctx.pg)
        return _own_block(g, ctx.dim, ctx.pg), None, None, None


def copy_to_group(x, pg):
    return x if pg is None else _Copy.apply(x, pg)


def reduce_from_group(x, pg):
    return x if pg is None else _Reduce.apply(x, pg)


def sum_over_group(x, pg):
    return x if pg is None else _SumBoth.apply(x, pg)


def split_to_group(x, dim, pg):
    return x if pg is None else _Split.apply(x, dim % x.dim(), pg)


def gather_from_group(x, dim, pg, partitioned=False):
    return x if pg is None else _Gather.apply(x, dim % x.dim(), pg,
                                              bool(partitioned))


def tp_group(param):
    """The tp process group a split parameter was cut over (None when the
    parameter is whole, or without a tp group)."""
    if not is_split(param):
        return None
    return axis_group(TENSOR_AXIS)


class ColumnParallelLinear(nn.Layer):
    """Output-dim-sharded linear (reference 'linear' with axis=1)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None):
        super().__init__(device=device)
        self.gather_output = gather_output
        self.inner = nn.Linear(in_features, out_features, weight_attr,
                               bias_attr=None if has_bias else False,
                               device=self._device)
        annotate(self.inner.weight, P(None, TENSOR_AXIS))
        if self.inner.bias is not None:
            annotate(self.inner.bias, P(TENSOR_AXIS))

    @property
    def weight(self):
        return self.inner.weight

    @property
    def bias(self):
        return self.inner.bias

    def forward(self, x):
        pg = tp_group(self.inner.weight)
        out = self.inner(copy_to_group(x, pg))
        if self.gather_output:
            out = gather_from_group(out, -1, pg)
        return out


class RowParallelLinear(nn.Layer):
    """Input-dim-sharded linear (reference axis=0): out =
    allreduce(x_local @ w_local) + b."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, mp_group=None,
                 name=None, device=None):
        super().__init__(device=device)
        self.input_is_parallel = input_is_parallel
        self.inner = nn.Linear(in_features, out_features, weight_attr,
                               bias_attr=None if has_bias else False,
                               device=self._device)
        annotate(self.inner.weight, P(TENSOR_AXIS, None))
        if self.inner.bias is not None:
            annotate(self.inner.bias, P())

    @property
    def weight(self):
        return self.inner.weight

    @property
    def bias(self):
        return self.inner.bias

    def forward(self, x):
        pg = tp_group(self.inner.weight)
        if pg is None:
            return self.inner(x)
        if not self.input_is_parallel:
            x = split_to_group(x, -1, pg)
        out = reduce_from_group(F.linear(x, self.inner.weight), pg)
        b = self.inner.bias
        return out if b is None else out + b


class VocabParallelEmbedding(nn.Layer):
    """Vocab-sharded embedding (reference _parallel_embedding: mask the
    ids outside this rank's rows, sum the partial lookups)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None):
        super().__init__(device=device)
        self.num_embeddings = num_embeddings
        self.inner = nn.Embedding(num_embeddings, embedding_dim,
                                  weight_attr=weight_attr,
                                  device=self._device)
        annotate(self.inner.weight, P(TENSOR_AXIS, None))

    @property
    def weight(self):
        return self.inner.weight

    def forward(self, x):
        return vocab_parallel_lookup(x, self.inner.weight)


def vocab_parallel_lookup(ids, weight):
    """Embedding lookup in a table that may hold this rank's block of
    rows over tp: out-of-block ids read zeros, then g sums the ranks'
    partial lookups."""
    pg = tp_group(weight)
    if pg is None:
        return F.embedding(ids, weight)
    per = weight.shape[0]
    local = ids - group_rank(pg) * per
    inside = (local >= 0) & (local < per)
    emb = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                      weight)
    emb = emb * inside.unsqueeze(-1).to(emb.dtype)
    return reduce_from_group(emb, pg)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """paddle.distributed.split (collective.py:566): makes the parallel
    layer on x's device and applies it."""
    dev = x.device
    if operation == "linear":
        in_f, out_f = size
        if axis == 0:
            layer = RowParallelLinear(in_f, out_f, weight_attr,
                                      has_bias=bias_attr is not False,
                                      device=dev)
        else:
            layer = ColumnParallelLinear(in_f, out_f, weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out,
                                         device=dev)
        return layer(x)
    if operation == "embedding":
        vocab, dim = size
        layer = VocabParallelEmbedding(vocab, dim, weight_attr, device=dev)
        return layer(x)
    raise ValueError(f"unknown operation '{operation}'")

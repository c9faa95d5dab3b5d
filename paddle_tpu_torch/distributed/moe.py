"""Mixture-of-Experts with expert parallelism over the 'ep' mesh axis
(counterpart of paddle_tpu/distributed/moe.py).

Routing is the JAX package's, token for token: top-k token-choice over
softmax(x @ gate) in f32, round by round over k; within a round each
token's slot in its expert is its position in batch order (a cumsum
over the tokens, overflowing ones included) after the slots earlier
rounds kept (`fill`); a token whose slot reaches the capacity C =
max(k, ceil(N / E * capacity_factor * k)) is dropped (its combine
weight is 0, the model's residual carries it). The Switch aux loss is
E * sum_e density_e * mean_prob_e over the first choice.

The JAX package builds dense [N, E, C] combine and dispatch masks and
four einsums over them. At ERNIE-base's 48x512 batch with 4 experts that
is 1.5e9 elements a MoE layer, so the port computes the same function
in index form: per round, each token's expert, slot and gate
(``moe_route``); an index_add of the kept tokens into [E, C, d] (every
(expert, slot) receives at most one token, so it is a copy); the
expert FFNs as two batched matmuls; and a gather of each token's k
slots, weighted by their gates. With one-hot masks the einsums add only
exact zeros, so the two forms compute the same values;
``moe_dispatch`` expands the indices into the JAX package's dense
(combine, dispatch, aux), the plain version the tests hold both against.
Dropped tokens point at a spare zero row, so no slot is written twice
and the gather's backward adds one value into each slot row.

One process per rank. The batch is split over the data axes (dp, fsdp)
and replicated over ep, as the JAX data_spec places it; the slot order
and the capacity stay global: C comes from the global token count, and
each rank's slots in a round are offset by the counts of the ranks
before it in batch order (an all-gather of the per-expert counts over
the data axes, one a round); the aux loss's two means are summed over
the data axes before their product. The expert weights [E, ...] are
split over ep (sharding.annotate): a rank takes its experts' rows of
the [E, C, d] buffer and sums them over the data axes (forward and
backward: the ranks' losses differ), runs its experts, and all-gathers
the outputs over ep (backward: its own block). Axes of size 1 are
skipped, so a one-card run issues none of these exchanges.

Dtypes: moe_layer is on neither AMP list in the JAX package, so under
O1 the gate, the expert FFNs and the combine run in the dtype of their
inputs (f32 out of LayerNorm, f32 parameters); the port calls no
amp_cast here and matches that. The activation is looked up as
jax.nn's: "gelu" is the tanh approximation there, and so here.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch

from .. import nn
from ..nn.initializer import XavierNormal
from .env import EXPERT_AXIS, get_mesh
from .parallel_layers import (_all_reduce, gather_from_group, group_rank,
                              group_size, split_to_group, sum_over_group)
from .sharding import PartitionSpec as P
from .sharding import annotate, is_split

__all__ = ["MoELayer", "moe_dispatch", "moe_route", "Routing",
           "EXPERT_AXIS"]


def _activation(name):
    """jax.nn's activation of that name (gelu: the tanh form)."""
    fns = {"relu": torch.relu, "silu": torch.nn.functional.silu,
           "swish": torch.nn.functional.silu,
           "gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
           "tanh": torch.tanh, "sigmoid": torch.sigmoid}
    if name not in fns:
        raise ValueError(f"unknown MoE activation {name!r}")
    return fns[name]


def data_groups() -> List:
    """The process groups of the global mesh's data axes (dp, then fsdp:
    batch order, outermost first) that span more than one rank."""
    mesh = get_mesh()
    if mesh is None:
        return []
    out = []
    for ax in ("dp", "fsdp"):
        pg = mesh.group(ax) if ax in mesh else None
        if pg is not None and group_size(pg) > 1:
            out.append(pg)
    return out


def expert_group(param):
    """The ep group a split expert parameter was cut over (None when the
    parameter is whole)."""
    if not is_split(param):
        return None
    mesh = get_mesh()
    if mesh is None or EXPERT_AXIS not in mesh:
        return None
    pg = mesh.group(EXPERT_AXIS)
    return pg if pg is not None and group_size(pg) > 1 else None


def _scan_counts(cnt, groups):
    """(offset, total) of the per-expert counts `cnt` [E] over the data
    groups: the sum over the ranks before this one in batch order, and
    over all of them."""
    from .collective import _gather_flat
    rows, idx = cnt[None], 0
    for pg in reversed(groups):           # innermost axis first
        idx = group_rank(pg) * rows.shape[0] + idx
        rows = _gather_flat(rows.contiguous(), pg).reshape(-1, cnt.shape[0])
    return rows[:idx].sum(0), rows.sum(0)


class Routing(NamedTuple):
    """moe_route's result: per round r and local token n, the expert
    [k, N] (int64), the slot [k, N] (int64, clamped to C-1 as the JAX
    package's index), keep [k, N] (bool), the gate value [k, N] (f32,
    0 where dropped), and the aux loss."""
    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor


def moe_route(gate_logits, num_experts: int, top_k: int, capacity: int,
              groups: Optional[List] = None) -> Routing:
    """Top-k token-choice routing with per-expert capacity, in index
    form. gate_logits [N, E] are this rank's tokens; `groups` the data
    axes' process groups the global batch is split over (batch order,
    outermost first; None or [] for one rank)."""
    groups = groups or []
    n = gate_logits.shape[0]
    probs = torch.softmax(gate_logits.to(torch.float32), dim=-1)
    remaining = probs
    fill = torch.zeros(num_experts, dtype=torch.float32,
                       device=probs.device)
    experts, slots, keeps, gates = [], [], [], []
    first = None
    for _ in range(top_k):
        choice = torch.argmax(remaining, dim=-1)                  # [N]
        onehot = torch.nn.functional.one_hot(
            choice, num_experts).to(torch.float32)                # [N, E]
        if first is None:
            first = onehot
        # position of each token within its chosen expert (batch order),
        # offset by the ranks before this one and by prior rounds
        base = fill
        total = None
        if groups:
            off, total = _scan_counts(onehot.sum(0), groups)
            base = fill + off
        # the running count over the tokens, scanned along the last dim
        # of the [E, N] transpose (an inner scan; exact: integers in f32)
        pos = torch.cumsum(onehot.t(), dim=1).t() - 1.0 + base[None, :]
        pos_tok = pos.gather(1, choice[:, None])[:, 0]             # [N]
        keep = pos_tok < capacity
        gate_val = probs.gather(1, choice[:, None])[:, 0] * keep
        slot = torch.clamp(pos_tok.to(torch.int64), 0, capacity - 1)
        if groups:
            kept = torch.minimum(torch.clamp(capacity - fill, min=0.0),
                                 total)
        else:
            kept = (onehot * keep[:, None]).sum(0)
        fill = fill + kept
        experts.append(choice)
        slots.append(slot)
        keeps.append(keep)
        gates.append(gate_val)
        remaining = remaining * (1.0 - onehot)   # next round: 2nd best

    # Switch-style load-balancing loss on the FIRST choice: E * sum_e
    # (fraction of tokens routed to e) * (mean gate prob of e), both
    # means over the global batch
    dens = first.sum(0)
    prox = probs.sum(0)
    n_glob = n
    for pg in groups:
        dens = _all_reduce(dens.clone(), pg)
        prox = sum_over_group(prox, pg)
        n_glob *= group_size(pg)
    aux = num_experts * torch.sum((dens / n_glob) * (prox / n_glob))
    return Routing(torch.stack(experts), torch.stack(slots),
                   torch.stack(keeps), torch.stack(gates), aux)


def dense_masks(route: Routing, num_experts: int, capacity: int):
    """The JAX package's (combine [N, E, C] f32, dispatch [N, E, C] bool)
    expanded from a Routing."""
    k, n = route.expert.shape
    combine = torch.zeros((n, num_experts, capacity), dtype=torch.float32,
                          device=route.gate.device)
    dispatch = torch.zeros((n, num_experts, capacity), dtype=torch.float32,
                           device=route.gate.device)
    tok = torch.arange(n, device=route.gate.device)
    for r in range(k):
        combine = combine.index_put(
            (tok, route.expert[r], route.slot[r]), route.gate[r],
            accumulate=True)
        dispatch = dispatch.index_put(
            (tok, route.expert[r], route.slot[r]),
            route.keep[r].to(torch.float32), accumulate=True)
    return combine, dispatch > 0


def moe_dispatch(gate_logits, num_experts: int, top_k: int, capacity: int):
    """The JAX package's moe_dispatch: gate_logits [N, E] -> (combine
    [N, E, C], dispatch [N, E, C] bool, aux scalar), expanded from
    moe_route's indices."""
    route = moe_route(gate_logits, num_experts, top_k, capacity)
    combine, dispatch = dense_masks(route, num_experts, capacity)
    return combine, dispatch, route.aux


def moe_ffn(x, gate, w1, b1, w2, b2, *, num_experts, top_k, capacity,
            activation="relu", groups=None, ep_group=None):
    """Route, expert FFNs over the stacked (or, under ep, this rank's)
    expert weights, combine. x [..., d] -> (y like x, the Routing)."""
    act = _activation(activation)
    d = x.shape[-1]
    tok = x.reshape(-1, d)
    n = tok.shape[0]
    logits = tok.to(torch.float32) @ gate                       # [N, E]
    route = moe_route(logits, num_experts, top_k, capacity, groups)
    e_c = num_experts * capacity
    # token -> expert slots; dropped tokens go to the spare row e_c
    idx = torch.where(route.keep, route.expert * capacity + route.slot,
                      torch.full_like(route.slot, e_c))         # [k, N]
    src = tok.repeat(top_k, 1) * route.keep.reshape(-1, 1).to(tok.dtype)
    buf = torch.zeros((e_c + 1, d), dtype=tok.dtype, device=tok.device)
    buf = buf.index_add(0, idx.reshape(-1), src)
    expert_in = buf[:e_c].reshape(num_experts, capacity, d)
    # this rank's experts, summed over the data axes (the all-to-all
    # the JAX partitioner places for P('ep'))
    expert_in = split_to_group(expert_in, 0, ep_group)
    for pg in groups or []:
        expert_in = sum_over_group(expert_in, pg)
    dt = torch.promote_types(expert_in.dtype, w1.dtype)
    h = act(torch.bmm(expert_in.to(dt), w1.to(dt)) + b1[:, None, :])
    out = torch.bmm(h, w2.to(h.dtype)) + b2[:, None, :]
    out = gather_from_group(out, 0, ep_group)                   # [E, C, d]
    rows = torch.cat([out.reshape(e_c, d),
                      out.new_zeros((1, d))])                    # spare row
    y = None
    for r in range(top_k):
        term = route.gate[r].to(x.dtype)[:, None] * \
            rows.index_select(0, idx[r])
        y = term if y is None else y + term
    return y.reshape(x.shape[:-1] + (y.shape[-1],)).to(
        torch.promote_types(x.dtype, out.dtype)), route


class MoELayer(nn.Layer):
    """Top-k gated mixture of expert FFNs over a stacked expert tensor.

    forward(x [B, S, D]) -> y [B, S, D]; the auxiliary loss of the last
    forward is on `.aux_loss` — add it to the training loss scaled by
    `aux_weight`. On a mesh whose ep axis spans several ranks, w1, b1,
    w2 and b2 hold this rank's experts."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_weight: float = 0.01, activation: str = "relu",
                 name=None, device=None):
        super().__init__(device=device)
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.aux_weight = float(aux_weight)
        self.activation = activation
        _activation(activation)
        self.gate = self.create_parameter(
            (d_model, num_experts), default_initializer=XavierNormal())
        self.w1 = self.create_parameter(
            (num_experts, d_model, d_hidden),
            default_initializer=XavierNormal())
        self.b1 = self.create_parameter((num_experts, d_hidden),
                                        is_bias=True)
        self.w2 = self.create_parameter(
            (num_experts, d_hidden, d_model),
            default_initializer=XavierNormal())
        self.b2 = self.create_parameter((num_experts, d_model),
                                        is_bias=True)
        # expert axis over 'ep' (replicated on meshes without it)
        annotate(self.w1, P(EXPERT_AXIS, None, None))
        annotate(self.b1, P(EXPERT_AXIS, None))
        annotate(self.w2, P(EXPERT_AXIS, None, None))
        annotate(self.b2, P(EXPERT_AXIS, None))
        self.aux_loss: Optional[torch.Tensor] = None

    def _capacity(self, n_tokens: int) -> int:
        return max(self.top_k, int(math.ceil(
            n_tokens / self.num_experts * self.capacity_factor
            * self.top_k)))

    def forward(self, x):
        groups = data_groups()
        n_glob = int(x.shape[0]) * int(x.shape[1])
        for pg in groups:
            n_glob *= group_size(pg)
        cap = self._capacity(n_glob)
        y, route = moe_ffn(x, self.gate, self.w1, self.b1, self.w2,
                           self.b2, num_experts=self.num_experts,
                           top_k=self.top_k, capacity=cap,
                           activation=self.activation, groups=groups,
                           ep_group=expert_group(self.w1))
        self.aux_loss = route.aux
        self.last_capacity = cap
        # this rank's routed slots that were kept, a device count (the
        # dropped share is 1 - kept / (top_k * tokens))
        self.last_kept = route.keep.sum()
        self.last_routed = route.keep.numel()
        return y

    def extra_repr(self):
        return (f"d_model={self.d_model}, experts={self.num_experts}, "
                f"top_k={self.top_k}")

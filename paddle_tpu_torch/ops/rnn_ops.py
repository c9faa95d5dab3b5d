"""Op-level RNN family and the CPU-fusion ops of the reference
(counterpart of paddle_tpu/ops/rnn_ops.py).

Reference specs: rnn_op.h (multi-layer bidirectional LSTM/GRU/RNN with
dropout and sequence_length masking), lstm_op.h, lstm_unit_op.h,
gru_unit_op.h, fusion_lstm_op.cc, fusion_gru_op.cc,
fusion_repeated_fc_relu_op.cc, fusion_seqconv_eltadd_relu_op.cc,
fusion_seqexpand_concat_fc_op.cc, fusion_seqpool_concat_op.cc,
fusion_squared_mat_sub_op.cc, batch_fc_op.cc, rank_attention_op.cc.

The JAX package runs each layer-direction's time loop as one lax.scan.
The port runs it as a Python loop over torch ops, with the input
projection x @ W_ih of the whole sequence hoisted out of the loop into
one GEMM (as the JAX _scan_layer does); each step is then one GEMM of
the state, h @ W_hh^T, and the gate arithmetic. On the card these are
cuBLAS GEMMs and torch's elementwise kernels, as the JAX package's are
XLA ops: there is no Pallas kernel on this path. Gate order is
(i, f, g, o) for LSTM and (r, z, n) for GRU, as the nn cells'.
"""
from __future__ import annotations

import torch

__all__ = [
    "rnn", "lstm", "lstm_unit", "gru_unit", "fusion_lstm", "fusion_gru",
    "fusion_repeated_fc_relu", "fusion_seqconv_eltadd_relu",
    "fusion_seqexpand_concat_fc", "fusion_seqpool_concat",
    "fusion_squared_mat_sub", "batch_fc", "rank_attention",
]


def _lstm_step(xg, h, c, whh):
    gates = xg + h @ whh.t()
    i, f, g, o = gates.chunk(4, -1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


def _gru_step(xg, h, whh, bhh):
    gh = h @ whh.t() + bhh
    ri, zi, ni = xg.chunk(3, -1)
    rh, zh, nh = gh.chunk(3, -1)
    r = torch.sigmoid(ri + rh)
    z = torch.sigmoid(zi + zh)
    n = torch.tanh(ni + r * nh)
    return (1 - z) * n + z * h


def _lengths(sequence_length, device):
    if sequence_length is None:
        return None
    return torch.as_tensor(sequence_length, device=device).long()


def _reverse_valid(x_tmajor, lengths):
    """Reverse each sequence within its valid prefix: position p maps to
    lengths[b] - 1 - p for p < lengths[b], identity past it (padding
    stays in place). Self-inverse, so the same map un-reverses the
    outputs."""
    t = torch.arange(x_tmajor.shape[0], device=x_tmajor.device)[:, None]
    src = torch.where(t < lengths[None, :], lengths[None, :] - 1 - t, t)
    idx = src.reshape(*src.shape, *([1] * (x_tmajor.dim() - 2)))
    return x_tmajor.gather(0, idx.expand_as(x_tmajor))


def _scan_layer(x_tmajor, h0, c0, wih, whh, bih, bhh, mode, lengths):
    """One direction of one layer over [T, B, D], the carries held where
    a sequence has ended. mode: LSTM, GRU, RNN_TANH or RNN_RELU.
    Returns (outputs [T, B, H], h_T, c_T); outputs past a sequence's
    length are zeros."""
    # the input projection of every step in one GEMM
    xg = x_tmajor @ wih.t() + bih
    if mode == "LSTM":
        xg = xg + bhh
    h, c = h0, c0
    outs = []
    for t in range(x_tmajor.shape[0]):
        if mode == "LSTM":
            h2, c2 = _lstm_step(xg[t], h, c, whh)
        elif mode == "GRU":
            h2, c2 = _gru_step(xg[t], h, whh, bhh), c
        else:
            z = xg[t] + h @ whh.t() + bhh
            h2 = torch.tanh(z) if mode == "RNN_TANH" else torch.relu(z)
            c2 = c
        if lengths is not None:
            live = (t < lengths)[:, None]
            h2 = torch.where(live, h2, h)
            c2 = torch.where(live, c2, c)
        outs.append(h2)
        h, c = h2, c2
    outs = torch.stack(outs)
    if lengths is not None:
        t = torch.arange(outs.shape[0], device=outs.device)
        outs = outs * (t[:, None] < lengths[None, :])[:, :, None].to(
            outs.dtype)
    return outs, h, c


def _direction(seq, h0, c0, weights, mode, lengths, reverse):
    """_scan_layer over `seq` [T, B, D], run backwards when `reverse`
    (within each valid prefix when there are lengths)."""
    if reverse:
        seq = (_reverse_valid(seq, lengths) if lengths is not None
               else seq.flip(0))
    outs, h_t, c_t = _scan_layer(seq, h0, c0, *weights, mode, lengths)
    if reverse:
        outs = (_reverse_valid(outs, lengths) if lengths is not None
                else outs.flip(0))
    return outs, h_t, c_t


def rnn(x, *weights, mode="LSTM", num_layers=1, is_bidirec=False,
        hidden_size=None, sequence_length=None, initial_states=None,
        dropout_prob=0.0, dropout_key=None, time_major=False, name=None):
    """The reference `rnn` op (rnn_op.h; also the capability of the
    reference's fused LSTM and GRU ops): multi-layer, optionally
    bidirectional LSTM/GRU/RNN over a whole sequence.

    weights: flat per (layer, direction): wih, whh, bih, bhh.
    dropout_key: a torch.Generator (or None) for the dropout between
    layers, which is applied only when one is given, as the JAX op
    applies it only with a key.
    Returns (out, h_final [L*D, B, H], c_final [L*D, B, H] (LSTM only)).
    """
    num_dir = 2 if is_bidirec else 1
    assert len(weights) == 4 * num_layers * num_dir, (
        f"expected {4 * num_layers * num_dir} weight arrays, "
        f"got {len(weights)}")
    xs = x if time_major else x.transpose(0, 1)          # [T, B, D]
    b = xs.shape[1]
    h = weights[1].shape[-1]                              # whh [G*H, H]
    lengths = _lengths(sequence_length, x.device)
    zeros = xs.new_zeros((b, h))
    finals_h, finals_c = [], []
    inp = xs
    for layer in range(num_layers):
        outs_dir = []
        for d in range(num_dir):
            idx = layer * num_dir + d
            base = 4 * idx
            h0 = c0 = zeros
            if initial_states is not None:
                if mode == "LSTM":
                    h0, c0 = initial_states[0][idx], initial_states[1][idx]
                else:
                    h0 = initial_states[idx]
            outs, h_t, c_t = _direction(inp, h0, c0,
                                        weights[base:base + 4], mode,
                                        lengths, d == 1)
            outs_dir.append(outs)
            finals_h.append(h_t)
            finals_c.append(c_t)
        inp = outs_dir[0] if num_dir == 1 else torch.cat(outs_dir, -1)
        if dropout_prob > 0 and layer < num_layers - 1 \
                and dropout_key is not None:
            keep = torch.empty(inp.shape, device=inp.device).bernoulli_(
                1.0 - dropout_prob, generator=dropout_key)
            inp = inp * keep.to(inp.dtype) / (1.0 - dropout_prob)
    out = inp if time_major else inp.transpose(0, 1)
    h_final = torch.stack(finals_h)
    if mode == "LSTM":
        return out, h_final, torch.stack(finals_c)
    return out, h_final


def _single_layer(x, wih, whh, bih, bhh, sequence_length, is_reverse, mode):
    xs = x.transpose(0, 1)
    lengths = _lengths(sequence_length, x.device)
    zeros = xs.new_zeros((xs.shape[1], whh.shape[-1]))
    outs, h_t, c_t = _direction(xs, zeros, zeros, (wih, whh, bih, bhh),
                                mode, lengths, is_reverse)
    return outs.transpose(0, 1), h_t, c_t


def lstm(x, wih, whh, bih, bhh, sequence_length=None, is_reverse=False,
         name=None):
    """Single fused LSTM layer (ref lstm_op.h / fusion_lstm_op.cc with the
    LoD input replaced by (padded [B, T, D], lengths)). Returns
    (hidden [B, T, H], hidden_final [B, H], cell_final [B, H]), the JAX
    op's order (its docstring names the last two the other way
    round)."""
    return _single_layer(x, wih, whh, bih, bhh, sequence_length,
                         is_reverse, "LSTM")


def lstm_unit(x, c_prev, forget_bias=0.0, name=None):
    """One LSTM cell tick on precomputed gates (ref lstm_unit_op.h):
    x [B, 4H] split (i, f, g, o); f gets forget_bias. Returns (c, h)."""
    i, f, g, o = x.chunk(4, -1)
    c = (torch.sigmoid(f + forget_bias) * c_prev
         + torch.sigmoid(i) * torch.tanh(g))
    return c, torch.sigmoid(o) * torch.tanh(c)


def gru_unit(x, h_prev, weight, bias=None, origin_mode=False, name=None):
    """One GRU tick (ref gru_unit_op.h): x [B, 3H] input projection,
    weight [H, 3H] packs (W_update | W_reset in [:, :2H], W_cand in
    [:, 2H:]). Returns (hidden, reset_hidden_prev, gate)."""
    h_size = h_prev.shape[-1]
    g = x if bias is None else x + bias
    ur = g[:, :2 * h_size] + h_prev @ weight[:, :2 * h_size]
    u, r = torch.sigmoid(ur).chunk(2, -1)
    rhp = r * h_prev
    c = torch.tanh(g[:, 2 * h_size:] + rhp @ weight[:, 2 * h_size:])
    h = u * h_prev + (1 - u) * c if origin_mode else \
        (1 - u) * h_prev + u * c
    return h, rhp, torch.cat([u, r, c], -1)


def fusion_lstm(x, wih, whh, bih, bhh, sequence_length=None,
                is_reverse=False, name=None):
    """ref fusion_lstm_op.cc: the same computation as `lstm`."""
    return lstm(x, wih, whh, bih, bhh, sequence_length=sequence_length,
                is_reverse=is_reverse)


def fusion_gru(x, wih, whh, bih, bhh, sequence_length=None,
               is_reverse=False, name=None):
    """ref fusion_gru_op.cc: single fused GRU layer over (padded,
    lengths). Returns (hidden [B, T, H], hidden_final [B, H])."""
    out, h_t, _ = _single_layer(x, wih, whh, bih, bhh, sequence_length,
                                is_reverse, "GRU")
    return out, h_t


def fusion_repeated_fc_relu(x, weights, biases):
    """ref fusion_repeated_fc_relu_op.cc: x -> [fc + relu] * N."""
    out = x
    for w, b in zip(weights, biases):
        out = torch.relu(out @ w + b)
    return out


def _sequence_conv(x, filt, length=None, context_length=3,
                   context_start=None):
    """Per-timestep context-window linear map (the port's copy of
    paddle_tpu/ops/misc_ops.py's sequence_conv): x [B, T, D], filter
    [context_length * D, M]; window rows outside [0, T) or beyond
    `length` are zero."""
    cl = int(context_length)
    start = -((cl - 1) // 2) if context_start is None else int(context_start)
    t = x.shape[1]
    pos0 = torch.arange(t, device=x.device)
    lens = _lengths(length, x.device)
    cols = []
    for j in range(cl):
        off = start + j
        shifted = torch.roll(x, -off, 1)
        pos = pos0 + off
        valid = (pos >= 0) & (pos < t)
        if lens is not None:
            valid = valid[None, :] & (pos[None, :] < lens[:, None])
            cols.append(shifted * valid[:, :, None].to(x.dtype))
        else:
            cols.append(shifted * valid[None, :, None].to(x.dtype))
    return torch.cat(cols, -1) @ filt


def fusion_seqconv_eltadd_relu(x, filt, bias, length=None, context_length=3,
                               context_start=None, name=None):
    """ref fusion_seqconv_eltadd_relu_op.cc: sequence_conv + bias + relu."""
    return torch.relu(_sequence_conv(x, filt, length, context_length,
                                     context_start) + bias)


def fusion_seqexpand_concat_fc(ref, xs, w, b, fc_act="relu"):
    """ref fusion_seqexpand_concat_fc_op.cc: per-sequence vectors
    broadcast over time, concatenated with `ref` [B, T, D0], then fc and
    the activation. xs: [B, Di] each; w [(D0 + sum Di), M], b [M]."""
    t = ref.shape[1]
    cols = [ref] + [v[:, None, :].expand(v.shape[0], t, v.shape[1])
                    for v in xs]
    out = torch.cat(cols, -1) @ w + b
    return torch.relu(out) if fc_act == "relu" else torch.tanh(out)


def _sequence_pool(x, pool_type, length=None, pad_value=0.0):
    """Masked pooling over the time axis of [B, T, D] (the port's copy of
    paddle_tpu/ops/sequence.py's sequence_pool): sum, average, sqrt,
    max, min, last or first; empty sequences give pad_value."""
    t = x.shape[1]
    length = (torch.full((x.shape[0],), t, device=x.device)
              if length is None else _lengths(length, x.device))
    mask = (torch.arange(t, device=x.device)[None, :] < length[:, None])
    maskf = mask.to(x.dtype)[..., None]
    lf = torch.clamp(length.to(x.dtype), min=1)[:, None]
    pt = pool_type.lower()
    if pt == "sum":
        out = (x * maskf).sum(1)
    elif pt == "average":
        out = (x * maskf).sum(1) / lf
    elif pt == "sqrt":
        out = (x * maskf).sum(1) / torch.sqrt(lf)
    elif pt == "max":
        out = torch.where(maskf > 0, x, float("-inf")).amax(1)
    elif pt == "min":
        out = torch.where(maskf > 0, x, float("inf")).amin(1)
    elif pt == "last":
        idx = torch.clamp(length - 1, min=0)
        out = x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]
    elif pt == "first":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    empty = (length == 0).reshape(-1, *([1] * (out.dim() - 1)))
    return torch.where(empty, torch.full((), pad_value, dtype=x.dtype,
                                         device=x.device), out)


def fusion_seqpool_concat(xs, pooltype="SUM", lengths=None):
    """ref fusion_seqpool_concat_op.cc: sequence_pool each [B, T, D]
    input, then concatenate along the features."""
    return torch.cat([_sequence_pool(x, pooltype,
                                     None if lengths is None else lengths[i])
                      for i, x in enumerate(xs)], -1)


def fusion_squared_mat_sub(x, y, scalar=1.0, name=None):
    """ref fusion_squared_mat_sub_op.cc: scalar * ((x@y)^2 - x^2@y^2)."""
    xy = x @ y
    return scalar * (xy * xy - (x * x) @ (y * y))


def batch_fc(x, w, bias=None, name=None):
    """Per-slot batched fc (ref batch_fc_op.cu): x [S, N, D], w [S, D, M],
    bias [S, 1, M] -> relu(x @ w + b) per slot."""
    out = torch.einsum("snd,sdm->snm", x, w)
    if bias is not None:
        out = out + bias
    return torch.relu(out)


def rank_attention(x, rank, rank_param, max_rank=3, name=None):
    """Rank-gated parameter selection (the dense regular case of
    rank_attention_op.cu: `rank` gives each instance's rank id):
    out[b] = x[b] @ rank_param[rank[b]]."""
    r = torch.clamp(rank.reshape(-1).long(), 0, rank_param.shape[0] - 1)
    return torch.einsum("bd,bdm->bm", x, rank_param[r])

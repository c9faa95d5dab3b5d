"""nn.BeamSearchDecoder + nn.dynamic_decode (counterpart of
paddle_tpu/nn/decode.py; reference python/paddle/nn/decode.py ->
fluid/layers/rnn.py BeamSearchDecoder / dynamic_decode over the
beam_search ops).

Steps run as a host loop with early exit once every beam has finished
(the reference's while_op is the same step-driven shape): each step
embeds the beams' last tokens, runs the cell, takes log-softmax of the
output layer's logits, expands the beams with beam_search_step
(finished beams frozen on the end token at no cost), and gathers every
state leaf to its parent beam; gather_tree back-traces the parent
pointers at the end. States are any pytree of tensors (an LSTM cell's
(h, c)), tiled and gathered leaf by leaf with torch.utils._pytree."""
from __future__ import annotations

import inspect
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ..ops.extras import beam_search_step, gather_tree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


class Decoder:
    """Abstract decode-step contract (reference Decoder): initialize() ->
    (initial_inputs, initial_states, initial_finished); step() ->
    (outputs, next_states, next_inputs, finished)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states


class BeamSearchDecoder(Decoder):
    """Beam search over an RNN cell (reference BeamSearchDecoder).

    cell: an RNNCellBase (SimpleRNNCell/GRUCell/LSTMCell), called as
    cell(inputs, states) -> (output, new_states).
    embedding_fn: token ids -> cell inputs (e.g. an nn.Embedding).
    output_fn: cell output -> vocab logits (e.g. an nn.Linear); identity
    when the cell output already is the logits.
    """

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn: Optional[Callable] = None,
                 output_fn: Optional[Callable] = None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states, batch_size=None):
        """(tokens [B, W], states with each leaf's rows tiled W times,
        scores [B, W] (beam 0 at 0, the others at -1e30, so the first
        step expands one beam), finished [B, W])."""
        w = self.beam_size
        leaves = pytree.tree_leaves(initial_cell_states)
        b = batch_size or leaves[0].shape[0]
        dev = leaves[0].device
        states = pytree.tree_map(lambda s: s.repeat_interleave(w, 0),
                                 initial_cell_states)
        tokens = torch.full((b, w), self.start_token, dtype=torch.int64,
                            device=dev)
        scores = torch.tensor([0.0] + [-1e30] * (w - 1),
                              device=dev).repeat(b, 1)
        finished = torch.zeros((b, w), dtype=torch.bool, device=dev)
        return tokens, states, scores, finished

    def step(self, time, tokens, states, scores, finished):
        b, w = tokens.shape
        flat = tokens.reshape(-1)
        inputs = self.embedding_fn(flat) if self.embedding_fn is not None \
            else flat
        out, new_states = self.cell(inputs, states)
        logits = self.output_fn(out) if self.output_fn is not None else out
        logp = torch.log_softmax(logits.float(), -1).reshape(b, w, -1)
        v = logp.shape[-1]
        # a finished beam only extends by the end token, at no cost
        frozen = torch.full((v,), -1e30, device=logp.device)
        frozen[self.end_token] = 0.0
        logp = torch.where(finished[:, :, None], frozen, logp)
        scores, toks, parents = beam_search_step(logp, scores, beam_size=w)
        finished = finished.gather(1, parents) | (toks == self.end_token)
        gidx = (torch.arange(b, device=tokens.device)[:, None] * w
                + parents).reshape(-1)
        new_states = pytree.tree_map(lambda s: s.index_select(0, gidx),
                                     new_states)
        return toks, parents, new_states, scores, finished


def dynamic_decode(decoder: BeamSearchDecoder, inits=None,
                   max_step_num: int = 32, batch_size=None,
                   output_time_major: bool = False, **kwargs):
    """Run the decoder for up to max_step_num steps, stopping early once
    every beam has finished (reference dynamic_decode).

    Returns (ids [B, T, W] int64 ([T, B, W] when time-major),
    final_scores [B, W]); beams come in beam_search_step order
    (descending scores, the best beam at W index 0)."""
    init_kw = {}
    if batch_size is not None and "batch_size" in \
            inspect.signature(decoder.initialize).parameters:
        init_kw["batch_size"] = batch_size
    tokens, states, scores, finished = decoder.initialize(inits, **init_kw)
    toks_steps, parents_steps = [], []
    for t in range(int(max_step_num)):
        tokens, parents, states, scores, finished = decoder.step(
            t, tokens, states, scores, finished)
        toks_steps.append(tokens)
        parents_steps.append(parents)
        if bool(finished.all()):
            break
    seqs = gather_tree(torch.stack(toks_steps), torch.stack(parents_steps))
    if not output_time_major:
        seqs = seqs.movedim(0, 1)
    return seqs.to(torch.int64), scores

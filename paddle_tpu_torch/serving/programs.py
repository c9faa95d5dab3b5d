"""The serving engine's programs, bucketed prefill, the paged decode
chunk and the paged multi-token chunk, and the per-engine program cache
that captures each of them as a CUDA graph (counterpart of
paddle_tpu/serving/programs.py).

The JAX engine runs a small fixed set of compiled executables over
static shapes, never a compile per request:

  n_prefill_buckets   prefill programs   (admit width x bucket length)
  n_decode_buckets    decode programs    (slot-count buckets)

and its raw-speed levers swap some of them for chunk programs (see
ServingEngine.expected_executables). The port keeps that set. On the card each (program, input shapes) entry
of an engine's ProgramCache is captured once, at the engine's warmup(),
as a torch.cuda.CUDAGraph, and every later dispatch replays it; on the
CPU each entry is the eager function. The RecompileSentinel pins the
entry count every step.

The math reuses models/generation.py's helpers (`_ln`, `_mm`,
`_attend`, `_prefill`, `_pick`) verbatim: the same ops in the same
order as the dense decode, only the cache addressing differs. That is
what makes the paged-vs-dense greedy parity hold token for token in f32.

Addressing: logical position ``p`` of a request lives in page
``table[p // block_size]`` at offset ``p % block_size``. Masked or
padded lanes carry an all-zeros table row: their writes land in the
reserved scratch page 0 and their reads are masked. Junk K/V (pad
positions a bucketed prefill computes past a row's true length) is
routed to scratch by table padding or overwritten by later decode
writes, and never attended, because every attention masks to the row's
live prefix. Indices past the ends (the table column of an over-decoded
position, a position past the position table) are clamped, as JAX
clamps a gather: such a write lands in the request's own last page,
which dies with it.

The rules of a captured program, which every body here keeps:
- static buffers: inputs are copied into buffers the graph was captured
  on, and outputs are read from the graph's own output tensors;
- no host synchronisation inside: no `.item()`, no boolean-mask
  indexing, no `nonzero`, no `torch.multinomial`; sampling adds Gumbel
  noise that the engine draws outside the graph from its generator;
- the page pools and the weights are read and written in place at the
  addresses the graph holds (JAX's donated `.at[].set` becomes an
  in-place index_put_): they are never reallocated, and a weight swap
  copies into them.

`make_chunk_fn` is the one program behind speculative verify and the
shared-prefix suffix prefill; unlike decode it routes the writes of
positions past a row's valid length to scratch instead of clamping them
into the row's last page, because under prefix sharing that page may be
borrowed. The tensor-parallel programs are not ported (ROADMAP.md queue
A item 14c).
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict

import numpy as np
import torch

from ..models.generation import _NEG, _attend, _ln, _mm, _pick, _prefill
from ..observability.anatomy import scope as _scope
from ..static.capture import capture, warm_up

__all__ = ["make_decode_fn", "make_prefill_fn", "make_chunk_fn",
           "ProgramCache"]

DISPATCH_TIMES_KEPT = 4096


def _gathered(pool, tables, n_heads, hd):
    """Pages -> contiguous logical cache: [n_blocks, bs, nh, hd]
    gathered by [B, W] tables into [B, nh, W*bs, hd] (table order is
    logical order, so index j along the length axis is position j)."""
    b, w = tables.shape
    pages = pool[tables]                       # [B, W, bs, nh, hd]
    flat = pages.reshape(b, w * pool.shape[1], n_heads, hd)
    return flat.permute(0, 2, 1, 3)


def make_decode_fn(eps: float, n_heads: int, block_size: int,
                   temperature: float, top_k, top_p, n_steps: int = 1):
    """``n_steps`` token boundaries for every running slot in one
    dispatch.

    run(pools, tables, toks, positions, params, noise=None)
        -> toks [n_steps, B] (int64); K/V written into pools in place

    toks [B] is each slot's last emitted token, positions [B] the
    logical index where its K/V land (== tokens held so far), noise
    [n_steps, B, V] the Gumbel noise of each step (None when greedy).
    The body mirrors generation.py's ragged decode step, with the cache
    write swapped for the paged scatter. Rows whose budget or eos fires
    mid-chunk decode at most n_steps - 1 junk tokens into their own
    pages; the host trims the emitted stream."""

    def step(pools, tables, toks, positions, params, noise):
        b = toks.shape[0]
        hd = params["wte"].shape[1] // n_heads
        scale = 1.0 / math.sqrt(hd)
        wpe = params["wpe"]
        # the JAX program's anatomy scopes: embed, attn and mlp per
        # layer, lm_head
        with _scope("embed"):
            x = (params["wte"][toks]
                 + wpe[positions.clamp(max=wpe.shape[0] - 1)])[:, None, :]
        bi = torch.arange(b, device=toks.device)
        col = (positions // block_size).clamp(max=tables.shape[1] - 1)
        blk = tables[bi, col]                            # [B]
        off = positions % block_size                     # [B]
        for bp, (kp, vp) in zip(params["blocks"], pools):
            with _scope("attn"):
                xn = _ln(x, bp["ln1_w"], bp["ln1_b"], eps)
                qkv = (_mm(xn, bp, "qkv") + bp["qkv_b"]).reshape(
                    b, 1, 3, n_heads, hd)
                q = qkv[:, :, 0].permute(0, 2, 1, 3)     # [B,nh,1,hd]
                kp[blk, off] = qkv[:, 0, 1]
                vp[blk, off] = qkv[:, 0, 2]
                kc = _gathered(kp, tables, n_heads, hd)
                vc = _gathered(vp, tables, n_heads, hd)
                ctx = _attend(q, kc, vc, positions + 1, scale)
                ctx = ctx.permute(0, 2, 1, 3).reshape(b, 1, -1)
                x = x + _mm(ctx, bp, "proj") + bp["proj_b"]
            with _scope("mlp"):
                ff = _ln(x, bp["ln2_w"], bp["ln2_b"], eps)
                ff = torch.nn.functional.gelu(_mm(ff, bp, "fc1")
                                              + bp["fc1_b"])
                x = x + _mm(ff, bp, "fc2") + bp["fc2_b"]
        with _scope("lm_head"):
            h = _ln(x, params["lnf_w"], params["lnf_b"], eps)
            logits = h[:, 0] @ params["wte"].T
            return _pick(logits, noise, temperature, top_k, top_p)

    def run(pools, tables, toks, positions, params, noise=None):
        out = []
        for i in range(n_steps):
            toks = step(pools, tables, toks, positions, params,
                        None if noise is None else noise[i])
            out.append(toks)
            positions = positions + 1
        return torch.stack(out)                          # [n_steps, B]

    return run


def make_prefill_fn(eps: float, n_heads: int, block_size: int,
                    temperature: float, top_k, top_p):
    """Bucketed admission prefill: the whole admit batch, of mixed true
    lengths, shares one program per (admit width, bucket length).

    run(pools, tables, ids, prompt_lens, params, noise=None) -> tok [A]

    ids [A, S] is right-padded to the bucket width S (a multiple of
    block_size); prompt_lens [A] drives generation.py's prefill mask, so
    each row's hidden state at its own last true token is exactly what
    the dense ragged path computes. The per-layer dense K/V [A, nh, S,
    hd] is then written page-wise into the pools and the first
    generated token is picked from the last-token logits (noise [A, V]
    when sampling)."""

    def run(pools, tables, ids, prompt_lens, params, noise=None):
        a, s = ids.shape
        if s % block_size:
            raise ValueError(
                f"prefill bucket {s} is not a multiple of "
                f"block_size {block_size}")
        nblk = s // block_size
        # the JAX program's anatomy scopes: the forward and the page
        # writes under attn, the head under lm_head
        with _scope("attn"):
            x, caches = _prefill(params, eps, n_heads, ids, s,
                                 prompt_lens=prompt_lens)
            pages = tables[:, :nblk]
            for (kp, vp), (kc, vc) in zip(pools, caches):
                # [A, nh, S, hd] -> page chunks [A, nblk, bs, nh, hd]
                shape = (a, nblk, block_size, kc.shape[1], kc.shape[3])
                kp[pages] = kc.permute(0, 2, 1, 3).reshape(shape)
                vp[pages] = vc.permute(0, 2, 1, 3).reshape(shape)
        with _scope("lm_head"):
            bi = torch.arange(a, device=ids.device)
            last = x[bi, prompt_lens - 1][:, None]
            h = _ln(last, params["lnf_w"], params["lnf_b"], eps)
            logits = h[:, 0] @ params["wte"].T
            return _pick(logits, noise, temperature, top_k, top_p)

    return run


def make_chunk_fn(eps: float, n_heads: int, block_size: int,
                  temperature: float, top_k, top_p):
    """Multi-token forward over the paged cache, the one program behind
    two levers:

    - speculative verify: the target scores a draft's k proposals plus
      the anchor token in one dispatch (``[slots, k+1]``) and returns
      every position's greedy argmax, so the host keeps the longest
      agreeing prefix;
    - shared-prefix suffix prefill: a request whose prompt head already
      lives in shared pages forwards only its unshared tail (``[admit,
      suffix bucket]``), its queries attending the shared pages through
      the same table gather decode uses.

    run(pools, tables, toks, starts, lens, params, noise=None)
        -> (all_tok [B, S], picked [B]) (int64); K/V written in place

    toks [B, S] is a right-padded token window, starts [B] the logical
    position of toks[:, 0] (the tokens already in the cache), lens [B]
    the valid counts (1..S), noise [B, V] the Gumbel noise of the pick
    (None when greedy). Position q of row i lands its K/V at logical
    ``starts[i] + q``; positions past lens write to scratch page 0. The
    per-query causal mask (key position <= query position) gives every
    query the support of a decode step at its position, so the verify
    argmaxes equal sequential decode. all_tok is the f32 argmax at every
    position; picked is the token at each row's last valid position (the
    next token a non-speculative boundary would emit)."""

    def run(pools, tables, toks, starts, lens, params, noise=None):
        b, s = toks.shape
        hd = params["wte"].shape[1] // n_heads
        scale = 1.0 / math.sqrt(hd)
        dev = toks.device
        offs = torch.arange(s, device=dev)
        positions = starts[:, None] + offs[None, :]          # [B, S]
        valid = offs[None, :] < lens[:, None]                # [B, S]
        wpe = params["wpe"]
        with _scope("embed"):
            x = (params["wte"][toks]
                 + wpe[positions.clamp(max=wpe.shape[0] - 1)])  # [B,S,H]
        bi = torch.arange(b, device=dev)
        col = (positions // block_size).clamp(max=tables.shape[1] - 1)
        blk = torch.where(valid, tables[bi[:, None], col], 0)  # [B, S]
        off = positions % block_size
        for bp, (kp, vp) in zip(params["blocks"], pools):
            with _scope("attn"):
                xn = _ln(x, bp["ln1_w"], bp["ln1_b"], eps)
                qkv = (_mm(xn, bp, "qkv") + bp["qkv_b"]).reshape(
                    b, s, 3, n_heads, hd)
                q = qkv[:, :, 0].permute(0, 2, 1, 3)     # [B,nh,S,hd]
                kp[blk, off] = qkv[:, :, 1]
                vp[blk, off] = qkv[:, :, 2]
                kc = _gathered(kp, tables, n_heads, hd)
                vc = _gathered(vp, tables, n_heads, hd)
                att = torch.einsum("bnqh,bnkh->bnqk", q, kc) * scale
                kpos = torch.arange(kc.shape[2], device=dev)
                mask = (kpos[None, None, None, :]
                        <= positions[:, None, :, None])
                att = torch.where(mask, att, _NEG)
                p = torch.softmax(att.float(), dim=-1).to(x.dtype)
                ctx = torch.einsum("bnqk,bnkh->bnqh", p, vc)
                ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, -1)
                x = x + _mm(ctx, bp, "proj") + bp["proj_b"]
            with _scope("mlp"):
                ff = _ln(x, bp["ln2_w"], bp["ln2_b"], eps)
                ff = torch.nn.functional.gelu(_mm(ff, bp, "fc1")
                                              + bp["fc1_b"])
                x = x + _mm(ff, bp, "fc2") + bp["fc2_b"]
        with _scope("lm_head"):
            h = _ln(x, params["lnf_w"], params["lnf_b"], eps)
            logits = h @ params["wte"].T                     # [B, S, V]
            all_tok = torch.argmax(logits.float(), dim=-1)
            last = logits[bi, lens - 1]                      # [B, V]
            return all_tok, _pick(last, noise, temperature, top_k, top_p)

    return run


def copy_page_fn(pools, src, dst, params=None, noise=None):
    """The copy-on-write page copy: page ``src`` of every pool into page
    ``dst`` (src, dst [1]), in place. Scratch into scratch is a harmless
    write, which is how the program is captured at warm-up."""
    for kv in pools:
        for t in kv:
            t.index_copy_(0, dst, t.index_select(0, src))


def _to_host(out):
    if out is None:
        return None
    if isinstance(out, tuple):
        return tuple(o.cpu().numpy() for o in out)
    return out.cpu().numpy()


class _Graph:
    """One captured program: the graph, its static input buffers (one
    int64 buffer, viewed per input), its static noise buffer and its
    output (a tensor, a tuple of tensors, or None)."""
    __slots__ = ("graph", "flat", "inputs", "noise", "out")


class ProgramCache:
    """An engine's programs, keyed by (program name, input shapes); the
    counterpart of the JAX engine's per-engine jits with donated pools.

    ``cache(name, fn, pools, params, inputs, noise)`` runs
    ``fn(pools, *inputs, params, noise)`` and returns its output as a
    numpy array (a tuple of them for a program with several outputs,
    None for one without). ``inputs`` are host integer arrays (tables, tokens,
    positions, lengths); ``noise`` is a float tensor on the device, or
    None when greedy.

    On a CUDA device the first call of a key captures the program as a
    torch.cuda.CUDAGraph (a warm-up run on a side stream, then the
    capture, on static buffers filled with the call's inputs) and every
    call replays it: the inputs are copied into the static buffers (one
    host-to-device copy), the graph replays, and the output is copied
    out. A capture that fails raises: there is no eager route on the
    card. On the CPU each key's entry is the eager function.

    Counts: ``len(cache)`` entries (the engine's executable count),
    ``captures``, ``replays``, ``eager_dispatches`` (calls that ran a
    program eagerly; on the card always 0), and ``dispatch_ms[name]``,
    the host time of each of the last DISPATCH_TIMES_KEPT calls from the
    copy in to the copy out (bounded, so a long-running server does not
    grow it)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._entries: Dict[tuple, object] = {}
        self.captures = 0
        self.replays = 0
        self.eager_dispatches = 0
        self.dispatch_ms: Dict[str, deque] = {}

    def __len__(self):
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def graph(self, key):
        """The captured entry of `key` (None on the CPU)."""
        ent = self._entries[key]
        return ent if isinstance(ent, _Graph) else None

    def __call__(self, name, fn, pools, params, inputs, noise=None):
        t0 = time.perf_counter()
        host = [np.ascontiguousarray(a, dtype=np.int64) for a in inputs]
        key = (name, tuple(a.shape for a in host),
               None if noise is None else tuple(noise.shape))
        if self.device.type != "cuda":
            self._entries.setdefault(key, fn)
            self.eager_dispatches += 1
            with torch.no_grad():
                out = fn(pools, *[torch.from_numpy(a) for a in host],
                         params, noise)
        else:
            ent = self._entries.get(key)
            if ent is None:
                ent = self._capture(fn, pools, params, host, noise)
                self._entries[key] = ent
            self._fill(ent, host, noise)
            ent.graph.replay()
            self.replays += 1
            out = ent.out
        res = _to_host(out)
        self.dispatch_ms.setdefault(
            name, deque(maxlen=DISPATCH_TIMES_KEPT)).append(
            (time.perf_counter() - t0) * 1e3)
        return res

    @staticmethod
    def _fill(ent, host, noise):
        ent.flat.copy_(torch.from_numpy(
            np.concatenate([a.reshape(-1) for a in host])))
        if noise is not None:
            ent.noise.copy_(noise)

    def _capture(self, fn, pools, params, host, noise):
        dev = self.device
        ent = _Graph()
        ent.flat = torch.empty(sum(a.size for a in host), dtype=torch.long,
                               device=dev)
        ent.inputs, off = [], 0
        for a in host:
            ent.inputs.append(ent.flat[off:off + a.size].view(a.shape))
            off += a.size
        ent.noise = None if noise is None else torch.empty_like(noise)
        self._fill(ent, host, noise)

        def body():
            return fn(pools, *ent.inputs, params, ent.noise)

        with torch.no_grad():
            # warm-up on a side stream (lazy library state, workspaces),
            # then the capture; both on this call's inputs, so the pool
            # writes of the warm-up are the ones the replay makes again
            warm_up(body, dev)
            ent.graph, ent.out = capture(body, dev, program="serving")
        self.captures += 1
        return ent

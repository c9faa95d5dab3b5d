"""Autoregressive generation with a KV cache (counterpart of
paddle_tpu/models/generation.py).

Prefill computes the prompt's per-layer K/V into a cache sized to
prompt + max_new_tokens, then each decode step writes one token's K/V in
place and attends over the valid prefix with a position mask. The JAX
package compiles the whole loop as one program per static signature
(`_build_run`, `_build_beam_run`, each lru_cached 64 deep). Here each
static signature (the same key plus the batch) is one `_Program`: static
buffers for the inputs, the caches, the position, the done flags and the
output, and three bodies over them with no host read, captured on the
card as CUDA graphs (prefill; one decode step, replayed T - 1 times;
finish), so a call is one copy in, T + 1 replays and one copy out. The
programs live in one per-model ProgramLRU, bounded to PROGRAMS_MAX
entries as the JAX lru_caches are and, unlike them, to PROGRAM_BYTES_MAX
bytes of resident buffers (a program keeps its KV caches while idle,
where a JAX executable keeps none), watched by a
RecompileSentinel("generate"). All of a model's graphs capture into one
shared memory pool. The eager step-by-step loop stays
(generate(eager=True), and what the CPU runs by default): it is the
reference the captured programs are held against, token for token.

Greedy, temperature / top-k / top-p sampling (filters applied in that
order, as the JAX package does), eos/pad, ragged prompts (prompt_lens)
and beam search over the same cache. Correctness contract: greedy decode
through the cache equals argmax over full re-forward logits at every
step.

This module is also the numerical reference of the continuous-batching
engine: serving/programs.py calls `_ln`, `_mm`, `_attend`, `_prefill`
and `_pick` (and the engine `_gpt_params`/`_cast_params`), so the paged
decode is the same ops in the same order with only the cache addressing
changed. That reuse is what makes the paged-vs-dense greedy parity hold
token for token in f32. A change to these helpers must keep both test
files green (tests/test_torch_generation.py, tests/test_torch_serving.py).

Sampling draws by Gumbel-max, as jax.random.categorical does: the token
is argmax(logits + g) with g = -log(-log(u)), u uniform in (tiny, 1),
drawn from an explicit torch.Generator. The draws differ from JAX's for
the same seed; the filters and the argmax are the same.
"""
from __future__ import annotations

import math
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..core.dtypes import convert_dtype
from ..quant.int8_serving import int8_matmul

__all__ = ["generate_gpt", "generate_programs", "GenerateState",
           "ProgramLRU", "PROGRAMS_MAX", "PROGRAM_BYTES_MAX"]

_NEG = -1e30


def _ln(x, w, b, eps):
    # moments in f32 regardless of storage dtype: bf16 serving would
    # otherwise lose layer norm precision. var is the population variance
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) / torch.sqrt(var + eps)).to(x.dtype) * w + b


_BLOCK_KEYS = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "qkv_w", "qkv_b",
               "proj_w", "proj_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _block_name(key):
    """Decode key -> the block's parameter name (ln1_w is ln1.weight,
    qkv_b qkv.bias, ...)."""
    return key[:-2] + (".weight" if key.endswith("_w") else ".bias")


def _block_params(blk):
    """Decode key -> the block's parameter tensor."""
    return {k: blk.get_parameter(_block_name(k)).detach()
            for k in _BLOCK_KEYS}


def _gpt_params(model):
    """The model's parameters as the generation/serving dict: wte, wpe,
    lnf_w, lnf_b and per-block dicts. Detached views of the live
    parameters, not copies. A scan_layers model's [L, ...] stacks are
    sliced into the same per-layer dicts, so generation and serving run
    alike off either layout."""
    gpt = model.gpt
    if gpt.config.scan_layers:
        stk = gpt.blocks
        stacks = {k: stk.stacked(_block_name(k)).detach()
                  for k in _BLOCK_KEYS}
        blocks = [{k: v[i] for k, v in stacks.items()}
                  for i in range(stk.L)]
    else:
        blocks = [_block_params(b) for b in gpt.blocks]
    return {
        "wte": gpt.wte.weight.detach(),
        "wpe": gpt.wpe.weight.detach(),
        "lnf_w": gpt.ln_f.weight.detach(), "lnf_b": gpt.ln_f.bias.detach(),
        "blocks": blocks,
    }


def _mm(x, bp, name):
    """One block matmul through either the float weight ``<name>_w`` or
    the serving int8 snapshot's ``{"q8", "s"}`` leaf
    (quant/int8_serving.py: per-channel codes and dequant factors). The
    float path is the ``x @ w`` it always was, so the f32 greedy parity
    holds as before."""
    w = bp[name + "_w"]
    if isinstance(w, dict):
        return int8_matmul(x, w["q8"], w["s"])
    return x @ w


def _attend(q, kc, vc, n_valid, scale):
    """q [B,N,1,hd] over cache kc/vc [B,N,T,hd], masked to n_valid
    (an int, or [B] for ragged per-row prompt lengths)."""
    s = torch.einsum("bnqh,bnkh->bnqk", q, kc) * scale
    pos = torch.arange(kc.shape[2], device=kc.device)
    if isinstance(n_valid, torch.Tensor) and n_valid.dim():
        mask = pos[None, None, None, :] < n_valid[:, None, None, None]
    else:
        mask = pos[None, None, None, :] < n_valid
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bnkh->bnqh", p, vc)


def _heads(qkv):
    """[B, S, 3, N, hd] -> q, k, v as [B, N, S, hd]."""
    return (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))


def _blocks_step(params, eps, n_heads, x, caches, write, n_valid):
    """One token's hidden state through all blocks: each block's K/V go
    into its caches through write(kc, vc, k, v) (k, v [B, N, 1, hd]),
    then attention runs over the caches masked to n_valid."""
    hd = x.shape[-1] // n_heads
    scale = 1.0 / math.sqrt(hd)
    b = x.shape[0]
    for bp, (kc, vc) in zip(params["blocks"], caches):
        xn = _ln(x, bp["ln1_w"], bp["ln1_b"], eps)
        qkv = (_mm(xn, bp, "qkv") + bp["qkv_b"]).reshape(
            b, 1, 3, n_heads, hd)
        q, k, v = _heads(qkv)
        write(kc, vc, k, v)
        ctx = _attend(q, kc, vc, n_valid, scale)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, 1, -1)
        x = x + _mm(ctx, bp, "proj") + bp["proj_b"]
        ff = _ln(x, bp["ln2_w"], bp["ln2_b"], eps)
        ff = torch.nn.functional.gelu(_mm(ff, bp, "fc1") + bp["fc1_b"])
        x = x + _mm(ff, bp, "fc2") + bp["fc2_b"]
    return x


def _step_hidden(params, eps, n_heads, x, caches, pos):
    """One token's hidden state through all blocks, writing its K/V
    into the caches in place.

    x: [B, 1, H]; caches: list of (k [B,N,T,hd], v [B,N,T,hd]);
    pos: index where this token's K/V land, an int (uniform prompts) or
    [B] (ragged prompts: each row writes at its own next position and
    attends over its own valid prefix)."""
    ragged = isinstance(pos, torch.Tensor) and pos.dim() > 0
    bi = torch.arange(x.shape[0], device=x.device)

    def write(kc, vc, k, v):
        if ragged:
            # per-row scatter: row i writes its K/V at pos[i]
            kc[bi, :, pos] = k[:, :, 0]
            vc[bi, :, pos] = v[:, :, 0]
        else:
            kc[:, :, pos] = k[:, :, 0]
            vc[:, :, pos] = v[:, :, 0]

    return _blocks_step(params, eps, n_heads, x, caches, write,
                        pos + 1), caches


def _step_hidden_at(params, eps, n_heads, x, caches, pos, ragged):
    """_step_hidden for a program whose position lives on the device:
    pos is a [1] int64 tensor (uniform prompts; index_copy_ along the
    cache's time axis) or [B] (ragged; a per-row scatter). No host read,
    so it runs inside a captured graph; the caches are written in
    place."""
    bi = torch.arange(x.shape[0], device=x.device)

    def write(kc, vc, k, v):
        if ragged:
            kc[bi, :, pos] = k[:, :, 0]
            vc[bi, :, pos] = v[:, :, 0]
        else:
            kc.index_copy_(2, pos, k)
            vc.index_copy_(2, pos, v)

    return _blocks_step(params, eps, n_heads, x, caches, write, pos + 1)


def _prefill(params, eps, n_heads, ids, total_len, prompt_lens=None,
             qkv_heads_major=False, tp_reduce=None, head_dim=None):
    """Full forward over the prompt, returning per-layer caches sized to
    total_len and the hidden states. Dense attention over the whole
    prompt; only decode is token-wise.

    prompt_lens [B] (ragged, right-padded prompts): keys beyond each
    row's true length are masked; their junk cache slots are overwritten
    by the decode's per-row writes before anything attends to them.

    qkv_heads_major / tp_reduce / head_dim are the JAX package's
    tensor-parallel hooks; tensor-parallel serving is not ported."""
    if qkv_heads_major or tp_reduce is not None or head_dim is not None:
        raise NotImplementedError(
            "tensor-parallel prefill (qkv_heads_major/tp_reduce/head_dim)"
            " is not ported yet: it comes with ROADMAP.md queue A item 14"
            " (tp serving)")
    b, s = ids.shape
    dev = ids.device
    hd = params["wte"].shape[1] // n_heads
    scale = 1.0 / math.sqrt(hd)
    x = params["wte"][ids] + params["wpe"][torch.arange(s, device=dev)][None]
    cm = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    if prompt_lens is not None:
        cm = (cm[None, None]
              & (torch.arange(s, device=dev)[None, :]
                 < prompt_lens[:, None])[:, None, None, :])
    caches = []
    for bp in params["blocks"]:
        xn = _ln(x, bp["ln1_w"], bp["ln1_b"], eps)
        qkv = (_mm(xn, bp, "qkv") + bp["qkv_b"]).reshape(
            b, s, 3, n_heads, hd)
        q, k, v = _heads(qkv)
        att = torch.einsum("bnqh,bnkh->bnqk", q, k) * scale
        att = torch.where(cm, att, _NEG)
        p = torch.softmax(att.float(), dim=-1).to(x.dtype)
        ctx = torch.einsum("bnqk,bnkh->bnqh", p, v)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, -1)
        x = x + _mm(ctx, bp, "proj") + bp["proj_b"]
        ff = _ln(x, bp["ln2_w"], bp["ln2_b"], eps)
        ff = torch.nn.functional.gelu(_mm(ff, bp, "fc1") + bp["fc1_b"])
        x = x + _mm(ff, bp, "fc2") + bp["fc2_b"]
        kc = torch.zeros((b, n_heads, total_len, hd), dtype=k.dtype,
                         device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :, :s] = k
        vc[:, :, :s] = v
        caches.append((kc, vc))
    return x, caches


def _gumbel(shape, generator, device):
    """Gumbel(0, 1) noise -log(-log(u)), u uniform in [tiny, 1), f32: the
    noise jax.random.categorical adds before its argmax."""
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(torch.finfo(torch.float32).tiny, 1.0, generator=generator)
    return -torch.log(-torch.log(u))


def _filter(logits, temperature, top_k, top_p=None):
    """The sampling filters on f32 logits [B, V]: temperature, then
    top-k, then top-p over the top-k-masked distribution (the JAX
    package's sequential order). Filtered-out entries read -1e30."""
    logits = logits / temperature
    need_p = top_p is not None and float(top_p) < 1.0
    if top_k is not None or need_p:
        # one descending sort serves both filters
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
    if top_k is not None:
        k = min(int(top_k), logits.shape[-1])  # HF-style clamp
        kth = sorted_l[:, k - 1:k]
        logits = torch.where(logits >= kth, logits, _NEG)
    if need_p:
        # nucleus: the smallest prefix of the descending order whose mass
        # reaches top_p (the first token past the threshold stays in; the
        # top token's exclusive mass is 0, so it always survives)
        base = sorted_l
        if top_k is not None:
            col = torch.arange(base.shape[-1], device=base.device)
            base = torch.where(col[None, :] < k, base, _NEG)
        probs = torch.softmax(base, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < float(top_p)
        kth = torch.where(keep, base, math.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= kth, logits, _NEG)
    return logits


def _pick(logits, noise, temperature, top_k, top_p=None):
    """Next token [B] (int64) from logits [B, V]: argmax when
    temperature is 0, else Gumbel-max over the filtered logits with
    `noise` [B, V] (_gumbel). Sampling math in f32 even when the matmuls
    ran in bf16; no host synchronisation, so it runs inside a captured
    program."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(_filter(logits, temperature, top_k, top_p)
                        + noise, dim=-1)


def _cast_params(params, dtype):
    """The generation/serving dict with every floating tensor cast to
    `dtype` (None keeps it as it is). Integer leaves pass through."""
    if dtype is None:
        return params
    if isinstance(params, dict):
        return {k: _cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_cast_params(v, dtype) for v in params)
    return params.to(dtype) if params.is_floating_point() else params


def _last_logits(params, eps, x, prompt_lens):
    """Logits [B, V] at each row's last prompt token (the last column,
    or prompt_lens - 1 per row)."""
    if prompt_lens is None:
        last = x[:, -1:]
    else:
        bi = torch.arange(x.shape[0], device=x.device)
        last = x[bi, prompt_lens - 1][:, None]
    h = _ln(last, params["lnf_w"], params["lnf_b"], eps)
    return h[:, 0] @ params["wte"].T


def _greedy_or_sample(params, eps, n_heads, ids, max_new_tokens, total,
                      temperature, top_k, top_p, eos_token_id,
                      pad_token_id, generator, prompt_lens=None):
    b, prompt = ids.shape
    x, caches = _prefill(params, eps, n_heads, ids, total,
                         prompt_lens=prompt_lens)
    logits = _last_logits(params, eps, x, prompt_lens)
    pos = prompt if prompt_lens is None else prompt_lens.clone()
    done = torch.zeros((b,), dtype=torch.bool, device=ids.device)
    toks = []
    v = params["wte"].shape[0]
    for step in range(max_new_tokens):
        noise = (None if temperature == 0.0
                 else _gumbel((b, v), generator, ids.device))
        tok = _pick(logits, noise, temperature, top_k, top_p)
        if eos_token_id is not None:
            tok = torch.where(done, pad_token_id, tok)
            done = done | (tok == eos_token_id)
        toks.append(tok)
        if step == max_new_tokens - 1:
            break      # the last token's K/V is never read
        x = (params["wte"][tok] + params["wpe"][pos])[:, None, :]
        x, caches = _step_hidden(params, eps, n_heads, x, caches, pos)
        h = _ln(x, params["lnf_w"], params["lnf_b"], eps)
        logits = h[:, 0] @ params["wte"].T
        pos = pos + 1
    return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)


def _beam_search(params, eps, n_heads, ids, num_beams, max_new_tokens,
                 total, eos_token_id, pad_token_id):
    """Beam search over the KV cache: beams live as batch rows [B*W],
    each step expands with beam_search_step (ops/extras.py), reorders
    the caches by parent beam, and gather_tree walks the token/parent
    trail back. Returns (ids + best beam's tokens [B, P+T] int64, its
    score [B] f32)."""
    from ..ops.extras import beam_search_step, gather_tree
    w = num_beams
    b, prompt = ids.shape
    dev = ids.device
    # prefill ONCE over the B prompts, then repeat caches and the final
    # logits across beams
    x, caches = _prefill(params, eps, n_heads, ids, total)
    caches = [(k.repeat_interleave(w, 0), v.repeat_interleave(w, 0))
              for k, v in caches]
    logits = _last_logits(params, eps, x, None).repeat_interleave(w, 0)
    scores = torch.tensor([0.0] + [_NEG] * (w - 1), device=dev).repeat(b, 1)
    done = torch.zeros((b, w), dtype=torch.bool, device=dev)
    v = params["wte"].shape[0]
    frozen = torch.full((v,), _NEG, device=dev)
    frozen[pad_token_id] = 0.0
    all_toks, all_parents = [], []
    pos = prompt
    for step in range(max_new_tokens):
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, w, -1)
        if eos_token_id is not None:
            # finished beams only extend with pad at zero cost
            logp = torch.where(done[:, :, None], frozen[None, None], logp)
        scores, toks, parents = beam_search_step(logp, scores, beam_size=w)
        if eos_token_id is not None:
            done = torch.gather(done, 1, parents) | (toks == eos_token_id)
        all_toks.append(toks)
        all_parents.append(parents)
        if step == max_new_tokens - 1:
            break
        # reorder beam rows (KV caches) by parent
        gidx = (torch.arange(b, device=dev)[:, None] * w
                + parents).reshape(-1)
        caches = [(k.index_select(0, gidx), vv.index_select(0, gidx))
                  for k, vv in caches]
        x = (params["wte"][toks.reshape(-1)]
             + params["wpe"][pos][None])[:, None, :]
        x, caches = _step_hidden(params, eps, n_heads, x, caches, pos)
        h = _ln(x, params["lnf_w"], params["lnf_b"], eps)
        logits = h[:, 0] @ params["wte"].T
        pos += 1
    seqs = gather_tree(torch.stack(all_toks), torch.stack(all_parents))
    best = torch.argmax(scores, dim=1)                      # [B]
    bi = torch.arange(b, device=dev)
    best_toks = seqs[:, bi, best]                           # [T, B]
    return (torch.cat([ids, best_toks.T], dim=1), scores[bi, best])


def _as_long(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)


# -- the static programs ------------------------------------------------------

PROGRAMS_MAX = 64            # the program cache's bound (the JAX lru_cache's)
PROGRAM_BYTES_MAX = 4 << 30  # and on the bytes its programs' buffers hold


class ProgramLRU:
    """key -> program, bounded to `maxsize` entries and to `max_bytes`
    bytes of the programs' `nbytes`, evicting the least recently used, as
    functools.lru_cache(maxsize) does; the program just built stays even
    when it alone is over `max_bytes`. An evicted program's release()
    frees its graphs and buffers. Counts hits, misses and evictions."""

    def __init__(self, maxsize: int = PROGRAMS_MAX,
                 max_bytes: int = PROGRAM_BYTES_MAX):
        self.maxsize = int(maxsize)
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict" = OrderedDict()
        self.nbytes = 0
        self.hits = self.misses = self.evictions = 0

    def __len__(self):
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def get(self, key, build):
        """The program of `key`, built by build() on a miss."""
        prog = self._entries.get(key)
        if prog is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return prog
        self.misses += 1
        prog = build()
        self._entries[key] = prog
        self.nbytes += getattr(prog, "nbytes", 0)
        while len(self._entries) > self.maxsize or (
                self.nbytes > self.max_bytes and len(self._entries) > 1):
            _, old = self._entries.popitem(last=False)
            self.evictions += 1
            self.nbytes -= getattr(old, "nbytes", 0)
            old.release()
        return prog

    def clear(self):
        for prog in self._entries.values():
            prog.release()
        self._entries.clear()
        self.nbytes = 0


def _leaves_of(params):
    if isinstance(params, dict):
        return [x for k in params for x in _leaves_of(params[k])]
    if isinstance(params, (list, tuple)):
        return [x for v in params for x in _leaves_of(v)]
    return [params]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


class _Weights:
    """The weights one dtype's programs read: the model's own tensors
    where no cast is needed (captured by address), else cast copies the
    programs own, made once and refreshed in place (copy_) when a
    source tensor changed since (its version counter or address moved).
    refresh() returns False when an uncast source tensor moved to a new
    address: the programs captured on the old one must be rebuilt."""

    def __init__(self, src, dtype):
        leaves = _leaves_of(src)
        own = [t.to(dtype) if dtype is not None and t.is_floating_point()
               else t for t in leaves]
        self.owned = [o.data_ptr() != t.data_ptr()
                      for o, t in zip(own, leaves)]
        self.tree = _rebuild(src, iter(own))
        self._own = own
        self._token = self._token_of(leaves)

    @staticmethod
    def _token_of(leaves):
        return tuple((t.data_ptr(), t._version) for t in leaves)

    def refresh(self, src) -> bool:
        leaves = _leaves_of(src)
        token = self._token_of(leaves)
        if token == self._token:
            return True
        for o, t, owned, (ptr, _) in zip(self._own, leaves, self.owned,
                                          self._token):
            if owned:
                o.copy_(t)
            elif t.data_ptr() != ptr:
                return False
        self._token = token
        return True


class _Program:
    """generate's program for one static signature (the JAX
    _build_run/_build_beam_run key plus the batch): the inputs, the
    decode state and the output live in static buffers, and three
    bodies run over them with no host read:

      prefill  the prompt's forward into the caches, the first logits,
               the state reset, the first pick (or beam expansion);
      step     one decode step: the last token's embedding (and for
               beams the caches reordered by parent, in place), its K/V
               written at the device position, the next logits, the
               next pick; replayed max_new_tokens - 1 times;
      finish   the output assembled (for beams gather_tree's walk back
               and the best beam).

    On the card each body is captured as a CUDA graph (static/capture.py:
    a warm-up on a side stream, then the capture, the sampling
    generator registered with the graph) into the memory pool `pool`;
    on the CPU the bodies run eagerly over the same buffers. A call is
    one copy of the inputs, a manual_seed of the generator and
    1 + (T - 1) + 1 replays. `nbytes` counts the static buffers the
    program holds while idle."""

    def __init__(self, spec, weights, b, device, pool=None):
        self.spec = spec
        self.weights = weights
        self.graphs = {}
        dev = self.device = torch.device(device)
        p, t, total = spec["prompt"], spec["max_new_tokens"], spec["total"]
        w = spec["num_beams"]
        params = weights.tree
        wte = params["wte"]
        v, hidden = wte.shape
        heads = spec["heads"]
        rows = b * w
        z = dict(device=dev)
        self.b, self.w, self.v = b, w, v
        self.ids = torch.zeros((b, p), dtype=torch.long, **z)
        self.pl = (torch.ones((b,), dtype=torch.long, **z)
                   if spec["ragged"] else None)
        self.caches = [tuple(torch.zeros((rows, heads, total,
                                          hidden // heads),
                                         dtype=wte.dtype, **z)
                             for _ in range(2))
                       for _ in params["blocks"]]
        self.logits = torch.zeros((rows, v), dtype=wte.dtype, **z)
        self.pos = torch.zeros((b,) if spec["ragged"] else (1,),
                               dtype=torch.long, **z)
        self.t = torch.zeros((1,), dtype=torch.long, **z)
        self.out = torch.zeros((b, p + t), dtype=torch.long, **z)
        self.gen = None
        if w > 1:
            self.scores = torch.zeros((b, w), dtype=torch.float32, **z)
            self.scores0 = torch.tensor([0.0] + [_NEG] * (w - 1),
                                        **z).repeat(b, 1)
            self.done = torch.zeros((b, w), dtype=torch.bool, **z)
            self.frozen = torch.full((v,), _NEG, **z)
            self.frozen[spec["pad"]] = 0.0
            self.beam_base = torch.arange(b, **z)[:, None] * w
            self.cur_toks = torch.zeros((b, w), dtype=torch.long, **z)
            self.cur_parents = torch.zeros((b, w), dtype=torch.long, **z)
            self.toks = torch.zeros((t, b, w), dtype=torch.long, **z)
            self.parents = torch.zeros((t, b, w), dtype=torch.long, **z)
            self.best_scores = torch.zeros((b,), dtype=torch.float32, **z)
            bodies = (self._beam_prefill, self._beam_step,
                      self._beam_finish)
        else:
            self.done = torch.zeros((b,), dtype=torch.bool, **z)
            self.tok = torch.zeros((b,), dtype=torch.long, **z)
            self.toks = torch.zeros((t, b), dtype=torch.long, **z)
            if spec["temperature"] != 0.0:
                self.gen = torch.Generator(device=dev)
            bodies = (self._prefill, self._step, self._finish)
        self.bodies = dict(zip(("prefill", "step", "finish"), bodies))
        if t == 1:
            del self.bodies["step"]   # no decode step: one pick in all
        self.nbytes = sum(x.numel() * x.element_size()
                          for x in self._buffers())
        if pool is not None:
            self._capture_all(pool)

    def _buffers(self):
        return [x for x in vars(self).values()
                if isinstance(x, torch.Tensor)] + [
            x for kv in self.caches for x in kv]

    # -- capture --------------------------------------------------------------
    def _capture_all(self, pool):
        from ..static.capture import capture, warm_up
        gens = () if self.gen is None else (self.gen,)
        for name, body in self.bodies.items():
            warm_up(body, self.device)
            self.graphs[name], _ = capture(body, self.device, gens,
                                           program="generate", pool=pool)

    def release(self):
        """Drop the graphs (the shared pool goes back to the allocator
        with the model's last graph) and the buffers."""
        for g in self.graphs.values():
            g.reset()
        self.graphs.clear()
        self.bodies = {}
        for name in [k for k, x in vars(self).items()
                     if isinstance(x, torch.Tensor)]:
            delattr(self, name)
        self.caches = []

    # -- a call ---------------------------------------------------------------
    def __call__(self, ids, prompt_lens, seed):
        self.ids.copy_(ids, non_blocking=True)
        if self.pl is not None:
            self.pl.copy_(prompt_lens, non_blocking=True)
        if self.gen is not None:
            self.gen.manual_seed(int(seed))
        run = ({k: g.replay for k, g in self.graphs.items()}
               if self.graphs else self.bodies)
        run["prefill"]()
        for _ in range(self.spec["max_new_tokens"] - 1):
            run["step"]()
        run["finish"]()
        if self.w > 1:
            return self.out.to(torch.int32), self.best_scores.clone()
        return self.out.to(torch.int32)

    # -- greedy / sampled bodies ----------------------------------------------
    def _reset_caches(self, caches, repeat=1):
        for (kc, vc), (k, vv) in zip(self.caches, caches):
            kc.copy_(k if repeat == 1 else k.repeat_interleave(repeat, 0))
            vc.copy_(vv if repeat == 1 else vv.repeat_interleave(repeat, 0))

    def _next_hidden(self, toks):
        """The next logits from tokens toks [rows] at self.pos."""
        sp, params = self.spec, self.weights.tree
        x = (params["wte"].index_select(0, toks)
             + params["wpe"].index_select(0, self.pos))[:, None, :]
        x = _step_hidden_at(params, sp["eps"], sp["heads"], x, self.caches,
                            self.pos, sp["ragged"])
        h = _ln(x, params["lnf_w"], params["lnf_b"], sp["eps"])
        self.logits.copy_(h[:, 0] @ params["wte"].T)
        self.pos.add_(1)

    def _pick_next(self):
        sp = self.spec
        noise = (None if self.gen is None
                 else _gumbel((self.b, self.v), self.gen, self.device))
        tok = _pick(self.logits, noise, sp["temperature"], sp["top_k"],
                    sp["top_p"])
        if sp["eos"] is not None:
            tok = torch.where(self.done, sp["pad"], tok)
            self.done.copy_(self.done | (tok == sp["eos"]))
        self.tok.copy_(tok)
        self.toks.index_copy_(0, self.t, tok[None])
        self.t.add_(1)

    def _prefill(self):
        sp, params = self.spec, self.weights.tree
        x, caches = _prefill(params, sp["eps"], sp["heads"], self.ids,
                             sp["total"], prompt_lens=self.pl)
        self._reset_caches(caches)
        self.logits.copy_(_last_logits(params, sp["eps"], x, self.pl))
        if self.pl is not None:
            self.pos.copy_(self.pl)
        else:
            self.pos.fill_(sp["prompt"])
        self.done.zero_()
        self.t.zero_()
        self._pick_next()

    def _step(self):
        self._next_hidden(self.tok)
        self._pick_next()

    def _finish(self):
        self.out.copy_(torch.cat([self.ids, self.toks.T], dim=1))

    # -- beam bodies ----------------------------------------------------------
    def _expand(self):
        from ..ops.extras import beam_search_step
        sp, b, w = self.spec, self.b, self.w
        logp = torch.log_softmax(self.logits.float(), dim=-1).reshape(
            b, w, -1)
        if sp["eos"] is not None:
            # finished beams only extend with pad at zero cost
            logp = torch.where(self.done[:, :, None], self.frozen[None, None],
                               logp)
        scores, toks, parents = beam_search_step(logp, self.scores,
                                                 beam_size=w)
        if sp["eos"] is not None:
            self.done.copy_(torch.gather(self.done, 1, parents)
                            | (toks == sp["eos"]))
        self.scores.copy_(scores)
        self.cur_toks.copy_(toks)
        self.cur_parents.copy_(parents)
        self.toks.index_copy_(0, self.t, toks[None])
        self.parents.index_copy_(0, self.t, parents[None])
        self.t.add_(1)

    def _beam_prefill(self):
        sp, params = self.spec, self.weights.tree
        # prefill once over the B prompts, then repeat caches and the
        # final logits across beams
        x, caches = _prefill(params, sp["eps"], sp["heads"], self.ids,
                             sp["total"])
        self._reset_caches(caches, self.w)
        self.logits.copy_(_last_logits(params, sp["eps"], x,
                                       None).repeat_interleave(self.w, 0))
        self.scores.copy_(self.scores0)
        self.done.zero_()
        self.pos.fill_(sp["prompt"])
        self.t.zero_()
        self._expand()

    def _beam_step(self):
        # reorder beam rows (KV caches) by parent, in place
        gidx = (self.beam_base + self.cur_parents).reshape(-1)
        for kc, vc in self.caches:
            kc.copy_(kc.index_select(0, gidx))
            vc.copy_(vc.index_select(0, gidx))
        self._next_hidden(self.cur_toks.reshape(-1))
        self._expand()

    def _beam_finish(self):
        from ..ops.extras import gather_tree
        seqs = gather_tree(self.toks, self.parents)           # [T, B, W]
        best = torch.argmax(self.scores, dim=1)               # [B]
        bi = torch.arange(self.b, device=self.device)
        self.out.copy_(torch.cat([self.ids, seqs[:, bi, best].T], dim=1))
        self.best_scores.copy_(self.scores[bi, best])


class GenerateState:
    """One model's generate programs: the program cache (its key holds
    num_beams, so one cache serves what the JAX package's two lru_caches
    do), the weights each dtype's programs read, the graphs' shared
    memory pool, the RecompileSentinel("generate") and the counts.
    ``captures`` counts programs built (CUDA-graph captured on the
    card); the sentinel holds it to the number of distinct signatures
    seen, so a second call with a seen signature that built anything
    fires it.

    The graphs share one pool: a body's allocations all die inside it
    (its results go to the program's static buffers, allocated outside
    the capture), and a model's replays run one after another on the
    current stream, so a graph may reuse what another freed."""

    def __init__(self):
        from ..observability.sentinel import RecompileSentinel
        self.runs = ProgramLRU()
        self.pool = None
        self.weights = {}
        self.sentinel = RecompileSentinel("generate")
        self.seen = set()
        self.captures = 0
        self.last = None          # the program of the last call

    @property
    def programs(self) -> int:
        return len(self.runs)

    def release(self):
        self.runs.clear()
        self.pool = None
        self.weights.clear()
        self.last = None


_states: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def generate_programs(model) -> GenerateState:
    """The model's GenerateState (made on first use; it dies with the
    model)."""
    st = _states.get(model)
    if st is None:
        st = _states[model] = GenerateState()
    return st


def _signature(key, b, prompt):
    """The sentinel's signature of one call: the batch and prompt shape
    and each static field of the program key."""
    return (("input_ids", (b, prompt), "int64"),) + tuple(
        (name, (), repr(val)) for name, val in key)


def _run_program(model, params, spec, ids, pl, seed, graphs):
    st = generate_programs(model)
    dev = ids.device
    b = ids.shape[0]
    dt = spec["dtype"]
    weights = st.weights.get(dt)
    if weights is not None and not weights.refresh(params):
        st.release()      # an uncast weight moved: recapture on it
        weights = None
    if weights is None:
        weights = st.weights[dt] = _Weights(params, convert_dtype(dt))
    key = tuple(sorted(spec.items(), key=lambda kv: kv[0])) + (("batch", b),)

    def build():
        st.captures += 1
        if graphs and st.pool is None:
            st.pool = torch.cuda.graph_pool_handle()
        return _Program(spec, weights, b, dev, st.pool if graphs else None)

    prog = st.last = st.runs.get(key, build)
    st.seen.add(key)
    st.sentinel.observe(st.captures, expected=len(st.seen),
                        signature=_signature(key, b, ids.shape[1]))
    return prog(ids, pl, seed)


def generate_gpt(model, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k: Optional[int] = None,
                 eos_token_id: Optional[int] = None, pad_token_id=0,
                 num_beams=1, seed=0, dtype=None, prompt_lens=None,
                 top_p: Optional[float] = None,
                 eager: Optional[bool] = None):
    """KV-cache decode for GPTForCausalLM on the model's device.
    temperature=0 -> greedy; num_beams>1 -> beam search
    (temperature/top_k/top_p ignored: beams expand by log-prob).

    prompt_lens [B] int (ragged batching): input_ids is right-padded to
    a common length; row i's true prompt is its first prompt_lens[i]
    ids. Each row masks its padding in prefill, then decode writes K/V at
    its own next position. Generated tokens land in out[:, P:] for every
    row (out[i, prompt_lens[i]:P] keeps the pad filler).

    dtype="bfloat16" casts the float params (and with them the KV cache)
    for the decode; layer norm moments and sampling stay f32. None keeps
    the model's dtype (the exact greedy-equals-full-forward contract).
    seed seeds the torch.Generator the sampling noise is drawn from.

    eager: None (the default) runs the model's program for this call's
    static signature on the card (captured as CUDA graphs once, replayed
    after; see _Program) and the eager step-by-step loop on the CPU;
    True runs the eager loop anywhere (the reference the programs are
    held against); False runs the program's bodies anywhere (on the CPU
    without graphs). Both give the same tokens for the same seed.

    Returns int32 [B, prompt_len + max_new_tokens]; rows that hit
    eos_token_id emit pad_token_id afterwards."""
    cfg = model.gpt.config
    dev = next(model.parameters()).device
    ids = _as_long(input_ids, dev)
    b, prompt = ids.shape
    if top_p is not None and not (0.0 < float(top_p) <= 1.0):
        # top_p <= 0 would mask every token and degenerate to uniform
        # sampling over the whole vocab
        raise ValueError(f"top_p must be in (0, 1]; got {top_p}")
    total = prompt + int(max_new_tokens)
    if total > cfg.max_seq_len:
        raise ValueError(
            f"prompt+max_new_tokens={total} exceeds max_seq_len="
            f"{cfg.max_seq_len}")
    if eager is None:
        eager = dev.type != "cuda"
    raw = _gpt_params(model)
    eps, n_heads = float(cfg.layer_norm_eps), int(cfg.num_heads)
    eos = None if eos_token_id is None else int(eos_token_id)
    dt = None if dtype is None else str(convert_dtype(dtype)).replace(
        "torch.", "")
    spec = dict(eps=eps, heads=n_heads, eos=eos, pad=int(pad_token_id),
                max_new_tokens=int(max_new_tokens), prompt=prompt,
                total=total, dtype=dt, num_beams=max(int(num_beams), 1),
                temperature=0.0, top_k=None, top_p=None, ragged=False)
    with torch.no_grad():
        if num_beams > 1:
            if prompt_lens is not None:
                raise ValueError("prompt_lens is not supported with beam "
                                 "search yet: pad to a common length")
            if not eager:
                out, _ = _run_program(model, raw, spec, ids, None, seed,
                                      dev.type == "cuda")
                return out
            params = _cast_params(raw, convert_dtype(dtype))
            out, _ = _beam_search(params, eps, n_heads, ids,
                                  int(num_beams), int(max_new_tokens),
                                  total, eos, int(pad_token_id))
            return out.to(torch.int32)
        pl = None
        if prompt_lens is not None:
            pl_host = np.asarray(prompt_lens.cpu() if isinstance(
                prompt_lens, torch.Tensor) else prompt_lens)
            # checked on the host: an out-of-range length would attend
            # junk cache slots (or index out of bounds on the card)
            if pl_host.shape != (b,):
                raise ValueError(
                    f"prompt_lens shape {pl_host.shape} != ({b},)")
            if pl_host.min() < 1 or pl_host.max() > prompt:
                raise ValueError(
                    f"prompt_lens must be in [1, {prompt}] (padded prompt "
                    f"width); got min={pl_host.min()} max={pl_host.max()}")
            pl = _as_long(pl_host, dev)
        temperature = float(temperature)
        top_k = None if top_k is None else int(top_k)
        top_p = None if top_p is None else float(top_p)
        if not eager:
            spec.update(temperature=temperature, top_k=top_k, top_p=top_p,
                        ragged=pl is not None)
            return _run_program(model, raw, spec, ids, pl, seed,
                                dev.type == "cuda")
        gen = None
        if temperature != 0.0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        out = _greedy_or_sample(
            _cast_params(raw, convert_dtype(dtype)), eps, n_heads, ids,
            int(max_new_tokens), total, temperature, top_k, top_p, eos,
            int(pad_token_id), gen, prompt_lens=pl)
    return out.to(torch.int32)

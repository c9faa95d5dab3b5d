"""Autoregressive generation with a KV cache (counterpart of
paddle_tpu/models/generation.py).

Prefill computes the prompt's per-layer K/V into a cache sized to
prompt + max_new_tokens, then each decode step writes one token's K/V in
place and attends over the valid prefix with a position mask. The JAX
package compiles the whole loop as one program (a lax.scan); here it
runs eagerly on the model's device, one step at a time. It is the
reference the serving engine is held against; capturing the dense decode
as a CUDA graph is ROADMAP.md queue A item 10e.

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
from typing import Optional

import numpy as np
import torch

from ..core.dtypes import convert_dtype
from ..quant.int8_serving import int8_matmul

__all__ = ["generate_gpt"]

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


def _step_hidden(params, eps, n_heads, x, caches, pos):
    """One token's hidden state through all blocks, writing its K/V
    into the caches in place.

    x: [B, 1, H]; caches: list of (k [B,N,T,hd], v [B,N,T,hd]);
    pos: index where this token's K/V land, an int (uniform prompts) or
    [B] (ragged prompts: each row writes at its own next position and
    attends over its own valid prefix)."""
    hd = x.shape[-1] // n_heads
    scale = 1.0 / math.sqrt(hd)
    ragged = isinstance(pos, torch.Tensor) and pos.dim() > 0
    b = x.shape[0]
    bi = torch.arange(b, device=x.device)
    for bp, (kc, vc) in zip(params["blocks"], caches):
        xn = _ln(x, bp["ln1_w"], bp["ln1_b"], eps)
        qkv = (_mm(xn, bp, "qkv") + bp["qkv_b"]).reshape(
            b, 1, 3, n_heads, hd)
        q, k, v = _heads(qkv)
        if ragged:
            # per-row scatter: row i writes its K/V at pos[i]
            kc[bi, :, pos] = k[:, :, 0]
            vc[bi, :, pos] = v[:, :, 0]
        else:
            kc[:, :, pos] = k[:, :, 0]
            vc[:, :, pos] = v[:, :, 0]
        ctx = _attend(q, kc, vc, pos + 1, scale)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, 1, -1)
        x = x + _mm(ctx, bp, "proj") + bp["proj_b"]
        ff = _ln(x, bp["ln2_w"], bp["ln2_b"], eps)
        ff = torch.nn.functional.gelu(_mm(ff, bp, "fc1") + bp["fc1_b"])
        x = x + _mm(ff, bp, "fc2") + bp["fc2_b"]
    return x, caches


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


def generate_gpt(model, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k: Optional[int] = None,
                 eos_token_id: Optional[int] = None, pad_token_id=0,
                 num_beams=1, seed=0, dtype=None, prompt_lens=None,
                 top_p: Optional[float] = None):
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
    params = _cast_params(_gpt_params(model), convert_dtype(dtype))
    eps, n_heads = float(cfg.layer_norm_eps), int(cfg.num_heads)
    eos = None if eos_token_id is None else int(eos_token_id)
    with torch.no_grad():
        if num_beams > 1:
            if prompt_lens is not None:
                raise ValueError("prompt_lens is not supported with beam "
                                 "search yet: pad to a common length")
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
        gen = None
        if float(temperature) != 0.0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        out = _greedy_or_sample(
            params, eps, n_heads, ids, int(max_new_tokens), total,
            float(temperature), None if top_k is None else int(top_k),
            None if top_p is None else float(top_p), eos,
            int(pad_token_id), gen, prompt_lens=pl)
    return out.to(torch.int32)

"""GPT-class decoder LM (counterpart of paddle_tpu/models/gpt.py).

GPTForCausalLM: token + position embeddings, a stack of pre-LN blocks
whose causal self-attention runs the flash-attention kernels
(F.flash_attention(..., causal=True); on the card csrc/flash_attn_fwd.cu
once per block, and in training the dQ and dK/dV kernels of
csrc/flash_attn_bwd.cu, with the in-kernel Philox attention dropout),
the final layer norm, and the head tied to the token embeddings
(logits = h @ wte^T through F.linear, so AMP casts it).
use_flash_attention=False takes the SDPA composition.

scan_layers=True keeps the blocks as one nn.ScannedStack (stacked
[L, ...] parameters under the JAX model's `gpt.blocks.stk__...` names);
chunked_ce=True makes forward return the hidden states and moves the
tied head into chunked_lm_loss (F.linear_cross_entropy: the
[b*s, vocab] logits never exist). Parameter names and shapes equal the
JAX model's in every form, so its state_dict loads by name
(models/convert.py). generate() is the KV-cache decode of
models/generation.py.
"""
from __future__ import annotations

import torch

from .. import nn
from ..nn import functional as F

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, dropout=0.1,
                 layer_norm_eps=1e-5, use_flash_attention=True,
                 scan_layers=False, chunked_ce=False,
                 ce_vocab_block=2048):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.use_flash_attention = use_flash_attention
        # chunked_ce: training only: forward returns the HIDDEN states
        # and chunked_lm_loss streams the tied head through vocab blocks
        # of ce_vocab_block columns. generate() reads the weights
        # directly and is unaffected
        self.chunked_ce = chunked_ce
        self.ce_vocab_block = ce_vocab_block
        # the blocks as one nn.ScannedStack of [L, ...] parameters
        self.scan_layers = bool(scan_layers)

    @classmethod
    def tiny(cls, **kw):
        return cls(vocab_size=512, hidden_size=64, num_layers=2,
                   num_heads=4, max_seq_len=128, **kw)


class GPTBlock(nn.Layer):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__(device=device)
        h = config.hidden_size
        dev = self._device
        eps = config.layer_norm_eps
        self.ln1 = nn.LayerNorm(h, epsilon=eps, device=dev)
        self.ln2 = nn.LayerNorm(h, epsilon=eps, device=dev)
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv = nn.Linear(h, 3 * h, device=dev)
        self.proj = nn.Linear(h, h, device=dev)
        self.fc1 = nn.Linear(h, 4 * h, device=dev)
        self.fc2 = nn.Linear(4 * h, h, device=dev)
        self.dropout = nn.Dropout(config.dropout, device=dev)
        self.use_flash = config.use_flash_attention

    def forward(self, x):
        b, s, h = x.shape
        xn = self.ln1(x)
        qkv = self.qkv(xn).reshape(b, s, 3, self.num_heads, self.head_dim)
        # strided views: the kernel reads them in place
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        p = self.dropout.p
        if self.use_flash:
            ctx = F.flash_attention(q, k, v, causal=True, dropout=p,
                                    training=self.training)
        else:
            ctx = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=p,
                training=self.training)
        x = x + self.dropout(self.proj(ctx.reshape(b, s, h)))
        x = x + self.dropout(self.fc2(F.gelu(self.fc1(self.ln2(x)))))
        return x


class GPTModel(nn.Layer):
    def __init__(self, config: GPTConfig = None, device=None, **kwargs):
        super().__init__(device=device)
        self.config = cfg = config or GPTConfig(**kwargs)
        dev = self._device
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=dev)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size,
                                device=dev)
        self.drop = nn.Dropout(cfg.dropout, device=dev)
        blocks = [GPTBlock(cfg, device=dev) for _ in range(cfg.num_layers)]
        self.blocks = (nn.ScannedStack(blocks, op_name="gpt_scanned_blocks")
                       if cfg.scan_layers else nn.LayerList(blocks))
        self.ln_f = nn.LayerNorm(cfg.hidden_size,
                                 epsilon=cfg.layer_norm_eps, device=dev)

    def forward(self, input_ids):
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device).unsqueeze(0)
        x = self.drop(self.wte(input_ids) + self.wpe(pos.expand(b, s)))
        if self.config.scan_layers:
            x = self.blocks(x)
        else:
            for blk in self.blocks:
                x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Layer):
    def __init__(self, config: GPTConfig = None, device=None, **kwargs):
        super().__init__(device=device)
        self.gpt = GPTModel(config, device=self._device, **kwargs)
        self.config = self.gpt.config

    def forward(self, input_ids):
        h = self.gpt(input_ids)
        if self.config.chunked_ce:
            return h   # the head moves into chunked_lm_loss
        # 2D head matmul against the tied embeddings: [b*s, vocab] logits
        b, s = h.shape[0], h.shape[1]
        h2 = h.reshape(-1, h.shape[-1])
        return F.linear(h2, self.gpt.wte.weight.t()).reshape(b, s, -1)

    @staticmethod
    def lm_loss(logits, labels):
        return F.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            labels[:, 1:].reshape(-1))

    def chunked_lm_loss(self, hidden, labels):
        """Loss for chunked_ce=True models: `hidden` is forward()'s
        output; the tied head + CE stream through vocab blocks, so the
        [b*s, vocab] logits never exist. Bind as the TrainStep loss_fn:
        TrainStep(model, model.chunked_lm_loss, ...)."""
        cfg = self.config
        h2 = hidden[:, :-1].reshape(-1, hidden.shape[-1])
        return F.linear_cross_entropy(
            h2, self.gpt.wte.weight.t(), None, labels[:, 1:].reshape(-1),
            vocab_block=min(cfg.ce_vocab_block, cfg.vocab_size))

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=None, eos_token_id=None, pad_token_id=0,
                 num_beams=1, seed=0, dtype=None, prompt_lens=None,
                 top_p=None, eager=None):
        """KV-cache autoregressive decode (models/generation.py) on the
        model's device: temperature=0 is greedy, num_beams>1 beam search,
        dtype="bfloat16" serves in bf16 (layer norm moments and sampling
        stay f32), prompt_lens [B] batches ragged right-padded prompts.
        On the card each static signature is one program of CUDA graphs,
        captured on first use; eager=True runs the step-by-step loop."""
        from .generation import generate_gpt
        return generate_gpt(self, input_ids, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            eos_token_id=eos_token_id,
                            pad_token_id=pad_token_id,
                            num_beams=num_beams, seed=seed, dtype=dtype,
                            prompt_lens=prompt_lens, top_p=top_p,
                            eager=eager)

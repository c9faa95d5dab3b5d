"""GPT-class decoder LM (counterpart of paddle_tpu/models/gpt.py).

GPTForCausalLM: token + position embeddings, a dense unscanned stack of
pre-LN blocks whose causal self-attention runs the flash-attention
forward kernel (F.flash_attention(..., causal=True); on the card
csrc/flash_attn_fwd.cu, once per block), the final layer norm, and the
head tied to the token embeddings (logits = h @ wte^T through F.linear,
so AMP casts it). use_flash_attention=False takes the SDPA composition.
Parameter names and shapes equal the JAX model's (gpt.wte.weight,
gpt.blocks.{i}.qkv.weight, ...), so its state_dict loads by name
(models/convert.py). generate() is the KV-cache decode of
models/generation.py.

Not ported yet, and rejected with NotImplementedError naming the ROADMAP
item that brings them: scan_layers and the vocab-chunked CE head
(chunked_ce, chunked_lm_loss), both training work (ROADMAP.md queue A
item 10f, GPT training through the three kernels).
"""
from __future__ import annotations

import torch

from .. import nn
from ..nn import functional as F

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM"]

_LATER = ("ROADMAP.md queue A item 10f (GPT training through the "
          "three kernels)")


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, dropout=0.1,
                 layer_norm_eps=1e-5, use_flash_attention=True,
                 scan_layers=False, chunked_ce=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.use_flash_attention = use_flash_attention
        self.chunked_ce = chunked_ce
        self.scan_layers = bool(scan_layers)

    @classmethod
    def tiny(cls, **kw):
        return cls(vocab_size=512, hidden_size=64, num_layers=2,
                   num_heads=4, max_seq_len=128, **kw)


def _check_supported(config: GPTConfig):
    for flag in ("scan_layers", "chunked_ce"):
        if getattr(config, flag):
            raise NotImplementedError(
                f"GPTConfig({flag}=True) is not ported yet: it comes with "
                f"{_LATER}; this slice runs the dense unscanned stack")


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
        _check_supported(cfg)
        dev = self._device
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=dev)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size,
                                device=dev)
        self.drop = nn.Dropout(cfg.dropout, device=dev)
        self.blocks = nn.LayerList([GPTBlock(cfg, device=dev)
                                    for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size,
                                 epsilon=cfg.layer_norm_eps, device=dev)

    def forward(self, input_ids):
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device).unsqueeze(0)
        x = self.drop(self.wte(input_ids) + self.wpe(pos.expand(b, s)))
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
        raise NotImplementedError(
            f"chunked_lm_loss is not ported yet: it comes with {_LATER} "
            "(with F.linear_cross_entropy)")

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=None, eos_token_id=None, pad_token_id=0,
                 num_beams=1, seed=0, dtype=None, prompt_lens=None,
                 top_p=None):
        """KV-cache autoregressive decode (models/generation.py), run
        eagerly on the model's device: temperature=0 is greedy,
        num_beams>1 beam search, dtype="bfloat16" serves in bf16
        (layer norm moments and sampling stay f32), prompt_lens [B]
        batches ragged right-padded prompts."""
        from .generation import generate_gpt
        return generate_gpt(self, input_ids, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            eos_token_id=eos_token_id,
                            pad_token_id=pad_token_id,
                            num_beams=num_beams, seed=seed, dtype=dtype,
                            prompt_lens=prompt_lens, top_p=top_p)

"""ERNIE/BERT-class encoder for inference and pretraining (counterpart
of paddle_tpu/models/ernie.py).

ErnieForPretraining: embeddings, an encoder whose self-attention runs
the flash-attention kernels (forward and backward, with the in-kernel
Philox attention dropout in training), the pooler, and the MLM head with
the decoder tied to the word embeddings (logits = h @ E^T + mlm_bias,
through F.linear so AMP casts it), plus the static pretraining_loss.
Hidden dropout goes through F.dropout.

scan_layers=True makes the encoder one ErnieScannedEncoder (stacked
[L, ...] parameters under the JAX model's `ernie.encoder.stk__...`
names); chunked_ce=True makes forward return the transformed hidden
states in place of the logits, and chunked_pretraining_loss streams the
tied decoder + CE through vocab blocks (F.linear_cross_entropy).
Parameter names and shapes equal the JAX model's in every form, so its
state_dict loads by name (models/convert.py).

Not ported yet, and rejected with NotImplementedError naming the slice
that brings them: MoE layers and sequence parallelism (the distributed
slice).
"""
from __future__ import annotations

import torch

from .. import nn
from ..nn import functional as F
from ..nn.initializer import Normal

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieSelfAttention",
           "ErnieLayer", "ErnieScannedEncoder", "ErnieModel",
           "ErnieForPretraining"]


class ErnieConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 use_flash_attention=True, moe_num_experts=0,
                 moe_top_k=2, moe_every_n_layers=2,
                 moe_capacity_factor=1.25, moe_aux_weight=0.01,
                 sequence_parallel=False, scan_layers=False,
                 chunked_ce=False, ce_vocab_block=2048):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.use_flash_attention = use_flash_attention
        self.chunked_ce = chunked_ce
        self.ce_vocab_block = ce_vocab_block
        self.moe_num_experts = moe_num_experts
        self.moe_top_k = moe_top_k
        self.moe_every_n_layers = moe_every_n_layers
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_aux_weight = moe_aux_weight
        if sequence_parallel not in (False, True, "ring", "ulysses"):
            raise ValueError(
                f"sequence_parallel must be False/True/'ring'/'ulysses',"
                f" got {sequence_parallel!r}")
        self.sequence_parallel = sequence_parallel
        self.scan_layers = bool(scan_layers)

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        """For tests/dryruns."""
        return cls(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=64, **kw)


def _check_supported(config: ErnieConfig):
    later = [(config.moe_num_experts > 0, "moe_num_experts > 0",
              "the distributed slice"),
             (bool(config.sequence_parallel), "sequence_parallel",
              "the distributed slice")]
    for bad, flag, where in later:
        if bad:
            raise NotImplementedError(
                f"ErnieConfig({flag}) is not ported yet: it comes with "
                f"{where}; this slice runs the dense encoder")


def _init_linear(layer, std):
    with torch.no_grad():
        layer.weight.copy_(Normal(0, std)(tuple(layer.weight.shape),
                                          layer.weight.dtype, layer._device))
    return layer


def _lens_to_additive_mask(kv_lens, s):
    """[b] right-padding lengths -> additive [b, 1, 1, s] mask (the SDPA
    form; the flash path consumes kv_lens directly)."""
    pos = torch.arange(s, device=kv_lens.device)
    am = pos[None, :] < kv_lens[:, None]
    return (1.0 - am[:, None, None, :].float()) * -1e9


class ErnieSelfAttention(nn.Layer):
    def __init__(self, config: ErnieConfig, device=None):
        super().__init__(device=device)
        h = config.hidden_size
        dev = self._device
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.use_flash = config.use_flash_attention
        self.dropout_p = config.attention_probs_dropout_prob
        std = config.initializer_range
        self.qkv = _init_linear(nn.Linear(h, 3 * h, device=dev), std)
        self.out = _init_linear(nn.Linear(h, h, device=dev), std)

    def forward(self, x, attn_mask=None, kv_lens=None):
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        # strided views: the kernel reads them in place
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if attn_mask is None and self.use_flash:
            ctx = F.flash_attention(q, k, v, dropout=self.dropout_p,
                                    training=self.training,
                                    kv_lens=kv_lens)
        else:
            if kv_lens is not None and attn_mask is None:
                attn_mask = _lens_to_additive_mask(kv_lens, s)
            ctx = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout_p,
                training=self.training)
        return self.out(ctx.reshape(b, s, h))


class ErnieLayer(nn.Layer):
    def __init__(self, config: ErnieConfig, device=None):
        super().__init__(device=device)
        h = config.hidden_size
        dev = self._device
        std = config.initializer_range
        self.attention = ErnieSelfAttention(config, device=dev)
        self.attn_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                      device=dev)
        self.ffn_in = _init_linear(
            nn.Linear(h, config.intermediate_size, device=dev), std)
        self.ffn_out = _init_linear(
            nn.Linear(config.intermediate_size, h, device=dev), std)
        self.ffn_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                     device=dev)
        self.dropout = nn.Dropout(config.hidden_dropout_prob, device=dev)
        self.act = config.hidden_act

    def forward(self, x, attn_mask=None, kv_lens=None):
        attn = self.attention(x, attn_mask, kv_lens=kv_lens)
        x = self.attn_norm(x + self.dropout(attn))
        ffn = self.ffn_out(getattr(F, self.act)(self.ffn_in(x)))
        return self.ffn_norm(x + self.dropout(ffn))


class ErnieScannedEncoder(nn.ScannedStack):
    """All encoder blocks as one nn.ScannedStack:
    ``encoder.0.attention.qkv.weight [h, 3h]`` x L becomes
    ``encoder.stk__attention__qkv__weight [L, h, 3h]``.
    ``load_from_layers`` imports unrolled weights; the additive
    attention mask rides as the blocks' side input."""

    def __init__(self, config: ErnieConfig, device=None):
        super().__init__([ErnieLayer(config, device=device)
                          for _ in range(config.num_hidden_layers)],
                         op_name="ernie_scanned_encoder")


class ErnieEmbeddings(nn.Layer):
    def __init__(self, config: ErnieConfig, device=None):
        super().__init__(device=device)
        dev = self._device
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size, device=dev)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size, device=dev)
        self.token_type_embeddings = nn.Embedding(
            config.type_vocab_size, config.hidden_size, device=dev)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_eps,
                                       device=dev)
        self.dropout = nn.Dropout(config.hidden_dropout_prob, device=dev)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, device=input_ids.device).unsqueeze(0).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class ErnieModel(nn.Layer):
    def __init__(self, config: ErnieConfig = None, device=None, **kwargs):
        super().__init__(device=device)
        self.config = config or ErnieConfig(**kwargs)
        _check_supported(self.config)
        dev = self._device
        self.embeddings = ErnieEmbeddings(self.config, device=dev)
        if self.config.scan_layers:
            self.encoder = ErnieScannedEncoder(self.config, device=dev)
        else:
            self.encoder = nn.LayerList(
                [ErnieLayer(self.config, device=dev)
                 for _ in range(self.config.num_hidden_layers)])
        self.pooler = nn.Linear(self.config.hidden_size,
                                self.config.hidden_size, device=dev)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, seq_lens=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None and seq_lens is not None:
            raise ValueError("pass attention_mask OR seq_lens, not both")
        if attention_mask is not None:
            # [b, s] 1/0 mask -> additive [b, 1, 1, s]: general key
            # masking, so it takes SDPA; right-padded batches should pass
            # seq_lens, which keeps the blockwise flash form
            am = attention_mask[:, None, None, :].float()
            attention_mask = (1.0 - am) * -1e9
        if seq_lens is not None and not self.config.use_flash_attention:
            attention_mask = _lens_to_additive_mask(seq_lens, x.shape[1])
            seq_lens = None
        if self.config.scan_layers:
            if seq_lens is not None:
                raise ValueError(
                    "scan_layers encoder takes attention_mask, not "
                    "seq_lens (the scanned stack carries the additive "
                    "mask form)")
            x = self.encoder(x, attention_mask)
        else:
            for layer in self.encoder:
                x = layer(x, attention_mask, kv_lens=seq_lens)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class ErnieForPretraining(nn.Layer):
    """MLM + NSP heads. forward returns (mlm logits [b, s, vocab],
    nsp logits [b, 2]); with chunked_ce, (the transformed hidden states
    [b, s, hidden], nsp logits), for chunked_pretraining_loss."""

    def __init__(self, config: ErnieConfig = None, device=None, **kwargs):
        super().__init__(device=device)
        dev = self._device
        self.ernie = ErnieModel(config, device=dev, **kwargs)
        cfg = self.ernie.config
        self.config = cfg
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                       device=dev)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_size,
                                     epsilon=cfg.layer_norm_eps, device=dev)
        self.mlm_bias = self.create_parameter((cfg.vocab_size,),
                                              is_bias=True)
        self.nsp = nn.Linear(cfg.hidden_size, 2, device=dev)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, seq_lens=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask, seq_lens=seq_lens)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        if self.config.chunked_ce:
            # the decoder matmul moves into chunked_pretraining_loss
            return h, self.nsp(pooled)
        # weight-tied decoder in 2D: logits = h @ E^T + mlm_bias, through
        # F.linear (an AMP white-list op, as in the JAX package)
        b, s = h.shape[0], h.shape[1]
        w = self.ernie.embeddings.word_embeddings.weight
        lg = F.linear(h.reshape(-1, h.shape[-1]), w.t())
        # bias in the LOGITS dtype: under O1 the f32 bias would promote
        # the whole [b*s, vocab] tensor to f32
        bias = self.mlm_bias if self.mlm_bias.dtype == lg.dtype \
            else self.mlm_bias.to(lg.dtype)
        return (lg + bias).reshape(b, s, -1), self.nsp(pooled)

    @staticmethod
    def pretraining_loss(outputs, mlm_labels, nsp_labels=None,
                         ignore_index=-100):
        """MLM cross-entropy over [b*s, vocab] (mean over the labels that
        are not ignore_index), plus NSP's when nsp_labels are given."""
        logits, nsp_logits = outputs
        mlm = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              mlm_labels.reshape(-1),
                              ignore_index=ignore_index)
        if nsp_labels is None:
            return mlm
        return mlm + F.cross_entropy(nsp_logits, nsp_labels.reshape(-1))

    def chunked_pretraining_loss(self, outputs, mlm_labels,
                                 nsp_labels=None, ignore_index=-100):
        """Loss for chunked_ce=True models: outputs carry the HIDDEN
        states (forward skipped the decoder); the tied decoder + CE
        stream through vocab blocks (F.linear_cross_entropy), so no
        [b*s, vocab] logits ever exist. Bind as the TrainStep loss_fn:
        TrainStep(model, model.chunked_pretraining_loss, ...)."""
        h, nsp_logits = outputs
        w_t = self.ernie.embeddings.word_embeddings.weight.t()
        mlm = F.linear_cross_entropy(
            h.reshape(-1, h.shape[-1]), w_t, self.mlm_bias,
            mlm_labels.reshape(-1),
            vocab_block=min(self.config.ce_vocab_block,
                            self.config.vocab_size),
            ignore_index=ignore_index)
        if nsp_labels is None:
            return mlm
        return mlm + F.cross_entropy(nsp_logits, nsp_labels.reshape(-1))

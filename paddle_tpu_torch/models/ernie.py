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

The distributed forms, as the JAX model declares them:
- moe_num_experts > 0: every moe_every_n_layers-th block's FFN is a
  top-k expert mixture (distributed/moe.py MoELayer, activation
  hidden_act, which is jax.nn's tanh GELU there); moe_aux_loss() sums
  the last forward's load-balancing losses;
- sequence_parallel True/"ring"/"ulysses": attention runs sequence-
  parallel over the global mesh's 'sp' axis (distributed/ring.py
  sequence_parallel_attention), with attention dropout 0;
- tensor parallelism: qkv and ffn_in are column-, out and ffn_out
  row-annotated over 'tp', the word embeddings and mlm_bias split on the
  vocab dim (sharding.annotate). Made on a mesh whose tp axis spans
  several ranks, each layer keeps its block and runs the Megatron form:
  f before qkv, ffn_in and the decoder, g after out and ffn_out, the
  vocab-parallel lookup; qkv's column block is all-gathered and each
  rank attends with its n/tp heads; the decoder's logits are
  all-gathered over the vocab.
The pipeline stages (ErnieStageFirst/Middle/Last, ernie_pipeline_stages)
split ErnieForPretraining into heterogeneous stages for
distributed/pipeline_engine.py's PipelineParallel: the embeddings on
the first, the pooler and the MLM/NSP heads (an untied decoder) on the
last, the blocks spread evenly; each stage's pipeline_local_loss() is
its MoE blocks' weighted aux loss.
"""
from __future__ import annotations

import torch

from .. import nn
from ..distributed.env import TENSOR_AXIS
from ..distributed.parallel_layers import (copy_to_group, gather_from_group,
                                           group_rank, group_size,
                                           reduce_from_group, tp_group,
                                           vocab_parallel_lookup)
from ..distributed.sharding import PartitionSpec as P
from ..distributed.sharding import annotate
from ..nn import functional as F
from ..nn.initializer import Normal
from ..observability.anatomy import scope as _scope

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieSelfAttention",
           "ErnieLayer", "ErnieScannedEncoder", "ErnieModel",
           "ErnieForPretraining", "ErnieStageFirst", "ErnieStageMiddle",
           "ErnieStageLast", "ernie_pipeline_stages"]


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
        if moe_num_experts > 0 and moe_every_n_layers < 1:
            raise ValueError(
                "moe_every_n_layers must be >= 1 when experts are "
                "enabled (set moe_num_experts=0 for a dense model)")
        if sequence_parallel not in (False, True, "ring", "ulysses"):
            raise ValueError(
                f"sequence_parallel must be False/True/'ring'/'ulysses',"
                f" got {sequence_parallel!r}")
        self.sequence_parallel = sequence_parallel
        if sequence_parallel and attention_probs_dropout_prob > 0:
            raise ValueError(
                "sequence_parallel requires "
                "attention_probs_dropout_prob=0 (ring attention carries "
                "no dropout)")
        self.scan_layers = bool(scan_layers)
        if self.scan_layers and moe_num_experts > 0:
            raise ValueError(
                "scan_layers needs homogeneous blocks; interleaved MoE "
                "layers differ from dense ones (set moe_num_experts=0 "
                "or scan_layers=False)")

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        return cls(hidden_size=1024, num_hidden_layers=24,
                   num_attention_heads=16, intermediate_size=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        """For tests/dryruns."""
        return cls(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=64, **kw)


def _init_linear(layer, std, w_spec=None, b_spec=None):
    """Normal(0, std) weights, then the tp annotations (each rank keeps
    its block on a mesh whose tp axis spans several ranks)."""
    with torch.no_grad():
        layer.weight.copy_(Normal(0, std)(tuple(layer.weight.shape),
                                          layer.weight.dtype, layer._device))
    if w_spec is not None:
        annotate(layer.weight, w_spec)
    if b_spec is not None and layer.bias is not None:
        annotate(layer.bias, b_spec)
    return layer


def _is_moe_layer(config: ErnieConfig, i: int) -> bool:
    """MoE placement rule: every n-th block (1-indexed), when the config
    enables experts."""
    return (config.moe_num_experts > 0
            and (i + 1) % config.moe_every_n_layers == 0)


def _row_parallel(x_local, layer, pg):
    """x_local @ W_local summed over tp (g), then the bias: the row-
    parallel linear of a layer whose weight holds rows of this rank."""
    out = reduce_from_group(F.linear(x_local, layer.weight), pg)
    return out + layer.bias if layer.bias is not None else out


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
        self.seq_parallel = config.sequence_parallel
        std = config.initializer_range
        self.qkv = _init_linear(nn.Linear(h, 3 * h, device=dev), std,
                                P(None, TENSOR_AXIS), P(TENSOR_AXIS))
        self.out = _init_linear(nn.Linear(h, h, device=dev), std,
                                P(TENSOR_AXIS, None))

    def forward(self, x, attn_mask=None, kv_lens=None):
        # anatomy scope: the qkv/proj matmuls and the attention math
        # attribute to "attn", their backward too (anatomy.count_flops)
        with _scope("attn"):
            return self._forward(x, attn_mask, kv_lens)

    def _forward(self, x, attn_mask=None, kv_lens=None):
        b, s, h = x.shape
        pg = tp_group(self.qkv.weight)
        if pg is None:
            qkv = self.qkv(x)
        else:
            # column block of qkv, all-gathered: each rank then attends
            # with its own n/tp heads
            qkv = gather_from_group(self.qkv(copy_to_group(x, pg)), -1, pg,
                                    partitioned=True)
        qkv = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
        if pg is not None:
            per = self.num_heads // group_size(pg)
            qkv = qkv.narrow(3, group_rank(pg) * per, per)
        # strided views: the kernel reads them in place
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        ctx = self._attend(q, k, v, attn_mask, kv_lens)
        ctx = ctx.reshape(b, s, -1)
        if pg is None:
            return self.out(ctx)
        return _row_parallel(ctx, self.out, pg)

    def _attend(self, q, k, v, attn_mask, kv_lens):
        s = q.shape[1]
        if self.seq_parallel:
            if attn_mask is not None or kv_lens is not None:
                raise ValueError(
                    "sequence_parallel attention takes no attention_mask"
                    "/kv_lens — pad to full blocks so every position is "
                    "real, or run the dense model")
            from ..distributed.env import get_mesh
            from ..distributed.ring import sequence_parallel_attention
            mesh = get_mesh()
            if mesh is None or "sp" not in mesh:
                raise ValueError(
                    "sequence_parallel attention needs the global mesh to "
                    "carry an 'sp' axis: dist.set_mesh(build_mesh({'dp': "
                    "..., 'sp': ...}))")
            mode = "ulysses" if self.seq_parallel == "ulysses" else "ring"
            return sequence_parallel_attention(q, k, v, mode=mode)
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
        return ctx


class ErnieLayer(nn.Layer):
    def __init__(self, config: ErnieConfig, use_moe: bool = False,
                 device=None):
        super().__init__(device=device)
        h = config.hidden_size
        dev = self._device
        std = config.initializer_range
        self.attention = ErnieSelfAttention(config, device=dev)
        self.attn_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                      device=dev)
        self.use_moe = bool(use_moe and config.moe_num_experts > 0)
        if self.use_moe:
            from ..distributed.moe import MoELayer
            self.moe = MoELayer(
                h, config.intermediate_size, config.moe_num_experts,
                top_k=config.moe_top_k,
                capacity_factor=config.moe_capacity_factor,
                aux_weight=config.moe_aux_weight,
                activation=config.hidden_act, device=dev)
        else:
            self.ffn_in = _init_linear(
                nn.Linear(h, config.intermediate_size, device=dev), std,
                P(None, TENSOR_AXIS), P(TENSOR_AXIS))
            self.ffn_out = _init_linear(
                nn.Linear(config.intermediate_size, h, device=dev), std,
                P(TENSOR_AXIS, None))
        self.ffn_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                     device=dev)
        self.dropout = nn.Dropout(config.hidden_dropout_prob, device=dev)
        self.act = config.hidden_act

    def _ffn(self, x):
        if self.use_moe:
            return self.moe(x)
        pg = tp_group(self.ffn_in.weight)
        if pg is None:
            return self.ffn_out(getattr(F, self.act)(self.ffn_in(x)))
        hid = getattr(F, self.act)(self.ffn_in(copy_to_group(x, pg)))
        return _row_parallel(hid, self.ffn_out, pg)

    def forward(self, x, attn_mask=None, kv_lens=None):
        attn = self.attention(x, attn_mask, kv_lens=kv_lens)
        with _scope("attn"):
            x = self.attn_norm(x + self.dropout(attn))
        with _scope("mlp"):
            return self.ffn_norm(x + self.dropout(self._ffn(x)))


class ErnieScannedEncoder(nn.ScannedStack):
    """All encoder blocks as one nn.ScannedStack:
    ``encoder.0.attention.qkv.weight [h, 3h]`` x L becomes
    ``encoder.stk__attention__qkv__weight [L, h, 3h]``.
    ``load_from_layers`` imports unrolled weights; the additive
    attention mask rides as the blocks' side input."""

    def __init__(self, config: ErnieConfig, num_blocks=None, device=None):
        n = config.num_hidden_layers if num_blocks is None \
            else int(num_blocks)
        super().__init__([ErnieLayer(config, device=device)
                          for _ in range(n)],
                         op_name="ernie_scanned_encoder")


class ErnieEmbeddings(nn.Layer):
    def __init__(self, config: ErnieConfig, device=None):
        super().__init__(device=device)
        dev = self._device
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size, device=dev)
        annotate(self.word_embeddings.weight, P(TENSOR_AXIS, None))
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size, device=dev)
        self.token_type_embeddings = nn.Embedding(
            config.type_vocab_size, config.hidden_size, device=dev)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_eps,
                                       device=dev)
        self.dropout = nn.Dropout(config.hidden_dropout_prob, device=dev)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        with _scope("embed"):
            return self._forward(input_ids, token_type_ids, position_ids)

    def _forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, device=input_ids.device).unsqueeze(0).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (vocab_parallel_lookup(input_ids,
                                     self.word_embeddings.weight)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class ErnieModel(nn.Layer):
    def __init__(self, config: ErnieConfig = None, device=None, **kwargs):
        super().__init__(device=device)
        self.config = config or ErnieConfig(**kwargs)
        dev = self._device
        self.embeddings = ErnieEmbeddings(self.config, device=dev)
        if self.config.scan_layers:
            self.encoder = ErnieScannedEncoder(self.config, device=dev)
        else:
            self.encoder = nn.LayerList(
                [ErnieLayer(self.config,
                            use_moe=_is_moe_layer(self.config, i),
                            device=dev)
                 for i in range(self.config.num_hidden_layers)])
        self.pooler = nn.Linear(self.config.hidden_size,
                                self.config.hidden_size, device=dev)

    def moe_aux_loss(self):
        """Sum of the last forward's expert load-balancing losses (None
        for a dense config)."""
        if isinstance(self.encoder, ErnieScannedEncoder):
            return None  # scan_layers excludes MoE by construction
        total = None
        for lyr in self.encoder:
            if getattr(lyr, "use_moe", False) and \
                    lyr.moe.aux_loss is not None:
                total = lyr.moe.aux_loss if total is None \
                    else total + lyr.moe.aux_loss
        return total

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
        annotate(self.mlm_bias, P(TENSOR_AXIS))
        self.nsp = nn.Linear(cfg.hidden_size, 2, device=dev)

    def moe_aux_loss(self):
        return self.ernie.moe_aux_loss()

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, seq_lens=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask, seq_lens=seq_lens)
        with _scope("mlm_head_ce"):
            return self._head(seq, pooled)

    def _head(self, seq, pooled):
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        if self.config.chunked_ce:
            # the decoder matmul moves into chunked_pretraining_loss
            return h, self.nsp(pooled)
        # weight-tied decoder in 2D: logits = h @ E^T + mlm_bias, through
        # F.linear (an AMP white-list op, as in the JAX package)
        b, s = h.shape[0], h.shape[1]
        w = self.ernie.embeddings.word_embeddings.weight
        pg = tp_group(w)
        lg = F.linear(copy_to_group(h.reshape(-1, h.shape[-1]), pg), w.t())
        # bias in the LOGITS dtype: under O1 the f32 bias would promote
        # the whole [b*s, vocab] tensor to f32
        bias = self.mlm_bias if self.mlm_bias.dtype == lg.dtype \
            else self.mlm_bias.to(lg.dtype)
        # vocab-split over tp: every rank's block of the logits
        lg = gather_from_group(lg + bias, -1, pg)
        return lg.reshape(b, s, -1), self.nsp(pooled)

    @staticmethod
    def pretraining_loss(outputs, mlm_labels, nsp_labels=None,
                         ignore_index=-100):
        """MLM cross-entropy over [b*s, vocab] (mean over the labels that
        are not ignore_index), plus NSP's when nsp_labels are given."""
        logits, nsp_logits = outputs
        with _scope("mlm_head_ce"):
            mlm = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  mlm_labels.reshape(-1),
                                  ignore_index=ignore_index)
            if nsp_labels is None:
                return mlm
            return mlm + F.cross_entropy(nsp_logits,
                                         nsp_labels.reshape(-1))

    def chunked_pretraining_loss(self, outputs, mlm_labels,
                                 nsp_labels=None, ignore_index=-100):
        """Loss for chunked_ce=True models: outputs carry the HIDDEN
        states (forward skipped the decoder); the tied decoder + CE
        stream through vocab blocks (F.linear_cross_entropy), so no
        [b*s, vocab] logits ever exist. Bind as the TrainStep loss_fn:
        TrainStep(model, model.chunked_pretraining_loss, ...)."""
        h, nsp_logits = outputs
        if tp_group(self.ernie.embeddings.word_embeddings.weight) is not None:
            raise ValueError(
                "chunked_ce streams the whole vocab through each rank; "
                "with the word embeddings split over tp, use the dense "
                "pretraining_loss")
        with _scope("mlm_head_ce"):
            w_t = self.ernie.embeddings.word_embeddings.weight.t()
            mlm = F.linear_cross_entropy(
                h.reshape(-1, h.shape[-1]), w_t, self.mlm_bias,
                mlm_labels.reshape(-1),
                vocab_block=min(self.config.ce_vocab_block,
                                self.config.vocab_size),
                ignore_index=ignore_index)
            if nsp_labels is None:
                return mlm
            return mlm + F.cross_entropy(nsp_logits,
                                         nsp_labels.reshape(-1))


# ---------------------------------------------------------------------------
# pipeline-parallel stage decomposition
# ---------------------------------------------------------------------------
# As in the JAX package: the embeddings on the first stage, the heads on
# the last, and the MLM decoder UNTIED from the word embeddings across a
# split (tying would need a tied-grad all-reduce between the first and
# the last stage every step).

def _stage_blocks(config, num_blocks, first_index, device):
    """A stage's run of encoder blocks: an ErnieScannedEncoder when
    config.scan_layers (and the stage has blocks), else a LayerList
    (the MoE placement counts from first_index)."""
    if config.scan_layers and num_blocks > 0:
        return ErnieScannedEncoder(config, num_blocks, device=device)
    return nn.LayerList(
        [ErnieLayer(config, use_moe=_is_moe_layer(config, first_index + j),
                    device=device)
         for j in range(num_blocks)])


def _run_blocks(blocks, x, attention_mask):
    if isinstance(blocks, nn.ScannedStack):
        return blocks(x, attention_mask)
    for b in blocks:
        x = b(x, attention_mask)
    return x


def _stage_moe_aux(blocks):
    """The weighted sum of the blocks' MoE aux losses from the last
    forward (None for dense blocks): the pipeline engine's
    pipeline_local_loss contract."""
    if isinstance(blocks, nn.ScannedStack):
        return None  # scan_layers excludes MoE by construction
    total = None
    for b in blocks:
        if getattr(b, "use_moe", False) and b.moe.aux_loss is not None:
            a = b.moe.aux_weight * b.moe.aux_loss
            total = a if total is None else total + a
    return total


class ErnieStageFirst(nn.Layer):
    """Embeddings + leading encoder blocks -> hidden states.

    With an attention_mask, the additive [b, 1, 1, s] form is built here
    once and passed on to later stages in the activation tuple."""

    def __init__(self, config: ErnieConfig, num_blocks: int,
                 first_index: int = 0, device=None):
        super().__init__(device=device)
        self.embeddings = ErnieEmbeddings(config, device=self._device)
        self.blocks = _stage_blocks(config, num_blocks, first_index,
                                    self._device)

    def forward(self, input_ids, attention_mask=None):
        x = self.embeddings(input_ids)
        if attention_mask is not None:
            am = attention_mask[:, None, None, :].float()
            attention_mask = (1.0 - am) * -1e9
        x = _run_blocks(self.blocks, x, attention_mask)
        if attention_mask is not None:
            return x, attention_mask
        return x

    def pipeline_local_loss(self):
        return _stage_moe_aux(self.blocks)


class ErnieStageMiddle(nn.Layer):
    """A run of encoder blocks (hidden -> hidden)."""

    def __init__(self, config: ErnieConfig, num_blocks: int,
                 first_index: int = 0, device=None):
        super().__init__(device=device)
        self.blocks = _stage_blocks(config, num_blocks, first_index,
                                    self._device)

    def forward(self, x, attention_mask=None):
        x = _run_blocks(self.blocks, x, attention_mask)
        if attention_mask is not None:
            return x, attention_mask
        return x

    def pipeline_local_loss(self):
        return _stage_moe_aux(self.blocks)


class ErnieStageLast(nn.Layer):
    """Trailing blocks + pooler + MLM/NSP heads (hidden -> (mlm logits,
    nsp logits)), the decoder a Linear of its own."""

    def __init__(self, config: ErnieConfig, num_blocks: int,
                 first_index: int = 0, device=None):
        super().__init__(device=device)
        dev = self._device
        h = config.hidden_size
        self.blocks = _stage_blocks(config, num_blocks, first_index, dev)
        self.pooler = nn.Linear(h, h, device=dev)
        self.mlm_transform = nn.Linear(h, h, device=dev)
        self.mlm_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                     device=dev)
        self.decoder = nn.Linear(h, config.vocab_size, device=dev)
        self.nsp = nn.Linear(h, 2, device=dev)

    def forward(self, x, attention_mask=None):
        x = _run_blocks(self.blocks, x, attention_mask)
        with _scope("mlm_head_ce"):
            pooled = F.tanh(self.pooler(x[:, 0]))
            h = self.mlm_norm(F.gelu(self.mlm_transform(x)))
            # the decoder matmul in 2D, as ErnieForPretraining.forward
            b, s = h.shape[0], h.shape[1]
            logits = self.decoder(h.reshape(-1, h.shape[-1])).reshape(
                b, s, -1)
            return logits, self.nsp(pooled)

    def pipeline_local_loss(self):
        return _stage_moe_aux(self.blocks)


class _Solo(nn.Layer):
    """The one-stage split: the embeddings and every block with the
    heads."""

    def __init__(self, config: ErnieConfig, device=None):
        super().__init__(device=device)
        self.first = ErnieStageFirst(config, 0, device=self._device)
        self.last = ErnieStageLast(config, config.num_hidden_layers,
                                   first_index=0, device=self._device)

    def forward(self, input_ids):
        return self.last(self.first(input_ids))

    def pipeline_local_loss(self):
        return self.last.pipeline_local_loss()


def ernie_pipeline_stages(config: ErnieConfig, num_stages: int, device=None):
    """Split an ERNIE pretraining model into heterogeneous stages: the
    blocks spread as evenly as possible (the first stages take one more
    when they do not divide), the embeddings on stage 0, the pooler and
    heads on the last."""
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    L = config.num_hidden_layers
    base, extra = divmod(L, num_stages)
    counts = [base + (1 if i < extra else 0) for i in range(num_stages)]
    if num_stages == 1:
        return [_Solo(config, device=device)]
    stages = [ErnieStageFirst(config, counts[0], device=device)]
    start = counts[0]
    for i in range(1, num_stages - 1):
        stages.append(ErnieStageMiddle(config, counts[i], first_index=start,
                                       device=device))
        start += counts[i]
    stages.append(ErnieStageLast(config, counts[-1], first_index=start,
                                 device=device))
    return stages

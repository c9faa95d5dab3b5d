"""The port's ERNIE inference path against the JAX package's.

ErnieConfig.tiny() (2 layers, hidden 64, 4 heads, vocab 1024) is built
in paddle_tpu with paddle.seed(0), its state_dict is carried into
paddle_tpu_torch with load_jax_params, and both run in eval mode on the
same seeded numpy batch. MLM logits, NSP logits and the pooled output
agree at atol=rtol=1e-4 in float32 (tests/conftest.py sets the JAX
matmul precision to "highest"; the two differ only in summation order).
The port runs on the CPU here, so its attention takes the plain
blockwise version of the CUDA kernel.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.models import ErnieConfig as JaxConfig
from paddle_tpu.models import ErnieForPretraining as JaxErnie
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     load_jax_params)

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxErnie(JaxConfig.tiny())
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig.tiny(), device="cpu").eval()
    load_jax_params(tm, state)
    return jm, tm, state


def _batch(b=2, s=48, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (b, s)).astype(np.int64)
    tt = rng.randint(0, 2, (b, s)).astype(np.int64)
    return ids, tt


def _jax(fn, *arrays):
    return fn(*[paddle.to_tensor(a) for a in arrays])


def _torch(fn, *arrays, **kw):
    with pt.no_grad():
        return fn(*[torch.from_numpy(a) for a in arrays], **kw)


def test_state_dict_names_and_shapes_match_jax(pair):
    jm, tm, state = pair
    assert [(k, tuple(v.shape)) for k, v in jm.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in tm.state_dict().items()]
    assert "mlm_bias" in state
    assert "ernie.encoder.0.attention.qkv.weight" in state
    assert all(v.device.type == "cpu" for v in tm.state_dict().values())


@pytest.mark.parametrize("s", [48, 64])
def test_pretraining_forward_matches_jax(pair, s):
    jm, tm, _ = pair
    ids, tt = _batch(s=s)
    jl, jn = _jax(jm, ids, tt)
    tl, tn = _torch(tm, ids, tt)
    assert tuple(tl.shape) == (2, s, 1024) and tuple(tn.shape) == (2, 2)
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tn.numpy(), jn.numpy(), atol=TOL, rtol=TOL)


def test_pooled_and_sequence_output_match_jax(pair):
    jm, tm, _ = pair
    ids, tt = _batch(seed=1)
    jx, jp = _jax(jm.ernie, ids, tt)
    tx, tp = _torch(tm.ernie, ids, tt)
    np.testing.assert_allclose(tp.numpy(), jp.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tx.numpy(), jx.numpy(), atol=TOL, rtol=TOL)


def test_default_token_types_and_positions(pair):
    jm, tm, _ = pair
    ids, _ = _batch(seed=2)
    jl, jn = _jax(jm, ids)
    tl, tn = _torch(tm, ids)
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tn.numpy(), jn.numpy(), atol=TOL, rtol=TOL)


def test_seq_lens_matches_jax(pair):
    """Right-padded batch: seq_lens rides kv_lens into the blockwise
    flash path in both packages."""
    jm, tm, _ = pair
    ids, tt = _batch(b=3, s=40, seed=3)
    lens = np.array([40, 23, 9], np.int32)
    jl, jn = jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
                seq_lens=paddle.to_tensor(lens))
    tl, tn = _torch(tm, ids, tt, seq_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tn.numpy(), jn.numpy(), atol=TOL, rtol=TOL)


def test_attention_mask_matches_jax(pair):
    """A general 1/0 key mask takes the materialised SDPA path."""
    jm, tm, _ = pair
    ids, tt = _batch(b=2, s=32, seed=4)
    mask = (np.random.RandomState(5).rand(2, 32) > 0.25).astype(np.int64)
    mask[:, 0] = 1
    jl, jn = jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
                attention_mask=paddle.to_tensor(mask))
    tl, tn = _torch(tm, ids, tt, attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tn.numpy(), jn.numpy(), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="OR"):
        _torch(tm, ids, tt, attention_mask=torch.from_numpy(mask),
               seq_lens=torch.tensor([32, 10]))


def test_non_flash_config_matches_jax(pair):
    _, _, state = pair
    paddle.seed(0)
    jm = JaxErnie(JaxConfig.tiny(use_flash_attention=False))
    jm.eval()
    jm.set_state_dict(state)
    tm = ErnieForPretraining(ErnieConfig.tiny(use_flash_attention=False),
                             device="cpu").eval()
    load_jax_params(tm, state)
    ids, tt = _batch(b=2, s=24, seed=6)
    lens = np.array([24, 11], np.int32)
    jl, _ = jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
               seq_lens=paddle.to_tensor(lens))
    tl, _ = _torch(tm, ids, tt, seq_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=TOL, rtol=TOL)


def test_bf16_cast_stays_close_to_f32(pair):
    _, tm, state = pair
    ids, tt = _batch(seed=7)
    ref, _ = _torch(tm, ids, tt)
    bf = ErnieForPretraining(ErnieConfig.tiny(), device="cpu").eval()
    load_jax_params(bf, state)
    bf = bf.to(torch.bfloat16)
    assert bf.ernie.encoder[0].attention.qkv.weight.dtype == torch.bfloat16
    out, nsp = _torch(bf, ids, tt)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    rel = ((out.float() - ref).norm() / ref.norm()).item()
    assert rel < 5e-2


def test_training_mode_attention_dropout_raises(pair, monkeypatch):
    """train() runs attention dropout (the training slice ported it); a
    typo in the PD_ATTN_DROPOUT_IMPL override still raises."""
    _, tm, _ = pair
    ids, tt = _batch(seed=8)
    ev, _ = _torch(tm, ids, tt)
    tm.train()
    try:
        tr, _ = _torch(tm, ids, tt)
        assert torch.isfinite(tr).all() and (tr - ev).abs().max() > 1e-4
        monkeypatch.setenv("PD_ATTN_DROPOUT_IMPL", "kernal")
        with pytest.raises(ValueError, match="PD_ATTN_DROPOUT_IMPL"):
            _torch(tm, ids, tt)
    finally:
        tm.eval()


@pytest.mark.parametrize("flag", [dict(moe_num_experts=4),
                                  dict(sequence_parallel=True),
                                  dict(scan_layers=True, moe_num_experts=4),
                                  dict(chunked_ce=True,
                                       sequence_parallel=True)])
def test_later_slice_flags_raise(flag):
    """MoE and sequence parallelism came with the planner slice (item
    14a): each flag, also beside scan_layers and chunked_ce, is now
    accepted or refused exactly as the JAX package's ErnieConfig does
    (sequence_parallel needs attention dropout 0; scan_layers excludes
    MoE), and nothing raises NotImplementedError."""
    try:
        JaxErnie(JaxConfig.tiny(**flag))
        jax_err = None
    except ValueError as e:
        jax_err = str(e)
    if jax_err is None:
        ErnieForPretraining(ErnieConfig.tiny(**flag), device="cpu")
    else:
        with pytest.raises(ValueError) as e:
            ErnieForPretraining(ErnieConfig.tiny(**flag), device="cpu")
        assert str(e.value) == jax_err


def test_load_jax_params_rejects_mismatch(pair):
    _, _, state = pair
    tm = ErnieForPretraining(ErnieConfig.tiny(), device="cpu")
    short = dict(state)
    short.pop("mlm_bias")
    with pytest.raises(KeyError, match="mlm_bias"):
        load_jax_params(tm, short)
    with pytest.raises(KeyError, match="bogus"):
        load_jax_params(tm, dict(state, bogus=np.zeros(1)))
    bad = dict(state, mlm_bias=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tm, bad)


def test_base_config_is_bench_base():
    cfg = ErnieConfig.base(vocab_size=30528)
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.max_position_embeddings) == \
        (768, 12, 12, 3072, 512)
    assert cfg.hidden_size // cfg.num_attention_heads == 64

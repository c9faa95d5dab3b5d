"""The port's GPT model against the JAX package's.

The JAX fixtures' GPTConfig(vocab 97, hidden 32, 2 layers, 4 heads,
max_seq_len 64) and GPTConfig.tiny() are built in paddle_tpu with a
fixed paddle.seed, their state_dicts carried into paddle_tpu_torch with
load_jax_params, and both run in eval mode on the same seeded numpy ids.
f32 logits agree within 1e-4 x max(1, max|ref|), with the flash route
(use_flash_attention=True: on the CPU the blockwise plain version of the
causal kernel) and the SDPA route, each against the JAX model of the
same route (tests/conftest.py sets the JAX matmul precision to
"highest"; the two differ only in summation order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_jax_params

TOL = 1e-4
SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=64, dropout=0.0)


def _pair(cfg_kw, flash, seed=3):
    paddle.seed(seed)
    jm = JaxGPT(JaxConfig(use_flash_attention=flash, **cfg_kw))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(use_flash_attention=flash, **cfg_kw),
                        device="cpu").eval()
    load_jax_params(tm, state)
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    return {flash: _pair(SMALL, flash) for flash in (False, True)}


def _close(got, ref):
    tol = TOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def _logits(jm, tm, ids):
    ref = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids.astype(np.int64))).numpy()
    return got, ref


def test_state_dict_names_and_shapes_match_jax(pairs):
    jm, tm = pairs[True]
    assert [(k, tuple(v.shape)) for k, v in jm.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in tm.state_dict().items()]
    names = list(tm.state_dict())
    assert names[0] == "gpt.wte.weight"
    assert "gpt.blocks.1.qkv.weight" in names and names[-1] == "gpt.ln_f.bias"


@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
@pytest.mark.parametrize("b,s", [(2, 12), (3, 64)])
def test_forward_matches_jax(pairs, flash, b, s):
    jm, tm = pairs[flash]
    ids = np.random.RandomState(b * 100 + s).randint(0, 97, (b, s))
    got, ref = _logits(jm, tm, ids)
    assert got.shape == (b, s, 97) and got.dtype == np.float32
    _close(got, ref)


def test_flash_and_sdpa_routes_agree(pairs):
    """The two routes of the port on the same weights (the JAX
    TestGPTFlashWiring contract)."""
    _, t_sdpa = pairs[False]
    _, t_flash = pairs[True]
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 97, (2, 12)))
    with torch.no_grad():
        a, b = t_sdpa(ids).numpy(), t_flash(ids).numpy()
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "flash"])
def test_tiny_config_forward_matches_jax(flash):
    kw = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0)
    tiny = GPTConfig.tiny(dropout=0.0)
    assert {k: getattr(tiny, k) for k in kw} == kw
    jm, tm = _pair(kw, flash, seed=5)
    ids = np.random.RandomState(7).randint(0, 512, (2, 40))
    got, ref = _logits(jm, tm, ids)
    _close(got, ref)


def test_lm_loss_matches_jax(pairs):
    jm, tm = pairs[True]
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 97, (2, 16))
    got, ref = _logits(jm, tm, ids)
    ref_loss = float(np.asarray(JaxGPT.lm_loss(
        paddle.to_tensor(ref), paddle.to_tensor(ids.astype(np.int32)))._data))
    loss = GPTForCausalLM.lm_loss(torch.from_numpy(got),
                                  torch.from_numpy(ids)).item()
    assert loss == pytest.approx(ref_loss, rel=1e-5)


def test_eval_ignores_dropout_and_train_applies_it():
    torch.manual_seed(0)
    m = GPTForCausalLM(GPTConfig(**dict(SMALL, dropout=0.5)),
                       device="cpu")
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 97, (2, 8)))
    with torch.no_grad():
        a = m.eval()(ids)
        b = m(ids)
        c = m.train()(ids)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)


@pytest.mark.parametrize("flag", ["scan_layers", "chunked_ce"])
def test_unported_config_flags_raise(flag):
    """The two flags the GPT slice once rejected are ported now: the
    model builds with the JAX model's parameter names and shapes for the
    flag (tests/test_torch_scan_layers.py and
    tests/test_torch_gpt_training.py hold their numbers against JAX)."""
    paddle.seed(0)
    jm = JaxGPT(JaxConfig(**dict(SMALL, **{flag: True})))
    tm = GPTForCausalLM(GPTConfig(**dict(SMALL, **{flag: True})),
                        device="cpu")
    assert [(k, tuple(v.shape)) for k, v in jm.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in tm.state_dict().items()]


def test_chunked_lm_loss_raises(pairs):
    """chunked_lm_loss no longer raises: over the hidden states it equals
    lm_loss over the dense logits of the same weights."""
    _, tm = pairs[True]
    ids = torch.from_numpy(np.random.RandomState(6).randint(0, 97, (2, 12)))
    with torch.no_grad():
        logits = tm(ids)
        hidden = tm.gpt(ids)
        got = tm.chunked_lm_loss(hidden, ids)
    torch.testing.assert_close(got, tm.lm_loss(logits, ids), atol=1e-5,
                               rtol=1e-5)

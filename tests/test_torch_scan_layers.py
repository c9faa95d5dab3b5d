"""The port's scanned stacks (nn.ScannedStack, ERNIE and GPT
scan_layers=True) against the unrolled forms and the JAX package's.

Tiny ERNIE (ErnieConfig.tiny) and tiny GPT (GPTConfig.tiny): the JAX
scanned model is built with a fixed paddle.seed and its state_dict,
under the `stk__...` names, loads into the port's scanned model by name
(load_jax_params). Eval-mode outputs agree within 1e-5 x max(1,
max|ref|) (f32 on both sides; tests/conftest.py sets the JAX matmul
precision to "highest", so the two differ in summation order only). The
port's scanned and unrolled forms on equal weights run the same ops in
the same order: equal bit for bit, generate() included.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ErnieConfig as JErnieConfig
from paddle_tpu.models import ErnieForPretraining as JErnie
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     GPTConfig, GPTForCausalLM,
                                     load_jax_params)

TOL = 1e-5
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())))


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def ernie_pair():
    paddle.seed(1)
    jm = JErnie(JErnieConfig.tiny(scan_layers=True, **NO_DROP))
    jm.eval()
    tm = ErnieForPretraining(ErnieConfig.tiny(scan_layers=True, **NO_DROP),
                             device="cpu").eval()
    load_jax_params(tm, _state(jm))
    return jm, tm


@pytest.fixture(scope="module")
def gpt_pair():
    paddle.seed(2)
    jm = JGPT(JGPTConfig.tiny(scan_layers=True, dropout=0.0))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig.tiny(scan_layers=True, dropout=0.0),
                        device="cpu").eval()
    load_jax_params(tm, _state(jm))
    return jm, tm


def _ids(vocab, b, s, seed):
    return np.random.RandomState(seed).randint(0, vocab, (b, s))


@pytest.mark.parametrize("pair,stack", [
    ("ernie_pair", "ernie.encoder.stk__attention__qkv__weight"),
    ("gpt_pair", "gpt.blocks.stk__qkv__weight")])
def test_scanned_names_and_shapes_match_jax(request, pair, stack):
    jm, tm = request.getfixturevalue(pair)
    assert [(k, tuple(v.shape)) for k, v in jm.state_dict().items()] \
        == [(k, tuple(v.shape)) for k, v in tm.state_dict().items()]
    assert tuple(tm.state_dict()[stack].shape) == (2, 64, 192)


def test_scanned_ernie_forward_matches_jax(ernie_pair):
    jm, tm = ernie_pair
    ids = _ids(1024, 2, 16, 0)
    tt = np.random.RandomState(1).randint(0, 2, (2, 16))
    jl, jn = jm(paddle.to_tensor(ids.astype(np.int32)),
                paddle.to_tensor(tt.astype(np.int32)))
    with torch.no_grad():
        tl, tn = tm(torch.from_numpy(ids), torch.from_numpy(tt))
    _close(tl.numpy(), jl.numpy())
    _close(tn.numpy(), jn.numpy())


def test_scanned_ernie_attention_mask_matches_jax(ernie_pair):
    """An additive attention mask rides into every layer as a side
    input; seq_lens is refused, as in the JAX package."""
    jm, tm = ernie_pair
    ids = _ids(1024, 2, 16, 0)
    mask = np.ones((2, 16), np.int64)
    mask[1, 10:] = 0
    jl, _ = jm(paddle.to_tensor(ids.astype(np.int32)),
               attention_mask=paddle.to_tensor(mask.astype(np.int32)))
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(ids),
                   attention_mask=torch.from_numpy(mask))
    _close(tl.numpy(), jl.numpy())
    with pytest.raises(ValueError, match="seq_lens"):
        tm(torch.from_numpy(ids), seq_lens=torch.tensor([16, 10]))


def test_scanned_gpt_forward_matches_jax(gpt_pair):
    jm, tm = gpt_pair
    ids = _ids(512, 2, 24, 2)
    ref = jm(paddle.to_tensor(ids.astype(np.int32)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    _close(got.numpy(), ref.numpy())


def _twins(kind, drop):
    """An unrolled model and its scanned twin loaded from it through
    load_from_layers (the other parameters copied by name)."""
    pt.seed(3)
    if kind == "gpt":
        cfg = dict(dropout=drop)
        u = GPTForCausalLM(GPTConfig.tiny(**cfg), device="cpu")
        s = GPTForCausalLM(GPTConfig.tiny(scan_layers=True, **cfg),
                           device="cpu")
        s.gpt.blocks.load_from_layers(u.gpt.blocks)
    else:
        cfg = dict(hidden_dropout_prob=drop,
                   attention_probs_dropout_prob=drop)
        u = ErnieForPretraining(ErnieConfig.tiny(**cfg), device="cpu")
        s = ErnieForPretraining(ErnieConfig.tiny(scan_layers=True, **cfg),
                                device="cpu")
        s.ernie.encoder.load_from_layers(u.ernie.encoder)
    own = s.state_dict()
    with torch.no_grad():
        for k, v in u.state_dict().items():
            if k in own:
                own[k].copy_(v)
    return u, s


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["gpt", "ernie"])
def test_scanned_equals_unrolled_bit_for_bit(kind, drop):
    """Forward (training mode, dropout on or off) and the stacked
    gradients equal the unrolled ones: the seeds are drawn in the same
    order."""
    u, s = _twins(kind, drop)
    ids = torch.from_numpy(_ids(512, 2, 16, 4))
    outs = []
    for m in (u, s):
        m.train()
        pt.seed(9)
        out = _first(m(ids))
        out.square().mean().backward()
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    stack = s.gpt.blocks if kind == "gpt" else s.ernie.encoder
    blocks = u.gpt.blocks if kind == "gpt" else u.ernie.encoder
    for name in stack._names:
        g = stack.stacked(name).grad
        for i, blk in enumerate(blocks):
            assert torch.equal(g[i], blk.get_parameter(name).grad), name


def test_scanned_gpt_generate_equals_unrolled():
    u, s = _twins("gpt", 0.0)
    prompt = torch.from_numpy(_ids(512, 2, 6, 5))
    for m in (u, s):
        m.eval()
    for kw in (dict(), dict(temperature=0.8, top_k=20, seed=3)):
        assert torch.equal(u.generate(prompt, max_new_tokens=6, **kw),
                           s.generate(prompt, max_new_tokens=6, **kw))


def test_scanned_gpt_serves_like_unrolled():
    """The ServingEngine reads a scanned model's stacks through
    _gpt_params' per-layer slices: the same streams as the unrolled
    twin's (f32, CPU)."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    u, s = _twins("gpt", 0.0)
    cfg = ServingConfig(max_slots=2, max_admit=2, block_size=4,
                        n_blocks=32, prefill_buckets=(8,),
                        max_total_tokens=24)
    prompts = [np.arange(5) + 3, np.arange(7) + 40]
    outs = [ServingEngine(m.eval(), cfg).generate_tokens(prompts, [6, 4])
            for m in (u, s)]
    assert outs[0] == outs[1]


def test_export_to_layers_roundtrip():
    u, s = _twins("gpt", 0.0)
    with torch.no_grad():
        s.gpt.blocks.stacked("fc1.weight").mul_(2.0)
    s.gpt.blocks.export_to_layers(u.gpt.blocks)
    for i, blk in enumerate(u.gpt.blocks):
        assert torch.equal(blk.fc1.weight,
                           s.gpt.blocks.stacked("fc1.weight")[i])


class _BN(nn.Layer):
    def __init__(self):
        super().__init__(device="cpu")
        self.fc = nn.Linear(4, 4, device="cpu")
        self.register_buffer("running_mean", torch.zeros(4))

    def forward(self, x):
        return self.fc(x) - self.running_mean


def test_buffer_carrying_blocks_are_rejected():
    with pytest.raises(ValueError, match="buffer-free"):
        nn.ScannedStack([_BN(), _BN()])


def test_template_keeps_no_storage_and_the_stack_moves_with_to():
    """The template's own parameters sit on meta (functional_call
    replaces them on every call), so only the stacks hold memory; a dtype
    move of the model moves the stacks and the forward follows them."""
    u, s = _twins("gpt", 0.0)
    tmpl = s.gpt.blocks._template
    assert all(p.is_meta for p in tmpl.parameters())
    assert not any(p.is_meta for p in s.parameters())
    ids = torch.from_numpy(
        np.random.default_rng(5).integers(0, 64, (2, 8)).astype(np.int64))
    s.double()
    u.double()
    assert s.gpt.blocks.stacked("fc1.weight").dtype == torch.float64
    with torch.no_grad():
        assert torch.equal(s(ids), u(ids))

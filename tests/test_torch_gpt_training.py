"""GPT training through the port's TrainStep against the JAX package's,
and the chunked-CE and scanned forms of both models.

Tiny GPT (GPTConfig.tiny, dropout 0) and tiny ERNIE (ErnieConfig.tiny,
dropouts 0): the JAX model is built with a fixed paddle.seed, its
state_dict carried into the port by name (load_jax_params), and both
TrainSteps (AdamW, lr 1e-3, weight decay 0.01, f32) take the same 4
numpy-seeded batches. Losses agree per step within 1e-4 relative and the
final params within 1e-4 (tests/conftest.py sets the JAX matmul
precision to "highest"; the two frameworks sum in another order and 4
AdamW steps amplify it where sqrt(v) ~ eps, as in
tests/test_torch_training.py), except the key third of each qkv
bias, whose gradient is 0 in exact arithmetic (the softmax cancels it):
Adam scales the two frameworks' rounding noise there into steps of up
to the learning rate, so it is held to 2 x 4 steps x lr. ce_vocab_block
96 cuts the tiny vocabs
into padded blocks (512 -> 6 x 96, 1024 -> 11 x 96).

Weight decay: neither package consults AdamW's apply_decay_param_fun,
so the stacked `stk__...` params decay exactly as their unrolled
counterparts do; the scanned trajectory holds that against JAX.

With dropout 0.1 the masks cannot equal the JAX package's (ROADMAP.md
queue C, "Dropout bits"): the port's run is deterministic for a seed,
and its scanned and unrolled forms take bit-equal steps.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ErnieConfig as JErnieConfig
from paddle_tpu.models import ErnieForPretraining as JErnie
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.static import TrainStep as JTrainStep
import paddle_tpu_torch as pt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     GPTConfig, GPTForCausalLM,
                                     load_jax_params)
from paddle_tpu_torch.static import TrainStep

BLOCK = 96
FORMS = {"dense": {}, "chunked_ce": dict(chunked_ce=True),
         "scan_layers": dict(scan_layers=True)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share the CPU: torch runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(vocab, n=4, b=2, s=32, seed=11):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (b, s)).astype(np.int64),
             rng.randint(0, vocab, (b, s)).astype(np.int64))
            for _ in range(n)]


def _adamw(pkg):
    return pkg.AdamW(learning_rate=1e-3, weight_decay=0.01)


def _gpt_loss(model):
    if model.gpt.config.chunked_ce:
        return model.chunked_lm_loss
    return type(model).lm_loss


def _gpt_pair(form):
    kw = dict(FORMS[form], dropout=0.0, ce_vocab_block=BLOCK)
    paddle.seed(0)
    jm = JGPT(JGPTConfig.tiny(**kw))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    load_jax_params(tm, state)
    jstep = JTrainStep(jm, _gpt_loss(jm), _adamw(paddle.optimizer))
    tstep = TrainStep(tm, _gpt_loss(tm), _adamw(topt))
    return jstep, tstep


def _ernie_pair():
    kw = dict(chunked_ce=True, ce_vocab_block=BLOCK,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    paddle.seed(0)
    jm = JErnie(JErnieConfig.tiny(**kw))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig.tiny(**kw), device="cpu")
    load_jax_params(tm, state)
    jstep = JTrainStep(jm, jm.chunked_pretraining_loss,
                       _adamw(paddle.optimizer))
    tstep = TrainStep(tm, tm.chunked_pretraining_loss, _adamw(topt))
    return jstep, tstep


def _trajectory(jstep, tstep, batches):
    jl, tl = [], []
    for ids, lbl in batches:
        jl.append(float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                              paddle.to_tensor(lbl.astype(np.int32)))
                        .numpy()))
        tl.append(tstep(torch.from_numpy(ids), torch.from_numpy(lbl))
                  .item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    own = dict(tstep.layer.named_parameters())
    assert sorted(own) == sorted(jstep.params)
    for name, arr in jstep.params.items():
        got, ref = own[name].detach().numpy(), np.asarray(arr)
        if name.endswith(("qkv.bias", "qkv__bias")):
            # the key bias adds q.b_k to a whole row of logits, which the
            # softmax cancels: its gradient is 0 in exact arithmetic and
            # ~1e-9 of rounding noise in each framework, which Adam
            # scales up to steps of up to ~lr. Held to the lr bound over
            # the 4 steps; the query and value biases to 1e-4
            h = ref.shape[-1] // 3
            np.testing.assert_array_less(
                np.abs(got[..., h:2 * h] - ref[..., h:2 * h]),
                2 * len(batches) * 1e-3)
            got, ref = got[..., np.r_[:h, 2 * h:3 * h]], \
                ref[..., np.r_[:h, 2 * h:3 * h]]
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    return tl


@pytest.mark.parametrize("form", sorted(FORMS))
def test_gpt_trainstep_trajectory_matches_jax(form):
    jstep, tstep = _gpt_pair(form)
    losses = _trajectory(jstep, tstep, _batches(512))
    assert np.isfinite(losses).all()


def test_ernie_chunked_ce_trainstep_trajectory_matches_jax():
    jstep, tstep = _ernie_pair()
    _trajectory(jstep, tstep, _batches(1024, seed=12))


def test_chunked_forward_returns_hidden_states():
    pt.seed(0)
    m = GPTForCausalLM(GPTConfig.tiny(chunked_ce=True, dropout=0.0),
                       device="cpu").eval()
    with torch.no_grad():
        h = m(torch.zeros((2, 8), dtype=torch.long))
    assert h.shape == (2, 8, 64)
    e = ErnieForPretraining(ErnieConfig.tiny(chunked_ce=True),
                            device="cpu").eval()
    with torch.no_grad():
        h, nsp = e(torch.zeros((2, 8), dtype=torch.long))
    assert h.shape == (2, 8, 64) and nsp.shape == (2, 2)


def _dropout_run(form, seed=5, steps=3):
    pt.seed(seed)
    m = GPTForCausalLM(GPTConfig.tiny(dropout=0.1), device="cpu")
    if form == "scan_layers":
        s = GPTForCausalLM(GPTConfig.tiny(dropout=0.1, scan_layers=True),
                           device="cpu")
        s.gpt.blocks.load_from_layers(m.gpt.blocks)
        own = s.state_dict()
        with torch.no_grad():
            for k, v in m.state_dict().items():
                if k in own:
                    own[k].copy_(v)
        m = s
    m.train()
    st = TrainStep(m, GPTForCausalLM.lm_loss, _adamw(topt))
    pt.seed(seed + 1)    # the same step seeds for every form
    ids, _ = _batches(512, n=1, seed=13)[0]
    x = torch.from_numpy(ids)
    losses = [st(x, x).item() for _ in range(steps)]
    return losses, m


def test_gpt_dropout_training_is_seeded_and_scan_is_bit_equal():
    a, ma = _dropout_run("dense")
    b, _ = _dropout_run("dense")
    c, mc = _dropout_run("scan_layers")
    assert a == b and a == c
    assert np.isfinite(a).all() and a[-1] < a[0]
    for i, blk in enumerate(ma.gpt.blocks):
        assert torch.equal(blk.qkv.weight,
                           mc.gpt.blocks.stacked("qkv.weight")[i])
    # dropout is on: another seed gives other losses
    d, _ = _dropout_run("dense", seed=6)
    assert d != a

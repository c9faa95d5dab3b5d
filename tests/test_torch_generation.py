"""The port's KV-cache generation (paddle_tpu_torch/models/generation.py)
against the JAX package's.

The JAX fixture model (GPTConfig vocab 97, hidden 32, 2 layers, 4 heads,
max_seq_len 64, paddle.seed(3)) is carried into the port by name; prompts
come from numpy seeds. Greedy, eos/pad, ragged and beam-search decodes
must be token-identical to JAX's (beam scores within 1e-4); the sampling
filters (temperature, top-k, top-p) must keep exactly the set of tokens
JAX's _pick keeps on the same logits. The sampling draws themselves are
not compared: the port draws its Gumbel noise from a torch.Generator,
JAX from its own keys.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import generation as jgen
from paddle_tpu.ops import extras as jextras
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_jax_params
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops import extras as textras

SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=64, dropout=0.0)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(3)
    jm = JaxGPT(JaxConfig(use_flash_attention=False, **SMALL))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu").eval()
    load_jax_params(tm, state)
    return jm, tm


def _jax_gen(jm, ids, **kw):
    if "prompt_lens" in kw:
        kw["prompt_lens"] = paddle.to_tensor(
            np.asarray(kw["prompt_lens"], np.int32))
    return np.asarray(jm.generate(paddle.to_tensor(ids.astype(np.int32)),
                                  **kw)._data)


def _port_gen(tm, ids, **kw):
    out = tm.generate(torch.from_numpy(ids.astype(np.int64)), **kw)
    assert out.dtype == torch.int32
    return out.numpy()


def _naive_greedy(tm, ids, n_new):
    """Full re-forward each step, argmax (the port's own forward)."""
    cur = torch.from_numpy(ids.astype(np.int64))
    with torch.no_grad():
        for _ in range(n_new):
            nxt = tm(cur)[:, -1].argmax(-1)
            cur = torch.cat([cur, nxt[:, None]], dim=1)
    return cur.numpy()


@pytest.mark.parametrize("b,p,n", [(2, 7, 9), (3, 1, 12), (1, 30, 20)])
def test_greedy_matches_jax_and_full_reforward(pair, b, p, n):
    jm, tm = pair
    ids = np.random.RandomState(b * 10 + p).randint(0, 97, (b, p))
    got = _port_gen(tm, ids, max_new_tokens=n)
    np.testing.assert_array_equal(got, _jax_gen(jm, ids, max_new_tokens=n))
    np.testing.assert_array_equal(got, _naive_greedy(tm, ids, n))


def test_eos_rows_emit_pad_like_jax(pair):
    jm, tm = pair
    ids = np.random.RandomState(1).randint(0, 97, (2, 5))
    first = int(_port_gen(tm, ids, max_new_tokens=1)[0, -1])
    kw = dict(max_new_tokens=6, eos_token_id=first, pad_token_id=96)
    got = _port_gen(tm, ids, **kw)
    np.testing.assert_array_equal(got, _jax_gen(jm, ids, **kw))
    assert got[0, 5] == first and (got[0, 6:] == 96).all()


def test_ragged_prompts_match_jax_and_solo_rows(pair):
    jm, tm = pair
    rng = np.random.RandomState(10)
    lens = [7, 4, 2]
    ids = np.zeros((3, 7), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, 97, n)
    got = _port_gen(tm, ids, max_new_tokens=6, prompt_lens=lens)
    np.testing.assert_array_equal(
        got, _jax_gen(jm, ids, max_new_tokens=6, prompt_lens=lens))
    for i, n in enumerate(lens):
        solo = _port_gen(tm, ids[i:i + 1, :n], max_new_tokens=6)
        np.testing.assert_array_equal(got[i, 7:], solo[0, n:])


def test_ragged_eos_matches_jax(pair):
    jm, tm = pair
    rng = np.random.RandomState(13)
    ids = np.zeros((2, 6), np.int64)
    ids[0] = rng.randint(0, 97, 6)
    ids[1, :3] = rng.randint(0, 97, 3)
    first = int(_port_gen(tm, ids[1:, :3], max_new_tokens=1)[0, -1])
    kw = dict(max_new_tokens=5, prompt_lens=[6, 3], eos_token_id=first,
              pad_token_id=96)
    got = _port_gen(tm, ids, **kw)
    np.testing.assert_array_equal(got, _jax_gen(jm, ids, **kw))
    assert got[1, 6] == first and (got[1, 7:] == 96).all()


def test_host_side_checks_raise(pair):
    _, tm = pair
    ids = torch.zeros((2, 4), dtype=torch.long)
    for bad in ([9, 4], [0, 4], [4]):
        with pytest.raises(ValueError, match="prompt_lens"):
            tm.generate(ids, max_new_tokens=2, prompt_lens=bad)
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.generate(torch.zeros((1, 60), dtype=torch.long),
                    max_new_tokens=10)
    for top_p in (0.0, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            tm.generate(ids, max_new_tokens=2, temperature=1.0,
                        top_p=top_p)
    with pytest.raises(ValueError, match="prompt_lens"):
        tm.generate(ids, max_new_tokens=2, num_beams=2, prompt_lens=[4, 4])


def _jax_kept(logits, temperature, top_k, top_p, monkeypatch):
    """The set JAX's _pick samples from: its filtered logits, caught at
    the jax.random.categorical call."""
    seen = []

    def categorical(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jgen._pick(jnp.asarray(logits), jax.random.key(0), temperature, top_k,
               top_p)
    return seen[0] > -1e29


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 5, None), (0.7, None, 0.8), (1.3, 20, 0.5), (0.9, 97, 0.95),
    (1.0, 200, None), (0.5, 3, 1.0), (2.0, None, 0.3)])
def test_filter_keeps_what_jax_pick_keeps(temperature, top_k, top_p,
                                          monkeypatch):
    rng = np.random.RandomState(int(temperature * 10) + (top_k or 0))
    logits = rng.randn(4, 97).astype(np.float32) * 3
    logits[1, :10] = logits[1, 0]   # ties at the cut
    want = _jax_kept(logits, temperature, top_k, top_p, monkeypatch)
    got = tgen._filter(torch.from_numpy(logits), temperature, top_k,
                       top_p).numpy() > -1e29
    np.testing.assert_array_equal(got, want)


def test_pick_is_gumbel_max_over_the_filter():
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(3, 97).astype(np.float32))
    noise = tgen._gumbel((3, 97), torch.Generator().manual_seed(0), "cpu")
    tok = tgen._pick(logits, noise, 0.8, 10)
    want = (tgen._filter(logits, 0.8, 10) + noise).argmax(-1)
    assert torch.equal(tok, want)
    kept = tgen._filter(logits, 0.8, 10) > -1e29
    assert kept[torch.arange(3), tok].all()
    assert torch.equal(tgen._pick(logits, None, 0.0, None),
                       logits.argmax(-1))


def test_sampling_deterministic_per_seed_and_in_range(pair):
    _, tm = pair
    ids = np.random.RandomState(2).randint(0, 97, (3, 4))
    kw = dict(max_new_tokens=8, temperature=0.8, top_k=10, top_p=0.9)
    a = _port_gen(tm, ids, seed=7, **kw)
    b = _port_gen(tm, ids, seed=7, **kw)
    c = _port_gen(tm, ids, seed=8, **kw)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 12) and ((a >= 0) & (a < 97)).all()
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(a[:, :4], ids)


def test_sampling_with_top_k_1_is_greedy(pair):
    _, tm = pair
    ids = np.random.RandomState(3).randint(0, 97, (2, 5))
    ragged = dict(prompt_lens=[5, 3])
    np.testing.assert_array_equal(
        _port_gen(tm, ids, max_new_tokens=6, temperature=1.5, top_k=1,
                  seed=4, **ragged),
        _port_gen(tm, ids, max_new_tokens=6, **ragged))


def _jax_beam(jm, ids, w, n, eos=None, pad=0):
    cfg = jm.gpt.config
    run = jgen._build_beam_run(float(cfg.layer_norm_eps), int(cfg.num_heads),
                               w, eos, pad, n, ids.shape[1],
                               ids.shape[1] + n, None)
    out, scores = run(jgen._gpt_params(jm), ids.astype(np.int32),
                      jax.random.key(0))
    return np.asarray(out), np.asarray(scores)


def _port_beam(tm, ids, w, n, eos=None, pad=0):
    cfg = tm.gpt.config
    with torch.no_grad():
        out, scores = tgen._beam_search(
            tgen._gpt_params(tm), float(cfg.layer_norm_eps),
            int(cfg.num_heads), torch.from_numpy(ids.astype(np.int64)), w, n,
            ids.shape[1] + n, eos, pad)
    return out.numpy(), scores.numpy()


@pytest.mark.parametrize("w,b,p,n", [(4, 1, 5, 7), (3, 2, 5, 6), (1, 2, 5, 6)])
def test_beam_search_matches_jax(pair, w, b, p, n):
    jm, tm = pair
    ids = np.random.RandomState(w + p).randint(0, 97, (b, p))
    out, scores = _port_beam(tm, ids, w, n)
    j_out, j_scores = _jax_beam(jm, ids, w, n)
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_allclose(scores, j_scores, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(
        _port_gen(tm, ids, max_new_tokens=n, num_beams=w)
        if w > 1 else out, out)


def test_beam_eos_freezes_like_jax(pair):
    jm, tm = pair
    ids = np.random.RandomState(8).randint(0, 97, (1, 4))
    first = int(_port_gen(tm, ids, max_new_tokens=1, num_beams=4)[0, -1])
    out, scores = _port_beam(tm, ids, 4, 5, eos=first, pad=96)
    j_out, j_scores = _jax_beam(jm, ids, 4, 5, eos=first, pad=96)
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_allclose(scores, j_scores, atol=1e-4, rtol=1e-4)
    assert out[0, 4] == first and (out[0, 5:] == 96).all()


def test_beam_search_step_breaks_ties_by_lower_index():
    """Frozen beams give equal candidates; the port must pick the ones
    jax.lax.top_k picks (lower flat index first)."""
    rng = np.random.RandomState(0)
    logp = rng.randn(2, 3, 5).astype(np.float32)
    logp[0] = -1e30
    logp[0, :, 2] = 0.0                     # three equal candidates
    logp[1, 1] = logp[1, 0]                 # two beams tie everywhere
    scores = np.zeros((2, 3), np.float32)
    want = jextras.beam_search_step.__pure_fn__(
        jnp.asarray(logp), jnp.asarray(scores), beam_size=3)
    got = textras.beam_search_step(torch.from_numpy(logp),
                                   torch.from_numpy(scores), beam_size=3)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_gather_tree_matches_jax():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 50, (6, 2, 3))
    parents = rng.randint(0, 3, (6, 2, 3))
    want = np.asarray(jextras.gather_tree.__pure_fn__(
        jnp.asarray(ids), jnp.asarray(parents)))
    got = textras.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_generate_deterministic_and_keeps_prompt(pair):
    _, tm = pair
    ids = np.random.RandomState(1).randint(0, 97, (2, 7))
    a = _port_gen(tm, ids, max_new_tokens=9, dtype="bfloat16")
    b = _port_gen(tm, ids, max_new_tokens=9, dtype="bfloat16")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, :7], ids)
    assert ((a >= 0) & (a < 97)).all()
    # the model's own parameters stay f32
    assert tm.gpt.wte.weight.dtype == torch.float32


def test_layer_norm_helper_uses_population_variance():
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 16).astype(
        np.float32))
    w, b = torch.ones(16), torch.zeros(16)
    want = np.asarray(jgen._ln(jnp.asarray(x.numpy()), jnp.ones(16),
                               jnp.zeros(16), 1e-5))
    np.testing.assert_allclose(tgen._ln(x, w, b, 1e-5).numpy(), want,
                               atol=1e-5)


def test_int8_leaf_raises():
    """An int8 {"q8", "s"} leaf goes through int8_matmul as in the JAX
    package's _mm (it used to raise as unported); a product the int8
    GEMM refuses (K mismatch) still raises."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 8).astype(np.float32)
    q8 = rng.randint(-128, 128, (8, 16)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (16,)).astype(np.float32)
    want = np.asarray(jgen._mm(jnp.asarray(x), {"qkv_w": {
        "q8": jnp.asarray(q8), "s": jnp.asarray(s)}}, "qkv"))
    got = tgen._mm(torch.from_numpy(x), {"qkv_w": {
        "q8": torch.from_numpy(q8), "s": torch.from_numpy(s)}}, "qkv")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError):
        tgen._mm(torch.zeros(1, 4), {"qkv_w": {
            "q8": torch.from_numpy(q8), "s": torch.from_numpy(s)}}, "qkv")

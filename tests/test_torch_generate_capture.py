"""generate's static programs (paddle_tpu_torch/models/generation.py
_Program, item 10e) against the JAX package's compiled decode and the
port's eager loop.

A small GPT (vocab 211, hidden 64, 2 layers, 4 heads, max_seq_len 64,
paddle.seed(5)) is carried into the port by name. On the CPU the
program's bodies (prefill, step, finish over static buffers, the state
on the device) run without graphs (generate(..., eager=False)): in f32
they give the JAX generate_gpt's tokens (greedy, ragged, beam 3 with and
without eos; beam scores within 1e-5 relative) and, for the sampled
modes, the port's eager loop's tokens for the same seed. The program
cache keys and evicts as functools.lru_cache(maxsize=64). On a card the
captured graphs are held bit-equal to the eager loop (skipped here).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import generation as jgen
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_jax_params
from paddle_tpu_torch.models import generation as tgen

SMALL = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=64, dropout=0.0)
SAMPLED = [dict(temperature=0.8), dict(temperature=0.8, top_k=7),
           dict(temperature=0.8, top_p=0.9),
           dict(temperature=0.8, top_k=7, top_p=0.9)]


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(5)
    jm = JaxGPT(JaxConfig(use_flash_attention=False, **SMALL))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu").eval()
    load_jax_params(tm, _state(jm))
    return jm, tm


def _ids(seed, b, p):
    return np.random.RandomState(seed).randint(0, SMALL["vocab_size"], (b, p))


def _jax(jm, ids, **kw):
    if "prompt_lens" in kw:
        kw["prompt_lens"] = paddle.to_tensor(
            np.asarray(kw["prompt_lens"], np.int32))
    return np.asarray(jm.generate(paddle.to_tensor(ids.astype(np.int32)),
                                  **kw)._data)


def _port(tm, ids, **kw):
    out = tm.generate(torch.from_numpy(ids.astype(np.int64)), **kw)
    assert out.dtype == torch.int32
    return out.numpy()


@pytest.mark.parametrize("b,p,n", [(1, 5, 9), (3, 8, 12), (2, 17, 6)])
def test_program_greedy_equals_jax(pair, b, p, n):
    jm, tm = pair
    ids = _ids(b * 100 + p, b, p)
    got = _port(tm, ids, max_new_tokens=n, eager=False)
    np.testing.assert_array_equal(got, _jax(jm, ids, max_new_tokens=n))
    np.testing.assert_array_equal(
        got, _port(tm, ids, max_new_tokens=n, eager=True))


def test_program_greedy_eos_equals_jax(pair):
    jm, tm = pair
    ids = _ids(21, 3, 6)
    first = int(_port(tm, ids, max_new_tokens=2, eager=False)[1, 6])
    kw = dict(max_new_tokens=10, eos_token_id=first, pad_token_id=3)
    got = _port(tm, ids, eager=False, **kw)
    np.testing.assert_array_equal(got, _jax(jm, ids, **kw))
    assert got[1, 6] == first and (got[1, 7:] == 3).all()


@pytest.mark.parametrize("lens", [[6, 3, 1], [2, 6, 4]])
def test_program_ragged_equals_jax(pair, lens):
    jm, tm = pair
    ids = _ids(sum(lens), 3, 6)
    got = _port(tm, ids, max_new_tokens=8, prompt_lens=lens, eager=False)
    np.testing.assert_array_equal(
        got, _jax(jm, ids, max_new_tokens=8, prompt_lens=lens))


def _jax_beam(jm, ids, w, n, eos, pad):
    cfg = jm.gpt.config
    run = jgen._build_beam_run(float(cfg.layer_norm_eps), int(cfg.num_heads),
                               w, eos, pad, n, ids.shape[1],
                               ids.shape[1] + n, None)
    out, scores = run(jgen._gpt_params(jm), ids.astype(np.int32),
                      jax.random.key(0))
    return np.asarray(out), np.asarray(scores)


@pytest.mark.parametrize("eos", [False, True])
@pytest.mark.parametrize("b,p,n", [(1, 5, 7), (2, 6, 9)])
def test_program_beam_equals_jax(pair, eos, b, p, n):
    jm, tm = pair
    ids = _ids(b + p + n, b, p)
    eos_id = None
    if eos:
        # the token beam search picks first for row 0: eos fires at once
        eos_id = int(_port(tm, ids, max_new_tokens=1, num_beams=3,
                           eager=False)[0, p])
    got = _port(tm, ids, max_new_tokens=n, num_beams=3, eos_token_id=eos_id,
                pad_token_id=2, eager=False)
    scores = tgen.generate_programs(tm).last.best_scores.numpy()
    want, want_scores = _jax_beam(jm, ids, 3, n, eos_id, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=0)
    if eos:
        assert got[0, p] == eos_id and (got[0, p + 1:] == 2).all()


@pytest.mark.parametrize("kw", SAMPLED, ids=["temp", "top_k", "top_p", "both"])
@pytest.mark.parametrize("ragged", [False, True])
def test_program_sampled_equals_eager(pair, kw, ragged):
    _, tm = pair
    ids = _ids(33, 3, 7)
    kw = dict(kw, max_new_tokens=10, seed=11)
    if ragged:
        kw["prompt_lens"] = [7, 2, 5]
    got = _port(tm, ids, eager=False, **kw)
    np.testing.assert_array_equal(got, _port(tm, ids, eager=True, **kw))
    # another seed draws other tokens, through the same program
    again = _port(tm, ids, eager=False, **dict(kw, seed=12))
    assert not np.array_equal(got, again)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_set_state_dict_between_calls_changes_the_output(dtype):
    paddle.seed(6)
    jm = JaxGPT(JaxConfig(use_flash_attention=False, **SMALL))
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu").eval()
    load_jax_params(tm, _state(jm))
    ids = _ids(3, 2, 6)
    kw = dict(max_new_tokens=8, dtype=dtype, eager=False)
    before = _port(tm, ids, **kw)
    st = tgen.generate_programs(tm)
    old = {k: v.clone() for k, v in tm.state_dict().items()}
    rng = torch.Generator().manual_seed(0)
    tm.set_state_dict({k: v + torch.randn(v.shape, generator=rng)
                       for k, v in old.items()})
    after = _port(tm, ids, **kw)
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, _port(tm, ids, **dict(kw,
                                                               eager=True)))
    # refreshed in place: the same program, nothing rebuilt
    assert st.captures == 1 and st.programs == 1 and st.sentinel.fired == 0
    tm.set_state_dict(old)
    np.testing.assert_array_equal(_port(tm, ids, **kw), before)


def test_one_program_per_signature_and_the_sentinel(pair):
    paddle.seed(7)
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu").eval()
    st = tgen.generate_programs(tm)
    ids = torch.from_numpy(_ids(1, 2, 5))
    calls = [dict(), dict(), dict(temperature=0.5), dict(num_beams=2),
             dict(temperature=0.5, seed=4), dict(num_beams=2),
             dict(prompt_lens=[5, 2]), dict(prompt_lens=[3, 1]),
             dict(max_new_tokens=3), dict()]
    for kw in calls:
        tm.generate(ids, **dict(dict(max_new_tokens=4), **kw), eager=False)
    # distinct signatures: greedy, sampled, beam, ragged, greedy T=3
    assert st.programs == st.captures == len(st.seen) == 5
    # one cache for both kinds: its key holds num_beams
    beams = [dict(k)["num_beams"] for k in st.runs.keys()]
    assert sorted(beams) == [1, 1, 1, 1, 2]
    assert st.sentinel.fired == 0
    # an uncast weight rebound to new memory: its programs are rebuilt
    # and the sentinel names the cause
    p = tm.gpt.ln_f.weight
    p.data = p.data.clone()
    tm.generate(ids, max_new_tokens=4, eager=False)
    assert st.captures == 6 and st.programs == 1
    assert st.sentinel.fired == 1
    assert "non-shape cause" in st.sentinel.events[0]["diff"]


class _Fake:
    released = 0

    def release(self):
        _Fake.released += 1


def test_program_cache_keys_and_evicts_like_lru_cache():
    """A key sequence with repeats, over more distinct keys than the
    bound: the same hits, misses and resident keys as
    functools.lru_cache(maxsize=64), and one release per eviction."""
    built = []

    @functools.lru_cache(maxsize=tgen.PROGRAMS_MAX)
    def ref(key):
        return key

    lru = tgen.ProgramLRU()
    rng = np.random.RandomState(0)
    keys = [("k", int(k)) for k in rng.zipf(1.3, 600) % 150]
    _Fake.released = 0
    for key in keys:
        ref(key)
        lru.get(key, lambda: built.append(key) or _Fake())
    info = ref.cache_info()
    assert (lru.hits, lru.misses) == (info.hits, info.misses)
    assert len(lru) == info.currsize == tgen.PROGRAMS_MAX
    assert lru.evictions == _Fake.released == info.misses - len(lru)
    assert len(built) == info.misses
    # the resident keys are the 64 most recently used
    recent = list(dict.fromkeys(reversed(keys)))[:tgen.PROGRAMS_MAX]
    assert sorted(lru.keys()) == sorted(recent)
    lru.clear()
    assert len(lru) == 0 and _Fake.released == info.misses


class _Sized(_Fake):
    def __init__(self, nbytes):
        self.nbytes = nbytes


def test_program_cache_evicts_by_bytes():
    """Over max_bytes the least recently used programs go first; the one
    just built stays even when it alone is over the bound."""
    lru = tgen.ProgramLRU(maxsize=8, max_bytes=100)
    _Fake.released = 0
    for key in "abc":
        lru.get(key, lambda: _Sized(30))
    assert lru.nbytes == 90 and lru.evictions == 0
    lru.get("a", lambda: _Sized(30))           # a hit: a is now newest
    lru.get("d", lambda: _Sized(30))
    assert lru.keys() == ["c", "a", "d"] and lru.nbytes == 90
    assert lru.evictions == _Fake.released == 1       # b, the oldest
    lru.get("e", lambda: _Sized(95))
    assert lru.keys() == ["e"] and lru.nbytes == 95
    assert lru.evictions == _Fake.released == 4
    lru.clear()
    assert lru.nbytes == 0 and _Fake.released == 5
    assert tgen.ProgramLRU().max_bytes == tgen.PROGRAM_BYTES_MAX


@pytest.mark.parametrize("num_beams", [1, 3])
def test_program_bytes_count_its_buffers_and_release_frees_them(pair,
                                                                num_beams):
    jm, tm = pair
    st = tgen.generate_programs(tm)
    st.release()
    b, p, n = 2, 5, 4
    _port(tm, _ids(2, b, p), max_new_tokens=n, num_beams=num_beams,
          eager=False)
    prog = st.last
    rows, hd = b * num_beams, SMALL["hidden_size"] // SMALL["num_heads"]
    caches = (SMALL["num_layers"] * 2 * rows * SMALL["num_heads"] * (p + n)
              * hd * 4)
    assert caches < prog.nbytes == st.runs.nbytes
    assert prog.nbytes - caches < rows * SMALL["vocab_size"] * 4 * 3
    st.release()
    assert st.programs == 0 and st.runs.nbytes == 0
    assert not prog.caches and not [x for x in vars(prog).values()
                                    if isinstance(x, torch.Tensor)]


@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the programs are captured as CUDA "
                    "graphs only there")
    torch.manual_seed(0)
    return GPTForCausalLM(GPTConfig(**SMALL), device="cuda").eval()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), *SAMPLED, dict(num_beams=3),
                                dict(num_beams=3, eos_token_id=5),
                                dict(prompt_lens=[6, 2, 4])])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_captured_equals_eager_on_card(cuda_model, kw, dtype):
    ids = torch.from_numpy(_ids(9, 3, 6)).cuda()
    kw = dict(kw, max_new_tokens=9, dtype=dtype, seed=3)
    if "prompt_lens" in kw:
        kw["prompt_lens"] = torch.tensor(kw["prompt_lens"])
    got = cuda_model.generate(ids, **kw)
    st = tgen.generate_programs(cuda_model)
    captures = st.captures
    again = cuda_model.generate(ids, **kw)
    assert torch.equal(got, again) and st.captures == captures
    assert torch.equal(got, cuda_model.generate(ids, eager=True, **kw))
    if kw.get("temperature"):
        # another seed through the same program: the seed reaches the
        # generator registered with its graphs
        kw["seed"] = 4
        other = cuda_model.generate(ids, **kw)
        assert st.captures == captures and not torch.equal(other, got)
        assert torch.equal(other, cuda_model.generate(ids, eager=True, **kw))
    assert st.sentinel.fired == 0

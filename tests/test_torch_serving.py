"""The port's continuous-batching engine (paddle_tpu_torch/serving)
against the JAX package's, on the CPU.

The JAX fixture model (GPTConfig vocab 97, hidden 32, 2 layers, 4 heads,
max_seq_len 64, paddle.seed(3)) is carried into the port by name. In the
f32 parity mode (dtype=None) every stream of a staggered-admission batch
must equal the port's solo greedy generate() of the same prompt, token
for token, and the JAX engine's stream for the same requests. On the CPU
the engine's programs run eagerly (the card captures each as a CUDA
graph: chip_smoke.py); the program count must equal
expected_executables with no sentinel event over a five-length prompt
mix. Then the page accounting, eviction and resume, hot weight swaps,
the bf16 default, sampling and the host-side units.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_jax_params
from paddle_tpu_torch.models.generation import _gpt_params
from paddle_tpu_torch.observability import RecompileSentinel
from paddle_tpu_torch.serving import (BucketLadder, FifoScheduler,
                                      PagedKVCache, ProgramCache, Request,
                                      ServingConfig, ServingEngine)

SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=64, dropout=0.0)
F32 = dict(max_slots=4, max_admit=2, block_size=4, n_blocks=32,
           prefill_buckets=(8, 16), max_total_tokens=32, decode_chunk=2,
           dtype=None)
# (prompt length, new tokens) of the staggered batch
STAGGER = [(7, 8), (3, 6), (11, 5), (2, 7)]


def _state(seed=3, **kw):
    paddle.seed(seed)
    jm = JaxGPT(JaxConfig(use_flash_attention=False, **dict(SMALL, **kw)))
    jm.eval()
    return jm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_model(state, **kw):
    tm = GPTForCausalLM(GPTConfig(**dict(SMALL, **kw)), device="cpu").eval()
    return load_jax_params(tm, state)


@pytest.fixture(scope="module")
def pair():
    jm, state = _state()
    return jm, _port_model(state)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def f32_config(**kw):
    return ServingConfig(**dict(F32, **kw))


def solo_greedy(model, ids, n_new):
    out = model.generate(torch.from_numpy(ids[None].astype(np.int64)),
                         max_new_tokens=n_new)
    return out.numpy()[0, len(ids):]


def _staggered(eng, prompts):
    """r0 admitted alone, r1 two boundaries later while r0 decodes, r2
    and r3 together at the next boundary (the pattern of
    tests/test_serving_engine.py::test_staggered_admission_bit_exact)."""
    rids = [eng.submit(prompts[0], STAGGER[0][1])]
    eng.step()
    eng.step()
    rids.append(eng.submit(prompts[1], STAGGER[1][1]))
    eng.step()
    rids += [eng.submit(prompts[i], STAGGER[i][1]) for i in (2, 3)]
    done = {r.rid: r for r in eng.run_to_completion()}
    return [list(done[r].out) for r in rids]


def test_staggered_streams_equal_solo_generate_and_jax_engine(pair):
    jm, tm = pair
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 97, (n,)).astype(np.int32) for n, _ in STAGGER]
    eng = ServingEngine(tm, f32_config()).warmup()
    got = _staggered(eng, prompts)
    for p, (_, n), out in zip(prompts, STAGGER, got):
        np.testing.assert_array_equal(out, solo_greedy(tm, p, n))
    want = _staggered(JaxServingEngine(jm, JaxServingConfig(**F32)),
                      prompts)
    assert got == want
    eng.cache.check_invariants()
    assert eng.cache.n_free == eng.cache.n_blocks - 1
    assert eng.executable_count() == eng.expected_executables == 3
    assert eng.sentinel.fired == 0


def test_batch_convenience_matches_solo(model):
    eng = ServingEngine(model, f32_config())
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 97, (n,)).astype(np.int32) for n in (5, 9, 4)]
    outs = eng.generate_tokens(prompts, [6, 4, 8])
    for p, o, n in zip(prompts, outs, [6, 4, 8]):
        np.testing.assert_array_equal(o, solo_greedy(model, p, n))


def test_five_length_mix_pins_program_count(model):
    """Five distinct prompt lengths admit through the two prefill
    buckets: the program count is the bucket count, not one per length,
    and the sentinel never fires."""
    eng = ServingEngine(model, f32_config())
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 97, (n,)).astype(np.int32)
               for n in (3, 5, 6, 9, 12)]
    outs = eng.generate_tokens(prompts, [4] * 5)
    names = [k[0] for k in eng.programs.keys()]
    assert names.count("prefill") == 2 and names.count("decode") == 1
    assert eng.executable_count() == eng.expected_executables == 3
    assert eng.sentinel.fired == 0 and eng.sentinel.counter == 0
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, solo_greedy(model, p, 4))


def test_warmup_builds_the_whole_ladder(model):
    eng = ServingEngine(model, f32_config(decode_buckets=(2, 4)))
    eng.warmup()
    assert eng.executable_count() == eng.expected_executables == 4
    assert eng.programs.eager_dispatches == 4     # the CPU runs eagerly
    assert eng.programs.captures == 0
    assert eng.cache.n_free == eng.cache.n_blocks - 1


def test_over_decode_past_the_table_and_positions_is_clamped(model):
    """A request of max_total_tokens == max_seq_len whose last chunk
    decodes past its pages and past the position table: the junk lands in
    its own last page (clamped, as JAX clamps a gather) and the stream
    still equals solo greedy."""
    eng = ServingEngine(model, f32_config(max_total_tokens=64, n_blocks=20,
                                          decode_chunk=4))
    p = np.random.RandomState(5).randint(0, 97, (13,)).astype(np.int32)
    (out,) = eng.generate_tokens([p], [51])
    np.testing.assert_array_equal(out, solo_greedy(model, p, 51))


def test_eos_finishes_early_and_frees_pages(model):
    eng = ServingEngine(model, f32_config())
    p = np.random.RandomState(6).randint(0, 97, (5,)).astype(np.int32)
    first = int(solo_greedy(model, p, 1)[0])
    rid = eng.submit(p, 8, eos_token_id=first)
    r = {r.rid: r for r in eng.run_to_completion()}[rid]
    assert r.finish_reason == "eos" and r.out == [first]
    eng.cache.check_invariants()
    assert eng.cache.n_free == eng.cache.n_blocks - 1


def test_admission_backpressure_fifo(model):
    """A pool too small for three requests queues the third until one
    retires: FIFO, invariants at every boundary, all pages back."""
    eng = ServingEngine(model, f32_config(n_blocks=9, prefill_buckets=(8,),
                                          max_total_tokens=16))
    p = np.random.RandomState(7).randint(0, 97, (8,)).astype(np.int32)
    r1, r2, r3 = (eng.submit(p, 8) for _ in range(3))
    eng.step()
    assert eng.sched.n_running == 2 and eng.sched.queue_depth == 1
    order = []
    for _ in range(200):
        if not eng.has_work():
            break
        order += [r.rid for r in eng.step()]
        eng.cache.check_invariants()
    assert sorted(order[:2]) == sorted([r1, r2]) and order[2] == r3
    assert eng.cache.n_free == 8


def test_submit_validation(model):
    eng = ServingEngine(model, f32_config())
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(np.zeros((17,), np.int32), 2)
    with pytest.raises(ValueError, match="max_total_tokens"):
        eng.submit(np.zeros((16,), np.int32), 32)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.zeros((4,), np.int32), 0)


def test_evict_requests_frees_and_resumes_exactly(model):
    eng = ServingEngine(model, f32_config()).warmup()
    rng = np.random.RandomState(13)
    p = rng.randint(0, 97, (5,)).astype(np.int32)
    others = [rng.randint(0, 97, (4,)).astype(np.int32) for _ in range(2)]
    eng.submit(p, 8)
    eng.step()
    eng.step()
    for o in others:
        eng.submit(o, 6)
    evicted = eng.evict_requests()
    assert [len(r.out) > 0 for r in evicted] == [True, False, False]
    assert eng.cache.n_free == eng.cache.n_blocks - 1 and not eng.has_work()
    eng.cache.check_invariants()
    r = evicted[0]
    k = len(r.out)
    assert 1 <= k < 8
    eng.submit(np.concatenate([p, np.asarray(r.out, np.int32)]), 8 - k)
    suffix = eng.run_to_completion()[-1].out
    np.testing.assert_array_equal(list(r.out) + list(suffix),
                                  solo_greedy(model, p, 8))


def test_same_weights_swap_mid_stream_is_identity(model):
    eng = ServingEngine(model, f32_config()).warmup()
    ptr = eng.params["blocks"][0]["qkv_w"].data_ptr()
    p = np.random.RandomState(14).randint(0, 97, (5,)).astype(np.int32)
    eng.submit(p, 8)
    eng.step()
    eng.step()
    eng.swap_weights(_gpt_params(model))
    done = eng.run_to_completion()
    np.testing.assert_array_equal(done[-1].out, solo_greedy(model, p, 8))
    assert eng.sentinel.fired == 0
    assert eng.executable_count() == eng.expected_executables
    # copied in place: the programs read the same tensors
    assert eng.params["blocks"][0]["qkv_w"].data_ptr() == ptr


def test_swap_to_other_weights_serves_them(model):
    _, state = _state(seed=21)
    other = _port_model(state)
    eng = ServingEngine(model, f32_config()).warmup()
    eng.swap_weights(_gpt_params(other))
    p = np.random.RandomState(15).randint(0, 97, (6,)).astype(np.int32)
    (out,) = eng.generate_tokens([p], [7])
    np.testing.assert_array_equal(out, solo_greedy(other, p, 7))
    # the model the engine was built from is untouched
    assert not torch.equal(model.gpt.wte.weight, other.gpt.wte.weight)


def test_swap_shape_or_dtype_mismatch_rejected_before_flip(model):
    _, state = _state(seed=15, hidden_size=64)
    other = _port_model(state, hidden_size=64)
    eng = ServingEngine(model, f32_config())
    before = eng.params["wte"].clone()
    with pytest.raises(ValueError, match="swap rejected"):
        eng.swap_weights(_gpt_params(other))
    bf16 = {k: v for k, v in _gpt_params(model).items()}
    bf16["wte"] = bf16["wte"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="swap rejected"):
        eng.swap_weights(bf16, cast=False)
    assert torch.equal(eng.params["wte"], before)


def test_bf16_default_pools_params_and_determinism(model):
    cfg = ServingConfig(max_slots=4, max_admit=2, block_size=4, n_blocks=32,
                        prefill_buckets=(8, 16), max_total_tokens=32)
    assert cfg.dtype == "bfloat16"
    eng = ServingEngine(model, cfg)
    k, v = eng.cache.pools[0]
    assert k.dtype == v.dtype == eng.params["wte"].dtype == torch.bfloat16
    assert model.gpt.wte.weight.dtype == torch.float32
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, 97, (n,)).astype(np.int32) for n in (6, 3)]
    a = eng.generate_tokens(prompts, [5, 5])
    b = ServingEngine(model, cfg).generate_tokens(prompts, [5, 5])
    assert a == b and all(0 <= t < 97 for row in a for t in row)


def test_sampling_engine_deterministic_and_in_range(model):
    def run(seed):
        eng = ServingEngine(model, f32_config(
            max_slots=2, max_admit=2, prefill_buckets=(8,),
            max_total_tokens=16, temperature=0.8, top_k=12, seed=seed))
        return eng.generate_tokens(prompts, [6, 4])
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, 97, (n,)).astype(np.int32) for n in (5, 3)]
    a, b = run(11), run(11)
    assert a == b and [len(x) for x in a] == [6, 4]
    assert all(0 <= t < 97 for row in a for t in row)
    assert a != run(12)


def test_config_validation():
    with pytest.raises(ValueError, match="decode bucket"):
        ServingConfig(max_slots=8, decode_buckets=(4,))
    with pytest.raises(ValueError, match="max_total_tokens"):
        ServingConfig(prefill_buckets=(32,), max_total_tokens=16)
    with pytest.raises(ValueError, match="decode_chunk"):
        ServingConfig(decode_chunk=0)
    # values the JAX config refuses stay ValueErrors, not "unported"
    with pytest.raises(ValueError, match="only 'int8'"):
        ServingConfig(quant="bf16")
    with pytest.raises(ValueError, match="speculative_k"):
        ServingConfig(speculative_k=-1)
    # the raw-speed levers are ported and compose; only tp plans stay
    # unported
    cfg = ServingConfig(quant="int8", speculative_k=2, prefix_sharing=True)
    assert (cfg.quant, cfg.speculative_k, cfg.prefix_sharing) == (
        "int8", 2, True)
    with pytest.raises(ValueError, match="greedy"):
        ServingConfig(speculative_k=2, temperature=0.7)
    with pytest.raises(NotImplementedError, match="item 14"):
        ServingConfig(plan=object())


def test_engine_rejects_a_too_long_config(model):
    with pytest.raises(ValueError, match="max_seq_len"):
        ServingEngine(model, f32_config(max_total_tokens=128))


def test_ladder_pick_and_errors():
    lad = BucketLadder((16, 8), (4,), block_size=4)
    assert lad.prefill == (8, 16)
    assert lad.pick_prefill(3) == 8 and lad.pick_prefill(9) == 16
    assert lad.pick_decode(1) == 4 and lad.size == 3
    with pytest.raises(ValueError, match="exceeds"):
        lad.pick_prefill(17)
    with pytest.raises(ValueError, match="exceed"):
        lad.pick_decode(5)
    with pytest.raises(ValueError, match="multiple"):
        BucketLadder((6,), (4,), block_size=4)


def test_fifo_head_blocks_admission():
    class FakeCache:
        available_pages = 4

        def blocks_for(self, n):
            return n
    s = FifoScheduler(max_slots=8, max_admit=8)
    for n in (3, 98, 1):
        s.submit(Request(ids=np.ones(2, np.int32), max_new_tokens=n))
    # head needs 5 > 4 pages: nothing overtakes it
    assert s.take_admissible(FakeCache()) == [] and s.queue_depth == 3
    with pytest.raises(ValueError, match="max_admit"):
        FifoScheduler(max_slots=2, max_admit=3)


def test_request_accept_finishes_on_budget_or_eos():
    r = Request(ids=[1, 2], max_new_tokens=3, eos_token_id=7)
    r.accept(5)
    assert not r.done
    r.accept(7)
    assert r.finish_reason == "eos" and r.total_tokens == 5
    with pytest.raises(ValueError, match="empty"):
        Request(ids=[], max_new_tokens=1)


def test_paged_cache_alloc_free_tables_and_invariants():
    c = PagedKVCache(n_layers=2, n_blocks=6, block_size=4, n_heads=2,
                     head_dim=8, device="cpu")
    assert c.n_free == 5 and c.blocks_for(9) == 3
    a = c.alloc("a", 9)
    b = c.alloc("b", 4)
    assert len(a) == 3 and len(b) == 1 and 0 not in a + b
    assert not c.can_alloc(9) and c.can_alloc(4)
    t = c.table_array(["a", None, "b"], 4)
    assert t.tolist() == [a + [0], [0, 0, 0, 0], b + [0, 0, 0]]
    with pytest.raises(ValueError, match="already"):
        c.alloc("a", 1)
    with pytest.raises(MemoryError):
        c.alloc("c", 12)
    c.check_invariants()
    c.free("a")
    assert c.n_free == 4 and c.n_live == 1
    # LIFO: the pages just freed are handed out first
    assert c.alloc("d", 4) == [a[-1]]
    with pytest.raises(KeyError):
        c.free("a")
    c._ref[a[0]] = 1               # a leaked page breaks conservation
    with pytest.raises(AssertionError):
        c.check_invariants()
    assert c.pools[0][0].shape == (6, 4, 2, 8)
    assert c.pool_bytes == 2 * 2 * 6 * 4 * 2 * 8 * 4


def test_paged_cache_rejects_unported_modes_and_bad_sizes():
    kw = dict(n_layers=1, n_blocks=4, block_size=4, n_heads=1, head_dim=4,
              device="cpu")
    # prefix sharing is ported; sharded pools are not
    assert PagedKVCache(prefix_sharing=True, **kw).prefix_sharing
    with pytest.raises(NotImplementedError, match="item 14"):
        PagedKVCache(tp=2, **kw)
    with pytest.raises(ValueError, match="n_blocks"):
        PagedKVCache(**dict(kw, n_blocks=1))


def test_program_cache_keys_by_shape_and_counts_eager_runs():
    progs = ProgramCache("cpu")
    calls = []

    def fn(pools, x, params, noise):
        calls.append(tuple(x.shape))
        return x * 2

    for n in (3, 3, 4):
        out = progs("p", fn, (), {}, (np.arange(n, dtype=np.int32),))
        np.testing.assert_array_equal(out, np.arange(n) * 2)
    assert len(progs) == 2 and progs.eager_dispatches == 3
    assert progs.captures == progs.replays == 0
    assert len(progs.dispatch_ms["p"]) == 3 and progs.graph(
        progs.keys()[0]) is None


def test_sentinel_fires_on_growth_with_the_shape_delta():
    s = RecompileSentinel("serving")
    sig = (("decode", (4,), "bucket"),)
    s.observe(3, expected=3, signature=sig)
    s.observe(3, expected=3, signature=sig)
    assert s.fired == 0
    s.observe(4, expected=3, signature=(("decode", (8,), "bucket"),))
    assert s.fired == 1 and s.counter == 1
    assert "(4,)" in s.events[0]["diff"] and "(8,)" in s.events[0]["diff"]
    s.observe(4, expected=3)
    assert s.fired == 1

"""The port's serving raw-speed levers (int8 weights, speculative
decoding, copy-on-write prefix sharing, and the chunk program under the
last two) against the JAX package's, on the CPU.

Each test of tests/test_serving_raw_speed.py has its counterpart here,
at the same sizes (vocab 97, hidden 32, 2 layers, 4 heads; the draft
hidden 16, 1 layer, 2 heads), on the JAX fixture models carried into the
port by name. Beside them, cross checks through the same numpy inputs:
the JAX chunk program against the port's (tokens equal, pools at 1e-5),
the int8 codes and scales bit-equal and int8_matmul within 1e-6
relative, the two PagedKVCaches driven through one sequence of
operations to equal tables and stats, and the f32 speculative and
shared-prefix engine streams equal to the JAX engine's. On the CPU the
programs run eagerly; the card captures each as a CUDA graph
(chip_smoke.py's serving_levers phase). The JAX package's loadgen
shared-prefix trace is not ported (ROADMAP.md queue A item 10c);
chip_smoke.py's shared-prefix trace helper is tested in
tests/test_torch_chip_smoke.py, the request-trace spans of the levers in
tests/test_torch_observability.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models.generation import _gpt_params as jax_gpt_params
from paddle_tpu.quant import QuantConfig
from paddle_tpu.quant import int8_serving as jq
from paddle_tpu.serving import PagedKVCache as JaxPagedKVCache
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import build_serving_snapshot as jax_snapshot
from paddle_tpu.serving.programs import make_chunk_fn as jax_chunk_fn
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_jax_params, load_jax_serving_params,
                                     serving_params_to_numpy)
from paddle_tpu_torch.models.generation import _gpt_params
from paddle_tpu_torch.quant import (QUANT_WEIGHT_KEYS, int8_matmul,
                                    logits_drift_receipt, quantize_params,
                                    quantize_weight)
from paddle_tpu_torch.serving import (PagedKVCache, ServingConfig,
                                      ServingEngine, build_serving_snapshot)
from paddle_tpu_torch.serving.programs import make_chunk_fn, make_decode_fn

V = 97
F32 = dict(max_slots=4, max_admit=2, block_size=4, n_blocks=32,
           prefill_buckets=(8, 16), max_total_tokens=32, decode_chunk=2,
           dtype=None)
# (prompt length, new tokens) of the staggered speculative batch
SPEC = [(7, 8), (3, 6), (11, 5), (2, 7)]


def _pair(seed, layers=2, hidden=32, heads=4):
    paddle.seed(seed)
    jm = JaxGPT(JaxConfig(vocab_size=V, hidden_size=hidden,
                          num_layers=layers, num_heads=heads, max_seq_len=64,
                          dropout=0.0, use_flash_attention=False))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(vocab_size=V, hidden_size=hidden,
                                  num_layers=layers, num_heads=heads,
                                  max_seq_len=64, dropout=0.0),
                        device="cpu").eval()
    return jm, load_jax_params(tm, state)


@pytest.fixture(scope="module")
def pair():
    return _pair(3)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(scope="module")
def draft_pair():
    # a different, smaller proposer over the same vocab
    return _pair(7, layers=1, hidden=16, heads=2)


@pytest.fixture(scope="module")
def draft(draft_pair):
    return draft_pair[1]


def f32_config(**kw):
    return ServingConfig(**dict(F32, **kw))


def solo_greedy(model, ids, n_new):
    out = model.generate(torch.from_numpy(ids[None].astype(np.int64)),
                         max_new_tokens=n_new)
    return out.numpy()[0, len(ids):]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- int8 ---------------------------------------------------------------------

class TestInt8:
    def test_quantize_weight_roundtrip(self):
        rng = np.random.RandomState(0)
        w = rng.randn(24, 12).astype(np.float32) * \
            rng.uniform(0.1, 4.0, (12,)).astype(np.float32)
        leaf = quantize_weight(_t(w))
        assert leaf["q8"].dtype == torch.int8
        assert tuple(leaf["s"].shape) == (12,)
        # dequant error is at most half a code step per channel
        s = leaf["s"].numpy()
        err = np.abs(leaf["q8"].numpy().astype(np.float32) * s - w)
        assert (err <= 0.5 * s + 1e-7).all()

    def test_codes_and_scales_bit_equal_to_jax(self):
        rng = np.random.RandomState(10)
        # exact .5 steps included: both round half to even
        w = rng.randn(32, 16).astype(np.float32)
        w[0, :] = np.arange(16, dtype=np.float32) - 7.5
        want = jq.quantize_weight(w)
        for bits in (8, 4):
            want = jq.quantize_weight(w, bits)
            got = quantize_weight(_t(w), bits)
            np.testing.assert_array_equal(got["q8"].numpy(),
                                          np.asarray(want["q8"]))
            np.testing.assert_array_equal(got["s"].numpy(),
                                          np.asarray(want["s"]))
        # the codes are laid out column-major (cuBLASLt's int8 layout)
        assert got["q8"].t().is_contiguous()

    def test_quantize_params_treedef_stable(self, model):
        p = _gpt_params(model)
        q1, q2 = quantize_params(p), quantize_params(p)
        assert sorted(q1) == sorted(q2)
        for k in QUANT_WEIGHT_KEYS:
            assert sorted(q1["blocks"][0][k]) == ["q8", "s"]
        # non-matmul leaves ride through untouched
        assert q1["blocks"][0]["qkv_b"] is p["blocks"][0]["qkv_b"]
        assert q1["wte"] is p["wte"]

    def test_int8_matmul_close_to_float(self):
        rng = np.random.RandomState(1)
        x = rng.randn(4, 24).astype(np.float32)
        w = rng.randn(24, 12).astype(np.float32)
        leaf = quantize_weight(_t(w))
        got = int8_matmul(_t(x), leaf["q8"], leaf["s"]).numpy()
        ref = x @ w
        # two abs-max int8 quantizations: relative error ~1e-2
        assert np.abs(got - ref).max() < 0.05 * np.abs(ref).max() + 0.05

    @pytest.mark.parametrize("shape", [(4, 24), (2, 3, 32), (33, 16)])
    def test_int8_matmul_matches_jax(self, shape):
        rng = np.random.RandomState(11)
        x = rng.randn(*shape).astype(np.float32)
        w = rng.randn(shape[-1], 40).astype(np.float32)
        jl = jq.quantize_weight(w)
        want = np.asarray(jq.int8_matmul(jnp.asarray(x), jl["q8"], jl["s"]))
        tl = quantize_weight(_t(w))
        got = int8_matmul(_t(x), tl["q8"], tl["s"]).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())

    def test_quant_config_threading(self):
        cfg = f32_config(quant=QuantConfig(int8_compute=True))
        assert cfg.quant == "int8"
        assert cfg.quant_config is not None
        with pytest.raises(ValueError, match="int8_compute"):
            f32_config(quant=QuantConfig())
        with pytest.raises(ValueError, match="quant"):
            f32_config(quant="bf16")
        # read by name: any object with int8_compute and weight_bits
        four = f32_config(quant=types.SimpleNamespace(int8_compute=True,
                                                      weight_bits=4))
        leaf = build_serving_snapshot(
            {"wte": torch.zeros(2, 2), "blocks": [{"qkv_w": torch.tensor(
                [[1.0, -1.0], [0.5, 0.25]])}]}, four)["blocks"][0]["qkv_w"]
        assert int(leaf["q8"].abs().max()) == 7          # 4-bit codes

    def test_int8_engine_serves_with_pinned_executables(self, pair):
        jm, model = pair
        eng = ServingEngine(model, f32_config(quant="int8")).warmup()
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, V, (L,)).astype(np.int32)
                   for L in (5, 9, 3)]
        outs = eng.generate_tokens(prompts, [6, 5, 4])
        assert [len(o) for o in outs] == [6, 5, 4]
        assert eng.executable_count() == eng.expected_executables
        assert eng.sentinel.fired == 0
        # greedy top-1 agreement against the f32 parity reference
        ref = ServingEngine(model, f32_config())
        routs = ref.generate_tokens(prompts, [6, 5, 4])
        agree = np.mean([t == r for o, ro in zip(outs, routs)
                         for t, r in zip(o, ro)])
        assert agree >= 0.5, f"top-1 agreement collapsed: {agree}"
        # the same codes and activation codes as the JAX int8 engine
        jouts = JaxServingEngine(jm, JaxServingConfig(
            **dict(F32, quant="int8"))).generate_tokens(prompts, [6, 5, 4])
        assert outs == jouts

    def test_logits_drift_receipt_bounds(self, model):
        ids = np.random.RandomState(6).randint(0, V, (4, 8))
        mcfg = model.gpt.config
        rec = logits_drift_receipt(_gpt_params(model),
                                   float(mcfg.layer_norm_eps),
                                   int(mcfg.num_heads), _t(ids).long())
        assert np.isfinite(rec["logit_drift_int8"])
        assert rec["logit_drift_int8"] < 1.0   # tiny-model logit scale
        assert 0.0 <= rec["top1_agreement_last"] <= 1.0

    def test_logits_drift_matches_jax(self, pair):
        """The receipt's int8 drift and top-1 agreement against the JAX
        package's (its logits_drift_receipt's last-logits forward, run
        under jit: the eager one compiles op by op for seconds). bf16
        rounds each framework's own accumulation order (jit and eager
        JAX differ too), so only its scale is held, within 2x."""
        from paddle_tpu.models.generation import _cast_params as jcast
        from paddle_tpu.models.generation import _ln as jln
        from paddle_tpu.models.generation import _prefill as jprefill
        jm, model = pair
        ids = np.random.RandomState(6).randint(0, V, (4, 8))
        mcfg = model.gpt.config
        eps, nh = float(mcfg.layer_norm_eps), int(mcfg.num_heads)
        rec = logits_drift_receipt(_gpt_params(model), eps, nh,
                                   _t(ids).long())

        @jax.jit
        def last(p, ids):
            x, _ = jprefill(p, eps, nh, ids, ids.shape[1])
            h = jln(x[:, -1:], p["lnf_w"], p["lnf_b"], eps)
            return (h[:, 0] @ p["wte"].T).astype(jnp.float32)

        p, jids = jax_gpt_params(jm), jnp.asarray(ids, jnp.int32)
        l32 = np.asarray(last(p, jids))
        l8 = np.asarray(last(jq.quantize_params(p), jids))
        lb = np.asarray(last(jcast(p, "bfloat16"), jids))
        assert rec["logit_drift_int8"] == pytest.approx(
            np.abs(l8 - l32).max(), rel=1e-3, abs=1e-5)
        assert 0.5 <= rec["logit_drift_bf16"] / np.abs(lb - l32).max() <= 2
        assert rec["top1_agreement_last"] == np.mean(
            l8.argmax(-1) == l32.argmax(-1))

    def test_int8_hot_swap_keeps_treedef(self, model):
        eng = ServingEngine(model, f32_config(quant="int8")).warmup()
        ptr = eng.params["blocks"][0]["qkv_w"]["q8"].data_ptr()
        # cast=True re-runs the full snapshot build (int8 included) so
        # the structure matches; a pre-built snapshot swaps in too
        eng.swap_weights(_gpt_params(model), cast=True)
        eng.swap_weights(
            build_serving_snapshot(_gpt_params(model), eng.config),
            cast=False)
        rng = np.random.RandomState(8)
        eng.generate_tokens([rng.randint(0, V, (5,)).astype(np.int32)],
                            [4])
        assert eng.sentinel.fired == 0
        assert eng.params["blocks"][0]["qkv_w"]["q8"].data_ptr() == ptr

    def test_jax_int8_snapshot_converts_both_ways(self, pair):
        """A JAX int8 serving snapshot carried into the port equals the
        port's own int8 snapshot bit for bit, converts back unchanged,
        and serves through swap_weights(cast=False)."""
        jm, model = pair
        for dtype in (None, "bfloat16"):
            cfg = dict(F32, quant="int8", dtype=dtype)
            jsnap = jax_snapshot(jax_gpt_params(jm), JaxServingConfig(**cfg))
            got = load_jax_serving_params(jsnap, device="cpu")
            mine = build_serving_snapshot(_gpt_params(model),
                                          ServingConfig(**cfg))
            for (pa, a), (pb, b) in zip(_flat(got), _flat(mine)):
                assert pa == pb and a.dtype == b.dtype
                assert torch.equal(a, b), pa
            back = serving_params_to_numpy(got)
            for (pa, a), (_, b) in zip(_flat(back), _flat(
                    jax.tree_util.tree_map(np.asarray, jsnap))):
                np.testing.assert_array_equal(a, np.asarray(b, a.dtype),
                                              err_msg=pa)
        eng = ServingEngine(model, f32_config(quant="int8"))
        eng.swap_weights(got if dtype is None else load_jax_serving_params(
            jax_snapshot(jax_gpt_params(jm), JaxServingConfig(
                **dict(F32, quant="int8"))), device="cpu"), cast=False)
        p = np.random.RandomState(12).randint(0, V, (6,)).astype(np.int32)
        assert len(eng.generate_tokens([p], [3])[0]) == 3


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, f"{path}/{i}")]
    return [(path, tree)]


# -- the chunk program --------------------------------------------------------

def _random_pools(rng, n_layers, n_blocks, bs, nh, hd):
    return [tuple(rng.randn(n_blocks, bs, nh, hd).astype(np.float32)
                  for _ in range(2)) for _ in range(n_layers)]


class TestChunkProgram:
    def test_chunk_fn_matches_jax(self, pair):
        """The same pools, tables and windows through the JAX chunk
        program and the port's: every position's argmax and each row's
        pick equal, and the written pools equal at 1e-5 (scratch page 0
        too: positions past lens write there)."""
        jm, tm = pair
        rng = np.random.RandomState(20)
        bs, w, nh, hd = 4, 8, 4, 8
        pools = _random_pools(rng, 2, 32, bs, nh, hd)
        perm = rng.permutation(np.arange(1, 32))
        tables = perm[:3 * w].reshape(3, w).astype(np.int32)
        tables[2, 5:] = 0                 # a short row: padding columns
        toks = rng.randint(0, V, (3, 8)).astype(np.int32)
        starts = np.array([0, 5, 12], np.int32)
        lens = np.array([8, 3, 1], np.int32)
        jrun = jax_chunk_fn(1e-5, nh, bs, 0.0, None, None)
        jp, jall, jpick = jrun(
            tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in pools),
            jnp.asarray(tables), jnp.asarray(toks), jnp.asarray(starts),
            jnp.asarray(lens), jax_gpt_params(jm), jax.random.key(0))
        tp = tuple((_t(k.copy()), _t(v.copy())) for k, v in pools)
        trun = make_chunk_fn(1e-5, nh, bs, 0.0, None, None)
        with torch.no_grad():
            tall, tpick = trun(tp, _t(tables).long(), _t(toks).long(),
                               _t(starts).long(), _t(lens).long(),
                               _gpt_params(tm), None)
        np.testing.assert_array_equal(tall.numpy(), np.asarray(jall))
        np.testing.assert_array_equal(tpick.numpy(), np.asarray(jpick))
        for (jk, jv), (tk, tv) in zip(jp, tp):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       atol=1e-5)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       atol=1e-5)

    def test_verify_argmaxes_equal_sequential_decode(self, model):
        """The chunk's argmax at position q (anchor + q window tokens in
        the cache) equals a decode step at that position, for every q,
        in f32: the per-query causal mask gives each query the decode
        step's support."""
        p = _gpt_params(model)
        nh, bs, w = 4, 4, 8
        rng = np.random.RandomState(21)
        pools = _random_pools(rng, 2, 32, bs, nh, 8)
        tables = rng.permutation(np.arange(1, 32))[:2 * w].reshape(2, w)
        ctx = rng.randint(0, V, (2, 9))
        window = rng.randint(0, V, (2, 5))
        starts = np.array([9, 6])
        dec = make_decode_fn(1e-5, nh, bs, 0.0, None, None)
        seq = tuple((_t(k.copy()), _t(v.copy())) for k, v in pools)
        with torch.no_grad():
            # fill the context through decode steps, then walk the window
            for j in range(9):
                dec(seq, _t(tables), _t(ctx[:, j]), _t(np.full(2, j)), p)
            want = []
            for q in range(window.shape[1]):
                want.append(dec(seq, _t(tables), _t(window[:, q]),
                                _t(starts + q), p)[0].numpy())
            chunk = make_chunk_fn(1e-5, nh, bs, 0.0, None, None)
            par = tuple((_t(k.copy()), _t(v.copy())) for k, v in pools)
            for j in range(9):
                dec(par, _t(tables), _t(ctx[:, j]), _t(np.full(2, j)), p)
            got, pick = chunk(par, _t(tables), _t(window), _t(starts),
                              _t(np.array([5, 5])), p, None)
        np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
        np.testing.assert_array_equal(pick.numpy(), want[-1])


# -- speculative decoding -----------------------------------------------------

def _staggered_spec(eng, prompts):
    rids = [eng.submit(prompts[0], SPEC[0][1])]
    eng.step()
    rids.append(eng.submit(prompts[1], SPEC[1][1]))
    eng.step()
    rids += [eng.submit(prompts[i], SPEC[i][1]) for i in (2, 3)]
    done = {r.rid: r for r in eng.run_to_completion()}
    return [list(done[r].out) for r in rids]


class TestSpeculative:
    def test_bit_identical_to_greedy_and_jax(self, pair, draft_pair):
        """Staggered-admission speculative decode emits exactly the
        non-speculative greedy stream, and the JAX engine's, with
        programs == expected and no sentinel event."""
        (jm, model), (jd, draft) = pair, draft_pair
        eng = ServingEngine(model, f32_config(speculative_k=2),
                            draft_model=draft).warmup()
        rng = np.random.RandomState(2)
        prompts = [rng.randint(0, V, (L,)).astype(np.int32)
                   for L, _ in SPEC]
        got = _staggered_spec(eng, prompts)
        for out, p, (_, n) in zip(got, prompts, SPEC):
            np.testing.assert_array_equal(out, solo_greedy(model, p, n))
        assert eng.executable_count() == eng.expected_executables == 6
        assert eng.sentinel.fired == 0
        eng.cache.check_invariants()
        eng.draft_cache.check_invariants()
        assert eng.draft_cache.n_free == eng.draft_cache.n_blocks - 1
        assert 0 < eng.spec_accepted and eng.spec_proposed > 0
        want = _staggered_spec(JaxServingEngine(
            jm, JaxServingConfig(**dict(F32, speculative_k=2)),
            draft_model=jd), prompts)
        assert got == want

    def test_draft_equals_target_accepts_everything(self, model):
        eng = ServingEngine(model, f32_config(speculative_k=3),
                            draft_model=model).warmup()
        p = np.random.RandomState(4).randint(0, V, (6,)).astype(np.int32)
        outs = eng.generate_tokens([p], [9])
        np.testing.assert_array_equal(outs[0], solo_greedy(model, p, 9))
        # an identical proposer is never rejected: acceptance exactly 1
        assert eng.spec_proposed > 0
        assert eng.spec_accepted == eng.spec_proposed

    def test_validation(self, model, draft):
        with pytest.raises(ValueError, match="draft_model"):
            ServingEngine(model, f32_config(speculative_k=2))
        with pytest.raises(ValueError, match="greedy"):
            f32_config(speculative_k=2, temperature=0.7)
        _, wrong_vocab = _pair(9)
        wrong_vocab.gpt.config.vocab_size = 11
        with pytest.raises(ValueError, match="vocab"):
            ServingEngine(model, f32_config(speculative_k=2),
                          draft_model=wrong_vocab)


# -- COW prefix sharing -------------------------------------------------------

def make_cache(n_blocks=32, block_size=4, cls=PagedKVCache, **kw):
    if cls is PagedKVCache:
        kw["device"] = "cpu"
    return cls(n_layers=2, n_blocks=n_blocks, block_size=block_size,
               n_heads=2, head_dim=4, dtype="float32", **kw)


class TestCowInvariants:
    def test_shared_pages_counted_once_and_survive_free(self):
        c = make_cache(prefix_sharing=True)
        prefix = list(range(1, 13))            # 3 full pages
        c.alloc_shared("a", 16, prefix + [50])
        c.register_prefix("a", prefix + [50])
        c.check_invariants()
        blocks_a = c.table("a")
        _, shared = c.alloc_shared("b", 16, prefix + [60])
        assert shared == 12                    # 3 pages matched
        assert c.table("b")[:3] == blocks_a[:3]
        c.check_invariants()
        assert 1 + c.n_free + c.n_live == c.n_blocks
        assert c.n_shared >= 3
        # the creator dies; the shared pages stay live (b + index hold)
        c.free("a")
        c.check_invariants()
        for p in blocks_a[:3]:
            assert p in c._ref and p not in c._free
        # the last holder dies; the index still holds them (reclaimable)
        c.free("b")
        c.check_invariants()
        for p in blocks_a[:3]:
            assert p in c._ref
        assert c.available_pages == c.n_blocks - 1

    def test_match_capped_one_token_short(self):
        c = make_cache(prefix_sharing=True)
        prompt = list(range(1, 9))             # exactly 2 full pages
        c.alloc_shared("a", 12, prompt)
        c.register_prefix("a", prompt)
        # identical prompt: the match caps at (8-1)//4 = 1 page
        _, shared = c.alloc_shared("b", 12, prompt)
        assert shared == 4
        c.check_invariants()

    def test_churn_conservation(self):
        rng = np.random.RandomState(0)
        c = make_cache(n_blocks=24, prefix_sharing=True)
        prefixes = [list(range(10 * k + 1, 10 * k + 9)) for k in range(3)]
        live = []
        for step in range(120):
            if live and (len(live) > 2 or rng.rand() < 0.4):
                c.free(live.pop(rng.randint(len(live))))
            else:
                rid = f"r{step}"
                prompt = (prefixes[rng.randint(3)]
                          + list(rng.randint(100, 120,
                                             (rng.randint(1, 6),))))
                if c.blocks_for(len(prompt) + 4) > c.available_pages:
                    continue
                c.alloc_shared(rid, len(prompt) + 4, prompt)
                c.register_prefix(rid, prompt)
                live.append(rid)
            c.check_invariants()
            assert 1 + c.n_free + c.n_live == c.n_blocks
        for rid in live:
            c.free(rid)
        c.check_invariants()

    def test_writer_copy_preserves_reader_bytes(self):
        c = make_cache(prefix_sharing=True)
        prefix = list(range(1, 5))             # 1 full page
        c.alloc_shared("a", 8, prefix + [9])
        c.register_prefix("a", prefix + [9])
        _, shared = c.alloc_shared("b", 8, prefix + [7])
        assert shared == 4
        page = c.table("a")[0]
        assert c.table("b")[0] == page
        # stamp recognizable bytes into the shared page, in place
        c.pools[0][0][page] = 3.5
        c.pools[0][1][page] = -2.25
        before = c.pools[0][0][page].clone()
        copies = c.ensure_writable("b", 0, 4)
        assert copies == 1
        new_page = c.table("b")[0]
        assert new_page != page
        assert c.table("a")[0] == page         # reader untouched
        assert torch.equal(c.pools[0][0][page], before)
        assert torch.equal(c.pools[0][0][new_page], before)
        assert bool((c.pools[0][1][new_page] == -2.25).all())
        c.check_invariants()
        assert c.cow_copies == 1 and c.copy_executables() == 1
        # unshared pages need no copy
        assert c.ensure_writable("b", 4, 2) == 0

    def test_index_reclaim_under_pressure(self):
        c = make_cache(n_blocks=8, prefix_sharing=True)  # 7 usable
        c.alloc_shared("a", 12, list(range(1, 13)))      # 3 pages
        c.register_prefix("a", list(range(1, 13)))
        c.free("a")
        assert c.n_free == 4 and c.available_pages == 7
        # a full-pool request forces LRU reclaim of the index pages
        c.alloc_shared("b", 28, list(range(50, 57)))     # 7 pages
        c.check_invariants()
        assert c.reclaimed_pages == 3
        with pytest.raises(MemoryError, match="exhausted"):
            c.alloc("z", 4)

    def test_sharing_disabled_contract_unchanged(self):
        c = make_cache()
        with pytest.raises(RuntimeError, match="prefix_sharing"):
            c.alloc_shared("a", 8, [1, 2, 3, 4, 5])
        assert c.register_prefix("a", [1, 2]) == 0
        assert c.available_pages == c.n_free

    def test_same_operations_same_tables_and_stats_as_jax(self):
        """The port's cache and the JAX package's through one sequence
        of alloc_shared / register_prefix / free / LRU reclaim / COW:
        equal tables, refcounts, free lists and stats at every step (the
        LIFO free list makes the page ids line up)."""
        rng = np.random.RandomState(3)
        caches = [make_cache(n_blocks=20, prefix_sharing=True),
                  make_cache(n_blocks=20, cls=JaxPagedKVCache,
                             prefix_sharing=True)]
        prefixes = [list(range(10 * k + 1, 10 * k + 9)) for k in range(3)]
        live = []
        for step in range(80):
            op = rng.rand()
            if live and (len(live) > 3 or op < 0.35):
                rid = live.pop(rng.randint(len(live)))
                got = [c.free(rid) for c in caches]
            elif live and op < 0.45:
                rid = live[rng.randint(len(live))]
                got = [c.ensure_writable(rid, 0, 8) for c in caches]
            else:
                rid = f"r{step}"
                prompt = (prefixes[rng.randint(3)]
                          + list(rng.randint(100, 110,
                                             (rng.randint(1, 9),))))
                n = len(prompt) + int(rng.randint(1, 8))
                if caches[0].blocks_for(n) > caches[0].available_pages:
                    continue
                got = [c.alloc_shared(rid, n, prompt) for c in caches]
                for c in caches:
                    c.register_prefix(rid, prompt)
                live.append(rid)
            assert got[0] == got[1]
            port, ref = caches
            assert port._free == ref._free and port._ref == ref._ref
            assert {r: port.table(r) for r in live} == \
                {r: ref.table(r) for r in live}
            want = ref.stats()
            want.pop("pool_bytes_per_chip")
            assert port.stats() == want
            port.check_invariants()
        assert caches[0].reclaimed_pages > 0 and caches[0].cow_copies > 0


class TestEngineSharing:
    def test_shared_prefix_parity_and_pages_fall(self, pair):
        """The second request with a cached prefix prefills only its
        suffix and still emits the exact greedy stream, and the JAX
        engine's stream."""
        jm, model = pair
        rng = np.random.RandomState(3)
        prefix = rng.randint(0, V, (8,)).astype(np.int32)  # 2 pages
        tails = [rng.randint(0, V, (3,)).astype(np.int32) for _ in range(3)]
        prompts = [np.concatenate([prefix, t]) for t in tails]

        def drive(eng, running):
            r0 = eng.submit(prompts[0], 5)
            done = {r.rid: r for r in eng.run_to_completion()}
            assert eng.cache.stats()["pages_live"] > 0
            r1 = eng.submit(prompts[1], 5)
            eng.step()
            assert running(eng, r1).shared_tokens == 8
            done.update({r.rid: r for r in eng.run_to_completion()})
            r2 = eng.submit(prompts[2], 5)
            done.update({r.rid: r for r in eng.run_to_completion()})
            return [list(done[r].out) for r in (r0, r1, r2)]

        eng = ServingEngine(model, f32_config(prefix_sharing=True)).warmup()
        got = drive(eng, lambda e, rid: e.sched.running[rid])
        for out, p in zip(got, prompts):
            np.testing.assert_array_equal(out, solo_greedy(model, p, 5))
        st = eng.cache.stats()
        assert st["prefix_hits"] == 2
        assert st["shared_pages_matched"] == 4
        assert eng.executable_count() == eng.expected_executables == 4
        assert eng.sentinel.fired == 0
        eng.cache.check_invariants()
        jeng = JaxServingEngine(jm, JaxServingConfig(
            **dict(F32, prefix_sharing=True)))
        assert drive(jeng, lambda e, rid: e.sched.running[rid]) == got

    def test_sharing_holds_fewer_fresh_pages(self, model):
        rng = np.random.RandomState(13)
        prefix = rng.randint(0, V, (12,)).astype(np.int32)
        p1 = np.concatenate([prefix, rng.randint(0, V, (2,))
                             .astype(np.int32)])
        p2 = np.concatenate([prefix, rng.randint(0, V, (2,))
                             .astype(np.int32)])
        peak = {}
        for name, eng in (
                ("shared", ServingEngine(
                    model, f32_config(prefix_sharing=True)).warmup()),
                ("plain", ServingEngine(model, f32_config()).warmup())):
            # seed the radix index, then hold both live together
            eng.submit(p1, 4)
            eng.run_to_completion()
            eng.submit(p1, 4)
            eng.submit(p2, 4)
            eng.step()                      # both admitted (max_admit=2)
            peak[name] = eng.cache.stats()["pages_live"]
            eng.run_to_completion()
        assert peak["shared"] < peak["plain"]

    def test_speculative_plus_sharing_compose(self, pair, draft_pair):
        (jm, model), (jd, draft) = pair, draft_pair
        eng = ServingEngine(
            model, f32_config(speculative_k=2, prefix_sharing=True,
                              quant=None),
            draft_model=draft).warmup()
        rng = np.random.RandomState(17)
        prefix = rng.randint(0, V, (8,)).astype(np.int32)
        prompts = [np.concatenate([prefix, rng.randint(0, V, (3,))
                                   .astype(np.int32)]) for _ in range(2)]
        outs = eng.generate_tokens(list(prompts), [5, 6])
        for o, p, n in zip(outs, prompts, (5, 6)):
            np.testing.assert_array_equal(o, solo_greedy(model, p, n))
        assert eng.executable_count() == eng.expected_executables
        assert eng.sentinel.fired == 0
        jeng = JaxServingEngine(jm, JaxServingConfig(**dict(
            F32, speculative_k=2, prefix_sharing=True)), draft_model=jd)
        assert jeng.generate_tokens(list(prompts), [5, 6]) == outs

    def test_all_three_levers_compose(self, model, draft):
        """int8 + speculation + sharing in one bf16 engine: streams of
        the right length, programs == expected, every page back."""
        eng = ServingEngine(model, ServingConfig(**dict(
            F32, dtype="bfloat16", quant="int8", speculative_k=2,
            prefix_sharing=True)), draft_model=draft).warmup()
        rng = np.random.RandomState(18)
        prefix = rng.randint(0, V, (8,)).astype(np.int32)
        prompts = [np.concatenate([prefix, rng.randint(0, V, (n,))
                                   .astype(np.int32)]) for n in (2, 5, 3)]
        outs = eng.generate_tokens(prompts, [4, 6, 5])
        assert [len(o) for o in outs] == [4, 6, 5]
        assert eng.executable_count() == eng.expected_executables
        assert eng.sentinel.fired == 0
        assert eng.cache.prefix_hits > 0
        eng.cache.check_invariants()
        assert eng.draft_cache.n_free == eng.draft_cache.n_blocks - 1

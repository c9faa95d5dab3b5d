"""Philox attention dropout of the port (ops/philox.py, the plain twin of
csrc/philox.cuh) and the seed streams of core/generator.py.

The mask is a pure function of (seed, b*n + head, query, key), so it is
checked for what that promises: Random123's known answers, independence
from the blocking, determinism per seed, the kept fraction, p = 0 being
no dropout, and the mean of the output being preserved (after
tests/test_pallas_attention.py's TPU check). It is never compared bit for
bit with JAX: the Pallas interpreter stubs its RNG to zeros.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import philox


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """tier-1 runs several pytest workers on one CPU: torch's default
    thread pool then oversubscribes it and its small ops slow down 20x
    or more, so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b=1, s=64, n=2, h=16, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, s, n, h).astype(np.float32))
            for _ in range(3)]


@pytest.mark.parametrize("word,key,want", [
    (0, 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    (0xFFFFFFFF, 0xFFFFFFFF, (0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                              0x6D5451FD)),
])
def test_random123_known_answers(word, key, want):
    c = torch.tensor([word], dtype=torch.int64)
    got = philox.philox4x32(c, c, c, c, key, key)
    assert tuple(int(w) for w in got) == want


def test_threshold_and_seed_split():
    assert philox.drop_threshold(0.0) == 0
    assert philox.drop_threshold(0.5) == 2 ** 31
    assert philox.drop_threshold(1.0) == 2 ** 32 - 1
    assert philox.split_seed((7 << 32) | 9) == (9, 7)


def test_mask_does_not_depend_on_block_k():
    q, k, v = _qkv(s=80)
    outs = [fa.flash_attention_fwd_plain(q, k, v, block_k=bk, dropout_p=0.3,
                                         seed=11)[0] for bk in (16, 48, 512)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=1e-6, rtol=1e-5)


def test_deterministic_per_seed_and_seed_sensitive():
    q, k, v = _qkv()
    a = fa.flash_attention_mha(q, k, v, dropout_p=0.4, seed=7)
    b = fa.flash_attention_mha(q, k, v, dropout_p=0.4, seed=7)
    c = fa.flash_attention_mha(q, k, v, dropout_p=0.4, seed=8)
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 1e-3
    base = fa.flash_attention_mha(q, k, v)
    assert (a - base).abs().max() > 1e-3


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_kept_fraction(p):
    n = 4 * 512 * 512  # 1,048,576 links
    bh = torch.arange(4)[:, None, None]
    rows = torch.arange(512)[None, :, None]
    cols = torch.arange(512)[None, None, :]
    keep = philox.keep_mask(2024, p, bh, rows, cols)
    assert keep.numel() == n
    assert abs(keep.float().mean().item() - (1 - p)) < 0.01


def test_p_zero_is_no_dropout():
    q, k, v = _qkv(seed=1)
    torch.testing.assert_close(
        fa.flash_attention_mha(q, k, v, causal=True, dropout_p=0.0, seed=3),
        fa.flash_attention_mha(q, k, v, causal=True), atol=0, rtol=0)


def test_mean_preserved():
    """E[dropout output] = the no-dropout output (atol 0.15 over 64
    seeds, as tests/test_pallas_attention.py holds the TPU kernel)."""
    q, k, v = _qkv(s=128, n=1, h=64, seed=2)
    base = fa.flash_attention_mha(q, k, v)
    acc = torch.zeros_like(base)
    for sd in range(64):
        acc += fa.flash_attention_mha(q, k, v, dropout_p=0.3, seed=sd)
    torch.testing.assert_close(acc / 64, base, atol=0.15, rtol=0)


def test_sdpa_and_flash_drop_the_same_links():
    """Under one seed, SDPA-with-dropout (materialized probabilities)
    and the flash dropout tier drop the same links."""
    q, k, v = _qkv(b=2, s=40, seed=3)
    with gen.seed_scope(5):
        a = F.scaled_dot_product_attention(q, k, v, dropout_p=0.25,
                                           is_causal=True, training=True)
    with gen.seed_scope(5):
        b = F.flash_attention(q, k, v, dropout=0.25, causal=True,
                              training=True)
    with gen.seed_scope(5):
        seed = gen.next_seed()
    c = fa.flash_attention_mha(q, k, v, causal=True, dropout_p=0.25,
                               seed=seed)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(b, c, atol=1e-5, rtol=1e-5)


def test_dropout_impl_routing(monkeypatch):
    monkeypatch.delenv("PD_ATTN_DROPOUT_IMPL", raising=False)
    assert F.attention_dropout_impl("cpu") == "blockwise"
    assert F.attention_dropout_impl("cuda") == "kernel"
    monkeypatch.setenv("PD_ATTN_DROPOUT_IMPL", "sdpa")
    assert F.attention_dropout_impl("cpu") == "sdpa"
    # the override picks among the CPU tiers: the card always runs the
    # kernels, and never the plain versions
    assert F.attention_dropout_impl("cuda") == "kernel"
    monkeypatch.setenv("PD_ATTN_DROPOUT_IMPL", "blockwise")
    assert F.attention_dropout_impl("cuda") == "kernel"
    monkeypatch.setenv("PD_ATTN_DROPOUT_IMPL", "sdpa")
    q, k, v = _qkv(seed=4)
    with gen.seed_scope(1):
        out = F.flash_attention(q, k, v, dropout=0.2, training=True)
    assert out.shape == q.shape and torch.isfinite(out).all()
    monkeypatch.setenv("PD_ATTN_DROPOUT_IMPL", "kernal")
    with pytest.raises(ValueError, match="PD_ATTN_DROPOUT_IMPL"):
        F.attention_dropout_impl("cpu")


def test_kv_lens_with_dropout_rides_blockwise():
    q, k, v = _qkv(b=2, s=32, seed=5)
    lens = torch.tensor([32, 9])
    with gen.seed_scope(2):
        a = F.flash_attention(q, k, v, dropout=0.2, training=True,
                              kv_lens=lens, block_size=8)
    with gen.seed_scope(2):
        b = F.flash_attention(q, k, v, dropout=0.2, training=True,
                              kv_lens=lens)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    # keys past a row's length are never attended
    k2 = k.clone()
    k2[1, 9:] = 100.0
    with gen.seed_scope(2):
        c = F.flash_attention(q, k2, v, dropout=0.2, training=True,
                              kv_lens=lens)
    torch.testing.assert_close(c, a, atol=1e-5, rtol=1e-5)


def test_seed_streams():
    pt.seed(3)
    a = [gen.next_seed() for _ in range(3)]
    pt.seed(3)
    assert [gen.next_seed() for _ in range(3)] == a
    assert len(set(a)) == 3 and all(0 <= s < 2 ** 64 for s in a)
    with gen.seed_scope(10) as sc:
        x = [gen.next_seed() for _ in range(2)]
    with gen.seed_scope(10):
        assert [gen.next_seed() for _ in range(2)] == x
    assert sc.counter == 2
    # a scope does not advance the global stream
    pt.seed(3)
    with gen.seed_scope(4):
        gen.next_seed()
    assert gen.next_seed() == a[0]


def test_hidden_dropout_in_a_scope_is_reproducible():
    x = torch.ones(256, 256)
    with gen.seed_scope(6):
        a = F.dropout(x, 0.1)
    with gen.seed_scope(6):
        b = F.dropout(x, 0.1)
    assert torch.equal(a, b)
    assert abs((a == 0).float().mean().item() - 0.1) < 0.01
    torch.testing.assert_close(a.mean(), torch.tensor(1.0), atol=0.02,
                               rtol=0)

"""paddle_tpu_torch's misc and loss_extra ops and SelectedRows against
the JAX package's on the CPU: every case of tests/torch_ops_cases.py's
misc and loss_extra tables (values and the gradients of sum(out * w), f32
at 1e-6 or, for reductions, 1e-5 x max(1, |ref|); integers exact), the
SelectedRows forms on one sequence of calls, and the random ops. JAX's
random bits cannot be matched, so shuffle_batch, nce and sample_logits
are held by what does not depend on them: the permutation's property
and its reproduction from a seed, the samplers' class frequencies
against the log-uniform law (the JAX sampler's too, at 0.01), and every
output downstream of the samples against a numpy evaluation of the
reference formulas on the samples the port drew (1e-5)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.core import selected_rows as jsr
from paddle_tpu.ops import loss_extra as jle
from paddle_tpu.ops import misc_ops as jmo
from paddle_tpu_torch.core import selected_rows as tsr
from paddle_tpu_torch.ops import loss_extra as tle
from paddle_tpu_torch.ops import misc_ops as tmo
from torch_ops_cases import by_module
from torch_ops_parity import check_case


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.mark.parametrize("case", by_module("misc") + by_module("loss_extra"),
                         ids=str)
def test_misc_and_loss_op_equals_jax(case):
    check_case(case)


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


RNG = np.random.RandomState(11)
ROWS = np.array([4, 1, 4, 7, 1, 0], np.int64)
VALS = RNG.randn(6, 3).astype(np.float32)


def test_selected_rows_against_jax():
    j = jsr.SelectedRows(ROWS, VALS, 9)
    t = tsr.SelectedRows(torch.from_numpy(ROWS), torch.from_numpy(VALS), 9)
    assert t.shape == j.shape == (9, 3) and t.rows.dtype == torch.int32
    np.testing.assert_allclose(t.to_dense().numpy(), _np(j.to_dense()),
                               rtol=1e-6, atol=1e-6)
    jm, tm = jsr.merge_selected_rows(j), tsr.merge_selected_rows(t)
    np.testing.assert_array_equal(tm.rows.numpy(), _np(jm.rows))
    np.testing.assert_allclose(tm.value.numpy(), _np(jm.value), rtol=1e-6,
                               atol=1e-6)
    ids = RNG.randint(0, 5, (2, 3))
    g = RNG.randn(2, 3, 4).astype(np.float32)
    je = jsr.embedding_grad_rows(ids, g, 5)
    te = tsr.embedding_grad_rows(torch.from_numpy(ids), torch.from_numpy(g),
                                 5)
    np.testing.assert_allclose(te.to_dense().numpy(), _np(je.to_dense()),
                               rtol=1e-6, atol=1e-6)
    p = RNG.randn(5, 4).astype(np.float32)
    v = RNG.randn(5, 4).astype(np.float32)
    for vel in (None, v):
        jp_, jv = jsr.sparse_row_update(p, je, 0.1, vel, 0.9)
        tp, tv = tsr.sparse_row_update(
            torch.from_numpy(p), te, 0.1,
            None if vel is None else torch.from_numpy(vel), 0.9)
        np.testing.assert_allclose(tp.numpy(), _np(jp_), rtol=1e-6,
                                   atol=1e-6)
        if vel is not None:
            np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-6,
                                       atol=1e-6)
    # the PS shard split and the value slab
    js = jmo.split_selected_rows(j, [3, 4, 2])
    ts = tmo.split_selected_rows(t, [3, 4, 2])
    for a, b in zip(ts, js):
        assert a.height == b.height
        np.testing.assert_array_equal(a.rows.numpy(), _np(b.rows))
        np.testing.assert_array_equal(a.value.numpy(), _np(b.value))
    assert tmo.get_tensor_from_selected_rows(t) is t.value
    assert "nnz_rows=6" in repr(t)


def test_shuffle_batch_is_a_seeded_permutation():
    x = torch.arange(40.0).reshape(20, 2)
    out, perm = tmo.shuffle_batch(x, seed=3)
    assert perm.dtype == torch.int32
    assert sorted(perm.tolist()) == list(range(20))
    assert torch.equal(out, x[perm.long()])
    assert torch.equal(tmo.shuffle_batch(x, seed=3)[1], perm)
    pt.seed(5)
    a = tmo.shuffle_batch(x)[1]
    pt.seed(5)
    assert torch.equal(tmo.shuffle_batch(x)[1], a)
    jout, jperm = jmo.shuffle_batch(jp.to_tensor(x.numpy()), seed=3)
    assert sorted(_np(jperm).tolist()) == list(range(20))


N_CLASSES = 20


def _law(n):
    c = np.arange(n)
    return np.log1p(1.0 / (c + 1.0)) / np.log(n + 1.0)


def _freq(samples, n):
    return np.bincount(np.asarray(samples).ravel(), minlength=n) / \
        np.asarray(samples).size


def _nce_reference(x, w, b, samples, k, q, n):
    logits = np.einsum("bd,bkd->bk", x, w[samples]) + b[samples]
    o = 1.0 / (1.0 + np.exp(-logits))
    kq = k * q
    cost = -np.log(o[:, :1] / (o[:, :1] + kq[:, :1]) + 1e-12).sum(1) \
        - np.log(kq[:, 1:] / (o[:, 1:] + kq[:, 1:]) + 1e-12).sum(1)
    return logits, cost[:, None]


@pytest.mark.parametrize("sampler", ["log_uniform", "uniform"])
def test_nce_samples_and_cost(sampler):
    bsz, d, k = 2000, 4, 10
    x = RNG.randn(bsz, d).astype(np.float32)
    w = RNG.randn(N_CLASSES, d).astype(np.float32)
    b = RNG.randn(N_CLASSES).astype(np.float32)
    label = RNG.randint(0, N_CLASSES, (bsz, 1))
    cost, logits, samples = tle.nce(
        torch.from_numpy(x), torch.from_numpy(label), torch.from_numpy(w),
        torch.from_numpy(b), num_total_classes=N_CLASSES, num_neg_samples=k,
        seed=1, sampler=sampler)
    s = samples.numpy()
    np.testing.assert_array_equal(s[:, 0], label[:, 0])
    law = _law(N_CLASSES) if sampler == "log_uniform" else \
        np.full(N_CLASSES, 1.0 / N_CLASSES)
    assert np.abs(_freq(s[:, 1:], N_CLASSES) - law).max() < 0.01
    _, _, js = jle.nce(jp.to_tensor(x), jp.to_tensor(label), jp.to_tensor(w),
                       jp.to_tensor(b), num_total_classes=N_CLASSES,
                       num_neg_samples=k, seed=1, sampler=sampler)
    assert np.abs(_freq(_np(js)[:, 1:], N_CLASSES) - law).max() < 0.01
    q = law[s] if sampler == "log_uniform" else np.full(s.shape,
                                                        1.0 / N_CLASSES)
    ref_logits, ref_cost = _nce_reference(x, w, b, s, k, q, N_CLASSES)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(cost.numpy(), ref_cost, rtol=1e-5, atol=1e-5)
    again = tle.nce(torch.from_numpy(x), torch.from_numpy(label),
                    torch.from_numpy(w), torch.from_numpy(b),
                    num_total_classes=N_CLASSES, num_neg_samples=k, seed=1,
                    sampler=sampler)[2]
    assert torch.equal(again, samples)


def test_sample_logits_samples_and_outputs():
    bsz, nt, ns = 1500, 2, 12
    logits = RNG.randn(bsz, N_CLASSES).astype(np.float32)
    label = np.stack([RNG.choice(N_CLASSES, nt, replace=False)
                      for _ in range(bsz)])
    samples, probs, sampled, slabel = tle.sample_logits(
        torch.from_numpy(logits), torch.from_numpy(label), num_samples=ns,
        seed=2)
    s = samples.numpy()
    np.testing.assert_array_equal(s[:, :nt], label)
    law = _law(N_CLASSES)
    assert np.abs(_freq(s[:, nt:], N_CLASSES) - law).max() < 0.01
    js = _np(jle.sample_logits(jp.to_tensor(logits), jp.to_tensor(label),
                               num_samples=ns, seed=2)[0])
    assert np.abs(_freq(js[:, nt:], N_CLASSES) - law).max() < 0.01
    np.testing.assert_allclose(probs.numpy(), law[s], rtol=1e-5)
    ref = np.take_along_axis(logits, s, 1) - np.log(law[s] + 1e-12)
    hit = (s[:, None, nt:] == label[:, :, None]).any(1)
    ref[:, nt:] += np.where(hit, -1e20, 0.0)
    np.testing.assert_allclose(sampled.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert hit.any()
    np.testing.assert_array_equal(slabel.numpy(),
                                  np.broadcast_to(np.arange(nt), (bsz, nt)))

"""paddle_tpu_torch's extras and amp_ops against the JAX package's on the
CPU: every case of tests/torch_ops_cases.py's extras and amp_ops tables
(values and the gradients of sum(out * w), f32 at 1e-6 or 1e-5 x max(1,
|ref|), integers and bools exact); linear_chain_crf and viterbi_decode
against brute force over every tag path at T <= 5, N <= 4 (the nll, its
gradients by finite differences of the brute force at 1e-3, the best
path and its score); the gradients of the ops that take a list of
tensors (the JAX registry takes none through a list: held here against
the same function written with torch indexing, exactly); poisson's
moments."""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from torch_ops_cases import by_module
from torch_ops_parity import check_case


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.mark.parametrize("case", by_module("extras") + by_module("amp_ops"),
                         ids=str)
def test_extras_op_equals_jax(case):
    check_case(case)


def _path_score(em, tr, path, n_len):
    start, stop, pair = tr[0], tr[1], tr[2:]
    s = start[path[0]] + stop[path[n_len - 1]]
    s += sum(em[t, path[t]] for t in range(n_len))
    s += sum(pair[path[t - 1], path[t]] for t in range(1, n_len))
    return s


def _brute(em, tr, n_len):
    """(log Z, best score, best path) over every path of n_len tags."""
    n = em.shape[1]
    paths = list(itertools.product(range(n), repeat=n_len))
    scores = np.array([_path_score(em, tr, p, n_len) for p in paths])
    m = scores.max()
    return (m + np.log(np.exp(scores - m).sum()), m,
            paths[int(np.argmax(scores))])


@pytest.mark.parametrize("t,n", [(5, 3), (4, 4), (3, 2)])
def test_crf_and_viterbi_against_brute_force(t, n):
    rng = np.random.RandomState(t * 10 + n)
    b = 3
    em = rng.randn(b, t, n)
    tr = rng.randn(n + 2, n)
    lab = rng.randint(0, n, (b, t))
    lens = np.array([t, max(1, t - 2), 1])
    emt = torch.from_numpy(em).requires_grad_(True)
    trt = torch.from_numpy(tr).requires_grad_(True)
    nll = pt.linear_chain_crf(emt, trt, torch.from_numpy(lab),
                              torch.from_numpy(lens))
    scores, paths = pt.viterbi_decode(emt.detach(), trt.detach(),
                                      torch.from_numpy(lens))
    for i in range(b):
        k = int(lens[i])
        logz, best, path = _brute(em[i], tr, k)
        gold = _path_score(em[i], tr, lab[i], k)
        assert float(nll[i].detach()) == pytest.approx(logz - gold, rel=1e-9,
                                              abs=1e-9)
        assert float(scores[i]) == pytest.approx(best, rel=1e-9, abs=1e-9)
        assert paths[i, :k].tolist() == list(path)
        assert set(paths[i, k:].tolist()) <= {path[-1]}
    # the gradient of sum(nll) against central differences of the brute
    # force (float64)
    nll.sum().backward()

    def total(e, r):
        return sum(_brute(e[i], r, int(lens[i]))[0]
                   - _path_score(e[i], r, lab[i], int(lens[i]))
                   for i in range(b))
    h = 1e-6
    for (idx, grad, arr, is_em) in ((np.unravel_index(5, em.shape),
                                     emt.grad, em, True),
                                    ((2, 1), trt.grad, tr, False),
                                    ((0, n - 1), trt.grad, tr, False)):
        up, dn = arr.copy(), arr.copy()
        up[idx] += h
        dn[idx] -= h
        fd = ((total(up, tr) - total(dn, tr)) if is_em else
              (total(em, up) - total(em, dn))) / (2 * h)
        assert float(grad[idx]) == pytest.approx(fd, abs=1e-3)


def test_viterbi_without_bos_eos_rows():
    rng = np.random.RandomState(3)
    em, tr = rng.randn(2, 4, 3), rng.randn(3, 3)
    scores, paths = pt.viterbi_decode(torch.from_numpy(em),
                                      torch.from_numpy(tr),
                                      include_bos_eos_tag=False)
    full = np.concatenate([np.zeros((2, 3)), tr])
    for i in range(2):
        _, best, path = _brute(em[i], full, 4)
        assert float(scores[i]) == pytest.approx(best)
        assert paths[i].tolist() == list(path)


def _leaf_grads(fn, inputs, w):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out = fn(ts)
    (out * w).sum().backward()
    return out.detach(), [t.grad for t in ts]


def test_list_input_gradients():
    rng = np.random.RandomState(4)
    # multiplex: out[i] = inputs[index[i]][i]
    xs = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    idx = np.array([2, 0, 1, 2])
    w = torch.from_numpy(rng.randn(4, 3).astype(np.float32))
    out, grads = _leaf_grads(
        lambda ts: pt.multiplex(ts, torch.from_numpy(idx[:, None])), xs, w)
    ref, rgrads = _leaf_grads(
        lambda ts: torch.stack(ts)[torch.from_numpy(idx), torch.arange(4)],
        xs, w)
    assert torch.equal(out, ref)
    for g, r in zip(grads, rgrads):
        assert torch.equal(g, r)
    # block_diag
    ms = [rng.randn(2, 2).astype(np.float32), rng.randn(1, 3).astype(
        np.float32)]
    w = torch.from_numpy(rng.randn(3, 5).astype(np.float32))
    out, grads = _leaf_grads(pt.block_diag, ms, w)
    assert torch.equal(grads[0], w[:2, :2]) and torch.equal(grads[1],
                                                            w[2:, 2:])
    # sequence_concat: each valid step lands at its packed position
    xs = [rng.randn(2, 3, 2).astype(np.float32),
          rng.randn(2, 4, 2).astype(np.float32)]
    lens = [torch.tensor([1, 3]), torch.tensor([4, 2])]
    w = torch.from_numpy(rng.randn(2, 7, 2).astype(np.float32))
    out, grads = _leaf_grads(lambda ts: pt.sequence_concat(ts, lens)[0],
                             xs, w)
    for row, (a, c) in enumerate(((1, 4), (3, 2))):
        assert torch.equal(out[row, :a], torch.from_numpy(xs[0][row, :a]))
        assert torch.equal(out[row, a:a + c], torch.from_numpy(
            xs[1][row, :c]))
        assert torch.equal(grads[0][row, :a], w[row, :a])
        assert torch.equal(grads[0][row, a:], torch.zeros(3 - a, 2))
        assert torch.equal(grads[1][row, :c], w[row, a:a + c])


def test_poisson_moments():
    lam = torch.full((20000,), 3.5)
    pt.seed(0)
    x = pt.poisson(lam)
    assert x.dtype == torch.float32 and torch.all(x == x.round())
    assert abs(float(x.mean()) - 3.5) < 0.05
    assert abs(float(x.var()) - 3.5) < 0.15
    pt.seed(9)
    a = pt.poisson(lam[:10])
    pt.seed(9)
    assert torch.equal(pt.poisson(lam[:10]), a)

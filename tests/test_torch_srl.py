"""The CoNLL-2005 semantic-role labeller of chip_smoke.py (the book's
db-LSTM + linear-chain CRF, srl_model) at a tiny size (SRL_TINY: depth
2, hidden 32, word_dim 8) on the CPU: the JAX model built from the JAX
package's layers, its weights carried across by name, the same batches
of paddle.text.Conll05st through both packages' TrainStep for four SGD
steps (losses at 1e-5 relative, the trained parameters at 1e-5
absolute); Viterbi decoding of the trained model against the JAX op
(scores 1e-5, paths equal); and the decode gate's helpers against brute
force (viterbi_top2's two best scores, srl_path_score) and on a planted
disagreement."""
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.static import TrainStep as JaxTrainStep
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.static import TrainStep

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH = 4, 10


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_srl",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _jax_batch(fields, lengths, lo, hi):
    def make(a):
        return jp.to_tensor(a.astype(np.int32))
    length = make(lengths[lo:hi])
    return (tuple(make(f[lo:hi]) for f in fields[:8]) + (length,),
            (make(fields[8][lo:hi]), length))


def test_tiny_srl_trainstep_matches_jax(cs):
    fields, lengths = cs.srl_arrays(np, pt.text.Conll05st(mode="train"))
    jp.seed(3)
    jm = cs.srl_model(jp, **cs.SRL_TINY)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = cs.srl_model(pt, **cs.SRL_TINY)
    load_jax_params(tm, state)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(p.shape)) for p in jm.parameters())
    jstep = JaxTrainStep(jm, cs.srl_loss(jp), jp.optimizer.SGD(
        learning_rate=cs.SRL_LR, parameters=jm.parameters()))
    tstep = TrainStep(tm, cs.srl_loss(pt), pt.optimizer.SGD(
        learning_rate=cs.SRL_LR, parameters=tm.parameters()))
    jl, tl = [], []
    for i in range(STEPS):
        lo, hi = i * BATCH, (i + 1) * BATCH
        jl.append(float(jstep(*_jax_batch(fields, lengths, lo, hi)).numpy()))
        tl.append(tstep(*cs.srl_batch(fields, lengths, lo, hi,
                                      torch.from_numpy)).item())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    own = dict(tstep.layer.named_parameters())
    for name, arr in jstep.params.items():
        np.testing.assert_allclose(own[name].detach().numpy(),
                                   np.asarray(arr), atol=1e-5, rtol=0,
                                   err_msg=name)
    # the trained model decoded by both packages
    tm.eval()
    tf, tlen = cs.srl_arrays(np, pt.text.Conll05st(mode="test"))
    with torch.no_grad():
        x, _ = cs.srl_batch(tf, tlen, 0, 16, torch.from_numpy)
        em, trans = tm(*x)
        scores, paths = pt.viterbi_decode(em, trans, x[-1])
    js, jpaths = jp.viterbi_decode(jp.to_tensor(em.numpy()),
                                   jp.to_tensor(trans.numpy()),
                                   jp.to_tensor(tlen[:16].astype(np.int32)))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js.numpy()),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(jpaths.numpy()))


def _all_scores(cs, em, trans, n):
    return sorted((cs.srl_path_score(np, em, trans, p, n)
                   for p in itertools.product(range(em.shape[1]), repeat=n)),
                  reverse=True)


@pytest.mark.parametrize("n,k", [(4, 3), (5, 2), (1, 4)])
def test_viterbi_top2_against_brute_force(cs, n, k):
    rng = np.random.RandomState(n * 7 + k)
    em, trans = rng.randn(n, k), rng.randn(k + 2, k)
    best, second = cs.viterbi_top2(np, em, trans, n)
    want = _all_scores(cs, em, trans, n)
    assert best == pytest.approx(want[0]) and second == pytest.approx(
        want[1])


def test_decode_agreement_flags_a_path_outside_the_ties(cs):
    rng = np.random.RandomState(1)
    b, t, k = 4, 5, 3
    em, trans = rng.randn(b, t, k), rng.randn(k + 2, k)
    lens = np.array([5, 5, 3, 5])
    s, p = pt.viterbi_decode(torch.from_numpy(em), torch.from_numpy(trans),
                             torch.from_numpy(lens))
    s, p = s.numpy(), p.numpy()
    same = cs.srl_decode_agreement(np, (s, p), (s, p), trans, em, lens)
    assert same["differ_outside_ties"] == [] and same["rescore_off"] == []
    assert same["gap"] == 0.0 and same["sentences"] == b
    bad = p.copy()
    bad[2, 0] = (bad[2, 0] + 1) % k
    out = cs.srl_decode_agreement(np, (s, bad), (s, p), trans, em, lens)
    assert out["paths_differ"] == [2] and out["differ_outside_ties"] == [2]
    assert 2 in out["rescore_off"]

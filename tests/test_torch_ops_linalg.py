"""paddle_tpu_torch's linalg ops and einsum against the JAX package's on
the CPU: every case of tests/torch_ops_cases.py's linalg table (values
and the gradients of sum(out * w); products and decompositions at 1e-5
x max(1, |ref|), integers exact), and the decompositions whose factors
are unique only up to signs or phases (svd, qr, eig, eigh, eigvals),
held by what is unique: the singular values and eigenvalues against
the JAX package's at 1e-5, the factors' reconstruction of the input and
their orthonormality at 1e-5. Also the paddle.linalg namespace (its
names are the JAX one's; linalg.cond is the condition number, the
top-level cond the control-flow op)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from torch_ops_cases import by_module
from torch_ops_parity import check_case

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.mark.parametrize("case", by_module("linalg"), ids=str)
def test_linalg_op_equals_jax(case):
    check_case(case)


def _mat(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape,full", [((4, 3), False), ((3, 5), False),
                                        ((2, 4, 3), False), ((4, 3), True)])
def test_svd_values_and_reconstruction(shape, full):
    a = _mat(*shape, seed=1)
    u, s, v = pt.svd(torch.from_numpy(a), full_matrices=full)
    _, js, _ = jp.svd(jp.to_tensor(a), full_matrices=full)
    _close(s.numpy(), js.numpy())
    k = s.shape[-1]
    rec = (u[..., :, :k] * s[..., None, :]) @ v[..., :, :k].transpose(-1, -2)
    _close(rec.numpy(), a)
    k_u = u.shape[-1]
    eye = np.broadcast_to(np.eye(k_u), u.shape[:-2] + (k_u, k_u))
    _close((u.transpose(-1, -2) @ u).numpy(), eye)


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr(mode):
    a = _mat(5, 3, seed=2)
    got = pt.qr(torch.from_numpy(a), mode=mode)
    want = jp.qr(jp.to_tensor(a), mode=mode)
    if mode == "r":
        # R is unique up to the signs of its rows
        _close(np.abs(got.numpy()), np.abs(want.numpy()))
        return
    q, r = got
    assert tuple(q.shape) == tuple(want[0].shape)
    assert tuple(r.shape) == tuple(want[1].shape)
    _close((q @ r).numpy(), a)
    _close((q.T @ q).numpy(), np.eye(q.shape[1]))
    _close(np.abs(r.numpy()), np.abs(want[1].numpy()))


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_eigh(uplo):
    a = _mat(4, 4, seed=3)
    a = a @ a.T + np.eye(4, dtype=np.float32)
    w, v = pt.eigh(torch.from_numpy(a), UPLO=uplo)
    jw, _ = jp.eigh(jp.to_tensor(a), UPLO=uplo)
    _close(w.numpy(), jw.numpy(), 1e-4)
    _close((v @ torch.diag(w) @ v.T).numpy(), a, 1e-4)


def test_eig_and_eigvals():
    a = _mat(4, 4, seed=4)
    w, v = pt.eig(torch.from_numpy(a))
    jw = np.asarray(jp.eigvals(jp.to_tensor(a)).numpy())
    _close(np.sort_complex(w.numpy()), np.sort_complex(jw), 1e-4)
    _close(np.sort_complex(pt.eigvals(torch.from_numpy(a)).numpy()),
           np.sort_complex(jw), 1e-4)
    # A v = v diag(w)
    av = torch.from_numpy(a).to(torch.complex64) @ v
    _close(av.numpy(), (v * w[None, :]).numpy(), 1e-4)


def test_linalg_namespace_is_the_jax_one():
    import paddle_tpu.linalg as jl
    assert sorted(pt.linalg.__all__) == sorted(jl.__all__)
    for n in pt.linalg.__all__:
        assert callable(getattr(pt.linalg, n)), n
    # cond: the top-level one is control flow, linalg's the condition
    a = _mat(3, 3, seed=5) + 3 * np.eye(3, dtype=np.float32)
    _close(pt.linalg.cond(torch.from_numpy(a)).numpy(),
           jp.linalg.cond(jp.to_tensor(a)).numpy())
    assert pt.cond is pt.ops.control_flow.cond
    assert torch.from_numpy(a).cond().item() == pytest.approx(
        float(pt.linalg.cond(torch.from_numpy(a))))


def test_norm_of_three_dims_over_no_axis_raises():
    with pytest.raises(ValueError):
        pt.norm(torch.ones(2, 2, 2), p=2)

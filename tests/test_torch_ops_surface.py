"""paddle_tpu_torch's top-level surface against the JAX package's:

- coverage: every name of the six op modules' __all__
  (paddle_tpu/ops/{creation,math,manipulation,logic,search,stat}.py) is
  reachable at the port's top level and has a parity case in
  tests/torch_ops_cases.py, or is a random op with a statistical test
  here (shape, dtype, device, range, moments, and paddle.seed
  reproducing it; JAX's PRNG bits cannot be matched);
- the exports: every public top-level name of paddle_tpu whose object
  the port defines in one of its modules is reachable at the top level;
- the op library's second half: every name in the __all__ of the JAX
  package's amp_ops, einsum, linalg (and paddle.linalg), control_flow,
  tensor_array, sequence, misc_ops, loss_extra, extras, text and
  core/selected_rows is reachable in the port at the JAX package's path
  (the top level where the JAX one has it) and is held against the JAX
  package by a case of tests/torch_ops_cases.py or by the test named in
  HELD_ELSEWHERE;
- the Tensor decision (ops/__init__.py): the op names torch.Tensor
  already has are exactly COLLISIONS and SAME_AS_TORCH, none of torch's
  attributes is replaced, the added methods are those torch lacks, and
  stop_gradient round-trips;
- paddle.grad against paddle_tpu.grad: first order, create_graph's
  second order, allow_unused, no_grad_vars, grad_outputs (f32, 1e-6);
- enable_static switches the static mode on and disable_static off.
"""
import importlib
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.ops import creation, logic, manipulation, math, search, stat
from torch_ops_cases import CASES, RANDOM

REPO = Path(__file__).resolve().parents[1]
SIX = (creation, math, manipulation, logic, search, stat)
NAMES = sorted({n for m in SIX for n in m.__all__})

#: names the port's modules define that are other objects than the JAX
#: package's top-level ones of the same name (not exported)
HOMONYMS = {
    "annotations": "the __future__ feature every module imports",
    "utils": "distributed.fleet.utils; paddle_tpu.utils is item 18.6",
    "compat": "static.compat and jit.compat, the static and jit "
              "compatibility layers; paddle_tpu.compat is the JAX "
              "package's top-level compat module, not ported",
    "sigmoid_focal_loss": "nn.functional's (logit, label, normalizer, "
                          "...) loss; paddle_tpu.sigmoid_focal_loss is "
                          "ops/detection.py's (x, label, fg_num), not "
                          "ported",
}


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


#: the second half's names held by a test of their own (not a case of
#: the parity table), with that test
HELD_ELSEWHERE = {
    **{n: "test_torch_ops_linalg.py (values unique up to signs)"
       for n in ("svd", "qr", "eig", "eigh", "eigvals")},
    **{n: "test_torch_control_flow.py" for n in (
        "cond", "while_loop", "bounded_while_loop", "case", "switch_case",
        "scan", "fori_loop")},
    **{n: "test_torch_ops_sequence.py" for n in (
        "TensorArray", "write_to_array", "read_from_array", "array_write",
        "array_read", "array_length", "tensor_array_to_tensor",
        "create_array")},
    **{n: "test_torch_ops_misc_loss.py" for n in (
        "shuffle_batch", "nce", "split_selected_rows",
        "get_tensor_from_selected_rows", "SelectedRows",
        "embedding_grad_rows", "merge_selected_rows", "sparse_row_update")},
    "poisson": "test_torch_ops_extras.py (moments)",
    "max_unpool2d": "test_torch_nn_functional_rest.py",
    **{n: "test_torch_text.py" for n in (
        "Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing", "WMT14",
        "WMT16")},
}


def _second_half():
    """[(JAX module, its dotted path below the package)]."""
    import importlib
    paths = ("ops.amp_ops", "ops.einsum", "ops.linalg", "linalg",
             "ops.control_flow", "ops.tensor_array", "ops.sequence",
             "ops.misc_ops", "ops.loss_extra", "ops.extras", "text",
             "core.selected_rows")
    return [(importlib.import_module("paddle_tpu." + p), p) for p in paths]


def test_second_half_names_are_at_the_jax_paths_and_held():
    import functools
    cased = {c.fn.split(".")[-1] for c in CASES}
    unheld, misplaced = [], []
    for mod, path in _second_half():
        for n in mod.__all__:
            if hasattr(jp, n) and not hasattr(pt, n):
                misplaced.append(f"{n} (top level)")
            port_mod = functools.reduce(getattr, path.split("."), pt) \
                if path != "ops.einsum" else pt.ops
            if not hasattr(port_mod, n):
                misplaced.append(f"{path}.{n}")
            if n not in cased and n not in HELD_ELSEWHERE:
                unheld.append(f"{path}.{n}")
    assert misplaced == [] and unheld == []


def test_every_op_is_exported_and_has_a_case():
    cased = {c.fn for c in CASES} | set(RANDOM)
    assert [n for n in NAMES if not hasattr(pt, n)] == []
    assert [n for n in NAMES if n not in cased] == []
    for n in ("reshape_", "squeeze_", "unsqueeze_", "scatter_", "tanh_"):
        assert n in cased and callable(getattr(pt, n)), n


def _port_defined():
    """Every public name bound in a module of the port."""
    names = set()
    for info in pkgutil.walk_packages(pt.__path__, "paddle_tpu_torch."):
        mod = importlib.import_module(info.name)
        names |= {n for n in vars(mod) if not n.startswith("_")}
    return names


def test_ported_top_level_names_are_exported():
    want = {n for n in dir(jp) if not n.startswith("_")}
    missing = sorted(n for n in want & _port_defined()
                     if not hasattr(pt, n) and n not in HOMONYMS)
    assert missing == []
    for n in ("save", "load", "DataParallel", "summary", "nms",
              "multiclass_nms", "matrix_nms", "yolo_box", "yolov3_loss",
              "box_coder", "box_clip", "iou_similarity", "one_hot", "tanh",
              "tanh_", "beam_search_step", "gather_tree", "callbacks",
              "grad", "batch", "ParamAttr", "regularizer", "tensor"):
        assert hasattr(pt, n), n
    # ops.nms stays the kernel's module; the top-level nms is the op
    assert pt.nms is pt.ops.detection.nms
    assert pt.ops.nms.__name__ == "paddle_tpu_torch.ops.nms"


def test_tensor_surface_is_additive():
    """In a fresh interpreter: the six modules' names torch.Tensor had
    before the port was imported are COLLISIONS plus SAME_AS_TORCH;
    after the import each of them, and every operator, is the very
    attribute torch had; the methods added are the others."""
    code = (
        "import inspect, json, torch\n"
        "get = lambda n: inspect.getattr_static(torch.Tensor, n)\n"
        "before = {n: get(n) for n in dir(torch.Tensor)}\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch import ops\n"
        "names = sorted({n for m in ops.SURFACE for n in m.__all__})\n"
        "changed = [n for n, v in before.items() if get(n) is not v]\n"
        "print(json.dumps({'had': [n for n in names if n in before], "
        "'names': names, 'changed': changed, "
        "'added': pt.framework.SURFACE_ADDED + ops.METHODS_ADDED, 'coll': sorted(ops.COLLISIONS), "
        "'same': sorted(ops.SAME_AS_TORCH)}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert r["changed"] == []
    assert not set(r["coll"]) & set(r["same"])
    assert sorted(set(r["coll"]) | set(r["same"])) == sorted(r["had"])
    not_methods = {"create_parameter", "broadcast_tensors",
                   "set_printoptions", "broadcast_shape"}
    want_added = set(r["names"]) - set(r["had"]) - not_methods
    assert want_added <= set(r["added"])
    # and x.cond(), linalg's condition number, as the JAX package sets it
    assert set(r["added"]) - want_added == {
        "stop_gradient", "astype", "cast", "clear_gradient", "clear_grad",
        "set_value", "place", "rank", "gradient", "scale_", "reshape_",
        "cond"} - set(r["had"]) - want_added


def test_collisions_keep_torch_and_the_functions_are_paddle():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert [t.shape for t in x.split(2, dim=2)] == [(2, 3, 2)] * 2
    assert [tuple(t.shape) for t in pt.split(x, 2, axis=2)] == \
        [(2, 3, 2)] * 2
    assert tuple(pt.transpose(x, [2, 0, 1]).shape) == (4, 2, 3)
    assert tuple(x.transpose(0, 1).shape) == (3, 2, 4)
    assert isinstance(x.max(1), tuple) and not isinstance(pt.max(x, 1),
                                                          tuple)
    assert tuple(pt.reshape(x, [0, -1]).shape) == (2, 12)
    assert pt.view(x, "int32").dtype == torch.int32
    assert torch.equal(pt.view(x, "int32"), x.to(torch.int32))
    assert x.scale(2.0).equal(x * 2.0)
    assert torch.equal(x.mod(5.0), pt.mod(x, 5.0))
    assert torch.equal(x.greater_than(x - 1), torch.ones_like(x, dtype=bool))


def test_tensor_methods_and_stop_gradient_round_trip():
    x = pt.to_tensor(np.ones((2, 3), np.float32))
    assert x.stop_gradient
    x.stop_gradient = False
    assert x.requires_grad and x.is_leaf
    (x * 3.0).sum().backward()
    assert torch.equal(x.grad, torch.full((2, 3), 3.0))
    x.clear_gradient(set_to_zero=True)
    assert torch.equal(x.grad, torch.zeros(2, 3))
    x.clear_gradient()
    assert x.grad is None
    y = x * 2.0
    y.stop_gradient = True
    assert not y.requires_grad and y.is_leaf
    assert x.astype("int32").dtype == torch.int32
    assert x.cast("float64").dtype == torch.float64
    assert isinstance(x.place, pt.CPUPlace)
    assert int(x.rank()) == 2
    z = pt.zeros([2, 3])
    z.set_value(np.full((2, 3), 5.0))
    assert torch.equal(z, torch.full((2, 3), 5.0))
    with pytest.raises(ValueError):
        z.set_value(np.zeros(3))


def test_grad_modes():
    with pt.no_grad():
        assert not pt.is_grad_enabled()
        with pt.enable_grad():
            assert pt.is_grad_enabled()
    with pt.set_grad_enabled(False):
        assert not pt.is_grad_enabled()
    assert pt.is_grad_enabled() and pt.in_dygraph_mode()
    from paddle_tpu_torch.static import program
    assert not program._static_mode
    pt.enable_static()
    try:
        assert program._static_mode
    finally:
        pt.disable_static()
    assert not program._static_mode


# -- the random ops ----------------------------------------------------------------

N = 20000


def _seeded(fn):
    """fn() twice under paddle.seed(5), once under seed(6)."""
    pt.seed(5)
    a = fn()
    pt.seed(5)
    b = fn()
    pt.seed(6)
    c = fn()
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.device.type == "cpu"
    return a


def _jax_like(name, args, got):
    """The JAX op's output has the shape and dtype kind of the port's."""
    ref = getattr(jp, name)(*args)
    assert tuple(ref.shape) == tuple(got.shape), name
    jk = np.dtype(ref.dtype).kind
    assert jk == {"f": "f", "i": "i", "b": "b"}[
        "f" if got.is_floating_point() else
        ("b" if got.dtype == torch.bool else "i")], name


@pytest.mark.parametrize("name", ["rand", "uniform"])
def test_uniform_ops(name):
    lo, hi = (0.0, 1.0) if name == "rand" else (-2.0, 3.0)
    fn = (lambda: pt.rand([N])) if name == "rand" else \
        (lambda: pt.uniform([N], min=lo, max=hi))
    x = _seeded(fn)
    assert x.dtype == torch.float32
    assert float(x.min()) >= lo and float(x.max()) < hi
    assert abs(float(x.mean()) - (lo + hi) / 2) < 0.02 * (hi - lo)
    assert abs(float(x.var()) - (hi - lo) ** 2 / 12) < 0.03 * (hi - lo) ** 2
    _jax_like(name, ([4, 3],), pt.rand([4, 3]))
    a = pt.uniform([5], seed=7)
    assert torch.equal(a, pt.uniform([5], seed=7))


@pytest.mark.parametrize("name", ["randn", "standard_normal"])
def test_normal_draws(name):
    x = _seeded(lambda: getattr(pt, name)([N], "float32"))
    assert abs(float(x.mean())) < 0.03 and abs(float(x.std()) - 1) < 0.03
    _jax_like(name, ([2, 5],), getattr(pt, name)([2, 5]))


def test_normal():
    x = _seeded(lambda: pt.normal(2.0, 3.0, [N]))
    assert abs(float(x.mean()) - 2.0) < 0.1
    assert abs(float(x.std()) - 3.0) < 0.1
    m = torch.tensor([0.0, 10.0])
    y = pt.normal(m, 0.1)
    assert y.shape == (2,) and abs(float(y[1]) - 10.0) < 1.0
    _jax_like("normal", (0.0, 1.0, [3, 2]), pt.normal(0.0, 1.0, [3, 2]))


def test_randint():
    x = _seeded(lambda: pt.randint(2, 9, [N]))
    assert x.dtype == torch.int64
    assert set(x.unique().tolist()) == set(range(2, 9))
    assert pt.randint(5, shape=[3]).max() < 5
    _jax_like("randint", (0, 4, [3, 2]), pt.randint(0, 4, [3, 2]))


def test_randperm():
    x = _seeded(lambda: pt.randperm(50))
    assert x.dtype == torch.int64 and sorted(x.tolist()) == list(range(50))
    _jax_like("randperm", (6,), pt.randperm(6))


def test_bernoulli():
    p = torch.full((N,), 0.3)
    x = _seeded(lambda: pt.bernoulli(p))
    assert x.dtype == torch.float32 and set(x.unique().tolist()) <= {0., 1.}
    assert abs(float(x.mean()) - 0.3) < 0.02
    _jax_like("bernoulli", (np.full((3, 2), 0.5, np.float32),),
              pt.bernoulli(torch.full((3, 2), 0.5)))


def test_multinomial():
    probs = torch.tensor([0.1, 0.2, 0.7])
    x = _seeded(lambda: pt.multinomial(probs, N, replacement=True))
    freq = torch.bincount(x, minlength=3).float() / N
    assert torch.allclose(freq, probs, atol=0.02)
    y = pt.multinomial(torch.rand(4, 6), 3)
    assert y.shape == (4, 3) and y.dtype == torch.int64
    assert all(len(set(r)) == 3 for r in y.tolist())
    _jax_like("multinomial", (np.full((2, 5), 0.2, np.float32), 3),
              pt.multinomial(torch.full((2, 5), 0.2), 3))


# -- paddle.grad ---------------------------------------------------------------------

def _both(arrs):
    j = [jp.to_tensor(a, stop_gradient=False) for a in arrs]
    t = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrs]
    return j, t


def _close(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-6)


RNG = np.random.RandomState(3)
XA = RNG.randn(3, 4).astype(np.float32)
WA = RNG.randn(3, 4).astype(np.float32)


def test_grad_first_order():
    (jx, jw), (tx, tw) = _both([XA, WA])
    jf = jp.sum(jp.tanh(jx) * jw + jx * jx)
    tf = pt.sum(pt.tanh(tx) * tw + tx * tx)
    _close(pt.grad(tf, [tx, tw]), jp.grad(jf, [jx, jw]))
    assert tx.grad is None  # paddle.grad leaves .grad alone


def test_grad_create_graph_second_order():
    (jx,), (tx,) = _both([XA])
    jg, = jp.grad(jp.sum(jx * jx * jx), jx, create_graph=True)
    tg, = pt.grad(pt.sum(tx * tx * tx), tx, create_graph=True)
    _close([tg], [jg])
    _close(pt.grad(pt.sum(tg * tg), tx), jp.grad(jp.sum(jg * jg), jx))


def test_grad_allow_unused_and_grad_outputs():
    (jx, jz), (tx, tz) = _both([XA, WA])
    _close(pt.grad(pt.exp(tx), [tx, tz], allow_unused=True),
           jp.grad(jp.exp(jx), [jx, jz], allow_unused=True))
    got = pt.grad(pt.exp(tx), [tx, tz])
    assert torch.equal(got[1], torch.zeros(3, 4))
    go = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    _close(pt.grad(pt.exp(tx), tx, grad_outputs=torch.from_numpy(go)),
           jp.grad(jp.exp(jx), jx, grad_outputs=jp.to_tensor(go)))


def test_grad_no_grad_vars():
    (jx,), (tx,) = _both([XA])
    jy, ty = jx * 2.0, tx * 2.0
    jf, tf = jp.sum(jy * jp.sin(jx)), pt.sum(ty * pt.sin(tx))
    _close(pt.grad(tf, tx, no_grad_vars=[ty]),
           jp.grad(jf, jx, no_grad_vars=[jy]))

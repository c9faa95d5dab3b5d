"""paddle_tpu_torch.nn's surface against paddle_tpu.nn's, and the repairs
of the nn surface's faults.

- Coverage: every public name of paddle_tpu.nn, paddle_tpu.nn.functional
  and the other modules of PAIRS exists in the port's counterpart, but
  for the named EXCEPTIONS (the JAX static planes' readers of XLA's HLO
  and cost analysis, and the JAX modules' own imports), and the names F
  shares with the op library are the same objects.
- Signature pins: for every public callable that both packages define
  in the top level, nn, nn.functional, the observability planes
  (sentry, anatomy, xprof, mfu, calibration, memory), the profiler,
  optimizer.extras and incubate, the JAX parameter names, in
  order, are a prefix of the port's, and the port adds only trailing
  `device`, `dtype` and `generator` keywords. INTENDED lists the
  differences that are the port's idiom, each with its reason; the test
  fails if one of them stops differing, so the list stays true.
- F1: abs, sqrt, square, pad and gather_tree under nn.functional and
  ParamAttr under nn (each the port's existing object).
- F2: Layer(name_scope=None, dtype="float32", *, device=None), so
  Paddle's `super().__init__("encoder")` builds a port Layer.
- F3: beam_search_step takes end_token and name, gather_tree name.
- F4: paddle.matmul and paddle.addmm are AMP white-list ops, as the JAX
  package registers them ("matmul_v2", "addmm"): under auto_cast O1
  their inputs are cast to bf16 (the port ran them in f32); the loss,
  cell and scan ops this slice adds follow the JAX lists too.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F

#: names the JAX module imports for its own use (not API)
_IMPORTS = ("Any", "Iterable", "List", "Mapping", "Tuple",
            "contextmanager", "logger", "logging", "jnp", "no_grad")
#: public names of the JAX modules the port leaves out, with the reason
EXCEPTIONS = {
    "nn": {}, "nn.functional": {},
    "observability": {}, "observability.sentry": {},
    "observability.anatomy": dict(
        dict.fromkeys(_IMPORTS, "the JAX module's import"),
        attribute_hlo_text="prices an executable's HLO text; a CUDA graph "
                           "has none (count_flops over the eager step)",
        attribute_compiled="as attribute_hlo_text",
        compile_uncached="jax's compilation cache; nothing to bypass"),
    "observability.xprof": {},
    "observability.mfu": dict(
        flops_of_compiled="XLA's cost analysis (step_flops counts the "
                          "call with FlopCounterMode)"),
    "observability.calibration": dict(List="the JAX module's import"),
    "observability.memory": dict(
        dict.fromkeys(_IMPORTS, "the JAX module's import"),
        scope_of_op_name="the JAX module's import of anatomy's",
        scope_of_param="the JAX module's import of sentry's",
        attribute_hlo_memory="reads HLO buffers (the meta-device trace "
                             "takes their place)",
        attribute_arguments="reads the jax flat-arg table (the lowered "
                            "step's arguments() take its place)",
        attribute_compiled_memory="as attribute_hlo_memory",
        compile_step="an AOT compile (TrainStep.aot_lower)",
        compile_uncached="jax's compilation cache",
        memory_analysis_dict="XLA's buffer assignment"),
    "profiler": {},
    "optimizer.extras": dict.fromkeys(_IMPORTS, "the JAX module's import"),
    "incubate": {}, "incubate.optimizer": {},
}

#: signature differences that are the port's idiom, by (module, name)
INTENDED = {
    ("", "Tensor"): "Tensor is torch.Tensor (the port's Tensor decision, "
                    "ops/__init__.py): torch's constructor",
    ("", "Parameter"): "Parameter is torch.nn.Parameter (the slice-2 "
                       "decision): torch's constructor",
    ("", "no_grad"): "torch.no_grad, a context manager and decorator",
    ("", "enable_grad"): "torch.enable_grad, as no_grad",
    ("", "load"): "takes Paddle's return_numpy load config as a keyword "
                  "of its own (serialization.py)",
    ("", "scatter_"): "the generated in-place forms take the function's "
                      "arguments as *args (ops/__init__.py _inplace)",
    ("", "tanh_"): "the generated in-place forms, as scatter_",
    ("nn.functional", "gumbel_softmax"): "generator= (a torch.Generator) "
                                         "replaces the JAX key=",
    ("nn.functional", "tanh_"): "takes Paddle's name= as the port's "
                                "functionals do; the JAX one takes x alone",
    ("observability.anatomy", "train_step_anatomy"):
        "adds seed= (the eager step's dropout seed) and profile= (device "
        "ms through xprof): the table comes from a step that runs",
    ("observability.calibration", "compiled_collective_bytes"):
        "takes the grads and a CommConfig: the port reads the comm "
        "planner's buckets where the JAX module reads HLO",
    ("observability.memory", "train_step_memory"):
        "no compiled=: the meta trace is the lowering, there is no "
        "compile to reuse",
}

import paddle_tpu.incubate as jinc  # noqa: E402
import paddle_tpu.observability as jobs  # noqa: E402
import paddle_tpu.optimizer.extras as jextras  # noqa: E402
import paddle_tpu.profiler as jprof  # noqa: E402
import paddle_tpu_torch.incubate as tinc  # noqa: E402
import paddle_tpu_torch.observability as tobs  # noqa: E402
import paddle_tpu_torch.optimizer.extras as textras  # noqa: E402
import paddle_tpu_torch.profiler as tprof  # noqa: E402

PAIRS = [("", jp, pt), ("nn", jnn, tnn), ("nn.functional", JF, F),
         ("observability", jobs, tobs),
         ("observability.sentry", jobs.sentry, tobs.sentry),
         ("observability.anatomy", jobs.anatomy, tobs.anatomy),
         ("observability.xprof", jobs.xprof, tobs.xprof),
         ("observability.mfu", jobs.mfu, tobs.mfu),
         ("observability.calibration", jobs.calibration, tobs.calibration),
         ("observability.memory", jobs.memory, tobs.memory),
         ("profiler", jprof, tprof),
         ("optimizer.extras", jextras, textras),
         ("incubate", jinc, tinc), ("incubate.optimizer", jinc.optimizer,
                                    tinc.optimizer)]
EXTRA_OK = {"device", "dtype", "generator"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def _params(obj):
    try:
        sig = inspect.signature(obj.__init__ if inspect.isclass(obj)
                                else obj)
    except (TypeError, ValueError):
        return None
    names = [p.name for p in sig.parameters.values()
             if p.kind is not p.VAR_KEYWORD]
    if inspect.isclass(obj) and names[:1] == ["self"]:
        names = names[1:]
    return names


def _mismatches():
    out = {}
    for where, jmod, tmod in PAIRS:
        for name in sorted(_public(jmod) & _public(tmod)):
            a, b = getattr(jmod, name), getattr(tmod, name)
            if inspect.ismodule(a) or not (callable(a) and callable(b)):
                continue
            pa, pb = _params(a), _params(b)
            if pa is None or pb is None:
                continue
            if pb[:len(pa)] != pa or not set(pb[len(pa):]) <= EXTRA_OK:
                out[(where, name)] = (pa, pb)
    return out


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.mark.parametrize("where,jmod,tmod", PAIRS[1:],
                         ids=[p[0] for p in PAIRS[1:]])
def test_every_jax_nn_name_exists_in_the_port(where, jmod, tmod):
    missing = sorted(_public(jmod) - _public(tmod) - set(EXCEPTIONS[where]))
    assert missing == []


def test_signatures_are_the_jax_ones_or_intended():
    got = _mismatches()
    assert sorted(set(got) - set(INTENDED)) == [], \
        {k: v for k, v in got.items() if k not in INTENDED}
    # an intended difference that is gone leaves the list
    assert sorted(set(INTENDED) - set(got)) == []


def test_f1_shared_names_are_the_ported_objects():
    assert F.abs is pt.abs and F.sqrt is pt.sqrt and F.square is pt.square
    assert F.pad is pt.pad and F.gather_tree is pt.gather_tree
    assert tnn.ParamAttr is pt.ParamAttr
    for name in ("affine_grid", "grid_sample", "max_unpool2d",
                 "diag_embed", "sequence_mask"):
        assert hasattr(pt, name) and hasattr(jp, name), name


def test_f2_layer_takes_the_name_scope_first():
    class Encoder(tnn.Layer):
        def __init__(self):
            super().__init__("encoder")
            self.fc = tnn.Linear(3, 2)

        def forward(self, x):
            return self.fc(x)

    enc = Encoder()
    assert enc._name_scope == "encoder" and enc._dtype == torch.float32
    assert tnn.Layer()._name_scope == "layer"
    assert tnn.Layer("scope", "float64")._dtype == torch.float64
    with pytest.raises(TypeError):
        tnn.Layer("scope", "float32", "cpu")   # device is keyword-only
    lyr = tnn.Layer(device="cpu")
    assert lyr._device.type == "cpu"
    assert enc(torch.ones(1, 3)).shape == (1, 2)
    # the JAX package takes the same call
    class JEncoder(jnn.Layer):
        def __init__(self):
            super().__init__("encoder")
    assert JEncoder()._name_scope == "encoder"


def test_f3_beam_ops_take_the_jax_keywords():
    rng = np.random.RandomState(0)
    lp = rng.randn(2, 3, 7).astype(np.float32)
    sc = rng.randn(2, 3).astype(np.float32)
    got = pt.beam_search_step(torch.from_numpy(lp), torch.from_numpy(sc),
                              beam_size=3, end_token=2, name=None)
    want = jp.beam_search_step(jp.to_tensor(lp), jp.to_tensor(sc),
                               beam_size=3, end_token=2, name=None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   rtol=1e-6)
    ids = rng.randint(0, 7, (4, 2, 3))
    par = rng.randint(0, 3, (4, 2, 3))
    np.testing.assert_array_equal(
        pt.gather_tree(torch.from_numpy(ids), torch.from_numpy(par),
                       name=None).numpy(),
        np.asarray(jp.gather_tree(jp.to_tensor(ids), jp.to_tensor(par),
                                  name=None).numpy()))


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("case", ["matmul", "addmm", "mse_loss", "l1_loss",
                                  "nll_loss", "bce", "lstm_cell",
                                  "rnn_scan"])
def test_f4_amp_casts_follow_the_jax_lists(case):
    """The dtype of each op's output under auto_cast(O1, bf16), from
    f32 inputs (bf16 for the black-list losses), as the JAX package's."""
    rng = np.random.RandomState(1)
    a = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(4, 5).astype(np.float32)
    out = {}
    for side, pkg, mk in (("jax", jp, jp.to_tensor),
                          ("torch", pt, torch.from_numpy)):
        nn_ = pkg.nn
        with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
            if case == "matmul":
                r = pkg.matmul(mk(a), mk(b))
            elif case == "addmm":
                r = pkg.addmm(mk(rng.randn(3, 5).astype(np.float32)),
                              mk(a), mk(b))
            elif case in ("mse_loss", "l1_loss", "bce"):
                x = mk(np.clip(a, 0.05, 0.95)).astype("bfloat16") \
                    if side == "jax" else \
                    mk(np.clip(a, 0.05, 0.95)).to(torch.bfloat16)
                fn = {"mse_loss": nn_.functional.mse_loss,
                      "l1_loss": nn_.functional.l1_loss,
                      "bce": nn_.functional.binary_cross_entropy}[case]
                r = fn(x, x)
            elif case == "nll_loss":
                x = mk(a).astype("bfloat16") if side == "jax" else \
                    mk(a).to(torch.bfloat16)
                r = nn_.functional.nll_loss(x, mk(np.array([0, 2, 1])))
            elif case == "lstm_cell":
                pkg.seed(0)
                r = nn_.LSTMCell(4, 6)(mk(a))[0]
            else:
                pkg.seed(0)
                r = nn_.RNN(nn_.GRUCell(4, 6))(mk(a[None]))[0]
        out[side] = _dtype_name(r)
    assert out["torch"] == out["jax"], out

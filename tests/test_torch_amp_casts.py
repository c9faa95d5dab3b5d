"""The op library's AMP casts: under auto_cast O1 and O2, from bf16 and
f32 inputs, every port function whose JAX op is registered under a name
on the JAX package's AMP_WHITE_LIST or AMP_BLACK_LIST gives the JAX op's
output dtype. The lists are read from paddle_tpu.amp.auto_cast here,
never from the port. Every name on either list is covered below or
named in SKIPPED with its reason."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.amp.auto_cast import AMP_BLACK_LIST, AMP_WHITE_LIST

RNG = np.random.RandomState(2)
POS = RNG.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
M34 = RNG.randn(3, 4).astype(np.float32)
M45 = RNG.randn(4, 5).astype(np.float32)
B234 = RNG.randn(2, 3, 4).astype(np.float32)
B245 = RNG.randn(2, 4, 5).astype(np.float32)
V4 = RNG.randn(4).astype(np.float32)

#: registered name -> (top-level function, its array arguments, keywords)
COVERED = {
    "exp": ("exp", [POS], {}), "log": ("log", [POS], {}),
    "log2": ("log2", [POS], {}), "log10": ("log10", [POS], {}),
    "log1p": ("log1p", [POS], {}), "square": ("square", [POS], {}),
    "sqrt": ("sqrt", [POS], {}), "rsqrt": ("rsqrt", [POS], {}),
    "reciprocal": ("reciprocal", [POS], {}),
    "elementwise_pow": ("pow", [POS, POS], {}),
    "cumsum": ("cumsum", [POS], {"axis": 1}),
    "logsumexp": ("logsumexp", [POS], {"axis": 1}),
    "reduce_sum": ("sum", [POS], {"axis": 0}),
    "reduce_mean": ("mean", [POS], {}),
    "reduce_prod": ("prod", [POS], {"axis": 1}),
    "p_norm": ("norm", [M34], {"p": 2, "axis": 1}),
    "matmul_v2": ("matmul", [M34, M45], {}),
    "addmm": ("addmm", [RNG.randn(3, 5).astype(np.float32), M34, M45], {}),
    "bmm": ("bmm", [B234, B245], {}),
    "mv": ("mv", [M34, V4], {}),
    "einsum": ("einsum", ["ij,jk->ik", M34, M45], {}),
}

#: the names on the lists that no test here covers, each with its reason
SKIPPED = {
    **{n: "an nn op, cast by nn.functional itself "
          "(tests/test_torch_nn_surface.py test_f4 and the nn tests)"
       for n in ("softmax_op", "log_softmax_op",
                 "softmax_with_cross_entropy_op", "bce_loss",
                 "bce_with_logits", "layer_norm_op", "batch_norm_op",
                 "group_norm_op", "instance_norm_op", "mse_loss_op",
                 "l1_loss_op", "kldiv_loss_op", "nll_loss_op",
                 "ctc_loss_op", "softplus", "conv1d", "conv2d", "conv3d",
                 "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
                 "linear", "flash_attention_op", "flash_attention_dropout",
                 "scaled_dot_product_attention", "sdpa_dropout",
                 "rnn_scan")},
    **{n: "the JAX package registers no op under this name, so its AMP "
          "hook casts nothing by it"
       for n in ("pow", "lstm_cell", "gru_cell", "simple_rnn_cell")},
    "sync_batch_norm": "paddle_tpu/ops/vision_extra.py, not ported "
                       "(ROADMAP.md item 18)",
}


def test_the_ports_lists_are_the_jax_ones():
    from paddle_tpu_torch.amp.auto_cast import (AMP_BLACK_LIST as black,
                                                AMP_WHITE_LIST as white)
    assert white == AMP_WHITE_LIST and black == AMP_BLACK_LIST


def test_chip_smokes_amp_table_is_this_one():
    """chip_smoke.py's amp_card phase runs the same ops on the card."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_amp", Path(__file__).resolve().parents[1] /
        "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert {k: v[0] for k, v in cs.AMP_OPS.items()} == \
        {k: v[0] for k, v in COVERED.items()}


def test_every_listed_name_is_covered_or_skipped():
    names = AMP_WHITE_LIST | AMP_BLACK_LIST
    assert sorted(names - set(COVERED) - set(SKIPPED)) == []
    assert not set(COVERED) & set(SKIPPED)
    assert set(COVERED) | set(SKIPPED) <= names


def _dtype(x):
    return str(x.dtype).split(".")[-1]


def _run(side, fn_name, arrays, kwargs, in_dtype, level):
    pkg = jp if side == "jax" else pt

    def make(a):
        if isinstance(a, str):
            return a
        if side == "jax":
            t = jp.to_tensor(a)
            return t.astype("bfloat16") if in_dtype == "bfloat16" else t
        return torch.from_numpy(a).to(getattr(torch, in_dtype))
    args = [make(a) for a in arrays]
    if level is None:
        return _dtype(getattr(pkg, fn_name)(*args, **kwargs))
    with pkg.amp.auto_cast(level=level, dtype="bfloat16"):
        return _dtype(getattr(pkg, fn_name)(*args, **kwargs))


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", sorted(COVERED))
def test_output_dtype_is_the_jax_ops(op, in_dtype, level):
    fn, arrays, kwargs = COVERED[op]
    want = _run("jax", fn, arrays, kwargs, in_dtype, level)
    got = _run("torch", fn, arrays, kwargs, in_dtype, level)
    assert got == want, f"{op} ({fn}) {in_dtype} {level}: {got} vs {want}"
    # and outside auto_cast the input dtype passes through, as there
    assert _run("torch", fn, arrays, kwargs, in_dtype, None) == \
        _run("jax", fn, arrays, kwargs, in_dtype, None) == in_dtype

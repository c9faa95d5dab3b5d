"""paddle_tpu_torch's sequence ops and tensor arrays against the JAX
package's on the CPU: every case of tests/torch_ops_cases.py's sequence
table (values and the gradients of sum(out * w), f32 at 1e-6 x max(1,
|ref|), integers exact), and the TensorArray ops (writes are functional,
stack and concat, tensor_array_to_tensor's extents) on the same calls."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.ops import tensor_array as jta
from paddle_tpu_torch.ops import tensor_array as tta
from torch_ops_cases import by_module
from torch_ops_parity import check_case


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.mark.parametrize("case", by_module("sequence"), ids=str)
def test_sequence_op_equals_jax(case):
    check_case(case)


RNG = np.random.RandomState(7)
ITEMS = [RNG.randn(2, 3).astype(np.float32) for _ in range(3)]


def _build(mod, make):
    arr = mod.create_array("float32")
    for i, a in enumerate(ITEMS):
        arr = mod.array_write(make(a), i, arr)
    return arr


@pytest.mark.parametrize("use_stack,axis", [(False, 0), (False, 1),
                                            (True, 0), (True, 2)])
def test_tensor_array_to_tensor(use_stack, axis):
    got = tta.tensor_array_to_tensor(_build(tta, torch.from_numpy),
                                     axis=axis, use_stack=use_stack)
    want = jta.tensor_array_to_tensor(_build(jta, jp.to_tensor), axis=axis,
                                      use_stack=use_stack)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0].numpy()))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1].numpy()))
    assert got[1].dtype == torch.int32


def test_tensor_array_writes_are_functional():
    for mod, make in ((tta, torch.from_numpy), (jta, jp.to_tensor)):
        a = _build(mod, make)
        b = mod.write_to_array(a, 1, make(ITEMS[0]))
        assert mod.array_length(a) == mod.array_length(b) == 3
        np.testing.assert_array_equal(np.asarray(mod.read_from_array(
            a, 1).numpy()), ITEMS[1])
        np.testing.assert_array_equal(np.asarray(mod.array_read(
            b, 1).numpy()), ITEMS[0])
        c = mod.write_to_array(None, 2, make(ITEMS[2]))
        assert mod.array_length(c) == 3 and c.read(0) is None
        d = a.append(make(ITEMS[2]))
        assert len(d) == 4 and len(a) == 3
    t = _build(tta, torch.from_numpy)
    np.testing.assert_array_equal(t.stack(1).numpy(), np.stack(ITEMS, 1))
    np.testing.assert_array_equal(t.concat(0).numpy(),
                                  np.concatenate(ITEMS, 0))
    assert [x.shape for x in t] == [(2, 3)] * 3
    assert t.read(torch.tensor(2)) is t.read(2)

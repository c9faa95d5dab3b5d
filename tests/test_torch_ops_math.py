"""paddle_tpu_torch's math ops against the JAX package's on the CPU:
every case of tests/torch_ops_cases.py's math table, values and the
gradients of sum(out * w), at the table's tolerances (f32 elementwise
1e-6 x max(1, |ref|), reductions and products 1e-5, integers and bools
exact)."""
import pytest

import paddle_tpu_torch as pt
from torch_ops_cases import by_module
from torch_ops_parity import check_case


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.mark.parametrize("case", by_module("math"), ids=str)
def test_math_op_equals_jax(case):
    check_case(case)

"""paddle_tpu_torch's logic, search and stat ops and the in-place forms
against the JAX package's on the CPU: every case of
tests/torch_ops_cases.py's logic, search, stat and in-place tables, at
the table's tolerances (f32 elementwise 1e-6 x max(1, |ref|),
statistics 1e-5, integers and bools exact). The JAX package runs with
x64 off, so its int64 requests give int32: the values are compared, and
the kind (integer), not the width."""
import pytest

import paddle_tpu_torch as pt
from torch_ops_cases import by_module
from torch_ops_parity import check_case


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.mark.parametrize(
    "case", [c for m in ("logic", "search", "stat", "inplace")
             for c in by_module(m)], ids=str)
def test_op_equals_jax(case):
    check_case(case)

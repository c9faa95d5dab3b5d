"""The op parity tables of paddle_tpu_torch's op library (creation,
math, manipulation, logic, search, stat, the in-place forms, and the
second half: linalg and einsum, sequence, misc, loss_extra, extras and
amp_ops; a dotted name is a path below the top level), shared
by tests/test_torch_ops_*.py (the port on the CPU against the JAX
package) and chip_smoke.py's ops_card phase (the port on the card
against the port on the CPU). Numpy only: this module imports neither
jax nor torch.

A case is one call: the op's top-level name, its arguments (numpy
arrays become tensors on each side; ARG wraps a value that stays as it
is), a tolerance class and whether the gradient of sum(out * w) is
compared. Inputs come from a numpy generator seeded by the case's id.

Tolerances, |got - ref| <= tol * max(1, |ref|) elementwise:
  "elem"   1e-6  (f32 elementwise ops),
  "reduce" 1e-5  (reductions, products, sorts' statistics),
  integer and bool results exactly.
"""
import zlib

import numpy as np

TOLS = {"elem": 1e-6, "reduce": 1e-5}

#: the random ops: a statistical test each instead of a parity case
RANDOM = ("rand", "randn", "randint", "randperm", "uniform", "normal",
          "bernoulli", "multinomial", "standard_normal")


class ARG:
    """An argument passed as it is (a list, a dtype name, ...)."""

    def __init__(self, value):
        self.value = value


class Gen:
    """An input drawn at case time from the case's generator."""

    def __init__(self, kind, shape, lo=None, hi=None, dtype=None):
        self.kind, self.shape, self.lo, self.hi = kind, shape, lo, hi
        self.dtype = dtype

    def make(self, rng):
        s = self.shape
        if self.kind == "randn":
            return rng.randn(*s).astype(np.float32)
        if self.kind == "uniform":
            return rng.uniform(self.lo, self.hi, s).astype(np.float32)
        if self.kind == "int":
            return rng.randint(self.lo, self.hi, s).astype(
                self.dtype or np.int64)
        if self.kind == "bool":
            return rng.rand(*s) > 0.5
        raise ValueError(self.kind)


def R(*shape):
    return Gen("randn", shape)


def U(lo, hi, *shape):
    return Gen("uniform", shape, lo, hi)


def I(lo, hi, *shape, dtype=None):  # noqa: E743
    return Gen("int", shape, lo, hi, dtype)


def B(*shape):
    return Gen("bool", shape)


class Case:
    def __init__(self, fn, args, kwargs, tol, grad, cid, module):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.tol, self.grad, self.id = tol, grad, cid
        self.module = module

    def inputs(self):
        """(args, kwargs) with every Gen drawn (numpy), from the case's
        own seed."""
        rng = np.random.RandomState(zlib.crc32(self.id.encode()))

        def draw(v):
            if isinstance(v, Gen):
                return v.make(rng)
            if isinstance(v, list):
                return [draw(a) for a in v]
            return v
        args = [draw(a) for a in self.args]
        kwargs = {k: draw(v) for k, v in self.kwargs.items()}
        return args, kwargs, rng

    def __repr__(self):
        return self.id


CASES = []
_COUNT = {}
_SECTION = [None]


def section(module):
    """The op module the cases that follow belong to."""
    _SECTION[0] = module


def C(fn, *args, tol="elem", grad=True, tag=None, **kwargs):
    n = _COUNT[fn] = _COUNT.get(fn, 0) + 1
    cid = f"{fn}-{tag or n}"
    CASES.append(Case(fn, args, kwargs, tol, grad, cid, _SECTION[0]))


NAN = np.array([[1.0, np.nan, -2.0], [np.inf, 0.5, -np.inf]], np.float32)
A = (3, 4)

# -- creation ------------------------------------------------------------------
section("creation")
C("zeros", ARG([2, 3]), grad=False)
C("zeros", ARG([2, 3]), ARG("int32"), grad=False)
C("ones", ARG([2, 3]), grad=False)
C("full", ARG([2, 3]), 1.5, grad=False)
C("full", ARG([2]), 3, ARG("int64"), grad=False)
C("empty", ARG([2, 3]), grad=False)
C("zeros_like", R(*A), grad=False)
C("ones_like", R(*A), ARG("int32"), grad=False)
C("full_like", R(*A), 2.5, grad=False)
C("empty_like", R(*A), grad=False)
C("arange", 5, grad=False)
C("arange", 1, 7, 2, grad=False)
C("arange", 0.0, 1.0, 0.25, grad=False)
C("arange", 2, 10, 3, ARG("float32"), grad=False)
C("linspace", 0.0, 1.0, 5, grad=False)
C("linspace", -2.0, 3.0, 7, grad=False)
C("logspace", 0.0, 2.0, 5, grad=False)
C("logspace", 0.0, 3.0, 4, base=2.0, grad=False)
C("eye", 3, grad=False)
C("eye", 2, 4, grad=False)
C("diag", R(4), grad=False)
C("diag", R(4), offset=1, grad=False)
C("diag", R(3), padding_value=9.0, grad=False)
C("diag", R(*A), grad=False)
C("diag", R(*A), offset=1, grad=False)
C("diagflat", R(3), grad=False)
C("diagflat", R(2, 2), offset=-1, grad=False)
C("tril", R(*A))
C("tril", R(*A), 1)
C("triu", R(*A))
C("triu", R(2, 4, 4), -1)
C("meshgrid", R(3), R(4), grad=False)
C("meshgrid", [R(2), R(3)], grad=False, tag="list")
C("assign", R(*A), grad=False)
C("clone_", R(*A), grad=False)
C("one_hot", I(0, 5, 6), 5, grad=False)
C("one_hot", I(0, 4, 2, 3), 4, grad=False)
C("numel", R(2, 3, 4), grad=False)
C("tril_indices", 4, 4, 0, grad=False)
C("tril_indices", 3, 5, 1, grad=False)
C("triu_indices", 4, grad=False)
C("triu_indices", 3, 5, -1, grad=False)
C("create_parameter", ARG([2, 3]), grad=False)
C("set_printoptions", threshold=1000, grad=False)

# -- math ------------------------------------------------------------------------
section("math")
POS, UNIT = U(0.2, 3.0, *A), U(-0.9, 0.9, *A)
for fn, x in (("abs", R(*A)), ("sqrt", POS), ("rsqrt", POS), ("exp", R(*A)),
              ("expm1", R(*A)), ("log", POS), ("log2", POS), ("log10", POS),
              ("log1p", POS), ("sin", R(*A)), ("cos", R(*A)),
              ("tan", UNIT), ("asin", UNIT), ("acos", UNIT),
              ("atan", R(*A)), ("sinh", R(*A)), ("cosh", R(*A)),
              ("tanh", R(*A)), ("asinh", R(*A)), ("acosh", U(1.2, 4.0, *A)),
              ("atanh", UNIT), ("floor", R(*A)), ("ceil", R(*A)),
              ("round", U(-3.0, 3.0, *A)), ("trunc", R(*A)),
              ("frac", R(*A)), ("sign", R(*A)), ("square", R(*A)),
              ("reciprocal", POS), ("neg", R(*A)), ("erf", R(*A)),
              ("erfinv", UNIT), ("angle", R(*A)), ("conj", R(*A)),
              ("real", R(*A)), ("imag", R(*A)), ("deg2rad", R(*A)),
              ("rad2deg", R(*A)), ("stanh", R(*A))):
    C(fn, x)
C("stanh", R(*A), scale_a=0.5, scale_b=2.0)
C("abs", I(-5, 5, *A), grad=False, tag="int")
C("sign", I(-5, 5, *A), grad=False, tag="int")
C("reciprocal", I(1, 5, *A), grad=False, tag="int")
for fn in ("signbit", "isnan", "isinf", "isfinite"):
    C(fn, NAN, grad=False)
C("real", np.array([1 + 2j, -3j], np.complex64), grad=False, tag="complex")
C("imag", np.array([1 + 2j, -3j], np.complex64), grad=False, tag="complex")
C("conj", np.array([1 + 2j, -3j], np.complex64), grad=False, tag="complex")
for fn, x, y in (("add", R(*A), R(*A)), ("subtract", R(*A), R(*A)),
                 ("multiply", R(*A), R(*A)), ("divide", R(*A), POS),
                 ("pow", POS, R(*A)), ("float_power", POS, R(*A)),
                 ("maximum", R(*A), R(*A)), ("minimum", R(*A), R(*A)),
                 ("fmax", R(*A), R(*A)), ("fmin", R(*A), R(*A)),
                 ("atan2", R(*A), R(*A)), ("logaddexp", R(*A), R(*A)),
                 ("hypot", R(*A), R(*A)), ("copysign", R(*A), R(*A))):
    C(fn, x, y)
C("add", R(*A), R(4), tag="broadcast")
C("add", R(*A), 2.0, tag="scalar")
C("subtract", R(2, 1, 4), R(3, 1), tag="broadcast")
C("multiply", R(*A), 3, tag="scalar")
C("divide", R(*A), 4.0, tag="scalar")
C("divide", I(-9, 9, *A), I(1, 4, *A), grad=False, tag="int")
C("pow", R(*A), 2, tag="scalar")
C("pow", I(0, 4, *A), 3, grad=False, tag="int")
C("floor_divide", R(*A), U(0.5, 2.0, *A), grad=False)
C("floor_divide", I(-20, 20, *A), I(1, 6, *A), grad=False, tag="int")
C("mod", R(*A), U(0.5, 2.0, *A))
C("mod", I(-20, 20, *A), I(1, 6, *A), grad=False, tag="int")
C("remainder", R(*A), U(-2.0, -0.5, *A))
C("floor_mod", I(-20, 20, *A), I(1, 6, *A), grad=False)
C("fmax", NAN, R(2, 3), tag="nan")
C("fmin", NAN, R(2, 3), tag="nan")
C("ldexp", R(*A), I(-3, 4, *A, dtype=np.int32), grad=False)
C("nextafter", R(*A), R(*A), grad=False)
C("heaviside", np.array([-1.0, 0.0, 2.0, 0.0], np.float32),
  np.array([0.5, 0.5, 0.5, 3.0], np.float32), grad=False)
C("gcd", I(-30, 30, *A), I(-30, 30, *A), grad=False)
C("lcm", I(-12, 12, *A), I(-12, 12, *A), grad=False)
C("matmul", R(3, 4), R(4, 5), tol="reduce")
C("matmul", R(4, 3), R(4, 5), transpose_x=True, tol="reduce")
C("matmul", R(3, 4), R(5, 4), transpose_y=True, tol="reduce")
C("matmul", R(2, 3, 4), R(4, 2), tol="reduce")
C("matmul", R(2, 3, 4), R(2, 4, 5), tol="reduce")
C("matmul", R(4), R(4, 3), tol="reduce")
C("matmul", R(4), R(4), tol="reduce")
C("mm", R(3, 4), R(4, 2), tol="reduce")
C("addmm", R(3, 2), R(3, 4), R(4, 2), tol="reduce")
C("addmm", R(3, 2), R(3, 4), R(4, 2), beta=0.5, alpha=2.0, tol="reduce")
C("inner", R(3, 4), R(2, 4), tol="reduce")
C("outer", R(3), R(4))
C("outer", R(2, 2), R(3), tag="flatten")
C("dot", R(4), R(4), tol="reduce")
C("dot", R(3, 4), R(3, 4), tol="reduce")
C("kron", R(2, 3), R(2, 2))
C("clip", R(*A), -0.5, 0.5)
C("clip", R(*A), min=0.0)
C("clip", R(*A), max=0.3)
C("lerp", R(*A), R(*A), 0.3)
C("lerp", R(*A), R(*A), 0.8)
C("scale", R(*A), 2.0, 1.0)
C("scale", R(*A), 2.0, 1.0, bias_after_scale=False)
C("increment", R(*A), 2.0, grad=False)
C("multiply_", R(*A), R(*A), grad=False)
C("rsub_", R(*A), R(*A))
C("add_n", [R(*A), R(*A), R(*A)])
C("add_n", R(*A), tag="one")
S = (2, 3, 4)
for fn in ("sum", "mean", "max", "min", "amax", "amin", "prod",
           "logsumexp", "nansum", "nanmean"):
    C(fn, R(*S), tol="reduce", tag="all")
    C(fn, R(*S), 1, tol="reduce", tag="axis")
    C(fn, R(*S), [0, 2], keepdim=True, tol="reduce", tag="axes")
    C(fn, R(*S), -1, keepdim=True, tol="reduce", tag="neg")
C("sum", I(0, 5, *S), 1, grad=False, tag="int")
C("sum", B(*S), grad=False, tag="bool")
C("sum", R(*S), 1, dtype=ARG("float32"), tol="reduce", tag="dtype")
C("mean", I(0, 5, *S), grad=False, tag="int", tol="reduce")
C("prod", U(0.5, 1.5, *S), [0, 1], tol="reduce", tag="pos")
C("nansum", NAN, 1, tol="reduce", tag="nan", grad=False)
C("nanmean", NAN, 0, tol="reduce", tag="nan", grad=False)
C("max", np.array([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0]], np.float32), 1,
  tol="reduce", tag="ties")
C("count_nonzero", I(-1, 2, *S), grad=False)
C("count_nonzero", I(-1, 2, *S), 1, grad=False)
C("count_nonzero", I(-1, 2, *S), [0, 2], keepdim=True, grad=False)
C("cumsum", R(*S), 1, tol="reduce")
C("cumsum", R(*S), tol="reduce", tag="flat")
C("cumsum", I(0, 5, *S), -1, grad=False, tag="int")
C("logcumsumexp", R(*S), 2, tol="reduce")
C("logcumsumexp", R(*S), tol="reduce", tag="flat")
C("cumprod", U(0.5, 1.5, *S), 1, tol="reduce")
C("cumprod", U(0.5, 1.5, *S), tol="reduce", tag="flat")
C("cummax", R(*S), 1)
C("cummax", R(*S), tag="flat")
C("cummin", R(*S), -1)
C("cummin", R(*S), tag="flat")
C("trace", R(4, 4), tol="reduce")
C("trace", R(4, 5), 1, tol="reduce")
C("trace", R(2, 3, 3), 0, 1, 2, tol="reduce")
C("diff", R(*A), tol="reduce")
C("diff", R(*A), 2, 0, tol="reduce")
C("diff", R(*A), 1, 1, prepend=R(3, 1), append=R(3, 2), tol="reduce")
C("diff", R(4), prepend=ARG(0.5), tol="reduce", tag="scalar")
C("rot90", R(*A))
C("rot90", R(*S), 2, [1, 2])
C("rot90", R(*A), -1)

# -- manipulation --------------------------------------------------------------
section("manipulation")
C("reshape", R(*S), ARG([4, 6]))
C("reshape", R(*S), ARG([0, -1]))
C("reshape", R(*S), ARG([2, 0, 2, 2]))
C("transpose", R(*S), ARG([2, 0, 1]))
C("transpose", R(*A), ARG([1, 0]))
C("t", R(*A))
C("t", R(*S))
C("t", R(4), tag="1d")
C("moveaxis", R(*S), 0, 2)
C("swapaxes", R(*S), 0, 2)
C("concat", [R(2, 4), R(3, 4)])
C("concat", [R(3, 2), R(3, 4), R(3, 1)], axis=1)
C("concat", [R(2, 3, 4), R(2, 3, 4)], axis=-1)
C("split", R(4, 6), 2)
C("split", R(4, 6), 3, axis=1)
C("split", R(4, 6), ARG([1, -1, 2]), axis=1)
C("split", R(5, 2), ARG([2, 3]))
C("chunk", R(4, 6), 2, axis=1)
C("stack", [R(*A), R(*A)])
C("stack", [R(*A), R(*A), R(*A)], axis=2)
C("unstack", R(*S))
C("unstack", R(*S), axis=1)
C("unbind", R(*S), 2)
C("squeeze", R(1, 3, 1, 4))
C("squeeze", R(1, 3, 1, 4), 2)
C("squeeze", R(1, 3, 1, 4), ARG([0, 1]))
C("unsqueeze", R(*A), 1)
C("unsqueeze", R(*A), ARG([0, 2]))
C("unsqueeze", R(*A), -1)
C("flatten", R(2, 3, 4, 2))
C("flatten", R(2, 3, 4, 2), 1)
C("flatten", R(2, 3, 4, 2), 1, 2)
C("cast", R(*A), ARG("int32"), grad=False)
C("cast", I(0, 9, *A), ARG("float32"), grad=False, tag="int")
C("cast", R(*A), ARG("float32"), tag="same")
C("gather", R(5, 3), np.array([4, 0, 2], np.int64))
C("gather", R(3, 5), np.array([[1, 2], [4, 0]], np.int64), 1)
C("gather", R(5, 3), np.array(3, np.int64), tag="0d")
C("gather_nd", R(*S), np.array([[0, 1], [1, 2]], np.int64))
C("gather_nd", R(*S), np.array([[[0, 1, 3]], [[1, 0, 0]]], np.int64))
C("scatter", R(5, 3), np.array([3, 0], np.int64), R(2, 3))
C("scatter", R(5, 3), np.array([3, 0, 3], np.int64), R(3, 3),
  overwrite=False)
C("scatter_nd_add", R(4, 3), np.array([[1], [3], [1]], np.int64), R(3, 3))
C("scatter_nd_add", R(4, 3), np.array([[1, 2], [0, 0]], np.int64), R(2))
C("scatter_nd", np.array([[1], [3]], np.int64), R(2, 3), ARG([5, 3]))
C("slice", R(3, 5, 4), ARG([0, 2]), ARG([1, -3]), ARG([3, 10]))
C("slice", R(3, 5, 4), ARG([1]), ARG([-4]), ARG([-1]))
C("strided_slice", R(3, 5, 4), ARG([1, 2]), ARG([0, 3]), ARG([5, 0]),
  ARG([2, -1]))
C("expand", R(1, 4), ARG([3, 4]))
C("expand", R(3, 1), ARG([2, -1, 4]))
C("expand_as", R(1, 4), R(3, 4))
C("broadcast_to", R(1, 4), ARG([2, 3, 4]))
C("broadcast_tensors", [R(1, 4), R(3, 1)])
C("tile", R(2, 3), ARG([2, 1]))
C("tile", R(2, 3), ARG([2, 1, 2]))
C("flip", R(*S), 1)
C("flip", R(*S), ARG([0, 2]))
C("reverse", R(*A), 0)
C("roll", R(*A), 1)
C("roll", R(*A), ARG([1, -2]), ARG([0, 1]))
C("roll", R(*A), 2, 1)
C("unique", I(0, 6, 12), grad=False)
C("unique", I(0, 6, 12), return_index=True, return_inverse=True,
  return_counts=True, grad=False)
C("unique_consecutive", np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int64),
  grad=False)
C("unique_consecutive", np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int64),
  return_inverse=True, return_counts=True, grad=False)
C("unique", I(0, 4, *A), return_inverse=True, return_counts=True,
  grad=False)
C("unique", I(0, 2, 6, 3), axis=0, return_inverse=True,
  return_counts=True, grad=False)
C("unique_consecutive", I(0, 2, *A), return_inverse=True,
  return_counts=True, grad=False)
C("unique_consecutive", np.array([[1, 2], [1, 2], [3, 4], [1, 2]],
                                 np.int64),
  axis=0, return_inverse=True, return_counts=True, grad=False)
C("masked_select", R(*A), B(*A), grad=False)
C("masked_select", R(*A), B(1, A[1]), grad=False)
C("index_select", R(5, 3), np.array([4, 1, 1], np.int64))
C("index_select", R(3, 5), np.array([0, 4], np.int64), 1)
C("index_sample", R(3, 5), I(0, 5, 3, 2))
C("where", B(*A), R(*A), R(*A))
C("where", B(*A), R(*A), 0.0, tag="scalar")
C("pad", R(*A), ARG([1, 2, 0, 1]))
C("pad", R(2, 3, 4, 5), ARG([1, 1, 2, 0]), value=1.5)
C("pad", R(2, 3, 4, 5), ARG([1, 2, 2, 1]), mode="reflect")
C("pad", R(2, 3, 4, 5), ARG([1, 2, 2, 1]), mode="replicate")
C("pad", R(2, 3, 4, 5), ARG([1, 2, 3, 1]), mode="circular")
C("pad", R(2, 4, 5, 3), ARG([1, 0, 2, 1]), data_format="NHWC")
C("pad", R(*A), 1, tag="int")
C("repeat_interleave", R(*A), 2, 1)
C("repeat_interleave", R(*A), 2, tag="flat")
C("repeat_interleave", R(3), np.array([1, 0, 2], np.int64), 0)
C("take_along_axis", R(3, 5), I(0, 5, 3, 2), 1)
C("take_along_axis", R(3, 5), I(0, 3, 1, 5), 0)
C("put_along_axis", R(3, 5), np.array([[1], [4], [0]], np.int64), R(3, 1), 1)
C("put_along_axis", R(3, 5), np.array([[1], [4], [0]], np.int64), 2.0, 1,
  reduce="add", grad=False)
C("put_along_axis", R(3, 5), np.array([[1], [4], [0]], np.int64), R(3, 1),
  1, reduce="multiply", grad=False)
C("tensordot", R(3, 4), R(4, 5), 1, tol="reduce")
C("tensordot", R(2, 3, 4), R(3, 4, 5), tol="reduce")
C("tensordot", R(2, 3, 4), R(4, 2, 5), ARG([[0, 2], [1, 0]]),
  tol="reduce")
C("as_real", np.array([[1 + 2j, -3j], [0.5, 2 - 1j]], np.complex64),
  grad=False)
C("as_complex", R(3, 2), grad=False)
C("unfold", R(3, 7), 1, 3, 2)
C("unfold", R(6, 2), 0, 2, 1)
C("view", R(*A), ARG([4, 3]))
C("view", R(*A), ARG("int32"), grad=False, tag="dtype")
C("view_as", R(*A), R(2, 6))
C("atleast_1d", R(3), grad=False)
C("atleast_2d", R(3), grad=False)
C("atleast_3d", R(3, 4), grad=False)
C("atleast_3d", R(3), grad=False, tag="1d")
C("crop", R(4, 5), ARG([2, 3]), ARG([1, 1]))
C("crop", R(4, 5), ARG([2, 3]), ARG([3, 4]), tag="clamped")
C("crop", R(4, 5), ARG([2, 2]))
C("tolist", R(2, 2), grad=False)
C("tolist", I(0, 9, 3), grad=False, tag="int")
C("rot90_", R(*A), 1, ARG([0, 1]))
C("shard_index", I(0, 20, 4, 1), 20, 2, 0, grad=False)
C("shard_index", I(0, 20, 4, 1), 20, 3, 2, ignore_value=-5, grad=False)
C("broadcast_shape", ARG([2, 1, 3]), ARG([4, 3]), grad=False)
C("shape", R(*S), grad=False)
C("rank", R(*S), grad=False)

# -- logic -------------------------------------------------------------------------
section("logic")
EQ_X = np.array([[1, 2, 3], [4, 5, 6]], np.int64)
EQ_Y = np.array([[1, 0, 3], [4, 0, 7]], np.int64)
for fn in ("equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal"):
    C(fn, EQ_X, EQ_Y, grad=False)
    C(fn, R(*A), R(*A), grad=False, tag="float")
C("equal", R(*A), 0.0, grad=False, tag="scalar")
for fn in ("logical_and", "logical_or", "logical_xor"):
    C(fn, B(*A), B(*A), grad=False)
C("logical_not", B(*A), grad=False)
C("logical_and", I(0, 2, *A), B(*A), grad=False, tag="int")
for fn in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    C(fn, I(0, 64, *A), I(0, 64, *A), grad=False)
    C(fn, B(*A), B(*A), grad=False, tag="bool")
C("bitwise_not", I(-64, 64, *A), grad=False)
C("bitwise_not", B(*A), grad=False, tag="bool")
C("bitwise_left_shift", I(0, 64, *A), I(0, 4, *A), grad=False)
C("bitwise_right_shift", I(0, 64, *A), I(0, 4, *A), grad=False)
C("equal_all", EQ_X, EQ_X, grad=False)
C("equal_all", EQ_X, EQ_Y, grad=False)
C("equal_all", R(*A), R(4, 3), grad=False, tag="shape")
C("allclose", R(*A), R(*A), grad=False)
C("allclose", np.ones(3, np.float32), np.ones(3, np.float32) + 1e-7,
  grad=False, tag="near")
C("isclose", np.array([1.0, 2.0, np.nan], np.float32),
  np.array([1.0 + 1e-6, 2.1, np.nan], np.float32), grad=False)
C("isclose", np.array([1.0, 2.0, np.nan], np.float32),
  np.array([1.0 + 1e-6, 2.1, np.nan], np.float32), equal_nan=True,
  grad=False, tag="nan")
C("is_empty", R(*A), grad=False)
C("is_empty", np.zeros((0, 3), np.float32), grad=False, tag="empty")
C("is_tensor", R(*A), grad=False)
C("is_tensor", ARG([1.0]), grad=False, tag="list")
C("isreal", R(*A), grad=False)
C("isreal", np.array([1 + 0j, 2j], np.complex64), grad=False, tag="complex")
C("all", B(*S), grad=False)
C("all", B(*S), 1, grad=False)
C("all", B(*S), ARG([0, 2]), keepdim=True, grad=False)
C("any", B(*S), grad=False)
C("any", B(*S), 0, keepdim=True, grad=False)
C("any", np.zeros((2, 3), bool), grad=False, tag="false")

# -- search ------------------------------------------------------------------------
section("search")
for fn in ("argmax", "argmin"):
    C(fn, R(*A), grad=False)
    C(fn, R(*A), 1, grad=False)
    C(fn, R(*S), 0, keepdim=True, grad=False)
    C(fn, R(*A), 1, dtype=ARG("int32"), grad=False, tag="int32")
C("index_of_max", R(*A), 1, grad=False)
C("argsort", R(*A), grad=False)
C("argsort", R(*A), 0, descending=True, grad=False)
C("argsort", np.array([3, 1, 3, 1, 2], np.int64), grad=False, tag="ties")
C("sort", R(*A))
C("sort", R(*A), 0, descending=True)
C("topk", R(*A), 2)
C("topk", R(*A), 2, axis=0, largest=False)
C("topk", R(*S), 3, axis=1)
C("kthvalue", R(*A), 2)
C("kthvalue", R(*A), 1, axis=0, keepdim=True)
C("mode", np.array([[1, 2, 2, 3], [4, 4, 1, 1]], np.int64), grad=False)
C("mode", np.array([[1, 2, 2, 3], [4, 4, 1, 1], [0, 0, 0, 5]],
                   np.int64), 0, keepdim=True, grad=False)
C("median", R(*A), tol="reduce")
C("median", R(*A), 1, tol="reduce")
C("median", R(3, 5), 1, keepdim=True, tol="reduce")
C("median", R(4, 3), 0, tol="reduce", tag="even")
C("nanmedian", NAN, 1, tol="reduce", grad=False)
C("nanmedian", R(*A), tol="reduce")
C("quantile", R(*A), 0.3, tol="reduce")
C("quantile", R(*A), ARG([0.2, 0.7]), axis=1, tol="reduce")
C("quantile", R(*S), 0.5, axis=ARG((0, 2)), tol="reduce")
C("quantile", R(*S), 0.25, axis=ARG((0, 2)), keepdim=True, tol="reduce",
  tag="keepdim")
for mode in ("lower", "higher", "nearest", "midpoint"):
    C("quantile", R(*A), 0.4, axis=1, interpolation=mode, tol="reduce",
      tag=mode)
C("nanquantile", NAN, 0.5, axis=1, tol="reduce", grad=False)
C("nanquantile", R(*A), ARG([0.1, 0.9]), tol="reduce")
C("searchsorted", np.array([1.0, 2.0, 4.0, 8.0], np.float32),
  np.array([0.5, 2.0, 3.0, 9.0], np.float32), grad=False)
C("searchsorted", np.array([1.0, 2.0, 4.0, 8.0], np.float32),
  np.array([0.5, 2.0, 3.0, 9.0], np.float32), right=True,
  out_int32=True, grad=False)
C("searchsorted", np.array([[1, 3, 5], [2, 4, 6]], np.int64),
  np.array([[3, 6], [1, 5]], np.int64), grad=False)
C("nonzero", I(-1, 2, *A), grad=False)
C("nonzero", I(-1, 2, *A), as_tuple=True, grad=False)

# -- stat ----------------------------------------------------------------------------
section("stat")
for fn in ("std", "var"):
    C(fn, R(*S), tol="reduce")
    C(fn, R(*S), 1, tol="reduce")
    C(fn, R(*S), ARG([0, 2]), unbiased=False, keepdim=True, tol="reduce")
C("numel_stat", R(*S), grad=False)

# -- the in-place forms (paddle.reshape_ etc.) --------------------------------------
section("inplace")
C("reshape_", R(*S), ARG([4, 6]), grad=False)
C("squeeze_", R(1, 3, 1), grad=False)
C("unsqueeze_", R(*A), 1, grad=False)
C("scatter_", R(5, 3), np.array([3, 0], np.int64), R(2, 3), grad=False)
C("tanh_", R(*A), grad=False)


# -- the op library's second half ---------------------------------------------
# constant, well-conditioned matrices for the decompositions (from a
# seeded generator of their own, so the cases above keep their inputs)
_RS = np.random.RandomState(18)


def _spd(n, *batch):
    a = _RS.randn(*batch, n, n)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


SPD3, SPD4B = _spd(3), _spd(4, 2)
WELL3 = (_RS.randn(3, 3) + 3 * np.eye(3)).astype(np.float32)
LOWER4 = (np.tril(_RS.randn(4, 4)) + 4 * np.eye(4)).astype(np.float32)
CHOL3 = np.linalg.cholesky(SPD3).astype(np.float32)

section("linalg")
C("bmm", R(2, 3, 4), R(2, 4, 5), tol="reduce")
C("mv", R(3, 4), R(4), tol="reduce")
C("norm", R(3, 4), tol="reduce")
C("norm", R(3, 4), 2, 1, tol="reduce", tag="p2-axis1")
C("norm", R(2, 3, 4), 3, -1, keepdim=True, tol="reduce", tag="p3")
C("norm", R(5), ARG(float("inf")), tol="reduce", tag="inf-1d")
C("norm", R(3, 4), ARG("inf"), 1, tol="reduce", tag="inf-str")
C("norm", R(3, 4), ARG("fro"), ARG([0, 1]), keepdim=True, tol="reduce",
  tag="fro-pair")
C("norm", R(3, 4), 1, ARG([0, 1]), tol="reduce", grad=False, tag="1-pair")
C("norm", R(3, 4), 0, 1, grad=False, tag="p0")
C("norm", R(4, 4), 2, tol="reduce", grad=False, tag="spectral")
C("vector_norm", R(2, 3), 2.0, 1, tol="reduce")
C("vector_norm", R(6), tol="reduce")
C("matrix_norm", R(2, 3, 4), tol="reduce")
C("matrix_norm", R(3, 4), ARG("nuc"), tol="reduce", grad=False)
C("dist", R(3, 4), R(3, 4), tol="reduce")
C("dist", R(3, 4), R(3, 4), 3, tol="reduce", tag="p3")
C("dist", R(3, 4), R(3, 4), 0, grad=False, tag="p0")
C("dist", R(3, 4), R(3, 4), ARG(float("inf")), tol="reduce", tag="inf")
C("cholesky", SPD3, tol="reduce", grad=False)
C("cholesky", SPD4B, upper=True, tol="reduce", grad=False, tag="upper")
C("cholesky_solve", R(3, 2), CHOL3, tol="reduce")
C("cholesky_solve", R(3, 2), CHOL3.T.copy(), upper=True, tol="reduce",
  tag="upper")
C("inverse", SPD3, tol="reduce")
C("inverse", SPD4B, tol="reduce", tag="batch")
C("det", WELL3, tol="reduce")
C("det", SPD4B, tol="reduce", tag="batch")
C("slogdet", WELL3, tol="reduce")
C("lu", WELL3, tol="reduce", grad=False)
C("eigvalsh", SPD3, tol="reduce", grad=False)
C("eigvalsh", SPD4B, ARG("U"), tol="reduce", grad=False, tag="upper")
C("solve", WELL3, R(3, 2), tol="reduce")
C("triangular_solve", LOWER4, R(4, 2), upper=False, tol="reduce")
C("triangular_solve", LOWER4.T.copy(), R(4, 2), tol="reduce", tag="upper")
C("triangular_solve", LOWER4, R(4, 2), upper=False, transpose=True,
  tol="reduce", tag="transpose")
C("triangular_solve", LOWER4, R(4, 2), upper=False, unitriangular=True,
  tol="reduce", tag="unit")
C("lstsq", R(5, 3), R(5, 2), tol="reduce", grad=False)
C("lstsq", R(5, 3), R(5), tol="reduce", grad=False, tag="vector")
C("matrix_power", WELL3, 3, tol="reduce")
C("matrix_power", SPD3, -2, tol="reduce", tag="negative")
C("matrix_rank", R(4, 3), grad=False)
C("matrix_rank", np.ones((3, 3), np.float32), grad=False, tag="rank1")
C("pinv", R(4, 3), tol="reduce", grad=False)
C("cross", R(3, 4), R(3, 4))
C("cross", R(2, 3), R(2, 3), axis=1, tag="axis")
C("corrcoef", R(3, 5), tol="reduce")
C("corrcoef", R(5, 3), rowvar=False, tol="reduce", tag="cols")
C("cov", R(3, 5), tol="reduce")
C("cov", R(5, 3), rowvar=False, ddof=False, tol="reduce", tag="cols")
C("histogram", R(20), bins=5, grad=False)
C("histogram", R(20), 4, -1.0, 1.0, grad=False, tag="range")
C("histogramdd", R(10, 2), bins=3, grad=False)
C("bincount", I(0, 6, 10), grad=False)
C("bincount", I(0, 6, 10), R(10), minlength=8, grad=False, tag="weights")
C("multi_dot", [R(2, 3), R(3, 4), R(4, 2)], tol="reduce")
C("linalg.cond", WELL3, tol="reduce", grad=False)
C("linalg.cond", WELL3, ARG("fro"), tol="reduce", grad=False, tag="fro")
C("einsum", ARG("ij,jk->ik"), R(2, 3), R(3, 4), tol="reduce")
C("einsum", ARG("bij,bkj->bik"), R(2, 3, 4), R(2, 5, 4), tol="reduce",
  tag="batch")
C("einsum", ARG("ii->i"), R(3, 3), tag="diag")
C("einsum", ARG("i,j->ij"), R(3), R(4), tag="outer")

section("sequence")
C("sequence_mask", np.array([2, 0, 4], np.int64), grad=False)
C("sequence_mask", np.array([1, 3], np.int64), maxlen=5, dtype=ARG("bool"),
  grad=False, tag="bool")
C("sequence_pad", R(9, 3), 0.0, np.array([2, 3, 4], np.int64))
C("sequence_pad", R(9, 3), -1.0, np.array([2, 3, 4], np.int64), maxlen=5,
  tag="maxlen")
C("sequence_unpad", R(3, 4, 2), np.array([2, 4, 1], np.int64))
for _pool in ("sum", "average", "sqrt", "max", "min", "last", "first"):
    C("sequence_pool", R(3, 5, 2), ARG(_pool),
      np.array([2, 5, 1], np.int64), tag=_pool)
C("sequence_pool", R(3, 5, 2), ARG("max"), np.array([2, 5, 0], np.int64),
  pad_value=-7.0, grad=False, tag="empty")
C("sequence_pool", R(2, 4, 3), ARG("average"), tag="no-length")
C("sequence_first_step", R(3, 4, 2), np.array([1, 4, 2], np.int64))
C("sequence_last_step", R(3, 4, 2), np.array([1, 4, 2], np.int64))
C("sequence_softmax", R(3, 5), np.array([2, 5, 3], np.int64))
C("sequence_softmax", R(2, 4, 1), np.array([3, 1], np.int64), tag="3d")
C("sequence_reverse", R(3, 5, 2), np.array([2, 5, 3], np.int64))
C("sequence_reverse", R(2, 4), tag="no-length")
C("sequence_expand", R(3, 2), np.array([2, 0, 3], np.int64))
C("sequence_expand_as", R(3, 2), R(3, 4, 1))
# a list argument: the JAX registry takes no gradient through it, so the
# port's gradients of the list-taking ops are held in
# tests/test_torch_ops_extras.py instead
C("sequence_concat", [R(2, 3, 2), R(2, 4, 2)],
  [np.array([1, 3], np.int64), np.array([4, 2], np.int64)], grad=False)
C("sequence_concat", [R(2, 3, 2), R(2, 4, 2)], grad=False, tag="no-length")
C("sequence_slice", R(3, 6, 2), np.array([1, 0, 2], np.int64),
  np.array([2, 4, 3], np.int64))
C("sequence_reshape", R(2, 4, 6), 3)
C("sequence_enumerate", I(0, 9, 2, 5), 3, grad=False)
C("sequence_enumerate", I(0, 9, 2, 5), 2, pad_value=-1, grad=False,
  tag="pad")

section("misc")
M = "ops.misc_ops."
C(M + "print_op", R(2, 3), message=ARG("x: "))
C(M + "select_input", [R(2, 3), R(2, 3), R(2, 3)], np.array(1, np.int64))
C(M + "select_input", [R(2, 3), R(2, 3)], np.array(5, np.int64),
  tag="clamped")
C(M + "select_output", R(2, 3), np.array(1, np.int64), n_out=3)
C(M + "partial_concat", [R(2, 5), R(2, 5)], start_index=1, length=2)
C(M + "partial_concat", [R(2, 5), R(2, 5)], tag="all")
C(M + "partial_sum", [R(2, 5), R(2, 5), R(2, 5)], start_index=-3, length=2)
C(M + "pad_constant_like", R(3, 4), R(2, 3), pad_value=1.5)
C(M + "space_to_depth", R(1, 2, 4, 6), 2)
C(M + "conv_shift", R(2, 7), R(2, 3))
C(M + "row_conv", R(2, 5, 3), R(2, 3))
C(M + "add_position_encoding", R(2, 5, 6), alpha=0.5, beta=2.0)
C(M + "add_position_encoding", R(2, 4, 5), tag="odd")
C(M + "filter_by_instag", R(4, 3), np.array([1, 2, 0, 1], np.int64),
  np.array([1, 2, 3, 2], np.int64), np.array([2], np.int64), grad=False)
C(M + "filter_by_instag", R(2, 3), np.array([1, 1], np.int64),
  np.array([1, 3], np.int64), np.array([2], np.int64),
  out_val_if_empty=-1, grad=False, tag="empty")
C(M + "split_ids", I(0, 10, 8), 3, grad=False)
C(M + "merge_ids", np.array([3, 5, 7, 9, 4], np.int64),
  [np.array([3, 9], np.int64), np.array([5, 7], np.int64)],
  [R(2, 4), R(2, 4)], grad=False)
C(M + "spp", R(1, 2, 4, 4), 2)
C(M + "spp", R(1, 2, 6, 6), 3, pooling_type=ARG("avg"), tag="avg")
C(M + "sequence_conv", R(2, 5, 3), R(9, 4), np.array([3, 5], np.int64))
C(M + "sequence_conv", R(2, 5, 3), R(6, 4), context_length=2,
  context_start=0, tag="start")
C(M + "sequence_scatter", R(2, 6), I(0, 6, 2, 3), R(2, 3))
C(M + "sequence_scatter", R(2, 6), I(0, 6, 2, 3), R(2, 3),
  np.array([2, 3], np.int64), tag="length")
C(M + "sequence_topk_avg_pooling", R(2, 3, 6), topks=ARG((1, 3)))
C(M + "l1_norm", R(3, 4), tol="reduce")
C(M + "squared_l2_norm", R(3, 4), tol="reduce")
C(M + "squared_l2_distance", R(3, 4), R(3, 4), tol="reduce")
C(M + "squared_l2_distance", R(3, 4), R(1, 4), tol="reduce", tag="bcast")

section("loss_extra")
L = "ops.loss_extra."
C(L + "hinge_loss", R(4, 1), I(0, 2, 4, 1, dtype=np.float32))
C(L + "huber_loss", R(4, 3), R(4, 3), delta=0.5)
C(L + "modified_huber_loss", U(-3, 3, 6, 1), I(0, 2, 6, 1, dtype=np.float32))
C(L + "rank_loss", I(0, 2, 4, 1, dtype=np.float32), R(4, 1), R(4, 1))
C(L + "bpr_loss", R(4, 5), I(0, 5, 4, 1), tol="reduce")
C(L + "center_loss", R(4, 3), I(0, 3, 4), R(3, 3), alpha=0.1)
C(L + "center_loss", R(4, 3), I(0, 3, 4), R(3, 3), need_update=False,
  tag="no-update")
C(L + "teacher_student_sigmoid_loss", R(6, 1),
  np.array([[-2.0], [-0.5], [0.3], [1.2], [0.0], [1.0]], np.float32))
C(L + "fsp", R(2, 3, 4, 4), R(2, 2, 4, 4), tol="reduce")
C(L + "cvm", U(0, 5, 4, 5), None)
C(L + "cvm", U(0, 5, 4, 5), None, use_cvm=False, tag="drop")
C(L + "data_norm", R(4, 3), U(1, 5, 3), R(3), U(1, 3, 3))
C(L + "sample_logits", R(3, 10), I(0, 10, 3, 1),
  use_customized_samples=True, customized_samples=I(0, 10, 3, 4),
  customized_probabilities=U(0.05, 0.5, 3, 4), tol="reduce")
C(L + "hierarchical_sigmoid", R(4, 3), I(0, 5, 4), R(4, 3), num_classes=5,
  tol="reduce")
C(L + "match_matrix_tensor", R(2, 3, 4), R(2, 5, 6), R(4, 2, 6),
  tol="reduce")

section("extras")
C("affine_channel", R(2, 3, 4, 4), R(3), R(3))
C("affine_channel", R(2, 4, 4, 3), R(3), R(3), data_format=ARG("NHWC"),
  tag="nhwc")
C("multiplex", [R(4, 3), R(4, 3), R(4, 3)],
  np.array([[2], [0], [1], [2]], np.int64), grad=False)
SEG = np.array([0, 0, 1, 1, 1, 2], np.int64)
for _fn in ("segment_sum", "segment_mean", "segment_max", "segment_min"):
    C(_fn, R(6, 3), SEG)
    C(_fn, R(6, 3), np.array([0, 0, 3, 3, 3, 3], np.int64), grad=False,
      tag="empty")
C("linear_chain_crf", R(2, 4, 3), R(5, 3), I(0, 3, 2, 4),
  np.array([4, 2], np.int64), tol="reduce")
C("linear_chain_crf", R(3, 5, 4), R(6, 4), I(0, 4, 3, 5), tol="reduce",
  tag="full")
C("viterbi_decode", R(2, 4, 3), R(5, 3), np.array([4, 2], np.int64),
  tol="reduce")
C("viterbi_decode", R(2, 5, 3), R(3, 3), include_bos_eos_tag=False,
  tol="reduce", tag="no-bos-eos")
C("gather_tree", I(0, 7, 4, 2, 3), I(0, 3, 4, 2, 3), grad=False)
C("beam_search_step", R(2, 3, 7), R(2, 3), beam_size=3)
C("diagonal", R(3, 4), 1)
C("diagonal", R(2, 3, 4), 0, 1, 2, tag="axes")
C("diag_embed", R(2, 3))
C("diag_embed", R(2, 3), 1, tag="offset")
C("affine_grid", R(2, 2, 3), ARG([2, 1, 3, 4]))
C("affine_grid", R(2, 2, 3), ARG([2, 1, 3, 4]), align_corners=False,
  tag="corners")
C("grid_sample", R(1, 2, 4, 4), U(-0.9, 0.9, 1, 3, 3, 2), tol="reduce")
C("bucketize", R(6), np.array([-1.0, 0.0, 1.0], np.float32), grad=False)
C("bucketize", np.array([-1.0, 0.0, 0.5, 1.0], np.float32),
  np.array([-1.0, 0.0, 1.0], np.float32), out_int32=True, right=True,
  grad=False, tag="right")
C("renorm", R(3, 4), 2.0, 0, 1.0)
C("renorm", R(3, 4), 1.0, 1, 0.5, tag="p1")
C("lgamma", U(0.5, 4, 3, 4))
C("lgamma", I(1, 6, 4), grad=False, tag="int")
C("digamma", U(0.5, 4, 3, 4), tol="reduce")
C("polygamma", U(0.5, 4, 3, 4), 1, tol="reduce")
C("logit", U(0.1, 0.9, 3, 4))
C("logit", U(0.0, 1.0, 3, 4), eps=0.2, tag="eps")
C("frexp", U(-9, 9, 3, 4), grad=False)
C("trapezoid", R(3, 5), tol="reduce")
C("trapezoid", R(3, 5), np.array([0.0, 0.5, 1.5, 2.0, 4.0], np.float32),
  tol="reduce", tag="x")
C("trapezoid", R(4, 3), dx=0.5, axis=0, tol="reduce", tag="dx")
C("cumulative_trapezoid", R(3, 5), tol="reduce")
C("cumulative_trapezoid", R(3, 5),
  np.array([0.0, 0.5, 1.5, 2.0, 4.0], np.float32), tol="reduce", tag="x")
C("cumulative_trapezoid", R(4, 3), dx=0.5, axis=0, tol="reduce", tag="dx")
C("vander", R(4), tol="reduce")
C("vander", R(4), 3, increasing=True, tol="reduce", tag="n")
C("cdist", R(3, 2), R(4, 2), tol="reduce")
C("cdist", R(3, 2), R(4, 2), 1.0, tol="reduce", tag="p1")
C("cdist", R(2, 3, 2), R(2, 4, 2), ARG(float("inf")), tol="reduce",
  tag="inf")
C("block_diag", [R(2, 2), R(1, 3)], grad=False)
C("householder_product", R(4, 3), R(3), tol="reduce")
C("py_func", ARG(np.sin), R(3, 4), grad=False)

section("amp_ops")
C("check_finite_and_unscale", R(3), R(2, 2), scale=np.array(4.0, np.float32),
  grad=False)
C("check_finite_and_unscale", np.array([1.0, np.inf], np.float32), R(2),
  scale=np.array(2.0, np.float32), grad=False, tag="inf")
for _found in (False, True):
    C("update_loss_scaling", np.array(_found), np.array(1024.0, np.float32),
      np.array(3, np.int32), np.array(0, np.int32), incr_every_n_steps=4,
      grad=False, tag=f"found-{_found}")
C("update_loss_scaling", np.array(False), np.array(8.0, np.float32),
  np.array(3, np.int32), np.array(0, np.int32), incr_every_n_steps=4,
  grad=False, tag="grow")
C("update_loss_scaling", np.array(True), np.array(8.0, np.float32),
  np.array(3, np.int32), np.array(1, np.int32), decr_every_n_nan_or_inf=2,
  grad=False, tag="shrink")
C("update_loss_scaling", np.array(True), np.array(8.0, np.float32),
  np.array(3, np.int32), np.array(1, np.int32), stop_update=True,
  grad=False, tag="stop")


def by_module(name):
    return [c for c in CASES if c.module == name]

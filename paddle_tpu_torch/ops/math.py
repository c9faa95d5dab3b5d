"""Elementwise, reduction and math ops (counterpart of
paddle_tpu/ops/math.py).

Each op is the JAX package's function, in torch ops; torch autograd
gives the gradients the JAX package takes from jax.vjp. Python scalars
and arrays are taken as the JAX package takes them: a number meets a
tensor as a 0-d tensor, so the tensor's dtype wins within its kind (as
JAX's weak types do). Reductions take `axis` as an int, a list or a
tuple (None: every axis) and `keepdim`. An integer sum is int64 where
the JAX package (x64 off) gives int32.
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import amp_cast
from ..core import dtypes as _dtypes
from ._args import axis_of, tensor_of

__all__ = [
    "floor_mod", "mm",
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "float_power", "matmul", "abs", "sqrt", "rsqrt",
    "exp", "expm1", "log", "log2", "log10", "log1p", "sin", "cos", "tan",
    "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "atan2", "floor", "ceil", "round", "trunc", "frac", "sign",
    "square", "reciprocal", "neg", "clip", "maximum", "minimum", "fmax",
    "fmin", "sum", "mean", "max", "min", "prod", "nansum", "nanmean",
    "cumsum", "cumprod", "cummax", "cummin", "logsumexp", "logcumsumexp",
    "isnan", "isinf", "isfinite", "erf", "erfinv", "lerp", "addmm", "inner",
    "outer", "dot", "kron", "trace", "diff", "angle", "conj", "real", "imag",
    "deg2rad", "rad2deg", "gcd", "lcm", "heaviside", "rot90", "amax", "amin",
    "stanh", "rsub_", "logaddexp", "hypot", "ldexp", "copysign", "nextafter",
    "signbit", "scale", "increment", "multiply_", "add_n", "count_nonzero",
]


def _pair(x, y):
    """(x, y) as tensors on one device; a number becomes a 0-d tensor."""
    if not isinstance(x, torch.Tensor):
        x = tensor_of(x, like=y if isinstance(y, torch.Tensor) else None)
    return x, tensor_of(y, like=x)


# -- binary elementwise ------------------------------------------------------

def _binary(fn, same_dtype=False):
    def op(x, y, name=None):
        x, y = _pair(x, y)
        if same_dtype and y.dtype != x.dtype:
            dt = torch.promote_types(x.dtype, y.dtype)
            x, y = x.to(dt), y.to(dt)
        return fn(x, y)
    return op


add = _binary(torch.add)
subtract = _binary(torch.sub)
multiply = _binary(torch.mul)
divide = _binary(torch.true_divide)
floor_divide = _binary(torch.floor_divide)
mod = _binary(torch.remainder)
remainder = mod
pow = _binary(torch.pow)
float_power = pow
maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)
fmax = _binary(torch.fmax)
fmin = _binary(torch.fmin)
atan2 = _binary(torch.atan2)
logaddexp = _binary(torch.logaddexp)
hypot = _binary(torch.hypot, same_dtype=True)
copysign = _binary(torch.copysign)
nextafter = _binary(torch.nextafter, same_dtype=True)
heaviside = _binary(torch.heaviside, same_dtype=True)
gcd = _binary(torch.gcd)
lcm = _binary(torch.lcm)


def ldexp(x, y, name=None):
    x, y = _pair(x, y)
    return torch.ldexp(x, y.to(torch.int32))


# -- matmul family -----------------------------------------------------------

def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """An AMP white-list op ("matmul_v2", as the JAX package registers
    it): under auto_cast its inputs are cast to the AMP dtype."""
    x, y = amp_cast("matmul_v2", *_pair(x, y))
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """An AMP white-list op, as matmul."""
    input, x, y = amp_cast("addmm", tensor_of(input), *_pair(x, y))
    return beta * input + alpha * torch.matmul(x, y)


def inner(x, y, name=None):
    return torch.inner(*_pair(x, y))


def outer(x, y, name=None):
    x, y = _pair(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


def dot(x, y, name=None):
    x, y = _pair(x, y)
    return torch.sum(x * y, dim=-1)


def kron(x, y, name=None):
    return torch.kron(*_pair(x, y))


# -- unary -------------------------------------------------------------------

def _unary(fn):
    def op(x, name=None):
        return fn(tensor_of(x))
    return op


def _real_only(fn, otherwise):
    """fn on a complex tensor, `otherwise` on a real one (jnp's real,
    imag and conj take real arrays)."""
    return lambda x: fn(x) if x.is_complex() else otherwise(x)


abs = _unary(torch.abs)
sqrt = _unary(torch.sqrt)
rsqrt = _unary(torch.rsqrt)
exp = _unary(torch.exp)
expm1 = _unary(torch.expm1)
log = _unary(torch.log)
log2 = _unary(torch.log2)
log10 = _unary(torch.log10)
log1p = _unary(torch.log1p)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
asin = _unary(torch.asin)
acos = _unary(torch.acos)
atan = _unary(torch.atan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
asinh = _unary(torch.asinh)
acosh = _unary(torch.acosh)
atanh = _unary(torch.atanh)
floor = _unary(torch.floor)
ceil = _unary(torch.ceil)
round = _unary(torch.round)
trunc = _unary(torch.trunc)
sign = _unary(torch.sign)
square = _unary(torch.square)
reciprocal = _unary(lambda x: 1.0 / x)
neg = _unary(torch.neg)
erf = _unary(torch.erf)
erfinv = _unary(torch.erfinv)
angle = _unary(torch.angle)
conj = _unary(_real_only(torch.conj, lambda x: x))
real = _unary(_real_only(torch.real, lambda x: x))
imag = _unary(_real_only(torch.imag, torch.zeros_like))
deg2rad = _unary(torch.deg2rad)
rad2deg = _unary(torch.rad2deg)
signbit = _unary(torch.signbit)
isnan = _unary(torch.isnan)
isinf = _unary(torch.isinf)
isfinite = _unary(torch.isfinite)


def frac(x, name=None):
    x = tensor_of(x)
    return x - torch.trunc(x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * tensor_of(x))


def clip(x, min=None, max=None, name=None):
    x = tensor_of(x)
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


def lerp(x, y, weight, name=None):
    x, y = _pair(x, y)
    return x + weight * (y - x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = tensor_of(x)
    return x * scale + bias if bias_after_scale else (x + bias) * scale


@torch.no_grad()
def increment(x, value=1.0, name=None):
    """x += value in place, outside autograd (the JAX set_value)."""
    return x.add_(value)


@torch.no_grad()
def multiply_(x, y, name=None):
    """x *= y in place, outside autograd (the JAX set_value)."""
    return x.mul_(y)


def rsub_(x, y):
    return subtract(y, x)


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    out = inputs[0]
    for x in inputs[1:]:
        out = out + x
    return out


# -- reductions --------------------------------------------------------------

def _dims(x, axis):
    """The reduced dims as a tuple (every dim for None)."""
    ax = axis_of(axis)
    if ax is None:
        return tuple(range(x.dim()))
    return ax if isinstance(ax, tuple) else (ax,)


def _reduce(fn, x, axis, keepdim):
    """fn(x, dim=dims, keepdim=) over the dims of `axis`; an empty axis
    list reduces nothing, as in jnp."""
    x = tensor_of(x)
    dims = _dims(x, axis)
    if not dims:
        return x
    return fn(x, dim=dims, keepdim=keepdim)


def _cast(out, dtype):
    return out.to(_dtypes.convert_dtype(dtype)) if dtype is not None \
        else out


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(_dtypes.get_default_dtype())


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return _cast(_reduce(torch.sum, x, axis, keepdim), dtype)


def mean(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.mean, _float(tensor_of(x)), axis, keepdim)


def max(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.amax, x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.amin, x, axis, keepdim)


amax, amin = max, min


def _prod(x, dim, keepdim):
    """torch.prod over several dims (torch takes one)."""
    for d in sorted((d % x.dim() for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    return _cast(_reduce(_prod, x, axis, keepdim), dtype)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return _cast(_reduce(torch.nansum, x, axis, keepdim), dtype)


def nanmean(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.nanmean, _float(tensor_of(x)), axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.logsumexp, x, axis, keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = tensor_of(x)
    return _reduce(torch.sum, x != 0, axis, keepdim).to(torch.int64)


def _flat_axis(x, axis):
    """(x, axis) with x flattened when axis is None."""
    x = tensor_of(x)
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis)


def cumsum(x, axis=None, dtype=None, name=None):
    x, axis = _flat_axis(x, axis)
    return _cast(torch.cumsum(x, axis), dtype)


def logcumsumexp(x, axis=None, name=None):
    x, axis = _flat_axis(x, axis)
    return torch.logcumsumexp(x, axis)


def cumprod(x, dim=None, dtype=None, name=None):
    x, dim = _flat_axis(x, dim)
    return _cast(torch.cumprod(x, dim), dtype)


def cummax(x, axis=None, dtype="int64", name=None):
    """(running max, the index where it was last attained), int64."""
    x, axis = _flat_axis(x, axis)
    vals, idx = torch.cummax(x, axis)
    return vals, idx.to(torch.int64)


def cummin(x, axis=None, dtype="int64", name=None):
    x, axis = _flat_axis(x, axis)
    vals, idx = torch.cummin(x, axis)
    return vals, idx.to(torch.int64)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(tensor_of(x), offset, axis1, axis2).sum(-1)


def _edge(v, x, axis):
    """diff's prepend/append as a tensor of x's rank (a number is one
    slice along `axis`)."""
    v = tensor_of(v, like=x).to(x.dtype)
    if v.dim() == 0:
        shape = list(x.shape)
        shape[axis] = 1
        v = v.expand(shape)
    return v


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = tensor_of(x)
    return torch.diff(
        x, n, axis,
        prepend=None if prepend is None else _edge(prepend, x, axis),
        append=None if append is None else _edge(append, x, axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(tensor_of(x), k, list(axes))


# reference aliases (python/paddle/__init__.py DEFINE_ALIAS rows)
floor_mod = mod
mm = matmul

for _n in __all__:
    if getattr(globals()[_n], "__name__", None) == "op":
        globals()[_n].__name__ = _n

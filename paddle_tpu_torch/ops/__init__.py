"""The op library and the kernels of the port (counterpart of
paddle_tpu/ops).

The op modules of Paddle's Tensor surface: creation, math,
manipulation, logic, search and stat, each the JAX package's module in
torch ops, with Paddle's semantics. `__all__` is the union of their
lists with the detection, vision-sampling and beam-search ops and the
in-place forms reshape_, squeeze_, unsqueeze_, scatter_ and tanh_; the
package's top level exports it, as the JAX package's does (`from .ops import *`).
ops.nms stays the NMS kernel's module; paddle_tpu_torch.nms is the
detection op. The kernels: flash_attention, philox and nms (csrc/).

The Tensor decision. The port's Tensor IS torch.Tensor. The JAX package
sets every op of these modules on its own Tensor as a method and routes
the Python operators through them (paddle_tpu/ops/__init__.py:106-177).
Doing that to torch.Tensor would change torch's behaviour for torch
itself and for every ported module, since many names mean something
else in torch. So:

- the top-level functions (paddle_tpu_torch.split(x, 2),
  paddle_tpu_torch.transpose(x, perm), ...) always have Paddle's
  semantics, and so do the in-place forms with a trailing `_`;
- only names torch.Tensor does not have are set on it, once, at import
  (framework.add_methods): the op names below that torch lacks (x.scale,
  x.concat, x.mod, x.greater_than, ...), and framework.py's
  stop_gradient, astype, cast, clear_gradient, clear_grad, set_value,
  place, rank and gradient;
- no attribute torch.Tensor already has is replaced, the operators
  (__eq__, __add__, ...) included, so the ported modules keep calling
  torch's methods and CUDA-graph capture sees plain torch;
- so a method torch already has keeps torch's meaning. COLLISIONS lists
  those whose meaning differs from Paddle's function of the same name
  (call the function for Paddle's; the table is appended to this
  docstring below); SAME_AS_TORCH lists the others.
  tests/test_torch_ops_surface.py pins both against torch.Tensor.
"""
from . import (creation, detection, extras, flash_attention,  # noqa: F401
               logic, manipulation, math, nms, search, stat)
from .creation import *  # noqa: F401,F403
from .detection import (box_clip, box_coder, iou_similarity,  # noqa: F401
                        matrix_nms, multiclass_nms, yolo_box, yolov3_loss)
from .extras import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from ..framework import add_methods as _add_methods
from ..framework import to_tensor  # noqa: F401

#: the op modules whose functions become Tensor methods
SURFACE = (creation, math, manipulation, logic, search, stat)

#: torch.Tensor methods whose meaning differs from Paddle's function of
#: the same name (torch's stays on the Tensor; the function is Paddle's)
COLLISIONS = {
    "split": "torch: an int is the chunk size; Paddle: the section count",
    "transpose": "torch: swaps two dims; Paddle: takes a permutation",
    "gather": "torch: gathers with an index of x's rank; Paddle: "
              "index_select along axis, the index's shape in its place",
    "scatter": "torch: scatter(dim, index, src); Paddle: overwrites rows",
    "max": "torch: with a dim, (values, indices); Paddle: values",
    "min": "torch: with a dim, (values, indices); Paddle: values",
    "sort": "torch: (values, indices); Paddle: values",
    "mode": "torch: index of any occurrence; Paddle: of the last",
    "median": "torch: the lower middle and its index; Paddle: the mean of "
              "the two middle values",
    "nanmedian": "torch: the lower middle and its index; Paddle: the mean",
    "kthvalue": "torch: index of any tie; Paddle: the stable sort's",
    "flatten": "torch: start_dim/end_dim; Paddle: start_axis/stop_axis",
    "t": "torch: at most 2-d; Paddle: swaps the last two dims of any rank",
    "expand": "torch: sizes as arguments; Paddle: shape=",
    "reshape": "torch: 0 is a size; Paddle: 0 copies the input's dim",
    "unsqueeze": "torch: one dim; Paddle: an int or a list of axes",
    "squeeze": "torch: dim=; Paddle: axis= (an int or a list)",
    "shape": "torch: the torch.Size attribute; Paddle: paddle.shape(x) "
             "is an int32 tensor (and Tensor.shape a list)",
    "numel": "torch: a Python int; Paddle: an int64 0-d tensor",
    "cumsum": "torch: dim is required; Paddle: axis None flattens",
    "cumprod": "torch: dim is required; Paddle: dim None flattens",
    "logsumexp": "torch: dim is required; Paddle: axis None is all",
    "count_nonzero": "torch: no keepdim; Paddle: keepdim, int64",
    "unique": "torch: no return_index; Paddle: numpy's unique",
    "nonzero": "torch: as_tuple gives 1-d tensors; Paddle: [n, 1] each",
    "view": "torch: view(dtype) reinterprets the bits; Paddle: casts",
    "where": "torch: x.where(condition, y); Paddle: where(condition, x, y)",
    "dot": "torch: 1-d only; Paddle: over the last axis of any rank",
    "outer": "torch: 1-d only; Paddle: flattens its inputs",
    "matmul": "torch: no transpose_x/transpose_y",
    "mm": "torch: 2-d only; Paddle: matmul",
    "trace": "torch: 2-d, no offset; Paddle: offset, axis1, axis2",
    "index_select": "torch: (dim, index); Paddle: (index, axis)",
    "equal": "torch: one Python bool for the whole tensor; Paddle: "
             "elementwise",
    "allclose": "torch: a Python bool; Paddle: a 0-d bool tensor",
    "float_power": "torch: computes in float64; Paddle: pow",
    "imag": "torch: complex inputs only; Paddle: zeros for a real one",
    "multiply_": "torch: recorded by autograd; Paddle: a write outside it",
    "chunk": "torch: uneven chunks allowed; Paddle: equal sections",
    "diag": "torch: no padding_value",
}

#: torch.Tensor methods with Paddle's meaning (argument names aside)
SAME_AS_TORCH = frozenset("""
abs acos acosh add addmm all amax amin angle any argmax argmin argsort
asin asinh atan atan2 atanh bernoulli bitwise_and bitwise_left_shift
bitwise_not bitwise_or bitwise_right_shift bitwise_xor broadcast_to ceil
clip conj copysign cos cosh cummax cummin deg2rad diagflat diff divide erf
erfinv exp expand_as expm1 flip floor floor_divide fmax fmin frac gcd
greater_equal heaviside hypot inner isclose isfinite isinf isnan isreal
kron lcm ldexp lerp less_equal log log10 log1p log2 logaddexp logcumsumexp
logical_and logical_not logical_or logical_xor masked_select maximum mean
minimum moveaxis multinomial multiply nanmean nanquantile nansum neg
nextafter not_equal pow prod quantile rad2deg real reciprocal
remainder repeat_interleave roll rot90 round rsqrt sign signbit sin sinh
sqrt square std subtract sum swapaxes tan tanh tile tolist topk tril triu
trunc unbind unfold unique_consecutive var view_as
""".split())

__doc__ = (__doc__ or "") + "\nThe collision table (COLLISIONS):\n\n" + "\n".join(
    f"- {name}: {how}" for name, how in COLLISIONS.items()) + "\n"

#: names never set on the Tensor (as in the JAX package)
_NOT_METHODS = {"create_parameter", "broadcast_tensors", "set_printoptions",
                "broadcast_shape"}

METHODS_ADDED = _add_methods({
    nm: getattr(mod, nm) for mod in reversed(SURFACE) for nm in mod.__all__
    if nm not in _NOT_METHODS})


# -- the in-place forms ----------------------------------------------------------

def _inplace(fn):
    """x.copy_(fn(x, ...)): the result written into x, recorded by
    autograd (a leaf that requires grad refuses it, as the JAX package's
    tape does)."""
    def f(x, *a, **k):
        return x.copy_(fn(x, *a, **k))
    f.__name__ = fn.__name__ + "_"
    return f


def _restride_(x, new):
    """x given `new`'s shape in place: a view's metadata change on a
    contiguous x, recorded by autograd."""
    if not x.is_contiguous():
        raise ValueError("an in-place reshape needs a contiguous tensor")
    return x.as_strided_(new.shape, new.stride())


def reshape_(x, shape, name=None):
    return _restride_(x, manipulation.reshape(x, shape))


def squeeze_(x, axis=None, name=None):
    return _restride_(x, manipulation.squeeze(x, axis))


def unsqueeze_(x, axis, name=None):
    return _restride_(x, manipulation.unsqueeze(x, axis))


scatter_ = _inplace(manipulation.scatter)
tanh_ = _inplace(math.tanh)

#: Paddle's in-place methods torch lacks (x.scale_(...), x.reshape_(...))
METHODS_ADDED += _add_methods({"scale_": _inplace(math.scale),
                               "reshape_": reshape_})

__all__ = (creation.__all__ + math.__all__ + manipulation.__all__
           + logic.__all__ + search.__all__ + stat.__all__
           + extras.__all__
           + [n for n in detection.__all__ if n != "nms"]
           + ["reshape_", "squeeze_", "unsqueeze_", "scatter_", "tanh_"])

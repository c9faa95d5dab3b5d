"""The JAX package's vision models with weights from a numpy seed, for
the port's vision tests (tests/test_torch_vision_models.py,
test_torch_resnet_train.py, test_torch_bn_parallel.py).

A model is built under paddle_tpu.utils.abstract_init (jax.random's
per-shape compiles cost seconds a model) and given conv and linear
weights N(0, 2 / fan_in), BatchNorm weights 1 + 0.1 N(0, 1) and biases
0.1 N(0, 1); the running statistics keep their zeros and ones. The port
takes them by name (models/convert.py load_jax_params).

jax_f64_steps runs the JAX TrainStep in float64, the referee against
which nearer_f64 holds an f32 result three ways where the port and the
JAX package part by more than a test's tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np

from paddle_tpu.utils.abstract_init import abstract_parameters
from paddle_tpu.vision import models as JM


def jax_vision_model(name, seed=0, num_classes=10, **kw):
    with abstract_parameters():
        m = getattr(JM, name)(num_classes=num_classes, **kw)
    rng = np.random.default_rng(seed)
    for k, t in m.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            continue
        shape = tuple(np.shape(t._data))
        arr = rng.standard_normal(shape, dtype=np.float32)
        if len(shape) >= 2:
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            arr *= np.float32(np.sqrt(2.0 / fan_in))
        elif k.endswith("weight"):
            arr = 1.0 + 0.1 * arr
        else:
            arr = 0.1 * arr
        t._data = jnp.asarray(arr)
    return m


def jax_yolo_model(seed=0, num_classes=4, width=4, stats=True,
                   backbone=None):
    """The JAX YOLOv3 with weights as jax_vision_model gives them and,
    with `stats`, running statistics that are not the identity (means
    0.1 N(0, 1), variances 1 + 0.1 |N(0, 1)|), so an eval forward
    normalises with them. backbone: a function making the backbone
    layer (default: the model's DarkNetTiny of `width`)."""
    from paddle_tpu.models import YOLOv3
    with abstract_parameters():
        m = YOLOv3(num_classes=num_classes, width=width,
                   backbone=None if backbone is None else backbone())
    rng = np.random.default_rng(seed)
    for k, t in m.state_dict().items():
        shape = tuple(np.shape(t._data))
        arr = rng.standard_normal(shape, dtype=np.float32)
        if k.endswith("_mean"):
            if not stats:
                continue
            arr = 0.1 * arr
        elif k.endswith("_variance"):
            if not stats:
                continue
            arr = 1.0 + 0.1 * np.abs(arr)
        elif len(shape) >= 2:
            arr *= np.float32(np.sqrt(2.0 / int(np.prod(shape[1:]))))
        elif k.endswith("weight"):
            arr = 1.0 + 0.1 * arr
        else:
            arr = 0.1 * arr
        t._data = jnp.asarray(arr)
    return m


def rel_err(got, want):
    """max |got - want| over max(1, max |want|), in float64."""
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# How far the reference's f32 value may lie from the float64 evaluation
# for a disagreement to be read as rounding (the largest seen: 2.8e-3,
# tests/bn_rounding_report.py).
ROUNDING_CAP = 1e-2


def nearer_f64(got, ref, want64):
    """The three-way comparison for an f32 result `got` that parts from
    the reference f32 result `ref` by more than its tolerance: both lie
    within ROUNDING_CAP of each other and of `want64`, the same
    computation in float64 (jax_f64_steps), and `got` lies no further
    from want64 than `ref` does. Returns (ok, what was compared).

    A train-mode BatchNorm over a few samples makes a step's gradients
    amplify the rounding of its sums; on some CPUs the JAX package's f32
    step then lies up to 2.8e-3 from the f64 step where the port's lies
    within 4.3e-6 of it."""
    e, eg, er = rel_err(got, ref), rel_err(got, want64), rel_err(ref, want64)
    ok = e <= ROUNDING_CAP and er <= ROUNDING_CAP and eg <= er
    return ok, {"vs_ref": e, "got_vs_f64": eg, "ref_vs_f64": er}


def ce64(out, label):
    """Softmax cross-entropy, mean over the batch, in the logits' dtype
    (JF.cross_entropy computes in f32): the f64 steps' loss."""
    from paddle_tpu.framework import Tensor
    o = out._data
    pick = jnp.take_along_axis(o, label._data[:, None].astype(jnp.int32),
                               axis=-1)[:, 0]
    return Tensor(jnp.mean(jax.nn.logsumexp(o, axis=-1) - pick))


def jax_f64_steps(model, loss_fn, optimizer, state, batches,
                  opt_state=None, **kw):
    """The JAX package's TrainStep in float64 (jax.enable_x64), the
    referee of nearer_f64: `model` (a JAX layer) given `state` (name ->
    array), `optimizer(parameters)`, `opt_state` (name -> {slot: array})
    where given, then one step on each of `batches` ((inputs, labels),
    numpy trees; floating arrays go in as f64). kw: TrainStep options.
    Returns (losses, state after). The step returns its loss in f32, and
    a loss that computes in f32 itself (yolov3_loss, as the reference op
    does) stays in f32 inside it."""
    from paddle_tpu.framework import Tensor
    from paddle_tpu.static import TrainStep

    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float64 if a.dtype.kind == "f"
                           else a.dtype)

    with jax.enable_x64(True):
        for k, t in model.state_dict().items():
            t._data = f64(state[k])
        step = TrainStep(model, loss_fn, optimizer(model.parameters()),
                         **kw)
        if opt_state is not None:
            step.opt_state = jax.tree_util.tree_map(f64, opt_state)
        losses = [float(step(*jax.tree_util.tree_map(
            lambda a: Tensor(f64(a)), batch))) for batch in batches]
        step.sync_to_layer()
        return losses, {k: np.asarray(v.numpy())
                        for k, v in model.state_dict().items()}

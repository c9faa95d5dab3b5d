"""The JAX package's vision models with weights from a numpy seed, for
the port's vision tests (tests/test_torch_vision_models.py,
test_torch_resnet_train.py, test_torch_bn_parallel.py).

A model is built under paddle_tpu.utils.abstract_init (jax.random's
per-shape compiles cost seconds a model) and given conv and linear
weights N(0, 2 / fan_in), BatchNorm weights 1 + 0.1 N(0, 1) and biases
0.1 N(0, 1); the running statistics keep their zeros and ones. The port
takes them by name (models/convert.py load_jax_params).
"""
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

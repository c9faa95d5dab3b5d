"""jit-facade compatibility (counterpart of paddle_tpu/jit/compat.py, the
reference's python/paddle/jit/__init__.py): TracedLayer, the
ProgramTranslator switch and the dy2static logging knobs, thin layers
over StaticFunction and static/io.py."""
from __future__ import annotations

from typing import List, Optional

__all__ = ["TracedLayer", "ProgramTranslator", "set_code_level",
           "set_verbosity"]

# module-level (not thread-local): conversion may happen on any thread
_verbosity = 0
_code_level_value = 0


def set_verbosity(level: int = 0, also_to_stdout: bool = False):
    """Reference jit.set_verbosity: dy2static log level (0 silences)."""
    global _verbosity
    _verbosity = int(level)


def set_code_level(level: int = 100, also_to_stdout: bool = False):
    """Reference jit.set_code_level: at level>0 the AST-transformed
    source of each converted function is printed when it is converted
    (dy2static.convert_function consults this)."""
    global _code_level_value
    _code_level_value = int(level)


def _code_level() -> int:
    return _code_level_value


class ProgramTranslator:
    """Reference ProgramTranslator singleton: the global on/off switch
    for @to_static conversion. enable(False) makes every StaticFunction
    call fall through to the original eager function."""

    _instance: Optional["ProgramTranslator"] = None
    _enabled = True

    @classmethod
    def get_instance(cls) -> "ProgramTranslator":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static: bool):
        type(self)._enabled = bool(enable_to_static)

    @classmethod
    def enabled(cls) -> bool:
        return cls._enabled


class TracedLayer:
    """Reference jit.TracedLayer (jit.py:1052): trace a dygraph Layer
    into a static callable once, replay it, and export it as an
    inference artifact. The trace is a StaticFunction;
    save_inference_model is static/io.py's torch.export path."""

    def __init__(self, layer, static_fn, example_inputs):
        self._layer = layer
        self._fn = static_fn
        self._example_inputs = example_inputs

    @staticmethod
    def trace(layer, inputs):
        """Returns (outputs, TracedLayer) like the reference."""
        from .api import StaticFunction
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        fn = StaticFunction(layer.forward, layer=layer)
        out = fn(*ins)
        return out, TracedLayer(layer, fn, ins)

    def __call__(self, *inputs):
        return self._fn(*inputs)

    def save_inference_model(self, path, feed=None, fetch=None,
                             **kwargs):
        from ..static.io import save_inference_model
        from .api import InputSpec
        spec: List[InputSpec] = []
        for i, t in enumerate(self._example_inputs):
            spec.append(InputSpec(list(t.shape), t.dtype, f"x{i}"))
        was_training = self._layer.training
        try:
            self._layer.eval()
            save_inference_model(path, layer=self._layer,
                                 input_spec=spec)
        finally:
            if was_training:
                self._layer.train()

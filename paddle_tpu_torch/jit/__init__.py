"""paddle.jit (counterpart of paddle_tpu/jit): InputSpec only. to_static,
save/load and TranslatedLayer are not ported yet (ROADMAP.md item
18.4)."""
from .api import InputSpec  # noqa: F401

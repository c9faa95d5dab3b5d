"""paddle.jit (counterpart of paddle_tpu/jit): to_static over dy2static,
StaticFunction, jit.save/load and TranslatedLayer (api.py), the AST
conversion (dy2static.py) and the compatibility layer (compat.py)."""
from .api import (InputSpec, StaticFunction, functionalize, to_static,
                  not_to_static, save, load, TranslatedLayer)  # noqa: F401
from . import dy2static  # noqa: F401
from .dy2static import (convert_function, set_max_while_iters,  # noqa: F401
                        max_while_iters_guard)
from .compat import (TracedLayer, ProgramTranslator,  # noqa: F401
                     set_code_level, set_verbosity)

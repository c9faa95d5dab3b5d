from .common import Dropout, Embedding, Linear  # noqa: F401
from .layers import Layer  # noqa: F401
from .norm import LayerNorm  # noqa: F401
from .scanned import ScannedStack  # noqa: F401

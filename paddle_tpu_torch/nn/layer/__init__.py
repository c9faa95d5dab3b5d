from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .layers import Layer  # noqa: F401
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .scanned import ScannedStack  # noqa: F401

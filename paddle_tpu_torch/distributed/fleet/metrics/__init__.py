from . import metric  # noqa: F401

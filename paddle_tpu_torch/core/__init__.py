from . import dtypes, generator, place  # noqa: F401

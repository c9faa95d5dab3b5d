"""paddle.text namespace (counterpart of paddle_tpu/text/__init__.py)."""
from .datasets import (Conll05st, Imdb, Imikolov, Movielens,  # noqa: F401
                       UCIHousing, WMT14, WMT16)

__all__ = ["Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
           "WMT14", "WMT16"]

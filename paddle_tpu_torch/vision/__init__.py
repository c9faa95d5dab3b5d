"""paddle.vision (counterpart of paddle_tpu/vision): the model zoo, the
datasets (synthetic when no file is given), the transforms, the image
backend and the YOLO ops (vision.ops). The deformable convolution comes
later (ROADMAP.md item 18.5)."""
from . import datasets, image, models, ops, transforms  # noqa: F401
from .image import (get_image_backend, image_load,  # noqa: F401
                    set_image_backend)

"""paddle.vision (counterpart of paddle_tpu/vision): the model zoo and
the YOLO ops (vision.ops). The transforms, datasets, image backend and
the deformable convolution come later (ROADMAP.md item 18)."""
from . import models, ops  # noqa: F401

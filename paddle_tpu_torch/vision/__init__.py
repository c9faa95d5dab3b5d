"""paddle.vision (counterpart of paddle_tpu/vision): the model zoo. The
transforms, datasets, image backend and detection ops come later
(ROADMAP.md item 18)."""
from . import models  # noqa: F401

"""paddle.vision.image: image backend selection (counterpart of
paddle_tpu/vision/image.py; reference python/paddle/vision/image.py:18).
PIL and a pure-numpy path are the backends; cv2 is used when present."""
import numpy as np

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_image_backend = "pil"


def set_image_backend(backend):
    global _image_backend
    if backend not in ("pil", "cv2", "numpy"):
        raise ValueError(
            f"Expected backend are one of ['pil', 'cv2', 'numpy'], "
            f"but got {backend}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Load an image as PIL.Image or ndarray depending on the backend."""
    backend = backend or _image_backend
    if backend == "numpy":
        from PIL import Image
        return np.asarray(Image.open(path))
    if backend == "cv2":
        try:
            import cv2
            return cv2.imread(path)
        except ImportError:
            from PIL import Image
            return np.asarray(Image.open(path))[..., ::-1]
    from PIL import Image
    return Image.open(path)

"""Vision transforms (counterpart of paddle_tpu/vision/transforms.py;
reference python/paddle/vision/transforms parity): numpy on the host,
composable; the batches go to the card through io.DataLoader."""
from __future__ import annotations

import numbers
from typing import Sequence

import numpy as np

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "BrightnessTransform", "Pad", "RandomResizedCrop"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor:
    """HWC uint8 [0,255] -> CHW float32 [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return arr.astype(np.float32)


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        return (arr - self.mean.reshape(shape)) / self.std.reshape(shape)


def _resize_np(arr, size):
    """Nearest-neighbor resize (no PIL dependency)."""
    if isinstance(size, numbers.Number):
        h, w = arr.shape[:2]
        if h < w:
            size = (int(size), int(size * w / h))
        else:
            size = (int(size * h / w), int(size))
    out_h, out_w = size
    h, w = arr.shape[:2]
    ri = (np.arange(out_h) * h / out_h).astype(np.int64)
    ci = (np.arange(out_w) * w / out_w).astype(np.int64)
    return arr[ri][:, ci]


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = size

    def __call__(self, img):
        return _resize_np(np.asarray(img), self.size)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        if self.padding:
            pad = [(self.padding, self.padding),
                   (self.padding, self.padding)] + \
                [(0, 0)] * (arr.ndim - 2)
            arr = np.pad(arr, pad)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return arr[i:i + th, j:j + tw]


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                return _resize_np(arr[i:i + ch, j:j + cw], self.size)
        return _resize_np(arr, self.size)


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[::-1].copy()
        return np.asarray(img)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


class BrightnessTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return np.clip(arr * factor, 0, 255 if arr.max() > 1 else 1.0)


class Pad:
    def __init__(self, padding, fill=0):
        self.padding = padding
        self.fill = fill

    def __call__(self, img):
        arr = np.asarray(img)
        p = self.padding
        if isinstance(p, numbers.Number):
            p = (p, p, p, p)
        pad = [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, pad, constant_values=self.fill)

# reference package layout: vision.transforms.transforms (self) and
# vision.transforms.functional (the lowercase per-image functions the
# class transforms are built from — paddle/vision/transforms/functional.py)
import sys as _sys  # noqa: E402
transforms = _sys.modules[__name__]


class _Functional:
    """paddle.vision.transforms.functional over numpy images."""

    @staticmethod
    def to_tensor(pic, data_format="CHW"):
        return ToTensor(data_format)(pic)

    @staticmethod
    def normalize(img, mean, std, data_format="CHW", to_rgb=False):
        return Normalize(mean, std, data_format)(img)

    @staticmethod
    def resize(img, size, interpolation="bilinear"):
        return _resize_np(np.asarray(img), size)

    @staticmethod
    def crop(img, top, left, height, width):
        return np.asarray(img)[top:top + height, left:left + width]

    @staticmethod
    def center_crop(img, output_size):
        return CenterCrop(output_size)(img)

    @staticmethod
    def hflip(img):
        return np.asarray(img)[:, ::-1]

    @staticmethod
    def vflip(img):
        return np.asarray(img)[::-1]

    @staticmethod
    def pad(img, padding, fill=0, padding_mode="constant"):
        return Pad(padding, fill)(img)

    @staticmethod
    def adjust_brightness(img, brightness_factor):
        arr = np.asarray(img)
        return np.clip(np.asarray(arr, np.float32) * brightness_factor,
                       0, 255).astype(arr.dtype)

    @staticmethod
    def adjust_contrast(img, contrast_factor):
        arr = np.asarray(img, np.float32)
        mean = arr.mean()
        out = (arr - mean) * contrast_factor + mean
        return np.clip(out, 0, 255).astype(np.asarray(img).dtype)

    @staticmethod
    def to_grayscale(img, num_output_channels=1):
        arr = np.asarray(img, np.float32)
        gray = (arr[..., :3] @ np.asarray(
            [0.299, 0.587, 0.114], np.float32))[..., None]
        return np.repeat(gray, num_output_channels,
                         axis=-1).astype(np.asarray(img).dtype)

    @staticmethod
    def rotate(img, angle, interpolation="nearest", expand=False,
               center=None, fill=0):
        k = int(round(angle / 90.0)) % 4
        if abs(angle - 90.0 * round(angle / 90.0)) > 1e-6:
            raise NotImplementedError(
                "rotate supports multiples of 90 degrees (no PIL in "
                "this image)")
        return np.rot90(np.asarray(img), k=k).copy()


# register as a REAL submodule so reference-style imports work
# (`import paddle_tpu_torch.vision.transforms.functional`, `from
# paddle_tpu_torch.vision.transforms import functional`)
_fmod = type(_sys)(__name__ + ".functional")
for _n in dir(_Functional):
    if not _n.startswith("_"):
        setattr(_fmod, _n, getattr(_Functional, _n))
_fmod.__doc__ = _Functional.__doc__
_sys.modules[__name__ + ".functional"] = _fmod
functional = _fmod

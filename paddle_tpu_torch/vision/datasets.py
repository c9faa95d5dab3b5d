"""Vision datasets (counterpart of paddle_tpu/vision/datasets.py;
reference python/paddle/vision/datasets parity), numpy on the host.

Zero-egress environment: when real data files are absent, datasets fall
back to a deterministic synthetic sample set (shape/dtype-faithful) so
examples, tests, and benchmarks run anywhere. Pass `data_file`/`image_path`
pointing at real data to use it.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "DatasetFolder", "ImageFolder", "VOC2012"]


class MNIST(Dataset):
    """28x28 grayscale digits; synthetic fallback generates class-dependent
    patterns so a model can actually learn (acc >> chance) without files."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend="cv2",
                 synthetic_size=None):
        self.mode = mode
        self.transform = transform
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(
                    f.read(), dtype=np.uint8).reshape(n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                f.read(8)
                self.labels = np.frombuffer(f.read(), dtype=np.uint8)
        else:
            n = synthetic_size or (1024 if mode == "train" else 256)
            # class patterns shared across splits; noise differs per split
            base = np.random.RandomState(1234).rand(10, 28, 28)
            rng = np.random.RandomState(42 if mode == "train" else 7)
            self.labels = rng.randint(0, 10, n).astype(np.int64)
            self.images = np.clip(
                (base[self.labels] * 128 + rng.rand(n, 28, 28) * 64),
                0, 255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = (img.astype(np.float32) / 255.0)[None]
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class _CifarBase(Dataset):
    n_classes = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend="cv2", synthetic_size=None):
        self.transform = transform
        if data_file and os.path.exists(data_file):
            import pickle
            import tarfile
            imgs, labels = [], []
            with tarfile.open(data_file) as tf:
                for member in tf.getmembers():
                    want = ("data_batch" if mode == "train" else
                            "test_batch") if self.n_classes == 10 else \
                        ("train" if mode == "train" else "test")
                    if want in member.name:
                        d = pickle.load(tf.extractfile(member),
                                        encoding="bytes")
                        imgs.append(d[b"data"])
                        labels.extend(d.get(b"labels",
                                            d.get(b"fine_labels", [])))
            self.images = np.concatenate(imgs).reshape(-1, 3, 32, 32)
            self.labels = np.asarray(labels, np.int64)
        else:
            n = synthetic_size or (1024 if mode == "train" else 256)
            base = np.random.RandomState(99).rand(self.n_classes, 3, 32, 32)
            rng = np.random.RandomState(13 if mode == "train" else 14)
            self.labels = rng.randint(0, self.n_classes, n).astype(np.int64)
            self.images = np.clip(base[self.labels] * 200
                                  + rng.rand(n, 3, 32, 32) * 55,
                                  0, 255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img.transpose(1, 2, 0))
        else:
            img = img.astype(np.float32) / 255.0
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.images)


class Cifar10(_CifarBase):
    n_classes = 10


class Cifar100(_CifarBase):
    n_classes = 100


class Flowers(_CifarBase):
    n_classes = 102


_DEFAULT_IMG_EXTS = (".npy", ".npz", ".png", ".jpg", ".jpeg", ".bmp")


def _file_filter(extensions, is_valid_file):
    """One predicate per torchvision/reference semantics: extensions and
    is_valid_file are mutually exclusive."""
    if extensions is not None and is_valid_file is not None:
        raise ValueError(
            "pass either extensions or is_valid_file, not both")
    if is_valid_file is not None:
        return is_valid_file, "<is_valid_file>"
    exts = tuple(e.lower() for e in (extensions or _DEFAULT_IMG_EXTS))
    return (lambda path: path.lower().endswith(exts)), exts


class DatasetFolder(Dataset):
    """Directory-per-class image dataset (reference
    vision/datasets/folder.py:62): root/<class>/<file>. Files load via a
    pluggable `loader`; the default handles numpy formats (.npy/.npz)
    directly and other image formats through PIL when available (store
    arrays as .npy/.npz or pass loader= on PIL-less stacks)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        valid, exts = _file_filter(extensions, is_valid_file)
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"no class folders under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            # recurse like the reference's make_dataset (folder.py):
            # class dirs may nest sessions/shards of files
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fn in sorted(files):
                    path = os.path.join(dirpath, fn)
                    if valid(path):
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no samples matching {exts} under {root}")

    @staticmethod
    def _default_loader(path):
        low = path.lower()
        if low.endswith(".npy"):
            return np.load(path)
        if low.endswith(".npz"):
            return next(iter(np.load(path).values()))
        try:
            from PIL import Image
            return np.asarray(Image.open(path).convert("RGB"))
        except ImportError as e:
            raise ImportError(
                f"loading {path} needs PIL; store arrays as .npy/.npz "
                "or pass a custom loader=") from e

    def __getitem__(self, index):
        path, target = self.samples[index]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat/recursive unlabeled image folder (reference folder.py:219):
    yields (image,) per sample for inference sweeps."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.transform = transform
        self.loader = loader or DatasetFolder._default_loader
        valid, _ = _file_filter(extensions, is_valid_file)
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                path = os.path.join(dirpath, fn)
                if valid(path):
                    self.samples.append(path)
        if not self.samples:
            raise ValueError(f"no images under {root}")

    def __getitem__(self, index):
        img = self.loader(self.samples[index])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class VOC2012(Dataset):
    """Segmentation pairs (reference vision/datasets/voc2012.py:40):
    (image [H,W,3] uint8, label mask [H,W] uint8 with 21 classes).
    Synthetic fallback: deterministic blob masks + class-colored images
    so segmentation models train without files."""

    NUM_CLASSES = 21

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None, synthetic_size=None,
                 image_size=64):
        self.mode = mode
        self.transform = transform
        if data_file and os.path.exists(data_file):
            blob = np.load(data_file)
            self.images, self.masks = blob["images"], blob["masks"]
        else:
            n = synthetic_size or (128 if mode == "train" else 32)
            rng = np.random.RandomState(0 if mode == "train" else 1)
            h = w = image_size
            yy, xx = np.mgrid[0:h, 0:w]
            images = np.zeros((n, h, w, 3), np.uint8)
            masks = np.zeros((n, h, w), np.uint8)
            for i in range(n):
                cls = rng.randint(1, self.NUM_CLASSES)
                cy, cx = rng.randint(h // 4, 3 * h // 4, size=2)
                r = rng.randint(h // 8, h // 4)
                blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
                masks[i][blob] = cls
                images[i] = rng.randint(0, 40, (h, w, 3))
                images[i][blob] = (cls * 11 % 255, cls * 37 % 255,
                                   cls * 73 % 255)
            self.images, self.masks = images, masks

    def __getitem__(self, idx):
        img, mask = self.images[idx], self.masks[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self.images)
# reference exposes per-dataset submodules (from . import cifar ...);
# register REAL modules in sys.modules so reference-style imports work
import sys as _sys  # noqa: E402


def _submodule(name, **attrs):
    mod = type(_sys)(__name__ + "." + name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    _sys.modules[__name__ + "." + name] = mod
    return mod


cifar = _submodule("cifar", Cifar10=Cifar10, Cifar100=Cifar100)
mnist = _submodule("mnist", MNIST=MNIST, FashionMNIST=FashionMNIST)
flowers = _submodule("flowers", Flowers=Flowers)
voc2012 = _submodule("voc2012", VOC2012=VOC2012)
folder = _submodule("folder", DatasetFolder=DatasetFolder,
                    ImageFolder=ImageFolder)

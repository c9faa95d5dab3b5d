"""Device/Place layer over torch devices.

Counterpart of paddle_tpu/core/place.py. A Place names a torch.device.
The default place is the first CUDA card: there is no silent fallback to
the CPU. Without CUDA, the first call that needs the default device
raises RuntimeError unless the caller asked for the CPU, either with
set_device("cpu") or with device="cpu" on a constructor. The check runs
at first use, never at import, so a CPU-only process can import the
package.
"""
from __future__ import annotations

from typing import Optional

import torch


class Place:
    """Base place: names a logical device kind + index."""

    kind = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        raise NotImplementedError

    def __eq__(self, other):
        return (isinstance(other, Place) and other.kind == self.kind
                and other.device_id == self.device_id)

    def __hash__(self):
        return hash((self.kind, self.device_id))

    def __repr__(self):
        return f"Place({self.kind}:{self.device_id})"


class CPUPlace(Place):
    kind = "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    kind = "gpu"

    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.device_id)


_NAMES = {"cpu": CPUPlace, "gpu": CUDAPlace, "cuda": CUDAPlace}

_current_place: Optional[Place] = None


def _to_place(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        cls = _NAMES.get(device.type)
        if cls is None:
            raise ValueError(f"unsupported device '{device}'")
        return cls(device.index or 0)
    name, _, idx = str(device).partition(":")
    cls = _NAMES.get(name)
    if cls is None:
        raise ValueError(f"unknown device '{device}'")
    return cls(int(idx) if idx else 0)


def _default_place() -> Place:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA card by default and none is "
            "available; call paddle_tpu_torch.set_device('cpu') or pass "
            "device='cpu' to run on the CPU")
    return CUDAPlace(0)


def set_device(device) -> Place:
    """paddle.set_device equivalent. Accepts 'gpu', 'gpu:1', 'cuda:0',
    'cpu', a Place or a torch.device."""
    global _current_place
    _current_place = _to_place(device)
    return _current_place


def get_device() -> str:
    p = current_place()
    return f"{p.kind}:{p.device_id}"


def current_place() -> Place:
    return _current_place if _current_place is not None else _default_place()


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on: `device` when given, else
    the current place (which raises without CUDA unless set to the CPU)."""
    if device is None:
        return current_place().torch_device()
    return _to_place(device).torch_device()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


"""Seeded RNG state: one default torch.Generator per device.

Counterpart of paddle_tpu/core/generator.py. JAX's splittable keys become
explicit torch.Generators, one per device, created on first use (a CUDA
generator needs the card, and importing the package must not touch it).
paddle_tpu_torch.seed(s) reseeds every default generator, so model
initialization is deterministic per seed and device. The numbers differ
from JAX's for the same seed; tests carry weights across by name instead.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

_generators: Dict[str, torch.Generator] = {}
_seed: Optional[int] = None
_lock = threading.Lock()


def _key(device: torch.device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{device.index if device.index is not None else 0}"
    return device.type


def default_generator(device="cpu") -> torch.Generator:
    """The default generator of `device`, seeded with the last seed()
    (a random seed when seed() was never called)."""
    key = _key(device)
    with _lock:
        g = _generators.get(key)
        if g is None:
            g = torch.Generator(device=key)
            g.manual_seed(_seed if _seed is not None
                          else int(np.random.randint(0, 2**31 - 1)))
            _generators[key] = g
        return g


def seed(s: int):
    """paddle.seed equivalent: reseed every default generator."""
    global _seed
    with _lock:
        _seed = int(s)
        for g in _generators.values():
            g.manual_seed(_seed)
    return _seed

"""Seeded RNG state: default torch.Generators and dropout seed streams.

Counterpart of paddle_tpu/core/generator.py. JAX's splittable keys become
two things here:

- one default torch.Generator per device, created on first use (a CUDA
  generator needs the card, and importing the package must not touch
  it), for weight initialisation and hidden dropout;
- a host-side stream of 64-bit seeds (next_seed) for the Philox dropout
  of the attention kernels. It plays the part of next_key: each call
  advances the stream once and returns a plain int, so drawing a seed
  never reads the device and never synchronises it.

seed(s) reseeds both, so a run is deterministic per seed. seed_scope(s)
plays the part of key_scope: inside it, next_seed() derives its seeds
from s and a counter instead of the global stream, so a TrainStep pins
every dropout of one step to that step's seed. The numbers differ from
JAX's for the same seed; tests carry weights across by name instead.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["default_generator", "seed", "next_seed", "seed_scope",
           "mix_seed", "scope_generator"]

_generators: Dict[str, torch.Generator] = {}
_seed: Optional[int] = None
_streams: Dict[str, int] = {}
_lock = threading.Lock()
_MASK64 = (1 << 64) - 1


def _key(device: torch.device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{device.index if device.index is not None else 0}"
    return device.type


def mix_seed(*parts: int) -> int:
    """splitmix64 over the parts: a 64-bit seed that changes with each."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z + (int(p) & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z


def _base_seed() -> int:
    global _seed
    if _seed is None:
        _seed = int(np.random.randint(0, 2**31 - 1))
    return _seed


def default_generator(device="cpu") -> torch.Generator:
    """The default generator of `device`, seeded with the last seed()
    (a random seed when seed() was never called)."""
    key = _key(device)
    with _lock:
        g = _generators.get(key)
        if g is None:
            g = torch.Generator(device=key)
            g.manual_seed(_base_seed())
            _generators[key] = g
        return g


def seed(s: int):
    """paddle.seed equivalent: reseed every default generator and restart
    every dropout seed stream."""
    global _seed
    with _lock:
        _seed = int(s)
        for g in _generators.values():
            g.manual_seed(_seed)
        _streams.clear()
    return _seed


class _SeedScope:
    def __init__(self, base: int):
        self.base = int(base)
        self.counter = 0

    def next(self) -> int:
        s = mix_seed(self.base, self.counter)
        self.counter += 1
        return s


_scope_stack = threading.local()


def _scopes():
    if not hasattr(_scope_stack, "stack"):
        _scope_stack.stack = []
    return _scope_stack.stack


class seed_scope:
    """with seed_scope(s): every next_seed() inside derives from s."""

    def __init__(self, base: int):
        self._scope = _SeedScope(base)

    def __enter__(self):
        _scopes().append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _scopes().pop()


def next_seed(device="cpu") -> int:
    """The next 64-bit dropout seed: from the innermost seed_scope, else
    from `device`'s stream (advanced once per call). Host-side only."""
    stack = _scopes()
    if stack:
        return stack[-1].next()
    key = _key(device)
    with _lock:
        n = _streams.get(key, 0)
        _streams[key] = n + 1
        base = _base_seed()
    return mix_seed(base, zlib.crc32(key.encode()), n)


def scope_generator(device) -> torch.Generator:
    """The generator a random op on `device` draws from: inside a
    seed_scope a fresh one seeded from next_seed(), else the default."""
    if not _scopes():
        return default_generator(device)
    g = torch.Generator(device=_key(device))
    g.manual_seed(next_seed(device) & ((1 << 63) - 1))
    return g

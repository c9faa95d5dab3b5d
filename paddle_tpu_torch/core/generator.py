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

A captured step (static/train_step.py) cannot take host ints: a CUDA
graph would replay the seeds of its capture forever. So inside a step
the scope's base is a SeedSlots path, and every draw is a `Draw`: its
path of counters below the step seed, whose value is
mix_seed(...mix_seed(step_seed, c1)..., cn), the very int the host scope
computes. The consumers turn a draw into what they need:
seed_tensor() (a 0-d int64 device tensor, which the attention kernels
read) and scope_generator() (a torch.Generator, for hidden dropout).
While SeedSlots records (the warm-up), those are made from the step's
ints, so the masks equal the host-int path's; while it replays, each
draw takes slot j: a view of one static int64 buffer or a generator of
its own, and fill(step_seed) writes every slot's seed before each
replay (one non-blocking copy, one manual_seed per generator).
rewind_point()/rewound() let a recompute (distributed/recompute.py)
draw the same seeds as the forward it repeats.

get_state()/set_state() carry the stream (the base seed and each
device's counter) through a checkpoint: a step restored with them draws
the step seed the uninterrupted run drew at that step, so its dropout
masks are the ones that run's were.
"""
from __future__ import annotations

import contextlib
import threading
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from .place import host_tensor

__all__ = ["default_generator", "seed", "next_seed", "seed_scope",
           "mix_seed", "scope_generator", "seed_tensor", "SeedSlots",
           "Draw", "rewind_point", "rewound", "seed_int64", "fold_seed",
           "get_state", "set_state"]

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


def seed_int64(seed: int) -> int:
    """The 64-bit seed as the signed int64 with the same bits: a 0-d
    int64 tensor holding it is the two uint32 words (lo, hi) the kernels
    read from device memory."""
    seed = int(seed) & _MASK64
    return seed - (1 << 64) if seed >> 63 else seed


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


def get_state() -> dict:
    """The dropout seed stream: {"seed": the base seed, "streams": each
    device's count of next_seed() draws}, plain ints."""
    with _lock:
        return {"seed": _base_seed(), "streams": dict(_streams)}


def set_state(state: dict):
    """Restore get_state() output (ints, or 0-d arrays as a checkpoint
    gives them back): the next next_seed() on a device continues that
    device's stream where the saved one stood. The default generators
    are left as they are."""
    global _seed
    with _lock:
        _seed = int(state["seed"])
        _streams.clear()
        _streams.update({str(k): int(v)
                         for k, v in state["streams"].items()})


class Draw:
    """A seed drawn inside a SeedSlots scope: `path`, the counters that
    lead from the step seed to it, and the table that resolves it."""
    __slots__ = ("path", "slots")

    def __init__(self, path, slots):
        self.path = tuple(path)
        self.slots = slots

    def __repr__(self):
        return f"Draw{self.path}"


class _SeedScope:
    def __init__(self, base, counter: int = 0):
        self.base = base if isinstance(base, Draw) else int(base)
        self.counter = counter

    def next(self):
        c = self.counter
        self.counter += 1
        if isinstance(self.base, Draw):
            return Draw(self.base.path + (c,), self.base.slots)
        return mix_seed(self.base, c)


_scope_stack = threading.local()


def _scopes():
    if not hasattr(_scope_stack, "stack"):
        _scope_stack.stack = []
    return _scope_stack.stack


class seed_scope:
    """with seed_scope(s): every next_seed() inside derives from s (an
    int, or a Draw: the draws inside are then Draws below it)."""

    def __init__(self, base, _counter: int = 0):
        self._scope = _SeedScope(base, _counter)

    def __enter__(self):
        _scopes().append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _scopes().pop()


def next_seed(device="cpu"):
    """The next 64-bit dropout seed: from the innermost seed_scope, else
    from `device`'s stream (advanced once per call). Host-side only: an
    int, or a Draw inside a SeedSlots scope."""
    stack = _scopes()
    if stack:
        return stack[-1].next()
    key = _key(device)
    with _lock:
        n = _streams.get(key, 0)
        _streams[key] = n + 1
        base = _base_seed()
    return mix_seed(base, zlib.crc32(key.encode()), n)


def _generator(device, s: int) -> torch.Generator:
    g = torch.Generator(device=_key(device))
    g.manual_seed(s & ((1 << 63) - 1))
    return g


def scope_generator(device) -> torch.Generator:
    """The generator a random op on `device` draws from: inside a
    seed_scope a fresh one seeded from next_seed() (a Draw's own
    generator inside a SeedSlots scope), else the default. None on the
    meta device (a step traced from shapes alone draws nothing)."""
    if torch.device(device).type == "meta":
        return None
    if not _scopes():
        return default_generator(device)
    s = next_seed(device)
    if isinstance(s, Draw):
        return s.slots.generator(s.path, device)
    return _generator(device, s)


def seed_tensor(seed, device) -> torch.Tensor:
    """A dropout seed as the attention kernels read it: a 0-d int64
    tensor on `device` holding the 64-bit seed's bits (seed_int64). An
    int becomes one without a host sync (place.host_tensor), a Draw
    resolves through its table, a tensor passes through."""
    if isinstance(seed, Draw):
        return seed.slots.tensor(seed.path, device)
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise TypeError(f"a seed tensor is one int64, got {seed.dtype} "
                            f"of shape {tuple(seed.shape)}")
        return seed.reshape(()).to(device)
    return host_tensor(seed_int64(seed), torch.int64, device)


def rewind_point():
    """The innermost scope and its counter now, or None outside scopes:
    what rewound() needs to draw the same seeds again."""
    stack = _scopes()
    if not stack:
        return None
    return stack[-1].base, stack[-1].counter


def rewound(point):
    """with rewound(point): the draws inside repeat those made after
    rewind_point() returned `point` (the same ints, or the same Draw
    paths). A recompute enters it so that its masks are the forward's."""
    return contextlib.nullcontext() if point is None else seed_scope(*point)


def fold_seed(step_seed: int, path) -> int:
    """The int a Draw of `path` stands for below `step_seed`."""
    s = int(step_seed)
    for c in path:
        s = mix_seed(s, c)
    return s


class SeedSlots:
    """The seeds of one captured step, one slot per draw.

    A step runs its body inside seed_scope(Draw(path, slots)), path
    being its microbatch's counters below the step seed. Two modes:

    - record(step_seed): the warm-up run. Every draw is resolved to the
      step's own int seed (tensor: a fresh device copy; generator: a
      fresh generator seeded with it), so the run equals the host-int
      path; each draw's (path, kind) is laid down as slot j, in order.
    - slots (after freeze()): every run draws slot 0, 1, ... again and
      must draw the same (path, kind) in the same order, else it raises.
      A tensor slot is a 0-d view of one static int64 buffer, a
      generator slot a generator of its own (`generators`, which the
      graph registers). fill(step_seed) writes all of them: the
      buffer with one non-blocking copy, each generator with
      manual_seed. Call it before each replay and before an eager run
      in slot mode."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.recipes = []           # [(path, "tensor" | "generator")]
        self.generators = {}        # slot -> torch.Generator
        self.buf = None
        self._step_seed = None
        self._cursor = 0

    def __len__(self):
        return len(self.recipes)

    def record(self, step_seed: int):
        if self.buf is not None:
            raise RuntimeError("SeedSlots already frozen")
        self._step_seed = int(step_seed)
        return self

    def freeze(self):
        """End the recording: make the static buffer and one generator
        per generator slot."""
        self._step_seed = None
        self.buf = torch.zeros(len(self.recipes), dtype=torch.int64,
                               device=self.device)
        for j, (_, kind) in enumerate(self.recipes):
            if kind == "generator":
                self.generators[j] = torch.Generator(
                    device=_key(self.device))
        return self

    def values(self, step_seed: int):
        """Each slot's int seed for `step_seed`."""
        return [fold_seed(step_seed, p) for p, _ in self.recipes]

    def fill(self, step_seed: int):
        """Write the seeds of `step_seed` into every slot; the next run
        draws slot 0 first."""
        vals = self.values(step_seed)
        if vals:
            self.buf.copy_(host_tensor([seed_int64(v) for v in vals],
                                       torch.int64, self.device),
                           non_blocking=True)
        for j, g in self.generators.items():
            g.manual_seed(vals[j] & ((1 << 63) - 1))
        self._cursor = 0

    def _draw(self, path, kind):
        if self.buf is None:
            if self._step_seed is None:
                raise RuntimeError("SeedSlots: draw outside record() "
                                   "before freeze()")
            self.recipes.append((path, kind))
            return None
        j = self._cursor
        if j >= len(self.recipes) or self.recipes[j] != (path, kind):
            want = self.recipes[j] if j < len(self.recipes) else None
            raise RuntimeError(
                f"seed draw {j} is {kind} {path}, but the recorded step "
                f"drew {want} there: the step must draw the same seeds "
                "in the same order every call")
        self._cursor += 1
        return j

    def tensor(self, path, device):
        j = self._draw(path, "tensor")
        if j is None:
            return host_tensor(seed_int64(fold_seed(self._step_seed, path)),
                               torch.int64, device)
        return self.buf[j]

    def generator(self, path, device):
        j = self._draw(path, "generator")
        if j is None:
            return _generator(device, fold_seed(self._step_seed, path))
        return self.generators[j]

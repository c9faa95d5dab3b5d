"""Recompile sentinel (counterpart of paddle_tpu/observability/sentinel.py,
minimal): the guard of the serving engine's fixed program count and of
the one-program-per-signature TrainStep.

The JAX engine promises a fixed ladder of compiled executables and the
JAX TrainStep one executable; the port's engine promises a fixed set of
programs, one CUDA graph per bucket on the card, and its TrainStep one
captured graph per input signature (``signature_of``). Each calls
``observe(executables, expected, signature)`` once per step; when the
count grows past the expected figure, the sentinel records an event
with the shape delta against the previous step's signature, adds the
growth to ``counter`` and logs a warning. The JAX version's metrics
registry and flight-recorder breadcrumbs belong to the observability
slice (ROADMAP.md queue A item 16) and are left out.
"""
from __future__ import annotations

import logging
from typing import Any, List, Optional, Tuple

import torch

__all__ = ["RecompileSentinel", "diff_signatures", "signature_of"]

logger = logging.getLogger("paddle_tpu_torch.observability")


def _leaves(tree, path):
    if isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def signature_of(*trees) -> Tuple[Tuple[str, Tuple[int, ...], str], ...]:
    """Flatten nested lists, tuples and dicts of tensors into ((path,
    shape, dtype), ...): the comparable identity a captured program is
    keyed on, as the JAX package's jit cache keys on it. A non-tensor
    leaf has shape () and its type's name."""
    out = []
    for path, leaf in _leaves(tuple(trees), ""):
        if isinstance(leaf, torch.Tensor):
            out.append((path, tuple(leaf.shape), str(leaf.dtype)))
        else:
            out.append((path, (), type(leaf).__name__))
    return tuple(out)


def diff_signatures(old, new) -> str:
    """Human-readable shape/dtype delta between two signatures, each a
    tuple of (path, shape, dtype)."""
    if old is None:
        return "no prior signature recorded"
    o = {p: (s, d) for p, s, d in old}
    n = {p: (s, d) for p, s, d in new}
    lines = []
    for p in sorted(set(o) | set(n)):
        if p not in o:
            lines.append(f"{p}: (new input) {n[p][0]}/{n[p][1]}")
        elif p not in n:
            lines.append(f"{p}: (dropped input) was {o[p][0]}/{o[p][1]}")
        elif o[p] != n[p]:
            lines.append(
                f"{p}: {o[p][0]}/{o[p][1]} -> {n[p][0]}/{n[p][1]}")
    return "; ".join(lines) if lines else \
        "identical input signature (new program from a non-shape cause)"


class RecompileSentinel:
    """Per-engine watcher of the program-count contract.

    events: list of {step, executables, expected, diff}, one per
    violation, newest last. counter: the total growth past the allowed
    count, a plain integer."""

    def __init__(self, name: str = "train"):
        self.name = name
        self.counter = 0
        self.events: List[dict] = []
        self._last_sig = None
        self._allowed: Optional[int] = None
        self._steps = 0

    def observe(self, executables: int, expected: int = 1,
                signature: Any = None):
        """Record one step's program count. Fires when the count exceeds
        the allowed figure (the expected count, or whatever higher count
        the first observation found)."""
        self._steps += 1
        if self._allowed is None:
            # first step: whatever exists now is the baseline
            self._allowed = max(int(executables), int(expected))
            self._last_sig = signature
            return self
        allowed = max(self._allowed, int(expected))
        if executables > allowed:
            delta = diff_signatures(self._last_sig, signature) \
                if signature is not None else "signature not captured"
            self.events.append({"step": self._steps,
                                "executables": int(executables),
                                "expected": allowed, "diff": delta})
            self.counter += int(executables) - allowed
            logger.warning(
                "recompile sentinel [%s]: program count grew %d -> %d at "
                "step %d; input delta: %s", self.name, allowed,
                executables, self._steps, delta)
        self._allowed = max(allowed, int(executables))
        if signature is not None:
            self._last_sig = signature
        return self

    @property
    def fired(self) -> int:
        return len(self.events)

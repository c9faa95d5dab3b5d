"""Deterministic chaos injection: reproducible faults at a named step
(counterpart of paddle_tpu/distributed/chaos.py, the same PD_CHAOS_*
variables, modes, receipts and flight-recorder events).

Every self-healing claim needs a drill, and a drill that fires at a
random moment can't be debugged or replayed. This module reads a
``PD_CHAOS_*`` plan from the environment once and injects exactly one
fault at exactly the named (rank, step):

  PD_CHAOS_MODE     kill | stall | corrupt_ckpt | corrupt_swap |
                    nan_grad | flip_bit | scale_grad
                    (empty/unset: off; any OTHER value raises: a
                    typo'd drill that injects nothing would otherwise
                    read as a passing receipt; corrupt_swap is
                    serving-only, the numeric trio training-only)
  PD_CHAOS_STEP     step number to fire at (default 5): the train step
                    for maybe_inject, the FLEET TICK for
                    maybe_inject_serving
  PD_CHAOS_RANK     rank (training) / replica slot (serving) to fire on
                    (default 1)
  PD_CHAOS_EVERY    "1": fire on every incarnation (default: only the
                    first, PADDLE_RESTART_COUNT == 0, so the restarted
                    worker survives, which is the drill)
  PD_CHAOS_STALL_S  stall duration in seconds (default 600)
  PD_CHAOS_SCOPE    numeric modes: only leaves whose name contains this
                    substring are eligible (default: first leaf in
                    sorted-name order)
  PD_CHAOS_BIT      flip_bit: which bit of the victim f32 element to
                    XOR (default 30, a high exponent bit)
  PD_CHAOS_SCALE    scale_grad multiplier (default 1e4)

Malformed values raise ValueError naming the offending variable at
plan() time.

Faults:
  kill          SIGKILL self: no atexit, no flush, the preemption shape
  stall         sleep in the train loop: alive but silent
  corrupt_ckpt  overwrite the checkpoint payload with garbage, THEN
                SIGKILL: the restart must survive restoring a corrupt
                primary (checkpoint.load_sharded's manifest fallback)
  nan_grad      poison one gradient element with NaN
  flip_bit      XOR one bit of one PARAM element (silent data
                corruption)
  scale_grad    multiply one gradient leaf by PD_CHAOS_SCALE

The numeric trio is returned to the training loop
(``maybe_inject_numeric`` names the fault, ``apply_numeric`` perturbs a
name -> tensor dict: torch tensors on any device, or numpy arrays), so
the loop applies it where a corrupted card would have produced it: the
elastic worker's sentry drill (distributed/elastic_worker.py --sentry)
applies nan_grad and scale_grad through the TrainStep's grad_hook,
between the backward and the update.

The injection point (``maybe_inject``) is called by the training loop
once per step; it is a no-op (one parse-once read) when no plan is
armed, and it records a ``chaos.inject`` flight-recorder event before
firing.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..observability import flight_recorder as _fr

__all__ = ["ChaosPlan", "plan", "maybe_inject", "maybe_inject_serving",
           "maybe_inject_numeric", "apply_numeric", "reset_plan_cache",
           "NUMERIC_MODES"]

# training faults execute in-process (the worker IS the victim);
# serving faults are RETURNED to the fleet, which applies them to the
# named replica (a host-side engine object, not a process); numeric
# faults are RETURNED to the training loop, which applies them to the
# named host tree via apply_numeric (the host callback the sentry sees)
TRAIN_MODES = ("kill", "stall", "corrupt_ckpt")
SERVING_MODES = ("kill", "stall", "corrupt_swap")
NUMERIC_MODES = ("nan_grad", "flip_bit", "scale_grad")
MODES = tuple(dict.fromkeys(TRAIN_MODES + SERVING_MODES
                            + NUMERIC_MODES))


class ChaosPlan:
    def __init__(self, mode: str, step: int, rank: int, every: bool,
                 stall_s: float, scope: str = "", bit: int = 30,
                 scale: float = 1e4):
        self.mode = mode
        self.step = int(step)
        self.rank = int(rank)
        self.every = bool(every)
        self.stall_s = float(stall_s)
        self.scope = str(scope)
        self.bit = int(bit)
        self.scale = float(scale)

    def __repr__(self):
        return (f"ChaosPlan(mode={self.mode!r}, step={self.step}, "
                f"rank={self.rank}, every={self.every})")


_plan_cache: Optional[ChaosPlan] = None
_plan_parsed = False
_plan_error: Optional[ValueError] = None


def _env(name: str, default: str, cast):
    """Parse one PD_CHAOS_* variable, failing LOUDLY with the variable
    named — a typo'd drill that silently arms nothing would inject
    nothing and read as a passing receipt."""
    raw = os.environ.get(name, default)
    try:
        return cast(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"chaos plan: {name}={raw!r} is not a valid "
            f"{cast.__name__}") from None


def plan() -> Optional[ChaosPlan]:
    """The armed plan, parsed from the environment ONCE (a drill sets
    the env before exec; re-reading per step would let a mid-run env
    mutation change the drill under CI's feet). Malformed values —
    including an unknown non-empty PD_CHAOS_MODE — raise ValueError
    naming the offending variable."""
    global _plan_cache, _plan_parsed, _plan_error
    if _plan_parsed:
        if _plan_error is not None:
            raise _plan_error  # every injection point fails loudly
        return _plan_cache
    _plan_parsed = True
    try:
        mode = os.environ.get("PD_CHAOS_MODE", "").strip().lower()
        if not mode:
            _plan_cache = None
            return None
        if mode not in MODES:
            raise ValueError(
                f"chaos plan: PD_CHAOS_MODE={mode!r} is not one of "
                f"{sorted(MODES)} (unset/empty disarms)")
        p = ChaosPlan(
            mode=mode,
            step=_env("PD_CHAOS_STEP", "5", int),
            rank=_env("PD_CHAOS_RANK", "1", int),
            every=os.environ.get("PD_CHAOS_EVERY", "") == "1",
            stall_s=_env("PD_CHAOS_STALL_S", "600", float),
            scope=os.environ.get("PD_CHAOS_SCOPE", ""),
            bit=_env("PD_CHAOS_BIT", "30", int),
            scale=_env("PD_CHAOS_SCALE", "1e4", float))
        if not 0 <= p.bit <= 31:
            raise ValueError(
                f"chaos plan: PD_CHAOS_BIT={p.bit} outside [0, 31] "
                "(one bit of an f32 element)")
    except ValueError as e:
        _plan_error = e
        raise
    _plan_cache = p
    return _plan_cache


def reset_plan_cache():
    """Re-read the environment on the next plan() call (tests)."""
    global _plan_cache, _plan_parsed, _plan_error
    _plan_cache = None
    _plan_parsed = False
    _plan_error = None


def _corrupt(path: str):
    """Overwrite the checkpoint payload at `path` with garbage. Handles
    every layout the checkpoint layer writes: an orbax directory
    (every regular file inside is smashed — a half-dead host doesn't
    corrupt politely), a plain file (npz), and the pickle fallback's
    `<path>.pkl` suffix the caller's base path doesn't name."""
    targets = [path, path + ".pkl"]
    hit = False
    for t in targets:
        if os.path.isdir(t):
            for root, _dirs, files in os.walk(t):
                for fn in files:
                    try:
                        with open(os.path.join(root, fn), "wb") as f:
                            f.write(b"\0chaos\0" * 16)
                        hit = True
                    except OSError:
                        pass
        elif os.path.exists(t):
            try:
                with open(t, "wb") as f:
                    f.write(b"\0chaos\0" * 16)
                hit = True
            except OSError:
                pass
    if not hit:
        # a corrupt_ckpt drill that corrupted NOTHING would "pass" by
        # restoring a pristine checkpoint — say so in the black box
        _fr.record("chaos.corrupt_miss", path=path)


def maybe_inject(step: int, rank: Optional[int] = None,
                 incarnation: Optional[int] = None,
                 ckpt_path: Optional[str] = None) -> Optional[str]:
    """Fire the armed fault if (rank, step, incarnation) match the
    plan. Returns the mode it fired (stall returns after sleeping;
    kill/corrupt_ckpt never return), None when nothing fired."""
    p = plan()
    if p is None or p.mode not in TRAIN_MODES:
        # a serving-only mode (corrupt_swap) armed while a training
        # loop runs must not fall through to the stall branch
        return None
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if incarnation is None:
        incarnation = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
    if rank != p.rank or int(step) != p.step:
        return None
    if incarnation != 0 and not p.every:
        return None
    # black-box breadcrumb BEFORE firing: the dump (on SIGTERM or the
    # stall's eventual termination) must name the injected fault
    _fr.record("chaos.inject", mode=p.mode, step=int(step),
               rank=int(rank))
    if p.mode == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if p.mode == "corrupt_ckpt":
        if ckpt_path:
            _corrupt(ckpt_path)
        os.kill(os.getpid(), signal.SIGKILL)
    # stall: alive, not stepping, not pulsing — the monitor's job
    time.sleep(p.stall_s)
    return p.mode


def maybe_inject_serving(tick: int, replica: int,
                         incarnation: int = 0) -> Optional[str]:
    """Serving-replica fault poll: fires when the armed plan's mode is
    a SERVING mode and (PD_CHAOS_RANK, PD_CHAOS_STEP) match this
    (replica, fleet tick). UNLIKE ``maybe_inject`` this RETURNS the
    mode instead of executing it — a serving replica is a host-side
    engine object inside the fleet process, so the fleet applies the
    fault deterministically (drop the engine for ``kill``, wedge the
    step loop for ``stall``, poison the standby weight pool for
    ``corrupt_swap``). ``incarnation`` is the replica's respawn count:
    like training, the default plan fires only on incarnation 0 so the
    replacement replica survives — which is the drill."""
    p = plan()
    if p is None or p.mode not in SERVING_MODES:
        return None
    if int(replica) != p.rank or int(tick) != p.step:
        return None
    if int(incarnation) != 0 and not p.every:
        return None
    _fr.record("chaos.inject", mode=p.mode, step=int(tick),
               rank=int(replica), scope="serving")
    return p.mode


def maybe_inject_numeric(step: int, rank: Optional[int] = None,
                         incarnation: Optional[int] = None
                         ) -> Optional[str]:
    """Numeric-fault poll: returns the armed NUMERIC mode when
    (rank, step, incarnation) match the plan, else None. Like the
    serving hook this RETURNS the mode instead of executing it — the
    training loop owns the host trees, so it applies the fault via
    ``apply_numeric`` at the exact point (post-backward grads,
    post-update params) a real corrupted chip would have produced it,
    and the sentry observes the poisoned values first-hand."""
    p = plan()
    if p is None or p.mode not in NUMERIC_MODES:
        return None
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if incarnation is None:
        incarnation = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
    if rank != p.rank or int(step) != p.step:
        return None
    if incarnation != 0 and not p.every:
        return None
    _fr.record("chaos.inject", mode=p.mode, step=int(step),
               rank=int(rank), scope="numeric")
    return p.mode


def _is_float(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def _numeric_victim(tree: Dict[str, Any], scope: str) -> Optional[str]:
    """The leaf the fault lands on: first (sorted) floating leaf whose
    name contains `scope` (empty scope: any floating leaf)."""
    for name in sorted(tree):
        if scope and scope not in name:
            continue
        if _is_float(tree[name]):
            return name
    return None


def _flip(e0: np.ndarray, bit: int) -> np.ndarray:
    """Element 0's f32 image with one bit XORed."""
    e0 = e0.astype(np.float32)
    e0.view(np.uint32)[0] ^= np.uint32(1 << bit)
    return e0


def apply_numeric(tree: Dict[str, Any], mode: str,
                  plan_: Optional[ChaosPlan] = None) -> Dict[str, Any]:
    """Apply a numeric fault to a name->tensor dict (torch tensors or
    numpy arrays), returning a NEW dict whose victim leaf is a perturbed
    copy (the caller assigns it back). nan_grad: element 0 of the victim
    becomes NaN. flip_bit: bit PD_CHAOS_BIT of element 0's f32 image is
    XORed and written back to that element alone. scale_grad: the whole
    victim is multiplied by PD_CHAOS_SCALE. A fault that found no victim
    records a ``chaos.numeric_miss`` breadcrumb."""
    p = plan_ or plan()
    scope = p.scope if p is not None else ""
    victim = _numeric_victim(tree, scope)
    if victim is None:
        _fr.record("chaos.numeric_miss", mode=mode, scope=scope)
        return dict(tree)
    if mode not in NUMERIC_MODES:
        raise ValueError(f"apply_numeric: unknown mode {mode!r}")
    out = dict(tree)
    leaf = out[victim]
    scale = p.scale if p is not None else 1e4
    bit = p.bit if p is not None else 30
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().clone()
        flat = arr.view(-1)
        with torch.no_grad():
            if mode == "nan_grad":
                flat[0] = float("nan")
            elif mode == "flip_bit":
                e0 = _flip(flat[:1].to(torch.float32).cpu().numpy(), bit)
                flat[0] = torch.from_numpy(e0).to(arr.dtype)[0]
            else:
                flat.mul_(scale)
    else:
        arr = np.array(np.asarray(leaf), copy=True)
        flat = arr.reshape(-1)
        if mode == "nan_grad":
            flat[0] = np.nan
        elif mode == "flip_bit":
            flat[0] = _flip(flat[:1], bit).astype(flat.dtype)[0]
        else:
            flat *= np.asarray(scale, flat.dtype)
    out[victim] = arr
    _fr.record("chaos.numeric_hit", mode=mode, leaf=victim)
    return out

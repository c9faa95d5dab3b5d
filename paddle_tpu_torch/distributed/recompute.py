"""Activation recomputation (counterpart of
paddle_tpu/distributed/recompute.py).

The JAX package wraps the segment in jax.checkpoint: the compiler
re-emits the forward in the backward, trading FLOPs for memory. The
port uses torch.utils.checkpoint, non-reentrant: the segment's
activations are dropped after the forward and recomputed when the
backward needs them. Two things the compiler gets for free are made
explicit here (`checkpointed`):

- the dropout seeds: the recompute must draw the masks of the forward
  it repeats, or the backward would be the gradient of another forward
  than the one whose loss was reported. The seed scope is rewound to
  where the forward entered the segment (core/generator.py rewound);
  inside a captured step that means the same Draw paths, so the same
  seeds. torch's own RNG stashing is off: no op in the port draws from
  the default generators inside a scope.
- the AMP state: the port's auto_cast is its own thread-local state,
  which the backward runs outside of, so the recompute re-enters the
  forward's (amp_state_scope).
- BatchNorm's running statistics: jax.checkpoint recomputes without a
  second buffer update, so a recompute runs under
  frozen_running_stats (nn/functional/norm.py), and re-enters the
  forward's batch_stat_scope (the groups a synced BatchNorm averages
  its moments over).

Policies, as the reference's RecomputeOptimizer picks them
(paddle_tpu/distributed/fleet/meta_optimizers.py:205-210): None or
"nothing_saveable" saves nothing inside the segment; "checkpoint_dots"
saves the matmul outputs (aten mm, addmm, bmm, baddbmm) through a
selective-checkpoint policy and recomputes the rest. The flash-attention
forward is no matmul, so it is recomputed under both, as a pallas_call
is under jax's checkpoint_dots.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils import checkpoint as _ckpt

from ..amp.auto_cast import amp_state, amp_state_scope
from ..core.generator import next_seed, rewind_point, rewound, seed_scope
from ..nn.functional import norm as _norm

__all__ = ["recompute", "recompute_sequential", "RecomputeFunction",
           "checkpointed", "remat_scope", "REMAT_POLICIES"]

REMAT_POLICIES = (None, "nothing_saveable", "checkpoint_dots")

_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default,
                   torch.ops.aten.baddbmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def check_policy(policy):
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {policy!r}")
    return policy


@contextlib.contextmanager
def _entered(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


def remat_scope(point, amp, stat_groups=None):
    """The recompute's context: the seed scope rewound to `point` (a
    rewind_point() value), the AMP state `amp` (an amp_state() value)
    and the batch-stat groups `stat_groups`, as the forward it repeats
    entered them, with BatchNorm's running statistics frozen. The
    pipeline engine's backward (pipeline_engine.py) enters it too."""
    return _entered(rewound(point), amp_state_scope(amp),
                    _norm.batch_stat_scope(stat_groups),
                    _norm.frozen_running_stats())


def _contexts(policy):
    """(forward, recompute) context managers for torch's checkpoint: the
    recompute rewinds the seed scope and re-enters the AMP state and the
    batch-stat groups found here, at the segment's entry."""
    fwd, rec = [], [remat_scope(rewind_point(), amp_state(),
                                _norm.stat_groups())]
    if policy == "checkpoint_dots":
        f, r = _ckpt.create_selective_checkpoint_contexts(_save_dots)
        fwd.append(f)
        rec.append(r)
    return _entered(*fwd), _entered(*rec)


def checkpointed(fn, *args, policy=None, **kwargs):
    """fn(*args, **kwargs) with its activations recomputed in the
    backward (torch.utils.checkpoint, non-reentrant), drawing the same
    dropout seeds and running under the same AMP state as the forward.
    policy: see REMAT_POLICIES."""
    check_policy(policy)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=functools.partial(_contexts, policy),
                            **kwargs)


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return "cpu"


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              **kwargs):
    """paddle.distributed.fleet.utils.recompute parity: `function(*args,
    **kwargs)` recomputed in the backward. As in the JAX package, the
    segment draws its dropout from one seed taken from the current stream
    at the call (next_seed), so the recompute repeats its masks.
    use_reentrant and preserve_rng_state are accepted for the signature:
    the port always runs torch's non-reentrant checkpoint with the seed
    rewound (checkpointed)."""
    seed = next_seed(_device_of(args))

    def pure(*a):
        with seed_scope(seed):
            return function(*a, **kwargs)

    return checkpointed(pure, *args)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Segment-wise recompute over a Sequential (paddle incubate parity):
    ctx["segments"] segments, each one recompute()."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    n = len(layers)
    per = (n + segments - 1) // segments
    out = args[0] if len(args) == 1 else args

    for i in range(0, n, per):
        seg = layers[i:i + per]

        def seg_fn(x, _seg=seg):
            for layer in _seg:
                x = layer(x)
            return x
        out = recompute(seg_fn, out)
    return out


class RecomputeFunction:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, **kwargs):
        return recompute(self.fn, *args, **kwargs)

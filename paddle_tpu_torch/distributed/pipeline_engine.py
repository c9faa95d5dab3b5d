"""Heterogeneous pipeline parallelism: per-stage programs driven in the
1F1B order from one host loop (counterpart of the dispatch mode of
paddle_tpu/distributed/pipeline_engine.py).

Reference: framework/section_worker.cc:34 (SectionWorker::TrainFiles,
the host-driven microbatch loop) and python/paddle/fluid/optimizer.py
:3718 (PipelineOptimizer).

Each stage is an arbitrary nn.Module (embeddings only, a run of blocks,
the heads: nothing has to match its neighbours). One controller emits
the schedule's order (build_1f1b_schedule: 1F1B or F-then-B;
build_interleaved_schedule: virtual stages); each op runs one of the
stage's programs:

- F: the stage's forward, under no_grad; only its inputs are kept for
  the backward (at most min(M, S - s) at stage s under 1F1B);
- B: the forward again, rematerialized under the seed scope and the AMP
  state that F ran under (distributed/recompute.py remat_scope), then
  one autograd pass of (y, local) against (dy, scale): a stage's
  pipeline_local_loss() (the MoE aux) joins the objective there with
  the loss scale as its cotangent. Stage 0 returns no input gradient
  (its input is integer ids), and of a tuple activation only the
  elements that carry a gradient get one (ERNIE's additive mask gets
  none);
- the last stage's F: loss, local loss and gradients in one op; the
  loss it reports is the unscaled main loss;
- gradients accumulate into per-stage buffers; the step's first B of a
  stage sets them instead of adding;
- U: one update per stage, optimizer.apply_gradients on the microbatch
  mean of the gradients divided by the loss scale, gated on the device
  by found_inf (skip=), so no host bool sits between the backward and
  the updates; the scaler reads one host bool after every update is
  dispatched.

Every dropout draw of op (s, m) derives from the step seed folded with
(s, m) (core/generator.py fold_seed), as the JAX engine folds its key
with s and then m; so B draws F's masks.

On the card each op replays a CUDA graph, one per (stage, op kind,
input signature, AMP state), captured at the first call after an eager
warm-up (static/capture.py): inputs through static buffers, the seeds
in the program's SeedSlots (filled with the op's seed before each
replay), the lr and the loss scale in 0-d device buffers, outputs
cloned out of the graph before the next replay (all the engine's graphs
share one memory pool). A capture that fails raises: nothing falls back
to eager. eager=True runs the same bodies without graphs (the
reference a replay is held against); on the CPU the engine runs eager.
The eval sweep runs eagerly.

All stages run on one device (mesh=None: stage_submeshes gives every
stage the engine's device; activations move with .to(device,
non_blocking=True), place_input). One rank per stage over p2p, the
one-program engine (exec_mode="spmd_1f1b", plan=) and the pipeline.py
schedules come with ROADMAP.md item 14d. sentry= is accepted and kept,
unused, as the JAX dispatch engine keeps it (its sentry instruments the
one-program spmd_1f1b engine only, item 14d here). The update runs under
the anatomy scopes the JAX engine opens: the unscale and the skip select
under ``loss_scale``, the rule under ``optimizer``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..amp.auto_cast import amp_state
from ..core.generator import Draw, SeedSlots, fold_seed, next_seed, seed_scope
from ..core.place import resolve_device
from ..observability import flight_recorder as _fr
from ..observability import metrics as _obs
from ..observability.anatomy import scope as _scope
from ..observability.sentinel import RecompileSentinel, signature_of
from ..static.capture import StaticInputs, capture, clone_outputs, warm_up
from .recompute import remat_scope

__all__ = ["PipelineParallel", "build_1f1b_schedule",
           "build_interleaved_schedule", "simulate_schedule", "tick_table",
           "stage_submeshes"]

_ITEM_14D = "ROADMAP.md item 14d (the SPMD pipeline)"


# ---------------------------------------------------------------------------
# schedule generation (pure python, no tensors)
# ---------------------------------------------------------------------------

def build_1f1b_schedule(n_stages: int, num_micro: int,
                        policy: str = "1f1b") -> List[Tuple[str, int, int]]:
    """Global op order [(op, stage, microbatch)] with op in {"F","B"}.

    policy="1f1b": PipeDream-flush — each stage runs (n_stages-1-s)
    warmup forwards, then alternates one-forward-one-backward, then
    drains backwards. Peak in-flight activations per stage is
    min(num_micro, n_stages-s) instead of GPipe's num_micro.
    policy="fthenb": all forwards then all backwards
    (section_worker.cc's F-then-B order).
    """
    deps_done: set = set()
    emitted: List[Tuple[str, int, int]] = []
    f_count = [0] * n_stages
    b_count = [0] * n_stages

    def f_ready(s):
        m = f_count[s]
        if m >= num_micro:
            return False
        return s == 0 or ("F", s - 1, m) in deps_done

    def b_ready(s):
        m = b_count[s]
        if m >= num_micro:
            return False
        if ("F", s, m) not in deps_done:
            return False
        return s == n_stages - 1 or ("B", s + 1, m) in deps_done

    total = 2 * n_stages * num_micro
    while len(emitted) < total:
        progressed = False
        for s in range(n_stages):
            warmup = min(num_micro, n_stages - s) if policy == "1f1b" \
                else num_micro
            # 1f1b steady state: prefer B once past warmup
            prefer_b = policy == "1f1b" and f_count[s] >= warmup
            order = ("B", "F") if prefer_b else ("F", "B")
            for op in order:
                if op == "F" and f_ready(s):
                    m = f_count[s]
                    emitted.append(("F", s, m))
                    deps_done.add(("F", s, m))
                    f_count[s] += 1
                    progressed = True
                    break
                if op == "B" and b_ready(s):
                    m = b_count[s]
                    emitted.append(("B", s, m))
                    deps_done.add(("B", s, m))
                    b_count[s] += 1
                    progressed = True
                    break
        if not progressed:
            raise RuntimeError("schedule deadlock (bug)")
    return emitted


def build_interleaved_schedule(n_dev: int, v: int, num_micro: int,
                               return_finish: bool = False):
    """Virtual-pipeline (Megatron-interleaved) order for n_dev physical
    ranks each hosting v model chunks (stage s runs on rank s % n_dev):
    the bubble shrinks from (p-1)/(M+p-1) to (p-1)/(vM+p-1), as
    simulate_schedule measures for the divisible case.

    Each rank's op program is the standard interleaved 1F1B (chunk index
    c(k) = (k // p) mod v, warmup (p-d-1)·2 + (v-1)·p forwards, strict
    F/B alternation, drain), merged into one valid global order by the
    unit-time tick machine. Requires M % n_dev == 0.
    """
    p = int(n_dev)
    if num_micro % p != 0:
        raise ValueError(
            f"interleaved schedule needs num_micro % n_dev == 0 "
            f"(got M={num_micro}, p={p}); pad the microbatch count or "
            "use schedule='1f1b'")
    Mv = num_micro * v
    S = p * v

    def f_op(d, k):
        c = (k // p) % v
        m = (k % p) + p * (k // (p * v))
        return ("F", c * p + d, m)

    def b_op(d, k):
        c = v - 1 - ((k // p) % v)
        m = (k % p) + p * (k // (p * v))
        return ("B", c * p + d, m)

    progs = []
    for d in range(p):
        w = min(Mv, (p - d - 1) * 2 + (v - 1) * p)
        seq = [f_op(d, k) for k in range(w)]
        nf, nb = w, 0
        while nb < Mv:
            if nf < Mv:
                seq.append(f_op(d, nf))
                nf += 1
            seq.append(b_op(d, nb))
            nb += 1
        progs.append(seq)
    order, _, finish = _run_ticks(progs, S, return_finish=True)
    if return_finish:
        return order, finish
    return order


def _run_ticks(queues: List[List[Tuple[str, int, int]]],
               n_stages: int, return_finish: bool = False):
    """Unit-time tick machine shared by the interleaved builder, the
    simulator and the static tick tables (one copy of the dependency
    rules): each rank executes its queue in order, one op per tick,
    waiting for F(s-1,m)→F(s,m) and {F(s,m), B(s+1,m)}→B(s,m). Returns
    (global order, ticks[, finish tick of each op])."""
    finish: Dict[Tuple[str, int, int], int] = {}
    pos = [0] * len(queues)
    tick = 0
    order: List[Tuple[str, int, int]] = []
    total = sum(len(q) for q in queues)
    while len(order) < total:
        tick += 1
        ran = False
        for d in range(len(queues)):
            if pos[d] >= len(queues[d]):
                continue
            op, s, m = queues[d][pos[d]]
            deps = []
            if op == "F" and s > 0:
                deps.append(("F", s - 1, m))
            if op == "B":
                deps.append(("F", s, m))
                if s < n_stages - 1:
                    deps.append(("B", s + 1, m))
            if all(finish.get(dp, tick + 1) < tick for dp in deps):
                finish[(op, s, m)] = tick
                pos[d] += 1
                order.append((op, s, m))
                ran = True
        if not ran:
            raise RuntimeError("schedule deadlock")
    if return_finish:
        return order, tick, finish
    return order, tick


def tick_table(sched: List[Tuple[str, int, int]], n_dev: int,
               dev_of=None) -> Dict[Tuple[str, int, int], int]:
    """Per-op tick assignment of a global order under the same machine
    (consumers run strictly after producers' ticks): the static
    timetable of the SPMD schedules."""
    dev_of = dev_of or (lambda s: s % n_dev)
    queues: List[List[Tuple[str, int, int]]] = [[] for _ in range(n_dev)]
    for op in sched:
        queues[dev_of(op[1])].append(op)
    S = 1 + max(s for _, s, _ in sched)
    _, _, finish = _run_ticks(queues, S, return_finish=True)
    return finish


def _spmd_tick_tables(sched: List[Tuple[str, int, int]], n_stages: int,
                      num_micro: int):
    """Static per-tick per-stage int32 tables of the one-program engine
    (ROADMAP.md item 14d), derived from the timetable the host engine
    executes (tick_table over the schedule's order).

    Returns (tables, R, Rb): tables is a tuple of [T, S] numpy arrays
    (f_act, f_mb, b_act, b_mb, rf_store, rf_mb, rb_store, rb_mb): row t
    holds, per stage, whether a forward/backward runs at tick t and on
    which microbatch, and whether last tick's hop delivered an
    activation (rf) or an activation-grad (rb) to store. R/Rb are the
    exact ring sizes of the saved-input and incoming-grad buffers
    (live-interval analysis, pipeline._min_slots)."""
    from .pipeline import _min_slots

    S, M = int(n_stages), int(num_micro)
    finish = tick_table(sched, S, dev_of=lambda s: s)
    T = max(finish.values())
    z = lambda: np.zeros((T + 2, S), np.int32)  # noqa: E731
    f_act, f_mb, b_act, b_mb = z(), z(), z(), z()
    rf_store, rf_mb, rb_store, rb_mb = z(), z(), z(), z()
    for (op, s, m), t in finish.items():
        if op == "F":
            f_act[t, s], f_mb[t, s] = 1, m
            if s < S - 1:     # activation arrives at the consumer at t+1
                rf_store[t + 1, s + 1] = 1
                rf_mb[t + 1, s + 1] = m
        else:
            b_act[t, s], b_mb[t, s] = 1, m
            if s > 0:         # activation-grad arrives at s-1 at t+1
                rb_store[t + 1, s - 1] = 1
                rb_mb[t + 1, s - 1] = m
    R = Rb = 1
    for s in range(S):
        acts, dys = {}, {}
        for m in range(M):
            store = (finish[("F", s, m)] if s == 0
                     else finish[("F", s - 1, m)] + 1)
            acts[m] = (store, finish[("B", s, m)])
            dstore = (finish[("F", s, m)] if s == S - 1
                      else finish[("B", s + 1, m)] + 1)
            dys[m] = (dstore, finish[("B", s, m)])
        R = max(R, _min_slots(acts))
        Rb = max(Rb, _min_slots(dys))
    # row 0 is empty (finish starts at 1); arrivals landing at T+1 have
    # no consumer, so the row is dropped
    tables = tuple(a[1:T + 1] for a in (
        f_act, f_mb, b_act, b_mb, rf_store, rf_mb, rb_store, rb_mb))
    return tables, R, Rb


def simulate_schedule(sched: List[Tuple[str, int, int]], n_dev: int,
                      dev_of=None) -> Tuple[int, float]:
    """Unit-time pipeline simulation of a global op order (the
    _run_ticks machine): (ticks, bubble_fraction), the hardware-
    independent receipt that a schedule shrinks the bubble."""
    dev_of = dev_of or (lambda s: s % n_dev)
    queues: List[List[Tuple[str, int, int]]] = [[] for _ in range(n_dev)]
    for op in sched:
        queues[dev_of(op[1])].append(op)
    S = 1 + max(s for _, s, _ in sched)
    _, tick = _run_ticks(queues, S)
    bubble = 1.0 - len(sched) / float(tick * n_dev)
    return tick, bubble


def stage_submeshes(mesh, n_stages: int, pp_axis: str = "pp") -> list:
    """Each stage's place: [None] * n_stages, every stage on the
    engine's device (the JAX mesh=None case). A mesh with an axis above
    one rank (a pp axis: one rank per stage over p2p; dp or tp inside a
    stage) comes with ROADMAP.md item 14d. A pp axis of one rank must
    still equal the stage count, as the JAX function asserts."""
    if mesh is None:
        return [None] * n_stages
    wide = {ax: mesh.shape[ax] for ax in mesh.axis_names
            if mesh.shape[ax] > 1}
    if wide:
        raise NotImplementedError(
            f"PipelineParallel over mesh axes {wide}: one rank per stage "
            f"(and axes inside a stage) come with {_ITEM_14D}; mesh=None "
            "runs every stage on this process's device")
    if pp_axis in mesh.axis_names and mesh.shape[pp_axis] != n_stages:
        raise ValueError(f"mesh '{pp_axis}' size {mesh.shape[pp_axis]} != "
                         f"{n_stages} stages")
    return [None] * n_stages


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


# ---------------------------------------------------------------------------
# one stage's programs
# ---------------------------------------------------------------------------

class _Stage:
    """Stage `idx` of `n_stages`: its layer, its trainable parameters,
    their gradient buffers and its op bodies. Each body takes its
    tensors and `base`, the seed its draws derive from (an int, or a
    Draw of a captured program's SeedSlots)."""

    def __init__(self, layer, idx: int, n_stages: int,
                 loss_fn: Optional[Callable], device: torch.device):
        self.layer = layer
        self.idx = idx
        self.is_first = idx == 0
        self.is_last = idx == n_stages - 1
        self.device = device
        self.loss_fn = loss_fn
        named = [(k, p) for k, p in layer.named_parameters()
                 if p.requires_grad]
        self.param_names = [k for k, _ in named]
        self.params = [p for _, p in named]
        # gradient accumulation buffers (persistent: a captured B writes
        # into them; the step's first B of the stage sets them)
        self.grads = [torch.zeros_like(p) for p in self.params]
        # which elements of the stage's output (and so of the next
        # stage's input) carry a gradient: found by the first forward
        self.diff_out: Optional[Tuple[bool, ...]] = None
        self.diff_in: Tuple[bool, ...] = ()
        self._local_fn = getattr(layer, "pipeline_local_loss", None)

    def place_input(self, x):
        """An activation or a batch onto this stage's device (the recv
        side of the transfer)."""
        if isinstance(x, (list, tuple)):
            return type(x)(self.place_input(a) for a in x)
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        return x

    def _local(self):
        if self._local_fn is None:
            return None
        a = self._local_fn()
        return None if a is None else a.to(torch.float32)

    def _diff_inputs(self, x):
        """The stage's inputs, those that carry a gradient detached and
        marked for it (none at stage 0: its input is raw data)."""
        if self.is_first:
            return x, []
        xs = tuple(t.detach().requires_grad_() if d else t
                   for t, d in zip(x, self.diff_in))
        return xs, [t for t, d in zip(xs, self.diff_in) if d]

    def _gx(self, grads_in):
        """The input gradient tuple passed back to the previous stage:
        None where an input carries none."""
        it = iter(grads_in)
        return tuple(next(it) if d else None for d in self.diff_in)

    @torch.no_grad()
    def _accumulate(self, gs, first: bool):
        gs = [g if g is not None else torch.zeros_like(p)
              for g, p in zip(gs, self.params)]
        if not gs:
            return
        if first:
            torch._foreach_copy_(self.grads, gs)
        else:
            torch._foreach_add_(self.grads, gs)

    def fwd(self, x, base):
        """F: the forward on input tuple `x`; returns the output tuple.
        The stage's first forward runs with grad on, to find which
        outputs carry a gradient."""
        probe = self.diff_out is None
        with seed_scope(base), torch.set_grad_enabled(probe):
            y = _as_tuple(self.layer(*x))
        if probe:
            self.diff_out = tuple(isinstance(t, torch.Tensor)
                                  and t.requires_grad for t in y)
            y = tuple(t.detach() if isinstance(t, torch.Tensor) else t
                      for t in y)
        return y

    def bwd(self, x, gy, scale, base, amp, first: bool):
        """B: the forward rematerialized under F's seed scope and AMP
        state, then one autograd pass of (y, local) against (gy, scale).
        Accumulates the parameter gradients; returns the input gradient
        tuple (None at stage 0)."""
        xs, xin = self._diff_inputs(x)
        with torch.enable_grad(), remat_scope((base, 0), amp):
            y = _as_tuple(self.layer(*xs))
            local = self._local()
        outs = [t for t, g in zip(y, gy) if g is not None]
        cots = [g for g in gy if g is not None]
        if local is not None:
            outs.append(local)
            cots.append(scale)
        gs = torch.autograd.grad(outs, self.params + xin, cots,
                                 allow_unused=True)
        n = len(self.params)
        self._accumulate(gs[:n], first)
        return None if self.is_first else self._gx(gs[n:])

    def last(self, x, labels, scale, base, first: bool):
        """The last stage's F: loss, local loss and gradients in one op.
        The gradients are of ((loss + local) * scale); returns (the
        unscaled main loss as f32, the input gradient tuple)."""
        xs, xin = self._diff_inputs(x)
        with torch.enable_grad(), seed_scope(base):
            out = self.layer(*xs)
            loss = self.loss_fn(out, *labels).to(torch.float32)
            local = self._local()
            obj = (loss + local if local is not None else loss) * scale
        gs = torch.autograd.grad(obj, self.params + xin, allow_unused=True)
        n = len(self.params)
        self._accumulate(gs[:n], first)
        return loss.detach(), None if self.is_first else self._gx(gs[n:])

    @torch.no_grad()
    def update(self, optimizer, lr, scale, found_inf, num_micro: int):
        """U: the microbatch mean of the accumulated gradients, unscaled,
        through the optimizer, gated by found_inf on the device (None:
        no gate)."""
        with _scope("loss_scale"):
            denom = scale * num_micro
            grads = [g / denom for g in self.grads]
        with _scope("optimizer"):
            optimizer.apply_gradients(self.params, grads, lr=lr,
                                      skip=found_inf)

    def found_inf(self):
        """Whether any accumulated gradient holds a non-finite value (a
        0-d bool device tensor)."""
        if not self.grads:
            return torch.zeros((), dtype=torch.bool, device=self.device)
        with _scope("loss_scale"):
            return ~torch.stack([torch.isfinite(g).all()
                                 for g in self.grads]).all()


class _Program:
    """One captured op: graph, static inputs, seed slots, outputs."""
    __slots__ = ("graph", "inputs", "slots", "out")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class PipelineParallel:
    """fleet.meta_parallel.PipelineParallel parity: heterogeneous stages,
    microbatched 1F1B training driven by train_batch().

    stages: nn.Modules; stage i feeds stage i+1 (a tuple output passes
    on as several inputs). loss_fn(last_stage_out, *labels) -> scalar.
    optimizer: one Optimizer; each stage's parameters keep their own
    state in it and each stage runs its own update (the reference gives
    each SectionWorker its own optimize ops). device: where the stages
    run (None: the current device, the card unless the CPU was asked
    for); the layers are moved there. eager: run the ops without CUDA
    graphs on the card too (the reference a replay is held against; the
    CPU always runs eager).

    Counts: last_dispatch_count (the ops of the last batch: S·M F,
    (S-1)·M B, S updates, and S + 1 overflow checks with a scaler),
    last_tick_ms (host ms per schedule op), last_in_flight (each stage's
    peak of held inputs in the last batch), schedule_bubble_fraction,
    captures, replays and programs (the graphs; one per stage, op kind
    and signature), recompile_sentinel."""

    def __init__(self, stages: Sequence, loss_fn: Callable, optimizer,
                 num_micro: int = 1, mesh=None, pp_axis: str = "pp",
                 schedule: str = "1f1b", param_spec_fn=None,
                 virtual_pipeline_degree: int = 1,
                 exec_mode: str = "dispatch", sentry=None, plan=None,
                 device=None, eager: bool = False):
        if len(stages) < 1:
            raise ValueError("PipelineParallel needs at least one stage")
        if exec_mode not in ("dispatch", "spmd_1f1b"):
            raise ValueError(
                f"exec_mode={exec_mode!r}: pick 'dispatch' (per-stage "
                "executables, host-driven tick loop, heterogeneous "
                "stages) or 'spmd_1f1b' (the whole train step — every "
                "microbatch forward/backward, grad accumulation, loss "
                "scaling, optimizer update — as ONE jitted shard_map "
                "program with donated state)")
        if plan is not None and exec_mode != "spmd_1f1b":
            raise ValueError(
                "plan= (MeshPlan) drives the one-executable spmd_1f1b "
                "engine; the dispatch engine places per-stage programs "
                "itself — drop plan= or set exec_mode='spmd_1f1b'")
        if exec_mode == "spmd_1f1b":
            raise NotImplementedError(
                "PipelineParallel(exec_mode='spmd_1f1b'"
                + (", plan=...)" if plan is not None else ")")
                + f": the one-program pipeline comes with {_ITEM_14D}; "
                "exec_mode='dispatch' runs the host-driven engine")
        if param_spec_fn is not None:
            raise NotImplementedError(
                "PipelineParallel(param_spec_fn=...) places parameters on "
                f"a stage's submesh: it comes with {_ITEM_14D}")
        if schedule not in ("1f1b", "fthenb", "interleaved"):
            raise ValueError(f"schedule={schedule!r}: pick '1f1b', "
                             "'fthenb' or 'interleaved'")
        self.exec_mode = exec_mode
        self.num_micro = int(num_micro)
        self.schedule_policy = schedule
        self.optimizer = optimizer
        # kept, unused, as the JAX dispatch engine keeps it
        self.sentry = sentry
        self.virtual_pipeline_degree = v = int(virtual_pipeline_degree)
        if v > 1:
            if len(stages) % v != 0:
                raise ValueError(
                    f"virtual_pipeline_degree={v} needs len(stages) "
                    f"divisible by it, got {len(stages)}")
            if schedule not in ("1f1b", "interleaved"):
                raise ValueError(
                    f"virtual_pipeline_degree={v} only runs the "
                    f"interleaved schedule; schedule={schedule!r} would "
                    "be silently ignored — drop it or set v=1")
        stage_submeshes(mesh, len(stages) // v, pp_axis)
        self.device = dev = resolve_device(device)
        for layer in stages:
            layer.to(dev)
        self.stages = [
            _Stage(layer, i, len(stages),
                   loss_fn if i == len(stages) - 1 else None, dev)
            for i, layer in enumerate(stages)]
        for st in self.stages:
            for p in st.params:
                # the optimizer state exists from the start, as the JAX
                # engine's init_state_tree makes it (a captured update
                # holds its addresses)
                optimizer._state_of(p)
        if schedule == "interleaved" or v > 1:
            self.schedule_policy = "interleaved"
            self._sched = build_interleaved_schedule(
                len(stages) // v, v, self.num_micro)
        else:
            self._sched = build_1f1b_schedule(len(stages), self.num_micro,
                                              schedule)
        _, self.schedule_bubble_fraction = simulate_schedule(
            self._sched, len(stages) // v)
        self.eager = eager or dev.type != "cuda"
        # the 0-d device buffers the ops read: lr, loss scale, found_inf
        self._lr = torch.zeros((), dtype=torch.float32, device=dev)
        self._scale = torch.ones((), dtype=torch.float32, device=dev)
        self._found_inf = torch.zeros((), dtype=torch.bool, device=dev)
        self._programs: Dict[Any, _Program] = {}
        self._pool = None
        self.captures = 0
        self.replays = 0
        self.recompile_sentinel = RecompileSentinel("pipeline")
        self._step_count = 0
        self.last_dispatch_count = 0
        self.last_tick_ms: List[float] = []
        self.last_in_flight: List[int] = []

    # -- programs -------------------------------------------------------------
    @property
    def programs(self) -> int:
        return len(self._programs)

    def _run(self, key, body, args, seed: int):
        """One op: body(args, base) eagerly with base = seed, or on the
        card the CUDA graph of `key` (the op's stage and kind) and args'
        signature, captured at its first call after the eager warm-up
        (which is this call's op). Returns body's outputs (cloned out of
        the graph)."""
        if self.eager:
            return body(args, seed)
        key = (key, signature_of(args), amp_state())
        prog = self._programs.get(key)
        if prog is None:
            return self._capture(key, body, args, seed)
        prog.inputs.fill(args)
        prog.slots.fill(seed)
        prog.graph.replay()
        self.replays += 1
        return clone_outputs(prog.out)

    def _capture(self, key, body, args, seed):
        dev = self.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        prog = _Program()
        prog.inputs = StaticInputs(args, dev)
        prog.slots = SeedSlots(dev).record(seed)
        out = warm_up(lambda: body(prog.inputs.tree, Draw((), prog.slots)),
                      dev)
        prog.slots.freeze()
        prog.graph, prog.out = capture(
            lambda: body(prog.inputs.tree, Draw((), prog.slots)), dev,
            prog.slots.generators.values(), program="pipeline",
            pool=self._pool)
        self._programs[key] = prog
        self.captures += 1
        return out

    def release(self):
        """Drop the captured programs and their memory pool."""
        self._programs.clear()
        self._pool = None

    # -- one full batch -------------------------------------------------------
    def _micro(self, tree, m):
        M = self.num_micro

        def sl(a):
            if not isinstance(a, torch.Tensor) or a.dim() == 0:
                return a
            mb = a.shape[0] // M
            return a[m * mb:(m + 1) * mb]
        return tuple(sl(a) for a in tree)

    def _check_batch(self, tree):
        M = self.num_micro
        for a in tree:
            if isinstance(a, torch.Tensor) and a.dim() > 0 \
                    and a.shape[0] % M != 0:
                raise ValueError(
                    f"batch dim {a.shape[0]} not divisible by "
                    f"num_micro={M} (remainder rows would be dropped)")

    def train_batch(self, inputs, labels=(), scaler=None, seed=None):
        """Run one pipelined training step over num_micro microbatches.
        Returns the mean microbatch loss (a 0-d f32 device tensor).

        scaler: amp.GradScaler — loss scaling. The overflow check gates
        every update on the device; the scaler reads one host bool after
        the updates are dispatched, skipped steps leave params and
        optimizer state alone, and its dynamic schedule advances.
        seed: the step's dropout seed (None draws the next from the
        device's stream, as the JAX engine draws next_key())."""
        rec = _obs._enabled
        t_step = time.perf_counter() if rec else 0.0
        tok = _fr.step_begin("pipeline", self._step_count)
        dev = self.device
        use_scaler = scaler is not None and scaler.is_enable()
        if use_scaler:
            self._scale.copy_(scaler._dev_state(dev)[0])
        else:
            self._scale.fill_(1.0)
        self._lr.fill_(self.optimizer.get_lr())
        inputs, labels = _as_tuple(inputs), _as_tuple(labels)
        self._check_batch(inputs + labels)
        M, S = self.num_micro, len(self.stages)
        step_seed = next_seed(dev) if seed is None else int(seed)
        amp = amp_state()
        scale = self._scale

        acts: List[Dict[int, Any]] = [dict() for _ in range(S)]
        gys: List[Dict[int, Any]] = [dict() for _ in range(S)]
        seen_b = [False] * S
        peak = [0] * S
        losses = []
        dispatches = 0
        tick_ms: List[float] = []
        for op, s, m in self._sched:
            t_tick = time.perf_counter()
            st = self.stages[s]
            sd = fold_seed(step_seed, (s, m))
            if op == "F":
                if s == 0:
                    x = st.place_input(self._micro(inputs, m))
                else:
                    x = acts[s][m]  # placed by the producing stage's F
                acts[s][m] = x
                peak[s] = max(peak[s], len(acts[s]))
                if st.is_last:
                    first = not seen_b[s]
                    seen_b[s] = True
                    lbl = st.place_input(self._micro(labels, m))
                    loss, gx = self._run(
                        (s, "L0" if first else "L"),
                        lambda a, b, st=st, first=first: st.last(
                            a[0], a[1], a[2], b, first),
                        (x, lbl, scale), sd)
                    losses.append(loss)
                    gys[s][m] = gx  # consumed by this stage's own B
                else:
                    probe = st.diff_out is None
                    y = self._run((s, "F"), lambda a, b, st=st: st.fwd(
                        a, b), x, sd)
                    if probe:
                        self.stages[s + 1].diff_in = st.diff_out
                    acts[s + 1][m] = self.stages[s + 1].place_input(y)
                dispatches += 1
            else:  # B
                if st.is_last:
                    # grads were produced together with the loss in F
                    gx = gys[s].pop(m)
                else:
                    first = not seen_b[s]
                    seen_b[s] = True
                    gy = gys[s].pop(m)
                    gx = self._run(
                        (s, "B0" if first else "B"),
                        lambda a, b, st=st, first=first: st.bwd(
                            a[0], a[1], a[2], b, amp, first),
                        (acts[s][m], gy, scale), sd)
                    dispatches += 1
                del acts[s][m]  # 1f1b frees this activation now
                if s > 0:
                    gys[s - 1][m] = self.stages[s - 1].place_input(gx)
            tick_ms.append((time.perf_counter() - t_tick) * 1e3)
        self.last_tick_ms = tick_ms
        self.last_in_flight = peak

        # the optimize phase: one update per stage, gated on the device
        self._step_count += 1
        mean_loss = torch.stack(losses).mean()
        if use_scaler:
            flags = [st.found_inf() for st in self.stages]
            self._found_inf.copy_(torch.stack(flags).any())
            dispatches += S + 1
        steps = self.optimizer._step_count
        for s, st in enumerate(self.stages):
            self._run((s, "U", use_scaler),
                      lambda a, b, st=st: st.update(
                          self.optimizer, a[0], a[1],
                          a[2] if use_scaler else None, M),
                      (self._lr, scale, self._found_inf), 0)
            dispatches += 1
        self.optimizer._step_count = steps + 1
        if use_scaler:
            # the scaler's state machine advances on the device, after
            # every update is dispatched; the one host read is the skip
            # bool its telemetry reports
            scaler._update(self._found_inf)
            if bool(self._found_inf):
                _obs.counter("amp.loss_scale.skipped_total",
                             _always=True).add(1)
                _fr.record("loss_scale.skip", step=self._step_count - 1)
            if _obs._enabled:
                _obs.gauge("amp.loss_scale.scale").set(
                    scaler.get_loss_scaling())
        self.last_dispatch_count = dispatches
        if not self.eager:
            self.recompile_sentinel.observe(
                len(self._programs), signature=signature_of(inputs, labels))
        if rec:
            _obs.histogram("pipeline.step_ms").observe(
                (time.perf_counter() - t_step) * 1e3)
            _obs.histogram("pipeline.tick_ms").observe_many(tick_ms)
            _obs.counter("pipeline.steps_total").add(1)
            _obs.counter("pipeline.microbatches_total").add(M)
            _obs.gauge("pipeline.dispatches_per_step").set(dispatches)
            _obs.gauge("pipeline.bubble_fraction").set(
                round(self.schedule_bubble_fraction, 4))
        if tok is not None and _fr.sync_steps() and mean_loss.is_cuda:
            torch.cuda.synchronize(mean_loss.device)
        _fr.step_end("pipeline", self._step_count - 1, tok)
        return mean_loss

    # -- predict-only path ----------------------------------------------------
    @torch.no_grad()
    def eval_batch(self, inputs):
        """Batched eval: every stage runs its whole microbatch sweep in
        turn (counted as one dispatch a stage, as the JAX engine runs one
        scan program a stage), eagerly, in the layers' current mode, with
        train_batch's seeds (the step seed folded with (s, m)). Returns
        the last stage's output over the whole batch."""
        inputs = _as_tuple(inputs)
        self._check_batch(inputs)
        M = self.num_micro
        step_seed = next_seed(self.device)
        cur = [self.stages[0].place_input(self._micro(inputs, m))
               for m in range(M)]
        for s, st in enumerate(self.stages):
            if s > 0:
                cur = [st.place_input(c) for c in cur]
            outs = []
            for m, x in enumerate(cur):
                with seed_scope(fold_seed(step_seed, (s, m))):
                    outs.append(_as_tuple(st.layer(*x)))
            cur = outs
        self.last_dispatch_count = len(self.stages)
        if _obs._enabled:
            _obs.counter("pipeline.eval_batches_total").add(1)
        out = tuple(torch.cat([c[i] for c in cur])
                    for i in range(len(cur[0])))
        return out[0] if len(out) == 1 else out

    def sync_to_layers(self):
        """The stages' layers hold the trained parameters already (the
        updates write them in place): nothing to copy back."""

    def state_dict(self):
        """{"stages": [{"model": the layer's state (copies), "opt_state":
        {param name: its optimizer state (copies)}}, ...]}."""
        out = []
        for st in self.stages:
            model = {k: v.detach().clone()
                     for k, v in st.layer.state_dict().items()}
            opt = {k: {n: t.detach().clone() for n, t in
                       self.optimizer._state_of(p).items()}
                   for k, p in zip(st.param_names, st.params)}
            out.append({"model": model, "opt_state": opt})
        return {"stages": out}

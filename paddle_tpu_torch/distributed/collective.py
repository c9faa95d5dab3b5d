"""Collective communication (counterpart of
paddle_tpu/distributed/collective.py) on torch.distributed.

In the JAX package a collective acts only inside a shard_map trace whose
axis is in scope, and is the world-size-1 identity everywhere else. In
the port every rank is a process holding its local shard, so a rank's
process is the body of that shard_map and a collective resolves its
process group in this order:

1. the ``group`` it is given (a Group, an axis name, or a torch
   ProcessGroup);
2. the axis of the current ``axis_context``;
3. the world's default group.

It is the identity when no process group is initialised, or when the
named axis has no group. On a group of size 1 it is still issued (its
result is the identity), so a single-rank run goes through the backend.
Every rank of the group calls it, in the same order, as every device of
a shard_map runs the same program. Results are the JAX package's: a
tensor argument is updated in place where Paddle's collective mutates
its input, and returned.

The backends: NCCL on the card, gloo on the CPU. Each op maps to its
torch.distributed call, NCCL's AVG included; the one composition is
gloo's AVG of an integer tensor, which gloo lacks: a SUM, then a
division that truncates (``_all_reduce_``). PROD is the true product
(the JAX package computes exp(psum(log x)), which is NaN for x <= 0).

Telemetry as in the JAX package: ``_record`` feeds the metrics plane's
``collective.calls`` and ``collective.bytes`` counters and the flight
recorder's per-(axis, op) ``collective_seq``, and the schedule capture
hook ``_schedule_capture`` lists each call's static signature when
armed.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ..observability import flight_recorder as _fr
from ..observability import metrics as _obs
from .env import axis_context, axis_group, current_axis_name

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "all_reduce",
    "all_gather", "broadcast", "reduce", "scatter", "reduce_scatter",
    "all_to_all", "alltoall", "barrier", "send", "recv", "wait",
    "p2p_shift", "split_group_axis",
]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _dist():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


class Group:
    """Names a mesh axis (the ring_id analogue), or holds the process
    group new_group made over explicit ranks."""

    def __init__(self, axis: str, ranks=None, gid=0, pg=None):
        self.axis = axis
        self.ranks = ranks
        self.id = gid
        self.pg = pg

    @property
    def process_group(self):
        return self.pg if self.pg is not None else axis_group(self.axis)

    @property
    def nranks(self):
        pg = self.process_group
        dist = _dist()
        return dist.get_world_size(pg) if (pg is not None and dist) else 1

    def __repr__(self):
        return f"Group(axis={self.axis})"


_groups = {}


def new_group(ranks=None, backend=None, axis: str = None) -> Group:
    """A Group over `axis` (default "dp"). With explicit `ranks` and a
    process group initialised this calls torch.distributed.new_group,
    which is collective: every rank of the world calls new_group with
    the same ranks, in the same order (the JAX new_group is local)."""
    axis = axis or "dp"
    pg = None
    dist = _dist()
    if ranks is not None and dist is not None:
        pg = dist.new_group(ranks=list(ranks), backend=backend)
    g = Group(axis, ranks, gid=len(_groups), pg=pg)
    _groups[g.id] = g
    return g


def get_group(gid=0) -> Optional[Group]:
    return _groups.get(gid)


def _resolve(group) -> Tuple[Optional[str], Any]:
    """(axis label, process group) of a call; the group is None when the
    call is the identity."""
    dist = _dist()
    if dist is None:
        axis = group.axis if isinstance(group, Group) else (
            group if isinstance(group, str) else current_axis_name())
        return axis, None
    if isinstance(group, Group):
        if group.pg is not None:
            return group.axis, group.pg
        return group.axis, axis_group(group.axis)
    if isinstance(group, str):
        return group, axis_group(group)
    if group is not None and not isinstance(group, int):
        return None, group                      # a torch ProcessGroup
    axis = current_axis_name()
    if axis is not None:
        return axis, axis_group(axis)
    return None, dist.group.WORLD


def _payload_bytes(*tensors) -> int:
    total = 0
    for t in tensors:
        for leaf in (t if isinstance(t, (list, tuple)) else (t,)):
            if isinstance(leaf, torch.Tensor):
                total += leaf.numel() * leaf.element_size()
    return total


# collective schedule capture: when armed (a list), every _record call
# appends its static signature (op, axis, shapes, dtypes, bytes) in the
# order the flight recorder stamps seq numbers. One `is not None` read
# when disarmed.
_schedule_capture: Optional[List[dict]] = None


def _capture_entry(op: str, axis: Optional[str], tensors,
                   nbytes: Optional[int], meta=None) -> dict:
    shapes, dtypes = [], []
    for t in tensors:
        for leaf in (t if isinstance(t, (list, tuple)) else (t,)):
            if isinstance(leaf, torch.Tensor):
                shapes.append([int(d) for d in leaf.shape])
                dtypes.append(str(leaf.dtype).replace("torch.", ""))
    entry = {"op": op, "axis": axis, "shapes": shapes, "dtypes": dtypes,
             "bytes": int(nbytes) if nbytes is not None
             else _payload_bytes(*tensors)}
    if meta:
        entry["meta"] = dict(meta)
    return entry


def _record(op: str, axis: Optional[str], *tensors,
            nbytes: Optional[int] = None, meta=None):
    """Collective telemetry: the op count and payload bytes
    (``collective.calls``/``collective.bytes``, per op) and the flight
    recorder's per-(axis, op) sequence number, counted at call time.
    Returns the exit hook (collective.exit with the same seq), or None
    when the recorder is off: callers do ``done = _record(...); ...;
    done and done()``. `nbytes` overrides the payload walk (comm.py's
    fused and compressed collectives report wire bytes); `meta` rides
    only the schedule capture."""
    if _schedule_capture is not None:
        _schedule_capture.append(
            _capture_entry(op, axis, tensors, nbytes, meta))
    if not (_obs._enabled or _fr._enabled):
        return None
    if nbytes is None:
        nbytes = _payload_bytes(*tensors)
    if _obs._enabled:
        _obs.counter("collective.calls", op=op).add(1)
        _obs.counter("collective.bytes", op=op).add(nbytes)
    if _fr._enabled:
        seq = _fr.collective_seq(axis, op)
        _fr.record("collective.enter", op=op, axis=axis, seq=seq,
                   bytes=nbytes)
        return lambda: _fr.record("collective.exit", op=op, axis=axis,
                                  seq=seq)
    return None


# -- backend helpers ----------------------------------------------------------

def _size(pg) -> int:
    return _dist().get_world_size(pg)


def _rank(pg) -> int:
    return _dist().get_rank(pg)


def _global(pg, group_rank: int) -> int:
    return _dist().get_global_rank(pg, int(group_rank))


def _is_gloo(pg) -> bool:
    return _dist().get_backend(pg) == "gloo"


def _torch_op(op):
    R = _dist().ReduceOp
    return {ReduceOp.SUM: R.SUM, ReduceOp.MAX: R.MAX, ReduceOp.MIN: R.MIN,
            ReduceOp.PROD: R.PRODUCT, ReduceOp.AVG: R.AVG}[op]


def _all_reduce_(t: torch.Tensor, op: str, pg) -> torch.Tensor:
    """`t` reduced over `pg` in place. gloo has no AVG of integers
    ("result type Float can't be cast"): there it is a SUM and a
    division that truncates, as NCCL's integer average does."""
    dist = _dist()
    if op == ReduceOp.AVG and not t.is_floating_point() and _is_gloo(pg):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=pg)
        t.copy_(torch.div(t, _size(pg), rounding_mode="trunc"))
        return t
    dist.all_reduce(t, op=_torch_op(op), group=pg)
    return t


def _gather_flat(x: torch.Tensor, pg) -> torch.Tensor:
    """[n, *x.shape]: every rank's x, in group-rank order."""
    dist = _dist()
    n = _size(pg)
    x = x.contiguous()
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x.reshape(-1), group=pg)
    return out.reshape((n,) + tuple(x.shape))


def _reduce_scatter_dim0(x: torch.Tensor, op: str, pg) -> torch.Tensor:
    """Rank i's block i (along dim 0) of the reduction of x over pg."""
    dist = _dist()
    n = _size(pg)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    rs = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    rs(out, x, op=_torch_op(op), group=pg)
    return out


# -- the collectives ---------------------------------------------------------

def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               comm_config=None):
    """c_allreduce_{sum,max,min,prod,avg}: `tensor` reduced over the
    group in place, and returned.

    `comm_config` (a comm.CommConfig) routes SUM through the planned
    path (per-payload algorithm, optional bf16/int8 wire compression,
    comm.* receipts); other reductions ignore it."""
    if comm_config is not None and op == ReduceOp.SUM:
        from .comm import planned_all_reduce
        return planned_all_reduce(tensor, config=comm_config, group=group)
    if op not in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN, ReduceOp.AVG,
                  ReduceOp.PROD):
        raise ValueError(op)
    axis, pg = _resolve(group)
    done = _record("allreduce_" + op, axis, tensor)
    if pg is not None:
        _all_reduce_(tensor, op, pg)
    done and done()
    return tensor


def all_gather(tensor_list, tensor=None, group=None, sync_op=True, axis=0):
    """c_allgather. Two call forms: paddle's all_gather(list, tensor)
    appends every rank's tensor to `list`; the functional all_gather(x)
    returns them stacked, [n, *x.shape] (x itself at world size 1)."""
    if tensor is None:
        x = tensor_list
        ax, pg = _resolve(group)
        done = _record("allgather", ax, x)
        out = x if pg is None else _gather_flat(x, pg)
        done and done()
        return out
    ax, pg = _resolve(group)
    done = _record("allgather", ax, tensor)
    if pg is None:
        done and done()
        tensor_list.append(tensor)
        return tensor_list
    gathered = _gather_flat(tensor, pg)
    done and done()
    tensor_list.extend(gathered.unbind(0))
    return tensor_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """c_broadcast: every rank takes group rank `src`'s value, in place."""
    axis, pg = _resolve(group)
    done = _record("broadcast", axis, tensor)
    if pg is not None:
        _dist().broadcast(tensor, src=_global(pg, src), group=pg)
    done and done()
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """c_reduce_*: the reduction lands in group rank `dst`'s tensor (in
    place); the other ranks keep theirs."""
    axis, pg = _resolve(group)
    done = _record("reduce_" + op, axis, tensor)
    if pg is not None:
        dist = _dist()
        red = tensor.detach().clone()
        dist.reduce(red, dst=_global(pg, dst), op=_torch_op(op), group=pg)
        if _rank(pg) == dst:
            with torch.no_grad():
                tensor.copy_(red)
    done and done()
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """c_scatter: group rank `src`'s i-th chunk (of `tensor_list`, or of
    `tensor` cut along dim 0) goes to rank i, which returns it."""
    axis, pg = _resolve(group)
    done = _record("scatter", axis, tensor)
    if pg is None:
        done and done()
        return tensor
    dist = _dist()
    n, me = _size(pg), _rank(pg)
    chunks = list(tensor_list) if tensor_list is not None else \
        list(tensor.chunk(n, dim=0))
    out = torch.empty_like(chunks[0])
    dist.scatter(out, [c.contiguous() for c in chunks] if me == src
                 else None, src=_global(pg, src), group=pg)
    done and done()
    return out


def reduce_scatter(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """c_reducescatter: rank i returns block i (along dim 0) of the
    reduction of `tensor` over the group."""
    axis, pg = _resolve(group)
    done = _record("reduce_scatter", axis, tensor)
    if pg is None:
        done and done()
        return tensor
    out = _reduce_scatter_dim0(tensor, op, pg)
    done and done()
    return out


def all_to_all(out_tensor_or_in, in_tensor=None, group=None, sync_op=True,
               split_axis=0, concat_axis=0):
    """alltoall (the Ulysses primitive): `x` cut into n blocks along
    `split_axis`, block j sent to rank j; the n blocks received are
    joined along `concat_axis` in rank order (lax.all_to_all, tiled)."""
    x = in_tensor if in_tensor is not None else out_tensor_or_in
    axis, pg = _resolve(group)
    done = _record("alltoall", axis, x)
    if pg is None:
        done and done()
        return x
    n = _size(pg)
    xs = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(xs)
    _dist().all_to_all_single(out, xs, group=pg)
    blocks = [b.movedim(0, split_axis) for b in out.chunk(n, dim=0)]
    done and done()
    return torch.cat(blocks, dim=concat_axis)


alltoall = all_to_all


def barrier(group=None):
    """barrier: every rank of the group waits for all of them."""
    axis, pg = _resolve(group)
    done = _record("barrier", axis)
    if pg is not None:
        dist = _dist()
        if dist.get_backend(pg) == "nccl":
            dist.barrier(group=pg,
                         device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=pg)
    done and done()


# send_v2/recv_v2 as the JAX package pairs them: every rank runs both
# calls; send() stages (axis, dst, value) and the matching recv() moves
# group rank src's staged value to group rank dst. Staging is FIFO per
# process and must pair in order, as the reference's send/recv queues.
_p2p_staged: List[Tuple[Optional[str], int, Any]] = []


def send(tensor, dst=0, group=None, sync_op=True):
    """send_v2: stage the value for the matching recv(). For ring and
    pipeline schedules use p2p_shift."""
    axis, _ = _resolve(group)
    done = _record("send", axis, tensor)
    _p2p_staged.append((axis, int(dst), tensor))
    done and done()
    return tensor


def recv(tensor=None, src=0, group=None, sync_op=True):
    """recv_v2: complete the p2p the matching send() staged. Every rank
    calls it; group rank `dst` returns group rank `src`'s payload, every
    other rank `tensor` (or zeros). A tensor argument takes the result
    in place. World size 1: the staged value loops back."""
    axis, pg = _resolve(group)
    payload = _p2p_staged[0][2] if (tensor is None and _p2p_staged) \
        else tensor
    done = _record("recv", axis, payload)
    if not _p2p_staged:
        done and done()
        raise RuntimeError(
            "recv() without a staged send(): p2p pairs one send() with "
            "one recv(), both called by every rank; stage the value with "
            "send(x, dst=...) first (ring patterns: use p2p_shift)")
    s_axis, dst, staged = _p2p_staged[0]  # peek: a mismatch must not
    if s_axis != axis:                    # consume the staged send
        done and done()
        raise RuntimeError(
            f"recv(group over axis {axis!r}) does not pair with the "
            f"staged send (axis {s_axis!r}): p2p pairs send/recv in FIFO "
            "order over the same group")
    _p2p_staged.pop(0)
    if pg is None:
        out = staged
    else:
        dist = _dist()
        me = _rank(pg)
        moved = None
        if src == dst:
            moved = staged
        elif me == src:
            dist.send(staged.contiguous(), dst=_global(pg, dst), group=pg)
        elif me == dst:
            moved = torch.empty_like(staged)
            dist.recv(moved, src=_global(pg, src), group=pg)
        if me == dst:
            out = moved
        else:
            out = tensor if tensor is not None else torch.zeros_like(staged)
    done and done()
    if isinstance(tensor, torch.Tensor):
        if out is not tensor:
            with torch.no_grad():
                tensor.copy_(out)
        return tensor
    return out


def p2p_shift(x, shift=1, group=None):
    """Ring shift by `shift` positions over the group: rank i's x goes to
    rank (i + shift) mod n (one isend/irecv pair a rank)."""
    axis, pg = _resolve(group)
    done = _record("ppermute", axis, x)
    if pg is None:
        done and done()
        return x
    dist = _dist()
    n, me = _size(pg), _rank(pg)
    if shift % n == 0:
        done and done()
        return x.clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      _global(pg, (me + shift) % n), pg),
           dist.P2POp(dist.irecv, out, _global(pg, (me - shift) % n), pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    done and done()
    return out


def wait(tensor, group=None, use_calc_stream=True):
    """c_sync_*_stream: the calls above return with their work ordered
    on the current stream (NCCL) or done (gloo)."""
    return tensor


def split_group_axis(axis: str):
    return axis_context(axis)


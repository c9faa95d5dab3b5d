"""Distributed / auto checkpointing (counterpart of
paddle_tpu/distributed/checkpoint.py, on its pickle layout).

A checkpoint is a tree (dicts, lists, tuples) of torch tensors, numpy
arrays and Python scalars (bfloat16 tensors as their exact float32
values), written as ``<path>.pkl`` by
``serialization.save`` with two JSON sidecars: the integrity MANIFEST
(``<path>.pkl.manifest.json``: per-leaf shape, dtype, crc32 and bytes,
the leaves named and ordered as the JAX package names them) and the
TOPOLOGY manifest (``<path>.pkl.topology.json``: step, dp, global batch,
the data-shard cursor, a health stamp). The JAX package writes the same
files when orbax is absent, so either package reads the other's. There
is no orbax here: every checkpoint takes that path.

- The commit is write-new-then-swap: the payload and sidecars go to
  ``.tmp`` files, the previous goods rotate to ``.old``/``.old2``
  (``PD_CKPT_KEEP_OLD=0``: no retention), then the new files are renamed
  in. A death at any point leaves a restorable candidate.
- ``save_sharded(..., async_write=True)`` blocks only for joining a
  still-running previous write and for the device->host snapshot. The
  snapshot of CUDA tensors goes into pinned host buffers (one flat
  buffer per dtype, made at the first save of a tree and reused by the
  next once its write is done), copied without blocking and then waited
  on through a recorded CUDA event, all before
  save_sharded returns: a captured TrainStep updates its parameters and
  moments in place at its next replay, and the file must hold the state
  as it was at the save. Only the file write (pickle, crc32, rename)
  runs on the background thread. The goodput ``checkpoint`` bucket gets
  the blocking interval; the write reports ``checkpoint.async_write_ms``.
- ``load_sharded`` verifies every candidate against its manifest and
  falls back from a corrupt, truncated or half-written primary to
  ``.old``/``.old2``; ``load_at_or_before`` is the consistent-cut
  rollback, ``rollback_plan`` its pure walk.
- ``DataShardCursor`` counts examples in one global order, so a
  checkpoint saved at dp=N resumes at dp=M with no example skipped or
  repeated.

With a torch.distributed process group of world > 1, a synchronous save
is collective (every rank calls it; barriers before and after the
commit) and an async one degrades to synchronous, as in the JAX package.
"""
from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import serialization
from ..core import generator as _generator
from ..observability import decisions as _dec
from ..observability import flight_recorder as _fr
from ..observability import metrics as _obs

__all__ = ["save_sharded", "load_sharded", "load_with_topology",
           "load_at_or_before", "candidate_healthy", "decertify_after",
           "rollback_plan", "wait_pending", "topology_manifest",
           "load_topology", "DataShardCursor", "train_epoch_range",
           "AutoCheckpoint"]


def _world() -> int:
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def _barrier():
    """Cross-process sync around a collective save (no-op in one
    process)."""
    if _world() > 1:
        torch.distributed.barrier()


# -- trees --------------------------------------------------------------------

def _key(k) -> str:
    return f"[{k!r}]"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the JAX package's order and names
    (jax.tree_util.keystr): dict keys sorted, sequences in order, None
    an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], prefix + _key(k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _map(fn, tree, prefix: str = ""):
    """fn(name, leaf) over the leaves, the structure kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + _key(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _nbytes(tree) -> int:
    total = 0
    for _, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(np.asarray(leaf).nbytes)
    return total


def _ckpt_record(kind: str, arrays, t0: float):
    """Metrics + flight-recorder close-out for one save/load (each gate
    is one module-bool read when its plane is disabled)."""
    if not (_obs._enabled or _fr._enabled):
        return
    nbytes = _nbytes(arrays)
    if _obs._enabled:
        _obs.counter(f"checkpoint.{kind}s_total").add(1)
        _obs.counter(f"checkpoint.{kind}_bytes_total").add(nbytes)
        _obs.histogram(f"checkpoint.{kind}_ms").observe(
            (time.perf_counter() - t0) * 1e3)
    if _fr._enabled:
        _fr.ckpt_end(kind, t0, nbytes=nbytes)


# -- the device->host snapshot -------------------------------------------------

# the async snapshot's host buffers, one flat buffer per dtype for each
# tree layout saved (pinned when the tree is on the card), reused save
# after save; a save joins the previous write first, so no buffer is
# refilled while a writer still reads it
_host_bufs: Dict[tuple, Dict[str, torch.Tensor]] = {}


def _host_views(tensors: List[Tuple[str, torch.Tensor]]):
    """{name: host view} for the tensor leaves, carved out of the flat
    buffers of their layout (made on the layout's first save)."""
    sig = tuple((n, tuple(t.shape), t.dtype, t.is_cuda) for n, t in tensors)
    views = _host_bufs.get(sig)
    if views is None:
        pin = any(t.is_cuda for _, t in tensors)
        sizes: Dict[torch.dtype, int] = {}
        for _, t in tensors:
            hd = serialization.host_dtype(t.dtype)
            sizes[hd] = sizes.get(hd, 0) + t.numel()
        flats = {hd: torch.empty(n, dtype=hd, pin_memory=pin)
                 for hd, n in sizes.items()}
        offs = dict.fromkeys(flats, 0)
        views = {}
        for n, t in tensors:
            hd = serialization.host_dtype(t.dtype)
            views[n] = flats[hd][offs[hd]:offs[hd] + t.numel()].view(t.shape)
            offs[hd] += t.numel()
        _host_bufs[sig] = views
    return views


def _snapshot(tree, reuse: bool):
    """The tree on the host as numpy: tensors copied out, other leaves
    through np.asarray. reuse=True (the async path) copies every tensor
    into its reused host buffer, a CUDA one without blocking, then waits
    for the copies through one CUDA event per device before returning;
    reuse=False takes plain host copies (the sync path writes before it
    returns)."""
    views = None
    if reuse:
        views = _host_views([(n, t) for n, t in _flatten(tree)
                             if isinstance(t, torch.Tensor)])
    devices = set()

    def one(name, leaf):
        if not isinstance(leaf, torch.Tensor):
            return np.asarray(leaf)
        if views is None:
            return serialization.to_numpy(leaf)
        buf = views[name]
        buf.copy_(leaf.detach(), non_blocking=leaf.is_cuda)
        if leaf.is_cuda:
            devices.add(leaf.device)
        return buf.numpy()

    host = _map(one, tree)
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return host


def _to_target(host, target):
    """Restored numpy leaves as tensors of the dtypes and on the devices
    of `target`'s matching tensors (leaves with no tensor there stay
    numpy; a JAX package's bfloat16 leaf goes through
    serialization.from_numpy)."""
    if target is None:
        return host
    tgt = dict(_flatten(target))

    def one(name, arr):
        t = tgt.get(name)
        if isinstance(t, torch.Tensor):
            return serialization.from_numpy(arr).to(t.device, t.dtype)
        return arr
    return _map(one, host)


# -- integrity manifest ---------------------------------------------------------

def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _manifest_doc(arrays) -> dict:
    """Per-leaf crc32 + shape/dtype/bytes over the host arrays."""
    leaves = {}
    for name, leaf in _flatten(arrays):
        arr = np.asarray(leaf)
        leaves[name] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                        "crc32": _crc32(arr), "nbytes": int(arr.nbytes)}
    return {"version": 1, "leaves": leaves}


def _verify_manifest(arrays, manifest: dict) -> Optional[str]:
    """None when `arrays` match `manifest`, else a human reason. A leaf
    present in the manifest but missing from the restore (or vice
    versa) is corruption too: a half-written checkpoint can lose whole
    leaves, not just bytes."""
    want = manifest.get("leaves", {})
    got = dict(_flatten(arrays))
    missing = set(want) - set(got)
    extra = set(got) - set(want)
    if missing or extra:
        return (f"leaf set mismatch (missing={sorted(missing)[:3]}, "
                f"extra={sorted(extra)[:3]})")
    for name, entry in want.items():
        arr = np.asarray(got[name])
        if list(arr.shape) != entry["shape"]:
            return (f"{name}: shape {list(arr.shape)} != saved "
                    f"{entry['shape']}")
        if entry.get("dtype") and str(arr.dtype) != entry["dtype"]:
            return f"{name}: dtype {arr.dtype} != saved {entry['dtype']}"
        if "crc32" in entry and _crc32(arr) != entry["crc32"]:
            return f"{name}: checksum mismatch"
    return None


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def topology_manifest(step: int, data_cursor: Optional[dict] = None,
                      mesh=None, dp: Optional[int] = None,
                      global_batch: Optional[int] = None,
                      extra: Optional[dict] = None,
                      health: Optional[dict] = None) -> dict:
    """The topology manifest saved next to the arrays: everything a
    differently-shaped resume needs that the arrays don't carry.
    `data_cursor` is a DataShardCursor.state_dict(); dp defaults to the
    process group's world size (1 without one). `mesh` takes anything
    with `axis_names` and a `shape` mapping or tuple (a DeviceMesh).
    `health` is a sentry health stamp, which
    ``load_at_or_before(require_healthy=True)`` walks for."""
    doc: Dict[str, Any] = {"version": 1, "step": int(step)}
    if health is not None:
        doc["health"] = dict(health)
    if mesh is not None:
        shape = getattr(mesh, "shape", None)
        if isinstance(shape, dict):
            doc["mesh_shape"] = {str(k): int(v) for k, v in shape.items()}
        else:
            doc["mesh_shape"] = dict(zip([str(a) for a in mesh.axis_names],
                                         (int(s) for s in shape)))
    doc["dp"] = int(dp) if dp is not None else _world()
    if global_batch is not None:
        doc["global_batch"] = int(global_batch)
    if data_cursor is not None:
        doc["data_cursor"] = dict(data_cursor)
    if extra:
        doc["extra"] = dict(extra)
    return doc


# -- async writer (at most one write in flight per process) --------------------

_async_lock = threading.Lock()
_async_thread: Optional[threading.Thread] = None
_async_error: Optional[BaseException] = None


def wait_pending(timeout: Optional[float] = None) -> bool:
    """Join the in-flight background checkpoint write, re-raising any
    error it hit. True when nothing is (any longer) in flight."""
    global _async_thread, _async_error
    with _async_lock:
        t = _async_thread
    if t is not None:
        t.join(timeout)
        if t.is_alive():
            return False
        with _async_lock:
            if _async_thread is t:
                _async_thread = None
    with _async_lock:
        err, _async_error = _async_error, None
    if err is not None:
        raise RuntimeError("async checkpoint write failed") from err
    return True


def _write_payload(host, path: str, manifest: bool = True,
                   topology: Optional[dict] = None):
    """The commit: write-new-then-swap (the previous good checkpoint
    survives any mid-write death), shared by the sync path and the
    background writer. `host` is the numpy snapshot."""
    pkl = path + ".pkl"
    tmp = pkl + ".tmp"
    serialization.save(host, tmp)
    side: List[Tuple[str, dict]] = []
    if manifest:
        side.append((pkl + ".manifest.json", _manifest_doc(host)))
    if topology is not None:
        side.append((pkl + ".topology.json", topology))
    for spath, doc in side:
        with open(spath + ".tmp", "w") as f:
            json.dump(doc, f)
    # depth-2 retention: previous goods become .old/.old2 (the
    # corruption fallback and the consistent-cut rollback pool), then
    # the new one commits
    keep = os.environ.get("PD_CKPT_KEEP_OLD", "1") != "0"
    written = {spath for spath, _doc in side}
    for suffix in ("", ".manifest.json", ".topology.json"):
        cur, old, old2 = (pkl + suffix, pkl + ".old" + suffix,
                          pkl + ".old2" + suffix)
        if keep:
            if os.path.exists(old):
                os.replace(old, old2)
            if os.path.exists(cur):
                os.replace(cur, old)
        else:
            for stale in (old, old2):
                if os.path.exists(stale):
                    os.remove(stale)
            # never pre-delete the current payload (os.replace is
            # atomic); only a sidecar this save does not rewrite goes
            if suffix and cur not in written and os.path.exists(cur):
                os.remove(cur)
    os.replace(tmp, pkl)
    for spath, _doc in side:
        os.replace(spath + ".tmp", spath)


def save_sharded(state: dict, path: str, async_write: bool = False,
                 manifest: bool = True, topology: Optional[dict] = None):
    """Save a tree of tensors / arrays / scalars at `path` (the files are
    ``<path>.pkl`` and its sidecars).

    async_write=True blocks only for (a) joining a still-running
    previous write and (b) the device->host snapshot into the reused
    (pinned) host buffers, finished before this returns; the commit runs
    on a background thread (``wait_pending`` joins it and re-raises its
    error)."""
    _fr.ckpt_begin("save")
    _t0 = time.perf_counter()
    if async_write and _world() == 1:
        global _async_thread
        wait_pending()          # at most one in flight; its buffers free
        _t1 = time.perf_counter()
        snapshot = _snapshot(state, reuse=True)
        block_ms = (time.perf_counter() - _t0) * 1e3
        if _obs._enabled:
            _obs.counter("checkpoint.saves_total").add(1)
            _obs.histogram("checkpoint.save_block_ms").observe(block_ms)
            # the host double the background write reads from
            _obs.gauge("checkpoint.host_snapshot_bytes").set(
                _nbytes(snapshot))
        if _fr._enabled:
            _fr.ckpt_end("save", _t0, nbytes=_nbytes(snapshot))

        def _writer():
            global _async_error
            w0 = time.perf_counter()
            try:
                try:
                    _write_payload(snapshot, path, manifest=manifest,
                                   topology=topology)
                except BaseException as e:  # wait_pending surfaces it
                    with _async_lock:
                        _async_error = e
                    return
                dur_ms = (time.perf_counter() - w0) * 1e3
                last_save["write_ms"] = dur_ms
                if _obs._enabled:
                    _obs.counter("checkpoint.async_saves_total").add(1)
                    _obs.histogram(
                        "checkpoint.async_write_ms").observe(dur_ms)
                _fr.ckpt_async_end("save", dur_ms)
            finally:
                g = _obs.get("checkpoint.host_snapshot_bytes")
                if g is not None:
                    g.reset()

        last_save.update(block_ms=block_ms, join_ms=(_t1 - _t0) * 1e3,
                         write_ms=None, nbytes=_nbytes(snapshot))
        t = threading.Thread(target=_writer, name="pd-ckpt-writer")
        with _async_lock:
            _async_thread = t
        t.start()  # non-daemon: interpreter exit joins it (no torn file)
        return
    if async_write:
        wait_pending()
    _barrier()
    host = _snapshot(state, reuse=False)
    block_ms = (time.perf_counter() - _t0) * 1e3
    _write_payload(host, path, manifest=manifest, topology=topology)
    _barrier()
    last_save.update(block_ms=block_ms, join_ms=0.0,
                     write_ms=(time.perf_counter() - _t0) * 1e3 - block_ms,
                     nbytes=_nbytes(host))
    _ckpt_record("save", host, _t0)


# the last save's timings: block_ms (the time the caller was blocked:
# join_ms of it waiting for the previous write, the rest the snapshot),
# write_ms (the file write; an async save fills it in when its writer
# ends) and nbytes
last_save: Dict[str, Any] = {"block_ms": None, "join_ms": None,
                             "write_ms": None, "nbytes": None}


def _load_candidates(path: str) -> List[str]:
    """Restore candidates in preference order: the primary, then the
    previous goods `.old`/`.old2`."""
    pkl = path + ".pkl"
    return [c for c in (pkl, pkl + ".old", pkl + ".old2")
            if os.path.exists(c)]


def _restore_one(cand: str):
    out = serialization.load(cand)
    manifest = _read_json(cand + ".manifest.json")
    if manifest is not None:
        reason = _verify_manifest(out, manifest)
        if reason is not None:
            raise ValueError(f"checkpoint integrity: {reason}")
    return out


def _load_first_good(path: str) -> Tuple[dict, str]:
    """The candidate walk: restore+verify newest-first, skipping (and
    counting) corrupt candidates. Returns (state, candidate_path)."""
    _fr.ckpt_begin("load")
    _t0 = time.perf_counter()
    cands = _load_candidates(path)
    if not cands:
        out = serialization.load(path + ".pkl")   # FileNotFoundError
        return out, path + ".pkl"
    last_err: Optional[BaseException] = None
    for cand in cands:
        try:
            out = _restore_one(cand)
        except Exception as e:
            last_err = e
            # the skip is visible with the hot-path gate down: a silent
            # fallback hides data loss
            _obs.counter("checkpoint.corruptions_total",
                         _always=True).add(1)
            _fr.record("ckpt.corrupt", path=cand, error=str(e)[:200])
            continue
        if cand != path + ".pkl":
            _fr.record("ckpt.fallback", path=cand)
        _ckpt_record("load", out, _t0)
        return out, cand
    raise RuntimeError(
        f"no restorable checkpoint at {path} (tried {cands})"
    ) from last_err


def load_sharded(path: str, target: Optional[dict] = None) -> dict:
    """Restore the newest verifiable candidate: a tree of numpy arrays
    (with `target`, a tree with tensors at the same leaves, each
    restored leaf becomes a tensor on its target's device). A corrupt or
    unreadable candidate falls back to `.old`/`.old2`, counted in
    `checkpoint.corruptions_total`."""
    out, _cand = _load_first_good(path)
    return _to_target(out, target)


def load_with_topology(path: str, target: Optional[dict] = None
                       ) -> Tuple[Optional[dict], Optional[dict]]:
    """Restore (state, topology) FROM THE SAME CANDIDATE (corruption of
    an array leaf sends the state to `.old`; the primary's topology
    would then name a newer step). (None, None) when no checkpoint
    exists."""
    try:
        out, cand = _load_first_good(path)
    except (RuntimeError, FileNotFoundError, OSError):
        return None, None
    return _to_target(out, target), _candidate_topology(cand)


def _topology_sidecar(cand: str) -> str:
    return cand + ".topology.json"


def _candidate_topology(cand: str) -> Optional[dict]:
    return _read_json(_topology_sidecar(cand))


def load_topology(path: str) -> Optional[dict]:
    """The topology manifest of the checkpoint at `path`, falling back
    past a DAMAGED newest candidate only: a healthy newest save that
    carried no topology returns None."""
    for i, cand in enumerate(_load_candidates(path)):
        doc = _candidate_topology(cand)
        if doc is not None:
            return doc
        if i == 0 and _read_json(cand + ".manifest.json") is not None:
            return None
    return None


def decertify_after(path: str, step: int,
                    reason: str = "fingerprint_divergence") -> int:
    """Mark every candidate of `path` whose topology step is GREATER than
    `step` and that carries a healthy stamp as unhealthy, in place.
    Returns how many were decertified."""
    n = 0
    for cand in _load_candidates(path):
        side = _topology_sidecar(cand)
        doc = _read_json(side)
        if doc is None or doc.get("step") is None:
            continue
        if int(doc["step"]) <= int(step):
            continue
        health = dict(doc.get("health") or {})
        if not health.get("healthy"):
            continue
        health["healthy"] = False
        health["decertified"] = reason
        doc["health"] = health
        tmp = side + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, side)
        except OSError as e:
            _obs.counter("checkpoint.decertify_failures_total",
                         _always=True).add(1)
            _fr.record("ckpt.decertify_failed", path=cand,
                       error=str(e)[:200])
            continue
        n += 1
        _obs.counter("checkpoint.decertified_total", _always=True).add(1)
        _fr.record("ckpt.decertified", path=cand, step=int(doc["step"]),
                   reason=reason)
    return n


def candidate_healthy(topo: Optional[dict]) -> bool:
    """Is this candidate certified numerically good (an explicit healthy
    sentry stamp)?"""
    return bool(((topo or {}).get("health") or {}).get("healthy"))


def rollback_plan(candidates: List[dict], step: int,
                  best_effort: bool = True,
                  require_healthy: bool = False) -> List[dict]:
    """The PURE rollback walk: the ordered attempt list
    ``load_at_or_before`` executes, from the candidate metadata alone.
    Each candidate is ``{"name", "step" (int or None), "healthy"}`` in
    newest-first order. Returns ``{"cand", "step", "tag"}`` entries, tag
    ``walk`` (an in-cut attempt), ``skip_unhealthy`` (the certified pass
    walked past an uncertified candidate) or ``gap`` (best effort: a
    too-new candidate, data loss recorded)."""
    attempts: List[dict] = []
    too_new: List[dict] = []
    passes = ["certified", "any"] if require_healthy else ["any"]
    for pass_name in passes:
        for c in candidates:
            s = c.get("step")
            if s is None:
                continue
            if int(s) > int(step):
                if pass_name == passes[0]:
                    too_new.append(c)
                continue
            if pass_name == "certified" and not c.get("healthy"):
                attempts.append({"cand": c["name"], "step": int(s),
                                 "tag": "skip_unhealthy"})
                continue
            attempts.append({"cand": c["name"], "step": int(s),
                             "tag": "walk"})
    if best_effort:
        gap = list(reversed(too_new))
        if require_healthy:
            gap = ([c for c in gap if c.get("healthy")]
                   + [c for c in gap if not c.get("healthy")])
        for c in gap:
            attempts.append({"cand": c["name"], "step": int(c["step"]),
                             "tag": "gap"})
    return attempts


def load_at_or_before(path: str, step: int,
                      target: Optional[dict] = None,
                      best_effort: bool = True,
                      require_healthy: bool = False
                      ) -> Tuple[dict, dict]:
    """Restore the newest candidate whose topology step is <= `step`
    (the consistent-cut rollback); returns (state, topology).

    best_effort=True: when every candidate is newer than the cut, the
    oldest verifiable one is restored and the gap recorded loudly
    (``ckpt.rollback_gap`` event, ``checkpoint.rollback_gaps_total``).
    require_healthy=True: a first pass takes only candidates with a
    healthy sentry stamp; uncertified ones are a recorded fallback."""
    last_err: Optional[BaseException] = None
    too_new: List[Tuple[str, dict]] = []
    failed: set = set()

    cand_meta: List[dict] = []
    if _dec.enabled():
        for _c in _load_candidates(path):
            _t = _candidate_topology(_c)
            cand_meta.append({
                "name": os.path.basename(str(_c).rstrip("/")),
                "step": (int(_t["step"]) if _t is not None
                         and _t.get("step") is not None else None),
                "healthy": candidate_healthy(_t)})

    def _ledger_rollback(cand, topo, tag):
        if not _dec.enabled():
            return None
        plan = rollback_plan(cand_meta, step, best_effort=best_effort,
                             require_healthy=require_healthy)
        certified = candidate_healthy(topo)
        return _dec.record(
            "checkpoint.rollback", "rollback",
            rule=("certified consistent-cut walk" if require_healthy
                  else "consistent-cut walk"),
            evidence={
                "inputs": {
                    "step": int(step),
                    "best_effort": bool(best_effort),
                    "require_healthy": bool(require_healthy),
                    "candidates": cand_meta,
                    "failed": sorted(os.path.basename(str(c).rstrip("/"))
                                     for c in failed)},
                "decision": {
                    "action": "rollback",
                    "chosen": os.path.basename(str(cand).rstrip("/")),
                    "chosen_step": int(topo["step"]),
                    "tag": tag, "certified": certified, "plan": plan}},
            signals={"restored": 0, "healthy": 0},
            post_signals={"restored": 1, "healthy": int(certified)})

    def _try_restore(cand):
        nonlocal last_err
        if cand in failed:
            return None
        try:
            return _restore_one(cand)
        except Exception as e:
            failed.add(cand)
            last_err = e
            _obs.counter("checkpoint.corruptions_total",
                         _always=True).add(1)
            _fr.record("ckpt.corrupt", path=cand, error=str(e)[:200])
            return None

    def _note_uncertified(cand, topo):
        if require_healthy and not candidate_healthy(topo):
            _obs.counter("checkpoint.unhealthy_fallbacks_total",
                         _always=True).add(1)
            _fr.record("ckpt.unhealthy_fallback", path=cand,
                       step=int(topo["step"]))

    def _done(out, cand, topo, tag):
        _note_uncertified(cand, topo)
        did = _ledger_rollback(cand, topo, tag=tag)
        if did is not None:
            topo = dict(topo)
            topo["rollback_decision_id"] = did
        return _to_target(out, target), topo

    passes = [True, False] if require_healthy else [False]
    for healthy_only in passes:
        for cand in _load_candidates(path):
            topo = _candidate_topology(cand)
            if topo is None or topo.get("step") is None:
                continue
            if int(topo["step"]) > int(step):
                if healthy_only or not require_healthy:
                    too_new.append((cand, topo))
                continue
            if healthy_only and not candidate_healthy(topo):
                _obs.counter("checkpoint.unhealthy_skips_total",
                             _always=True).add(1)
                _fr.record("ckpt.unhealthy_skipped", path=cand,
                           step=int(topo["step"]))
                continue
            out = _try_restore(cand)
            if out is not None:
                return _done(out, cand, topo, "walk")
    if best_effort:
        gap_cands = list(reversed(too_new))
        if require_healthy:
            gap_cands = (
                [c for c in gap_cands if candidate_healthy(c[1])]
                + [c for c in gap_cands if not candidate_healthy(c[1])])
        for cand, topo in gap_cands:
            out = _try_restore(cand)
            if out is None:
                continue
            _obs.counter("checkpoint.rollback_gaps_total",
                         _always=True).add(1)
            _fr.record("ckpt.rollback_gap", path=cand,
                       wanted_step=int(step), got_step=int(topo["step"]))
            return _done(out, cand, topo, "gap")
    raise RuntimeError(
        f"no checkpoint at or before step {step} under {path}: the "
        "consistent-cut rollback needs the olds retained by "
        "save_sharded") from last_err


class DataShardCursor:
    """Global-order data cursor: the shrink/grow data-shard contract.

    The dataset is traversed in one fixed GLOBAL order; every optimizer
    step consumes `global_batch` consecutive examples starting at the
    cursor, split contiguously across the dp ranks. The cursor counts
    global examples, so a checkpoint saved at dp=N resumes at any dp=M
    dividing `global_batch` with no example skipped or repeated, and
    with the same global batches."""

    def __init__(self, dataset_size: int, global_batch: int,
                 offset: int = 0, epoch: int = 0):
        if global_batch <= 0 or dataset_size <= 0:
            raise ValueError("dataset_size and global_batch must be > 0")
        self.dataset_size = int(dataset_size)
        self.global_batch = int(global_batch)
        self.offset = int(offset)      # examples consumed this epoch
        self.epoch = int(epoch)

    def indices(self, rank: int, dp: int) -> np.ndarray:
        """This step's example indices for `rank` of `dp` ranks."""
        if self.global_batch % dp:
            raise ValueError(
                f"global_batch={self.global_batch} not divisible by "
                f"dp={dp}; shrink/grow would tear a batch")
        if not 0 <= rank < dp:
            raise ValueError(f"rank {rank} out of range for dp={dp}")
        per = self.global_batch // dp
        base = self.offset + rank * per
        return (np.arange(base, base + per) % self.dataset_size)

    def advance(self):
        """One global step consumed (call ONCE per step, not per rank)."""
        self.offset += self.global_batch
        while self.offset >= self.dataset_size:
            self.offset -= self.dataset_size
            self.epoch += 1

    def state_dict(self) -> dict:
        return {"dataset_size": self.dataset_size,
                "global_batch": self.global_batch,
                "offset": self.offset, "epoch": self.epoch}

    @classmethod
    def from_state(cls, state: dict) -> "DataShardCursor":
        return cls(state["dataset_size"], state["global_batch"],
                   offset=state.get("offset", 0),
                   epoch=state.get("epoch", 0))


class AutoCheckpoint:
    """Epoch-guard auto checkpoint/resume: the epoch, the model's and the
    optimizer's state and the dropout seed stream in one atomically
    replaced file, so a preemption never restores a mixed epoch."""

    def __init__(self, job_id: str, checkpoint_dir: str, model=None,
                 optimizer=None, save_freq: int = 1):
        self.job_id = job_id
        self.dir = os.path.join(checkpoint_dir, job_id)
        self.model = model
        self.optimizer = optimizer
        self.save_freq = save_freq
        os.makedirs(self.dir, exist_ok=True)

    @property
    def _meta_path(self):
        return os.path.join(self.dir, "meta.json")

    @property
    def _state_path(self):
        return os.path.join(self.dir, "state.pdckpt")

    def restore_epoch(self) -> int:
        """Last completed epoch + 1, restoring state if present."""
        if not os.path.exists(self._state_path):
            return 0
        bundle = serialization.load(self._state_path)
        epoch = int(bundle.get("epoch", -1)) + 1
        if self.model is not None and bundle.get("model") is not None:
            self.model.set_state_dict(bundle["model"])
        if self.optimizer is not None and bundle.get("opt") is not None:
            self.optimizer.set_state_dict(bundle["opt"])
        if bundle.get("rng") is not None:
            _generator.set_state(bundle["rng"])
        return epoch

    def save_epoch(self, epoch: int):
        bundle = {
            "epoch": epoch,
            "job_id": self.job_id,
            "model": None if self.model is None else self.model.state_dict(),
            "opt": (None if self.optimizer is None
                    else self.optimizer.state_dict()),
            # the seed stream too: a resumed run replays the interrupted
            # epoch's dropout masks exactly
            "rng": _generator.get_state(),
        }
        tmp = self._state_path + ".tmp"
        serialization.save(bundle, tmp)
        os.replace(tmp, self._state_path)  # single atomic commit
        with open(self._meta_path + ".tmp", "w") as f:
            json.dump({"epoch": epoch, "job_id": self.job_id}, f)
        os.replace(self._meta_path + ".tmp", self._meta_path)


def train_epoch_range(max_epoch_num: int, job_id: str = "default_job",
                      checkpoint_dir: Optional[str] = None,
                      model=None, optimizer=None,
                      save_freq: int = 1) -> Iterator[int]:
    """for epoch in train_epoch_range(N, ...): already-completed epochs
    are skipped after a restart; each yielded epoch is checkpointed on
    completion. checkpoint_dir defaults to
    $PADDLE_AUTO_CHECKPOINT_DIR, else the system temp dir."""
    if checkpoint_dir is None:
        import tempfile
        checkpoint_dir = os.environ.get(
            "PADDLE_AUTO_CHECKPOINT_DIR",
            os.path.join(tempfile.gettempdir(), "paddle_tpu_autockpt"))
    ac = AutoCheckpoint(job_id, checkpoint_dir, model, optimizer, save_freq)
    start = ac.restore_epoch()
    for epoch in range(start, max_epoch_num):
        yield epoch
        if (epoch + 1) % save_freq == 0 or epoch == max_epoch_num - 1:
            ac.save_epoch(epoch)

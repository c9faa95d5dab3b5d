"""DataLoader: batching, thread workers, device prefetch (counterpart of
paddle_tpu/io/dataloader.py).

Host workers produce numpy batches (threads: numpy transforms release
the GIL, and a batch needs no serialisation), and a prefetch thread
keeps up to prefetch_factor of them ready. The JAX package's prefetch
thread also puts the next batch on the device (jax.device_put); the
port stages it from the consumer's thread instead, so that no thread
but the training loop's makes a CUDA call (a call from another thread
while the step captures its CUDA graph would invalidate the capture,
or wait on it). When the loop asks for batch N, batch N + 1 is staged
first and N handed out, so N + 1's copy overlaps step N:

- on the card, each array is copied from pinned host memory with
  non_blocking=True on the loader's side stream, and an event is
  recorded after the batch's copies. Before a batch is handed out the
  consumer's stream waits on its event (the step reads it only once it
  has landed) and each tensor records that stream (the allocator does
  not reuse its memory while the step may still read it). A pinned
  staging buffer goes back to torch's caching host allocator, which
  reuses it only after the copy that read it has run;
- on the CPU, the arrays become tensors;
- with a sharding_plan (a distributed.ShardingPlan), each array is this
  rank's block along the plan's data axes (plan.place_batch) first.

worker_mode="process" (forkserver workers over a shared-memory ring,
the JAX package's io/process_pool.py and csrc's shm ring) is not ported
yet (ROADMAP.md item 18.3) and raises.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time

import numpy as np
import torch

from ..core.place import resolve_device
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "WorkerInfo",
           "get_worker_info"]


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch])
                for k in sample}
    if isinstance(sample, torch.Tensor):
        return np.stack([s.detach().cpu().numpy() for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, str):
        return list(batch)
    return np.asarray(batch)


class _WorkerPool:
    """Thread pool mapping collate over index batches; results come back
    by sequence number, so the batch order is the sampler's."""

    def __init__(self, fn, num_workers, dataset=None):
        self.fn = fn
        self.num_workers = num_workers
        self.dataset = dataset
        self.in_q = queue.Queue()
        self.out = {}
        self.cv = threading.Condition()
        self.workers = []
        for wid in range(num_workers):
            t = threading.Thread(target=self._loop, args=(wid,),
                                 daemon=True)
            t.start()
            self.workers.append(t)

    def _loop(self, wid=0):
        _set_worker_info(WorkerInfo(wid, self.num_workers, self.dataset))
        while True:
            item = self.in_q.get()
            if item is None:
                return
            seq, payload = item
            try:
                res = (True, self.fn(payload))
            except Exception as e:  # surfaced on the consumer side
                res = (False, e)
            with self.cv:
                self.out[seq] = res
                self.cv.notify_all()

    def submit(self, seq, payload):
        self.in_q.put((seq, payload))

    def get(self, seq):
        with self.cv:
            while seq not in self.out:
                self.cv.wait()
            ok, val = self.out.pop(seq)
        if not ok:
            raise val
        return val

    def shutdown(self):
        for _ in self.workers:
            self.in_q.put(None)


class _Staged:
    """A batch copied to the card on a side stream, and the event after
    its copies."""
    __slots__ = ("batch", "event", "tensors")

    def __init__(self, batch, event, tensors):
        self.batch, self.event, self.tensors = batch, event, tensors


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, sharding_plan=None,
                 worker_mode="thread"):
        """worker_mode: "thread" (the default). "process" is not ported
        yet. places: the device the batches go to (default: the current
        device, the card unless the CPU was asked for)."""
        if worker_mode == "process":
            raise NotImplementedError(
                "DataLoader(worker_mode='process') needs io/process_pool.py "
                "and the shared-memory ring, which are not ported yet "
                "(ROADMAP.md item 18.3): use worker_mode='thread'")
        if worker_mode != "thread":
            raise ValueError(f"worker_mode={worker_mode!r}: 'thread' or "
                             "'process'")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.prefetch_factor = max(prefetch_factor, 2)
        self.use_buffer_reader = use_buffer_reader
        self.sharding_plan = sharding_plan
        self.places = places
        self.iterable = not isinstance(dataset, IterableDataset)
        if self.iterable:
            if batch_sampler is not None:
                self.batch_sampler = batch_sampler
            elif batch_size is None:
                self.batch_sampler = None
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)
        else:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("IterableDataset DataLoader has no len()")

    # -- iteration ------------------------------------------------------------
    def _batches(self):
        if not self.iterable:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == (self.batch_size or 1):
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not getattr(self, "drop_last", False):
                yield self.collate_fn(batch)
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return

        def make(idxs):
            return [self.dataset[i] for i in idxs]
        if self.num_workers <= 0:
            for idxs in self.batch_sampler:
                yield self.collate_fn(make(idxs))
            return
        pool = _WorkerPool(lambda idxs: self.collate_fn(make(idxs)),
                           self.num_workers, dataset=self.dataset)
        try:
            # windowed submission: at most workers * prefetch batches in
            # flight, so a slow consumer does not pile an epoch into RAM
            window = self.num_workers * self.prefetch_factor
            it = enumerate(iter(self.batch_sampler))
            in_flight = []
            for seq, idxs in itertools.islice(it, window):
                pool.submit(seq, idxs)
                in_flight.append(seq)
            next_take = 0
            while next_take < len(in_flight):
                out = pool.get(in_flight[next_take])
                next_take += 1
                for seq, idxs in itertools.islice(it, 1):
                    pool.submit(seq, idxs)
                    in_flight.append(seq)
                yield out
        finally:
            pool.shutdown()

    def _device(self):
        return resolve_device(self.places)

    def _to_device(self, batch, device, stream=None):
        """The batch's numpy arrays as tensors on `device` (this rank's
        block under a sharding_plan); on the card copied from pinned
        memory, non-blocking, on `stream`. Returns (batch, tensors)."""
        made = []

        def put(a):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            if not isinstance(a, torch.Tensor):
                return a
            if self.sharding_plan is not None:
                a = self.sharding_plan.place_batch(a)
            if device.type == "cuda":
                a = a.pin_memory().to(device, non_blocking=True)
            else:
                a = a.to(device)
            made.append(a)
            return a

        def walk(b):
            if isinstance(b, (list, tuple)):
                return type(b)(walk(x) for x in b)
            if isinstance(b, dict):
                return {k: walk(v) for k, v in b.items()}
            return put(b)

        if stream is None:
            return walk(batch), made
        with torch.cuda.stream(stream):
            return walk(batch), made

    def _stage(self, batch, device, stream):
        if stream is None:
            return self._to_device(batch, device)[0]
        out, made = self._to_device(batch, device, stream)
        event = torch.cuda.Event()
        event.record(stream)
        return _Staged(out, event, made)

    @staticmethod
    def _hand_out(item, device):
        """A staged batch, once the consumer's stream has waited for its
        copies (and each tensor knows that stream reads it)."""
        if not isinstance(item, _Staged):
            return item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(item.event)
        for t in item.tensors:
            t.record_stream(consumer)
        return item.batch

    def __iter__(self):
        from ..observability import flight_recorder as _fr
        from ..observability import metrics as _obs
        device = self._device()
        gen = self._batches()
        if not self.use_buffer_reader:
            for b in gen:
                if _obs._enabled:
                    _obs.counter("dataloader.batches_total").add(1)
                yield self._to_device(b, device)[0]
            return
        # host batches prefetched by a thread; staged on the device here
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()

        class _Error:
            def __init__(self, exc):
                self.exc = exc

        def producer():
            try:
                for b in gen:
                    q.put(b)
            except Exception as e:
                q.put(_Error(e))
            q.put(sentinel)

        def take():
            rec_m, rec_f = _obs._enabled, _fr._enabled
            if not (rec_m or rec_f):
                return q.get()
            # input-pipeline health: the time the consumer spends blocked
            # on the prefetch queue, and its standing depth
            t0 = time.perf_counter()
            item = q.get()
            wait_s = time.perf_counter() - t0
            if rec_m:
                _obs.histogram("dataloader.wait_ms").observe(wait_s * 1e3)
                _obs.gauge("dataloader.prefetch_depth").set(q.qsize())
                if not (item is sentinel or isinstance(item, _Error)):
                    _obs.counter("dataloader.batches_total").add(1)
            if rec_f:
                _fr.dataloader_wait(wait_s)
            return item

        threading.Thread(target=producer, daemon=True).start()
        stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None
        staged = None
        while True:
            item = take()
            # batch N + 1 is staged before N goes out: its copy runs on
            # the side stream while step N runs
            end = item is sentinel or isinstance(item, _Error)
            nxt = None if end else self._stage(item, device, stream)
            if staged is not None:
                yield self._hand_out(staged, device)
            if item is sentinel:
                return
            if isinstance(item, _Error):
                raise item.exc
            staged = nxt


# -- worker introspection (the reference's io.get_worker_info) ----------------

class WorkerInfo:
    """paddle.io.get_worker_info's payload: inside a DataLoader worker
    (id, num_workers, dataset); in the main thread get_worker_info()
    returns None."""

    def __init__(self, wid, num_workers, dataset):
        self.id = wid
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = threading.local()


def _set_worker_info(info):
    _worker_info.value = info


def get_worker_info():
    return getattr(_worker_info, "value", None)

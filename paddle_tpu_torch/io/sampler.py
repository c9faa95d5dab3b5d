"""Samplers, DistributedBatchSampler, BucketBatchSampler and
bucket_collate (counterpart of paddle_tpu/io/sampler.py, the
python/paddle/io surface). Host-side: every random draw comes from
numpy (the global stream, or a RandomState seeded by the epoch), the
same stream the JAX package draws, so one seed gives both packages the
same indices."""
from __future__ import annotations

import math

import numpy as np

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "SubsetRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "BucketBatchSampler",
           "bucket_collate"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num = num_samples

    @property
    def num_samples(self):
        return self._num if self._num is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-strided sharding of the dataset (the reference's
    distributed_batch_sampler). The port runs one process per rank, so
    each rank's sampler yields that rank's share (num_replicas and rank
    default to the process group's)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed.env import get_rank, get_world_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else \
            get_world_size()
        self.rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - n]  # pad to equal shards
        local = indices[self.rank::self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


class BucketBatchSampler(BatchSampler):
    """Length-bucketed batching: the framework-level variable-length
    policy.

    Ragged batches become `(padded, lengths)` pairs drawn from a small
    fixed set of padded shapes: samples are grouped by which bucket
    boundary their length fits under, and every emitted batch is padded
    to its bucket's boundary by `bucket_collate`, so a captured TrainStep
    holds one program per bucket, never one per shape. With
    drop_last=False, per-bucket remainder batches are smaller along the
    batch dim and add one program each; pass drop_last=True when a
    strict one-program-per-bucket guarantee matters.

    lengths: per-sample lengths (ints), or None to call len() on each
    sample of `dataset`. boundaries: ascending bucket upper bounds;
    samples longer than the last boundary go to a final overflow bucket
    sized by the max observed length (rounded up to `multiple`).
    """

    def __init__(self, dataset=None, lengths=None, boundaries=(64, 128,
                 256, 512), batch_size=1, shuffle=False, drop_last=False,
                 multiple=8):
        if lengths is None:
            lengths = [len(dataset[i]) for i in range(len(dataset))]
        if dataset is None:
            dataset = range(len(lengths))  # lengths determine the stream
        super().__init__(dataset=dataset, shuffle=shuffle,
                         batch_size=batch_size, drop_last=drop_last)
        self.lengths = np.asarray(lengths, np.int64)
        bounds = sorted(int(b) for b in boundaries)
        mx = int(self.lengths.max()) if len(self.lengths) else 1
        if mx > bounds[-1]:
            bounds.append(-(-mx // multiple) * multiple)
        self.boundaries = bounds
        self._num_batches = None  # lazily computed, then cached

    def collate(self, pad_value=0):
        """The matching collate_fn: built over self.boundaries, which
        already includes the overflow bucket's rounded bound — always
        use this (or bucket_collate(sampler)) so collate and sampler
        agree on the padded-shape set."""
        return bucket_collate(self, pad_value=pad_value)

    def bucket_of(self, length: int) -> int:
        for i, b in enumerate(self.boundaries):
            if length <= b:
                return i
        return len(self.boundaries) - 1

    def __iter__(self):
        pending: dict = {}
        for idx in self.sampler:
            b = self.bucket_of(int(self.lengths[idx]))
            pending.setdefault(b, []).append(idx)
            if len(pending[b]) == self.batch_size:
                yield pending.pop(b)
        for b in sorted(pending):
            if not self.drop_last:
                yield pending[b]

    def __len__(self):
        # exact and precomputed: lengths and boundaries are fixed at
        # construction (consumers like LR schedulers and progress bars
        # call len() repeatedly)
        if self._num_batches is None:
            counts: dict = {}
            for ln in self.lengths:
                b = self.bucket_of(int(ln))
                counts[b] = counts.get(b, 0) + 1
            total = 0
            for c in counts.values():
                total += c // self.batch_size
                if not self.drop_last and c % self.batch_size:
                    total += 1
            self._num_batches = total
        return self._num_batches


def bucket_collate(boundaries, pad_value=0):
    """collate_fn companion to BucketBatchSampler: stacks variable-length
    1D+ samples into (padded [B, T, ...], lengths [B]) with T = the
    smallest bucket boundary fitting the batch (the LoD-replacement
    convention of the sequence ops' lengths arguments).

    Pass the BucketBatchSampler itself (preferred) so the collate uses
    the sampler's boundary list INCLUDING the overflow bucket's rounded
    bound — building from a raw boundary tuple while the sampler added
    an overflow bucket would give overflow batches per-batch shapes."""
    if isinstance(boundaries, BucketBatchSampler):
        bounds = list(boundaries.boundaries)
    else:
        bounds = sorted(int(b) for b in boundaries)

    def collate(samples):
        arrs = [np.asarray(s) for s in samples]
        lens = np.asarray([a.shape[0] for a in arrs], np.int64)
        mx = int(lens.max())
        t = next((b for b in bounds if b >= mx), bounds[-1])
        if t < mx:
            raise ValueError(
                f"sample length {mx} exceeds the largest bucket bound "
                f"{bounds[-1]}; build the collate from the sampler "
                "(bucket_collate(sampler)) so the overflow bucket is "
                "included")
        tail = arrs[0].shape[1:]
        out = np.full((len(arrs), t) + tail, pad_value,
                      arrs[0].dtype)
        for i, a in enumerate(arrs):
            out[i, :a.shape[0]] = a
        return out, lens

    return collate

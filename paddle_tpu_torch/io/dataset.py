"""Dataset abstractions (counterpart of paddle_tpu/io/dataset.py, the
python/paddle/io surface). Host-side and framework-free: a sample is
whatever the dataset returns (numpy arrays, tensors, numbers);
random_split draws from numpy's global stream, as the JAX package's
does, so one np.random.seed gives both packages the same split."""
from __future__ import annotations

import bisect

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors
        n = len(tensors[0])
        assert all(len(t) == n for t in tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        assert self.datasets
        n = len(self.datasets[0])
        assert all(len(d) == n for d in self.datasets)

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumsizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumsizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        i = bisect.bisect_right(self.cumsizes, idx)
        prev = self.cumsizes[i - 1] if i > 0 else 0
        return self.datasets[i][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if all(isinstance(n, float) for n in lengths):
        lengths = [int(round(n * total)) for n in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    assert sum(lengths) == total
    perm = np.random.permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out

"""The port's io package (paddle_tpu_torch/io: datasets, samplers,
bucket_collate, random_split, the DataLoader) against the JAX package's
paddle_tpu/io, on the CPU.

Both packages draw their random indices from numpy: every sampler is
held index for index against the JAX one after the same np.random.seed,
and the DataLoader's batches (0 and 2 thread workers) value for value
against the JAX DataLoader's. The port's batches are torch tensors on
the loader's device (the CPU here); the card's staging (pinned memory, a
side stream, the consumer waiting on its event) runs in chip_smoke.py's
yolo_fit phase.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch as pt
import paddle_tpu_torch.io as tio


class _Items:
    """A dataset class made for either package's Dataset base."""

    def __init__(self, n=23, dim=3):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, dim).astype(np.float32)
        self.y = rng.randint(0, 5, n).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _ds(mod, n=23):
    return type("Items", (_Items, mod.Dataset), {})(n)


def _draw(fn, seed=7):
    np.random.seed(seed)
    return fn()


def _same_stream(make_j, make_t, seed=7, epochs=2):
    """Iterate both samplers over `epochs` epochs, each after the same
    seed; the indices must match."""
    for e in range(epochs):
        j = _draw(lambda: list(make_j()), seed + e)
        t = _draw(lambda: list(make_t()), seed + e)
        assert j == t
    return t


@pytest.mark.parametrize("name,kw", [
    ("SequenceSampler", {}),
    ("RandomSampler", {}),
    ("RandomSampler", dict(replacement=True, num_samples=30)),
    ("RandomSampler", dict(num_samples=9)),
])
def test_samplers_over_a_dataset(name, kw):
    js = getattr(jio, name)(_ds(jio), **kw)
    ts = getattr(tio, name)(_ds(tio), **kw)
    assert len(js) == len(ts)
    _same_stream(lambda: iter(js), lambda: iter(ts))


def test_weighted_and_subset_random_samplers():
    w = np.linspace(0.1, 2.0, 11)
    _same_stream(lambda: iter(jio.WeightedRandomSampler(w, 15)),
                 lambda: iter(tio.WeightedRandomSampler(w, 15)))
    _same_stream(
        lambda: iter(jio.WeightedRandomSampler(w, 6, replacement=False)),
        lambda: iter(tio.WeightedRandomSampler(w, 6, replacement=False)))
    idx = [3, 5, 8, 13, 21]
    _same_stream(lambda: iter(jio.SubsetRandomSampler(idx)),
                 lambda: iter(tio.SubsetRandomSampler(idx)))
    assert len(tio.SubsetRandomSampler(idx)) == 5


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler(shuffle, drop_last):
    kw = dict(shuffle=shuffle, batch_size=4, drop_last=drop_last)
    jb = jio.BatchSampler(_ds(jio), **kw)
    tb = tio.BatchSampler(_ds(tio), **kw)
    assert len(jb) == len(tb) == (5 if drop_last else 6)
    got = _same_stream(lambda: iter(jb), lambda: iter(tb))
    assert all(len(b) == 4 for b in got[:5])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("nranks", [2, 3])
def test_distributed_batch_sampler(shuffle, drop_last, nranks):
    for rank in range(nranks):
        kw = dict(batch_size=3, num_replicas=nranks, rank=rank,
                  shuffle=shuffle, drop_last=drop_last)
        js = jio.DistributedBatchSampler(_ds(jio), **kw)
        ts = tio.DistributedBatchSampler(_ds(tio), **kw)
        assert len(js) == len(ts)
        for epoch in range(2):
            assert list(js) == list(ts)     # epochs advance alike
        js.set_epoch(5)
        ts.set_epoch(5)
        assert list(js) == list(ts)


def test_distributed_batch_sampler_defaults_to_one_rank():
    ts = tio.DistributedBatchSampler(_ds(tio), batch_size=5)
    assert (ts.nranks, ts.rank) == (1, 0)
    assert [len(b) for b in ts] == [5, 5, 5, 5, 3]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_bucket_batch_sampler(shuffle, drop_last):
    rng = np.random.RandomState(3)
    lengths = rng.randint(1, 300, 57).tolist()
    kw = dict(lengths=lengths, boundaries=(32, 64, 128, 200),
              batch_size=4, shuffle=shuffle, drop_last=drop_last)
    js, ts = jio.BucketBatchSampler(**kw), tio.BucketBatchSampler(**kw)
    assert ts.boundaries == js.boundaries
    assert ts.boundaries[-1] == -(-max(lengths) // 8) * 8   # overflow
    assert len(js) == len(ts)
    got = _same_stream(lambda: iter(js), lambda: iter(ts))
    for b in got:
        assert len({ts.bucket_of(lengths[i]) for i in b}) == 1


def test_bucket_batch_sampler_reads_lengths_from_the_dataset():
    data = [np.zeros(n) for n in (3, 9, 4, 12, 7, 2)]
    js = jio.BucketBatchSampler(data, boundaries=(4, 8), batch_size=2)
    ts = tio.BucketBatchSampler(data, boundaries=(4, 8), batch_size=2)
    assert list(js) == list(ts)
    assert ts.boundaries == [4, 8, 16]


@pytest.mark.parametrize("from_sampler", [True, False])
def test_bucket_collate(from_sampler):
    rng = np.random.RandomState(4)
    samples = [rng.randn(n, 2).astype(np.float32) for n in (5, 3, 7)]
    if from_sampler:
        lengths = [5, 3, 7, 20]
        jc = jio.bucket_collate(jio.BucketBatchSampler(
            lengths=lengths, boundaries=(4, 8), batch_size=2), -1)
        tc = tio.BucketBatchSampler(lengths=lengths, boundaries=(4, 8),
                                    batch_size=2).collate(-1)
    else:
        jc = jio.bucket_collate((8, 4), pad_value=-1)
        tc = tio.bucket_collate((8, 4), pad_value=-1)
    (jp, jl), (tp, tl) = jc(samples), tc(samples)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)
    assert tp.shape == (3, 8, 2)
    with pytest.raises(ValueError, match="largest bucket"):
        tio.bucket_collate((4,))([np.zeros(9)])


def test_datasets():
    a, b = _ds(tio, 5), _ds(tio, 7)
    cat = tio.ConcatDataset([a, b])
    assert len(cat) == 12
    np.testing.assert_array_equal(cat[6][0], b[1][0])
    np.testing.assert_array_equal(cat[-1][0], b[6][0])
    sub = tio.Subset(b, [4, 2])
    assert len(sub) == 2 and sub[1][1] == b[2][1]
    comp = tio.ComposeDataset([a, _ds(tio, 5)])
    assert len(comp[0]) == 4
    td = tio.TensorDataset([torch.arange(6), torch.arange(6) * 2])
    assert len(td) == 6 and td[2][1].item() == 4
    ch = tio.ChainDataset([range(2), range(3)])
    assert [v for v in ch] == [0, 1, 0, 1, 2]
    with pytest.raises(RuntimeError):
        len(ch)
    with pytest.raises(RuntimeError):
        ch[0]


@pytest.mark.parametrize("lengths", [[4, 8, 11], [0.25, 0.5, 0.25]])
def test_random_split(lengths):
    j = _draw(lambda: jio.random_split(_ds(jio), lengths), 11)
    t = _draw(lambda: tio.random_split(_ds(tio), lengths), 11)
    assert [s.indices for s in j] == [s.indices for s in t]
    assert sum(len(s) for s in t) == 23


def _batches(loader):
    out = []
    for x, y in loader:
        out.append((np.asarray(getattr(x, "_data", x)),
                    np.asarray(getattr(y, "_data", y))))
    return out


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False),
                                               (True, True)])
def test_dataloader_matches_jax(workers, shuffle, drop_last):
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
              num_workers=workers)
    j = _draw(lambda: _batches(jio.DataLoader(_ds(jio), **kw)))
    tl = tio.DataLoader(_ds(tio), places="cpu", **kw)
    assert len(tl) == (5 if drop_last else 6)
    t = _draw(lambda: [(x.numpy(), y.numpy()) for x, y in tl])
    assert len(t) == len(j)
    for (tx, ty), (jx, jy) in zip(t, j):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_dataloader_batches_are_tensors_on_its_device():
    pt.set_device("cpu")
    x, y = next(iter(tio.DataLoader(_ds(tio), batch_size=3)))
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert x.shape == (3, 3) and y.dtype == torch.int64


def test_dataloader_with_a_bucket_sampler_and_its_collate():
    rng = np.random.RandomState(5)
    data = [rng.randn(int(n)).astype(np.float32)
            for n in rng.randint(2, 30, 17)]
    sampler = tio.BucketBatchSampler(data, boundaries=(8, 16), batch_size=3,
                                     drop_last=True)
    loader = tio.DataLoader(data, batch_sampler=sampler,
                            collate_fn=sampler.collate(), num_workers=2,
                            places="cpu")
    shapes = {tuple(p.shape[1:]) for p, _ in loader}
    assert shapes <= {(8,), (16,), (32,)}
    assert sum(1 for _ in loader) == len(sampler)


def test_dataloader_no_buffer_reader_and_iterable_dataset():
    class Stream(tio.IterableDataset):
        def __iter__(self):
            for i in range(7):
                yield np.full(2, i, np.float32)

    got = [b.numpy() for b in tio.DataLoader(
        Stream(), batch_size=3, use_buffer_reader=False, places="cpu")]
    assert [b.shape[0] for b in got] == [3, 3, 1]
    got = list(tio.DataLoader(Stream(), batch_size=3, drop_last=True,
                              places="cpu"))
    assert len(got) == 2
    with pytest.raises(TypeError):
        len(tio.DataLoader(Stream(), places="cpu"))


def test_get_worker_info_inside_and_outside_workers():
    seen = []

    class Probe(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            info = tio.get_worker_info()
            seen.append((threading.current_thread().name,
                         None if info is None else (info.id,
                                                    info.num_workers,
                                                    info.dataset is self)))
            return np.float32(i)

    assert tio.get_worker_info() is None
    list(tio.DataLoader(Probe(), batch_size=2, num_workers=2,
                        places="cpu"))
    infos = {s[1] for s in seen}
    assert None not in infos
    assert {i[0] for i in infos} <= {0, 1} and \
        all(i[1:] == (2, True) for i in infos)
    seen.clear()
    list(tio.DataLoader(Probe(), batch_size=2, places="cpu"))
    assert {s[1] for s in seen} == {None}


def test_a_worker_error_reaches_the_consumer():
    class Bad(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("sample 2")
            return np.float32(i)

    with pytest.raises(KeyError, match="sample 2"):
        list(tio.DataLoader(Bad(), batch_size=1, num_workers=2,
                            places="cpu"))


def test_process_workers_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="18.3"):
        tio.DataLoader(_ds(tio), num_workers=2, worker_mode="process")


def test_default_collate_fn():
    batch = [({"a": np.ones(2), "s": "x"}, torch.tensor([i]), 1.5)
             for i in range(3)]
    d, t, f = tio.default_collate_fn(batch)
    assert d["a"].shape == (3, 2) and d["s"] == ["x", "x", "x"]
    np.testing.assert_array_equal(t, [[0], [1], [2]])
    np.testing.assert_array_equal(f, [1.5] * 3)

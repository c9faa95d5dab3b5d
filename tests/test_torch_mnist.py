"""BASELINE config 1 (LeNet on MNIST in dygraph) in paddle_tpu_torch
against the JAX package, on the CPU:

- vision.datasets.MNIST (the synthetic fallback, no download) and the
  transforms give the JAX package's arrays bit for bit on the same seed;
- the dygraph loop as Paddle users write it (io.DataLoader, the model,
  paddle.reshape, F.cross_entropy, paddle.mean, backward, Adam's step
  and clear_grad) and hapi.Model.fit take 5 steps of LeNet from the JAX
  model's weights on the same batches: the loss trajectories agree
  within 1e-4 relative; the no_grad evaluation (paddle.argmax,
  paddle.metric.accuracy) agrees too;
- paddle.save/paddle.load round-trip the state dict.

The chip runs the same path at MNIST's real sizes (chip_smoke.py's
mnist_dygraph phase).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jtr
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as ttr
from torch_vision_weights import jax_vision_model

STEPS, BATCH, RTOL = 5, 64, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    torch.set_num_threads(n)


def _normalize(tr):
    return tr.Normalize(mean=[127.5], std=[127.5], data_format="CHW")


@pytest.mark.parametrize("mode", ["train", "test"])
def test_mnist_equals_the_jax_dataset(mode):
    j = jds.MNIST(mode=mode, synthetic_size=300, transform=_normalize(jtr))
    t = tds.MNIST(mode=mode, synthetic_size=300, transform=_normalize(ttr))
    assert len(t) == len(j) == 300
    assert np.array_equal(t.images, j.images)
    assert np.array_equal(t.labels, j.labels)
    for i in (0, 1, 150, 299):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert ti.dtype == ji.dtype and ti.shape == ji.shape == (1, 28, 28)
        assert np.array_equal(ti, ji) and tl == jl


def test_default_sizes_and_other_datasets_equal_jax():
    for cls in ("MNIST", "FashionMNIST", "Cifar10", "Cifar100"):
        t, j = getattr(tds, cls)(), getattr(jds, cls)()
        assert len(t) == len(j)
        for i in (0, len(j) - 1):
            assert np.array_equal(t[i][0], j[i][0]), cls
            assert t[i][1] == j[i][1], cls
    t, j = tds.VOC2012(synthetic_size=3), jds.VOC2012(synthetic_size=3)
    assert np.array_equal(t[2][1], j[2][1])


_IMG = np.random.RandomState(5).randint(0, 256, (20, 24, 3)).astype(np.uint8)


@pytest.mark.parametrize("name,args", [
    ("ToTensor", ()), ("Resize", (12,)), ("Resize", ((10, 14),)),
    ("CenterCrop", (10,)), ("RandomCrop", (16,)), ("RandomCrop", (16, 2)),
    ("RandomHorizontalFlip", (1.0,)), ("RandomVerticalFlip", (1.0,)),
    ("Transpose", ()), ("BrightnessTransform", (0.4,)), ("Pad", (2,)),
    ("Pad", ((1, 2, 3, 4),)), ("RandomResizedCrop", (8,)),
    ("Normalize", ([100.0, 120.0, 90.0], [50.0, 60.0, 70.0], "HWC"))])
def test_transforms_equal_jax(name, args):
    np.random.seed(11)
    want = getattr(jtr, name)(*args)(_IMG)
    np.random.seed(11)
    got = getattr(ttr, name)(*args)(_IMG)
    assert got.dtype == want.dtype and np.array_equal(got, want), name


def test_compose_functional_and_image_backend_equal_jax():
    chain = [("Resize", (16,)), ("CenterCrop", (12,)), ("ToTensor", ())]
    got = ttr.Compose([getattr(ttr, n)(*a) for n, a in chain])(_IMG)
    want = jtr.Compose([getattr(jtr, n)(*a) for n, a in chain])(_IMG)
    assert np.array_equal(got, want)
    for fn, args in (("hflip", ()), ("vflip", ()), ("crop", (2, 3, 8, 9)),
                     ("adjust_brightness", (1.3,)),
                     ("adjust_contrast", (0.7,)), ("to_grayscale", (3,)),
                     ("rotate", (90,))):
        assert np.array_equal(getattr(ttr.functional, fn)(_IMG, *args),
                              getattr(jtr.functional, fn)(_IMG, *args)), fn
    import paddle_tpu_torch.vision.transforms.functional as tfun
    assert tfun is ttr.functional
    assert pt.vision.get_image_backend() == jp.vision.get_image_backend()
    pt.vision.set_image_backend("numpy")
    assert pt.vision.get_image_backend() == "numpy"
    pt.vision.set_image_backend("pil")
    with pytest.raises(ValueError):
        pt.vision.set_image_backend("tf")


def _pair():
    jm = jax_vision_model("LeNet")
    tm = pt.vision.models.LeNet(device="cpu")
    load_jax_params(tm, {k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jm, tm


def _train_set(mod, tr):
    return mod.MNIST(mode="train", synthetic_size=STEPS * BATCH,
                     transform=_normalize(tr))


def _test_set(mod, tr):
    return mod.MNIST(mode="test", synthetic_size=BATCH,
                     transform=_normalize(tr))


def test_dygraph_loop_equals_jax():
    jm, tm = _pair()
    jopt = jp.optimizer.Adam(learning_rate=1e-3, parameters=jm.parameters())
    topt = pt.optimizer.Adam(learning_rate=1e-3, parameters=tm.parameters())
    jl, tl = [], []
    for x, y in jp.io.DataLoader(_train_set(jds, jtr), batch_size=BATCH):
        loss = jp.mean(JF.cross_entropy(jm(x), jp.reshape(y, [-1])))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
    for x, y in pt.io.DataLoader(_train_set(tds, ttr), batch_size=BATCH):
        loss = pt.mean(TF.cross_entropy(tm(x), pt.reshape(y, [-1])))
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(float(loss))
    assert len(tl) == STEPS
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    # evaluation under no_grad: the argmax predictions and the accuracy
    (jx, jy), = list(jp.io.DataLoader(_test_set(jds, jtr), batch_size=BATCH))
    (tx, ty), = list(pt.io.DataLoader(_test_set(tds, ttr), batch_size=BATCH))
    with jp.no_grad():
        jout = jm(jx)
    with pt.no_grad():
        tout = tm(tx)
    assert not tout.requires_grad
    assert np.array_equal(pt.argmax(tout, axis=1).numpy(),
                          jp.argmax(jout, axis=1).numpy())
    tacc = pt.metric.accuracy(tout, pt.reshape(ty, [-1, 1]))
    jacc = jp.metric.accuracy(jout, jp.reshape(jy, [-1, 1]))
    assert float(tacc) == pytest.approx(float(jacc.numpy()), abs=1e-7)


def _recorder(base):
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"][0])
    return Rec()


def test_model_fit_and_evaluate_equal_jax():
    jnet, tnet = _pair()
    jm, tm = jp.Model(jnet), pt.Model(tnet)
    jm.prepare(jp.optimizer.Adam(learning_rate=1e-3,
                                 parameters=jnet.parameters()),
               lambda o, y: JF.cross_entropy(o, y),
               metrics=[jp.metric.Accuracy()])
    tm.prepare(pt.optimizer.Adam(learning_rate=1e-3,
                                 parameters=tnet.parameters()),
               lambda o, y: TF.cross_entropy(o, y),
               metrics=[pt.metric.Accuracy()])
    jrec, trec = _recorder(jp.callbacks.Callback), \
        _recorder(pt.callbacks.Callback)
    jm.fit(_train_set(jds, jtr), epochs=1, batch_size=BATCH, shuffle=False,
           verbose=0, callbacks=[jrec])
    tm.fit(_train_set(tds, ttr), epochs=1, batch_size=BATCH, shuffle=False,
           verbose=0, callbacks=[trec])
    assert len(trec.losses) == STEPS
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=RTOL)
    ej = jm.evaluate(_test_set(jds, jtr), batch_size=BATCH, verbose=0)
    et = tm.evaluate(_test_set(tds, ttr), batch_size=BATCH, verbose=0)
    np.testing.assert_allclose(et["loss"], ej["loss"], rtol=RTOL)
    assert et["acc"] == pytest.approx(ej["acc"], abs=1e-7)


def test_save_and_load_round_trip(tmp_path):
    _, tm = _pair()
    path = str(tmp_path / "lenet.pdparams")
    pt.save(tm.state_dict(), path)
    other = pt.vision.models.LeNet(device="cpu")
    other.set_state_dict(pt.load(path))
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 1, 28, 28).astype(np.float32))
    with pt.no_grad():
        assert torch.equal(other(x), tm(x))

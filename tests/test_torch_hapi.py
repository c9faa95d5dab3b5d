"""The port's hapi (Model, the callbacks, summary) and metric packages
against the JAX package's paddle_tpu/hapi and paddle_tpu/metric, on the
CPU.

Model.fit's loss history (a callback records every batch's loss),
evaluate's loss and metrics and predict's outputs are held against the
JAX hapi.Model on the same weights and data: a small Linear classifier
(SGD, cross-entropy, Accuracy), and a tiny YOLOv3 (4 classes, 64 x 64;
its neck, heads and loss over a 3-convolution backbone, which keeps the
JAX package's compile of the step to a few seconds; the model itself is
held in tests/test_torch_yolo.py) with multi-label InputSpecs (img;
gt_box, gt_label), trained with Adam. Tolerances, float32: losses at
1e-4 relative (Adam turns 1e-7 gradient differences into at most that
over two steps),
predictions at 1e-5 x max(1, max|ref|), metrics exact (they count
on the host). The callbacks are held on their contract: EarlyStopping
stops where the JAX one does, ModelCheckpoint's files load back bit for
bit, the LRScheduler callback steps the schedule per batch, summary
counts the parameters.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.hapi as jhapi
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.hapi as thapi
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.metric as tmetric
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu_torch.models import YOLOv3, load_jax_params
from paddle_tpu_torch.optimizer import SGD as TSGD
from paddle_tpu_torch.optimizer import Adam as TAdam
from paddle_tpu_torch.optimizer.lr import StepDecay as TStepDecay
from paddle_tpu_torch.static import InputSpec as TSpec
from torch_vision_weights import jax_yolo_model


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    """The port's entry points on the CPU, one torch thread (tier-1 runs
    several workers on the CPU's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    torch.set_num_threads(n)


class _Rows:
    def __init__(self, n=20, seed=0):
        rng = np.random.RandomState(seed)
        self.x = rng.randn(n, 6).astype(np.float32)
        self.y = (self.x[:, :3].argmax(1)).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _rows(mod, **kw):
    return type("Rows", (_Rows, mod.Dataset), {})(**kw)


def _recorder(base):
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"][0])
    return Rec()


def _linear_pair(lr=0.5, sched=False):
    paddle.seed(0)
    jnet = jnn.Linear(6, 3)
    tnet = tnn.Linear(6, 3, device="cpu")
    load_jax_params(tnet, {k: np.asarray(v.numpy())
                           for k, v in jnet.state_dict().items()})
    jlr = paddle.optimizer.lr.StepDecay(lr, step_size=2, gamma=0.5) \
        if sched else lr
    tlr = TStepDecay(lr, step_size=2, gamma=0.5) if sched else lr
    jm = jhapi.Model(jnet)
    jm.prepare(paddle.optimizer.SGD(learning_rate=jlr,
                                    parameters=jnet.parameters()),
               loss=lambda o, y: JF.cross_entropy(o, y),
               metrics=jmetric.Accuracy())
    tm = thapi.Model(tnet)
    tm.prepare(TSGD(learning_rate=tlr, parameters=tnet.parameters()),
               loss=lambda o, y: TF.cross_entropy(o, y),
               metrics=tmetric.Accuracy())
    return jm, tm


def test_linear_fit_evaluate_predict_match_jax():
    jm, tm = _linear_pair()
    jrec, trec = _recorder(jhapi.Callback), _recorder(thapi.Callback)
    jm.fit(_rows(jio), batch_size=4, epochs=2, shuffle=False, verbose=0,
           callbacks=[jrec])
    tm.fit(_rows(tio), batch_size=4, epochs=2, shuffle=False, verbose=0,
           callbacks=[trec])
    assert len(trec.losses) == 10
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-4)
    ev_j = jm.evaluate(_rows(jio, seed=1), batch_size=5, verbose=0)
    ev_t = tm.evaluate(_rows(tio, seed=1), batch_size=5, verbose=0)
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-4)
    assert ev_t["acc"] == ev_j["acc"]
    pj = jm.predict(_rows(jio, seed=2), batch_size=8, stack_outputs=True)
    ptt = tm.predict(_rows(tio, seed=2), batch_size=8, stack_outputs=True)
    assert ptt[0].shape == (20, 3)
    np.testing.assert_allclose(ptt[0], pj[0], rtol=0, atol=1e-5 * max(
        1.0, float(np.abs(pj[0]).max())))


def test_shuffled_fit_draws_the_jax_order():
    jm, tm = _linear_pair()
    jrec, trec = _recorder(jhapi.Callback), _recorder(thapi.Callback)
    np.random.seed(3)
    jm.fit(_rows(jio), batch_size=4, epochs=1, verbose=0, callbacks=[jrec])
    np.random.seed(3)
    tm.fit(_rows(tio), batch_size=4, epochs=1, verbose=0, callbacks=[trec])
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-4)


def test_lr_scheduler_callback_steps_per_batch():
    jm, tm = _linear_pair(sched=True)
    cj = jhapi.LRSchedulerCallback(by_step=True)
    ct = thapi.LRSchedulerCallback(by_step=True)
    jrec, trec = _recorder(jhapi.Callback), _recorder(thapi.Callback)
    jm.fit(_rows(jio), batch_size=4, epochs=1, shuffle=False, verbose=0,
           callbacks=[cj, jrec])
    tm.fit(_rows(tio), batch_size=4, epochs=1, shuffle=False, verbose=0,
           callbacks=[ct, trec])
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-4)
    # 5 batch steps by the callback, 1 epoch step by fit
    assert tm._optimizer._lr.last_epoch == jm._optimizer._lr.last_epoch
    assert tm._optimizer.get_lr() == pytest.approx(jm._optimizer.get_lr())


def test_early_stopping_stops_where_the_jax_one_does():
    stops = []
    for mod, hapi in ((jio, jhapi), (tio, thapi)):
        jm_tm = _linear_pair(lr=5.0)
        m = jm_tm[0] if hapi is jhapi else jm_tm[1]
        es = hapi.EarlyStopping(monitor="loss", patience=1)
        m.fit(_rows(mod), eval_data=_rows(mod, seed=1), batch_size=4,
              epochs=8, shuffle=False, verbose=0, callbacks=[es])
        stops.append((m.stop_training, es.wait, es.best))
    assert stops[1][:2] == stops[0][:2]
    assert stops[1][2] == pytest.approx(stops[0][2], rel=1e-4)


def test_model_checkpoint_save_and_load(tmp_path):
    _, tm = _linear_pair()
    tm.fit(_rows(tio), batch_size=4, epochs=2, shuffle=False, verbose=0,
           callbacks=[thapi.ModelCheckpoint(save_dir=str(tmp_path))])
    for name in ("0", "1", "final"):
        assert os.path.exists(tmp_path / f"{name}.pdparams")
        assert os.path.exists(tmp_path / f"{name}.pdopt")
    want = {k: v.clone() for k, v in tm.network.state_dict().items()}
    _, fresh = _linear_pair()
    fresh.load(str(tmp_path / "final"))
    for k, v in fresh.network.state_dict().items():
        assert torch.equal(v, want[k])
    # the loaded weights are the live ones the step trains
    before = fresh.network.weight.detach().clone()
    fresh.fit(_rows(tio), batch_size=4, epochs=1, shuffle=False, verbose=0)
    assert not torch.equal(before, fresh.network.weight)


def test_summary_counts_parameters(capsys):
    _, tm = _linear_pair()
    jnet = jax_yolo_model(0)
    tnet = YOLOv3(num_classes=4, width=4, device="cpu")
    want = jhapi.summary(jnet)
    assert thapi.summary(tnet) == want
    assert tm.summary() == {"total_params": 21, "trainable_params": 21}
    assert "Total params: 21" in capsys.readouterr().out


def test_metrics_logger_exports(tmp_path):
    from paddle_tpu_torch.observability import metrics
    _, tm = _linear_pair()
    was = metrics.enabled()
    log = thapi.MetricsLogger(log_freq=2, jsonl_path=str(tmp_path / "m.jsonl"),
                              prom_path=str(tmp_path / "m.prom"),
                              batch_size=4)
    try:
        tm.fit(_rows(tio), batch_size=4, epochs=1, shuffle=False, verbose=0,
               callbacks=[log])
    finally:
        metrics.enable(was)
    assert metrics.enabled() == was
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(lines) == 3                 # batches 2 and 4, and the end
    assert "train_loss" in (tmp_path / "m.prom").read_text()


# -- the tiny YOLOv3 through fit ------------------------------------------------

def _det_items(n=8, seed=0):
    rng = np.random.RandomState(seed)
    items = []
    for _ in range(n):
        img = (rng.randn(3, 64, 64) * 0.5).astype(np.float32)
        box = np.zeros((2, 4), np.float32)
        box[0] = [0.5, 0.5, 0.4, 0.3]
        box[1] = [0.3, 0.25, 0.2, 0.2]
        lbl = rng.randint(0, 4, (2,)).astype(np.int32)
        items.append((img, box, lbl))
    return items


def _det_ds(mod, **kw):
    class SynthDet(mod.Dataset):
        def __init__(self):
            self.items = _det_items(**kw)

        def __len__(self):
            return len(self.items)

        def __getitem__(self, i):
            return self.items[i]
    return SynthDet()


def _backbone(nn, F, **device):
    """Three strided convolutions at strides 8, 16 and 32 (the maps
    YOLOv3's neck takes), in either package."""
    class TinyBackbone(nn.Layer):
        def __init__(self):
            super().__init__()
            self.s8 = nn.Conv2D(3, 8, 3, stride=8, padding=1, **device)
            self.s16 = nn.Conv2D(8, 16, 3, stride=2, padding=1, **device)
            self.s32 = nn.Conv2D(16, 32, 3, stride=2, padding=1, **device)
            self.out_channels = (8, 16, 32)

        def forward(self, x):
            c3 = F.relu(self.s8(x))
            c4 = F.relu(self.s16(c3))
            return c3, c4, F.relu(self.s32(c4))
    return TinyBackbone()


def _yolo_models():
    jnet = jax_yolo_model(7, backbone=lambda: _backbone(jnn, JF))
    tnet = YOLOv3(num_classes=4, backbone=_backbone(tnn, TF, device="cpu"),
                  device="cpu")
    load_jax_params(tnet, {k: np.asarray(v.numpy())
                           for k, v in jnet.state_dict().items()})
    specs = []
    for Spec in (JSpec, TSpec):
        specs.append(dict(
            inputs=[Spec([None, 3, 64, 64], "float32", "img")],
            labels=[Spec([None, 2, 4], "float32", "gt_box"),
                    Spec([None, 2], "int32", "gt_label")]))
    jm = jhapi.Model(jnet, **specs[0])
    tm = thapi.Model(tnet, **specs[1])
    jm.prepare(paddle.optimizer.Adam(learning_rate=2e-3,
                                     parameters=jnet.parameters()),
               loss=lambda p5, p4, p3, b, l: jnet.loss((p5, p4, p3), b, l))
    tm.prepare(TAdam(learning_rate=2e-3, parameters=tnet.parameters()),
               loss=lambda p5, p4, p3, b, l: tnet.loss((p5, p4, p3), b, l))
    return jm, tm


def test_yolo_fit_with_multi_label_specs_matches_jax():
    jm, tm = _yolo_models()
    jrec, trec = _recorder(jhapi.Callback), _recorder(thapi.Callback)
    jm.fit(_det_ds(jio), batch_size=4, epochs=1, shuffle=False, verbose=0,
           callbacks=[jrec])
    tm.fit(_det_ds(tio), batch_size=4, epochs=1, shuffle=False, verbose=0,
           callbacks=[trec])
    assert len(trec.losses) == 2 and np.isfinite(trec.losses).all()
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-4)
    assert tm._train_step.programs == 1


def test_yolo_evaluate_and_predict_match_jax():
    jm, tm = _yolo_models()
    jm.network.eval()
    ej = jm.evaluate(_det_ds(jio, n=4, seed=1), batch_size=4, verbose=0)
    et = tm.evaluate(_det_ds(tio, n=4, seed=1), batch_size=4, verbose=0)
    np.testing.assert_allclose(et["loss"], ej["loss"], rtol=1e-5)
    assert tm.network.training          # eval mode only inside evaluate
    outs = tm.predict(_det_ds(tio, n=2, seed=2), batch_size=2)[0][0]
    assert [o.shape for o in outs] == [(2, 27, 2, 2), (2, 27, 4, 4),
                                       (2, 27, 8, 8)]


# -- metrics --------------------------------------------------------------------

@pytest.mark.parametrize("topk", [(1,), (1, 3)])
def test_accuracy_metric(topk):
    rng = np.random.RandomState(0)
    jm, tm = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    for _ in range(3):
        pred = rng.randn(8, 5).astype(np.float32)
        lbl = rng.randint(0, 5, (8, 1)).astype(np.int64)
        cj = jm.compute(paddle.to_tensor(pred), paddle.to_tensor(lbl))
        ct = tm.compute(torch.from_numpy(pred), torch.from_numpy(lbl))
        np.testing.assert_array_equal(ct.numpy(), cj.numpy())
        assert tm.update(ct) == jm.update(cj)
    assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name()
    tm.reset()
    assert tm.accumulate() == (0.0 if len(topk) == 1 else [0.0, 0.0])


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_and_recall(cls):
    rng = np.random.RandomState(1)
    jm, tm = getattr(jmetric, cls)(), getattr(tmetric, cls)()
    for _ in range(3):
        p = rng.rand(10).astype(np.float32)
        y = rng.randint(0, 2, 10).astype(np.int64)
        jm.update(paddle.to_tensor(p), paddle.to_tensor(y))
        tm.update(torch.from_numpy(p), torch.from_numpy(y))
    assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name()


@pytest.mark.parametrize("two_cols", [False, True])
def test_auc(two_cols):
    rng = np.random.RandomState(2)
    jm, tm = jmetric.Auc(num_thresholds=255), tmetric.Auc(num_thresholds=255)
    for _ in range(2):
        p = rng.rand(40).astype(np.float32)
        if two_cols:
            p = np.stack([1 - p, p], 1)
        y = rng.randint(0, 2, 40).astype(np.int64)
        jm.update(paddle.to_tensor(p), paddle.to_tensor(y))
        tm.update(torch.from_numpy(p), torch.from_numpy(y))
    assert tm.accumulate() == pytest.approx(jm.accumulate(), rel=1e-12)
    assert 0.0 < tm.accumulate() < 1.0


@pytest.mark.parametrize("k", [1, 2])
def test_functional_accuracy(k):
    rng = np.random.RandomState(3)
    pred = np.round(rng.rand(12, 4), 1).astype(np.float32)   # ties
    lbl = rng.randint(0, 4, (12, 1)).astype(np.int64)
    want = jmetric.accuracy(paddle.to_tensor(pred), paddle.to_tensor(lbl),
                            k=k)
    got = tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(lbl),
                           k=k)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(want.numpy())

"""The port's inference API and inference-model files against the JAX
package's (twin of tests/test_text_inference.py's save/load/Predictor
cases and tests/test_yolo.py::test_export_serve_end_to_end).

Each model is built in both packages with the same weights (by name),
saved by each package's save_inference_model or jit.save, loaded, and
run by each package's Predictor on the same numpy input; the port's
Predictor runs on the CPU here (Config.disable_gpu(), or the executor's
CPUPlace), where it calls the exported program (on the card it replays
one CUDA graph per input signature: chip_smoke.py's predictor phase).
Outputs agree to 1e-5 (YOLOv3's detections to 1e-4 and its counts up to
a box at the score threshold, as the JAX test allows).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch import jit
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.jit import InputSpec
from paddle_tpu_torch.models import load_jax_params

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    torch.set_num_threads(n)


def _cpu_config(prefix):
    c = Config(prefix)
    c.disable_gpu()
    return c


def _lenets():
    from paddle_tpu.vision.models import LeNet as JaxLeNet
    from paddle_tpu_torch.vision.models import LeNet
    paddle.seed(3)
    jm = JaxLeNet()
    jm.eval()
    tm = LeNet()
    load_jax_params(tm, {k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jm, tm.eval()


def _save_lenets(tmp_path):
    jm, tm = _lenets()
    spec = [1, 1, 28, 28]
    tprefix = os.path.join(str(tmp_path), "t", "lenet")
    jprefix = os.path.join(str(tmp_path), "j", "lenet")
    pt.static.save_inference_model(tprefix, layer=tm,
                                   input_spec=[InputSpec(spec, "float32")])
    paddle.static.save_inference_model(
        jprefix, layer=jm, input_spec=[paddle.jit.InputSpec(spec,
                                                            "float32")])
    x = np.random.RandomState(0).randn(*spec).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    return tprefix, jprefix, x, ref


def test_save_load_inference_model_matches_jax(tmp_path):
    tprefix, jprefix, x, ref = _save_lenets(tmp_path)
    for suffix in (".pdmodel", ".pdiparams", ".pdmeta.json"):
        assert os.path.exists(tprefix + suffix)
    pred, feeds, fetches = pt.static.load_inference_model(
        tprefix, executor=pt.static.Executor(pt.CPUPlace()))
    jpred, jfeeds, jfetches = paddle.static.load_inference_model(jprefix)
    assert (feeds, fetches) == (jfeeds, jfetches)
    got = pred.run([x])[0]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, jpred.run([x])[0], rtol=TOL, atol=TOL)


def test_predictor_handle_api(tmp_path):
    tprefix, _, x, ref = _save_lenets(tmp_path)
    pred = create_predictor(_cpu_config(tprefix))
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(x)
    assert h.shape() == list(x.shape)
    pred.run()
    out_h = pred.get_output_handle(pred.get_output_names()[0])
    np.testing.assert_allclose(out_h.copy_to_cpu(), ref, rtol=TOL,
                               atol=TOL)
    with pytest.raises(RuntimeError, match="output handle"):
        out_h.copy_from_cpu(x)


def test_pdiparams_layout_is_the_jax_packages(tmp_path):
    """The port's .pdiparams and .pdmeta.json read like the JAX
    package's: a pickle of numpy arrays by state name, and JSON names."""
    import json
    import pickle
    tprefix, jprefix, _, _ = _save_lenets(tmp_path)
    with open(tprefix + ".pdiparams", "rb") as f:
        t = pickle.load(f)
    with open(jprefix + ".pdiparams", "rb") as f:
        j = pickle.load(f)
    assert sorted(t) == sorted(j) == ["meta", "state"]
    assert sorted(t["state"]) == sorted(j["state"])
    for k, v in j["state"].items():
        np.testing.assert_array_equal(t["state"][k], np.asarray(v))
    with open(tprefix + ".pdmeta.json") as f:
        tm = json.load(f)
    with open(jprefix + ".pdmeta.json") as f:
        assert json.load(f) == tm


def test_jax_pdmodel_refused_by_the_predictor(tmp_path):
    from paddle_tpu_torch.core.enforce import EnforceNotMet
    _, jprefix, _, _ = _save_lenets(tmp_path)
    with pytest.raises(EnforceNotMet, match="not a paddle_tpu_torch"):
        create_predictor(_cpu_config(jprefix))


def test_jit_save_load_runnable(tmp_path):
    pt.seed(5)
    model = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2)).eval()
    path = os.path.join(str(tmp_path), "mlp", "model")
    jit.save(model, path, input_spec=[InputSpec([3, 4], "float32")])
    loaded = jit.load(path)
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 4).astype(
        np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(loaded(x).numpy(), model(x).numpy(),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("batch", [1, 3, 17])
def test_polymorphic_batch_dim(tmp_path, batch):
    pt.seed(9)
    model = nn.Linear(4, 2).eval()
    path = os.path.join(str(tmp_path), "poly", "model")
    jit.save(model, path, input_spec=[InputSpec([None, 4], "float32")])
    loaded = jit.load(path)
    pred = create_predictor(_cpu_config(path))
    x = np.random.RandomState(batch).randn(batch, 4).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(loaded(torch.from_numpy(x)).numpy(),
                                   ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pred.run([x])[0], ref, rtol=TOL, atol=TOL)


def test_jit_save_untraceable_forward_keeps_weights(tmp_path):
    class Weird(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 2)

        def forward(self, x):
            if float(x.sum().item()) > 0:     # a branch on a value
                return self.fc(x)
            return self.fc(x) * 2
    path = os.path.join(str(tmp_path), "weird", "model")
    with pytest.warns(UserWarning, match="export skipped"):
        jit.save(Weird(), path, input_spec=[InputSpec([2, 4], "float32")])
    assert os.path.exists(path + ".pdiparams")
    assert not os.path.exists(path + ".pdmodel")


def test_jit_save_without_spec_loads_weights_only(tmp_path):
    path = os.path.join(str(tmp_path), "w", "model")
    jit.save(nn.Linear(4, 2), path)
    loaded = jit.load(path)
    with pytest.raises(RuntimeError):
        loaded(torch.zeros(1, 4))


def test_config_devices():
    c = Config("x")
    assert c.use_gpu() and c.prog_file() == "x.pdmodel"
    c.disable_gpu()
    assert not c.use_gpu() and c.device() == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="CUDA card"):
        Config("x").enable_tpu()


class _JaxServing(jnn.Layer):
    def __init__(self, det, hw):
        super().__init__()
        self.det = det
        self.hw = hw

    def forward(self, images):
        outs = self.det(images)
        im = paddle.to_tensor(np.full((images.shape[0], 2), self.hw,
                                      np.int32))
        return self.det.predict(outs, im, conf_thresh=0.1, keep_top_k=16)


class _Serving(nn.Layer):
    def __init__(self, det, hw):
        super().__init__()
        self.det = det
        self.hw = hw

    def forward(self, images):
        outs = self.det(images)
        im = torch.full((images.shape[0], 2), self.hw, dtype=torch.int32,
                        device=images.device)
        return self.det.predict(outs, im, conf_thresh=0.1, keep_top_k=16)


def test_yolo_export_serve_end_to_end(tmp_path):
    """YOLOv3 (width 4, 4 classes, 64 px) forward plus hard-NMS predict:
    saved with save_inference_model, loaded with load_inference_model
    and run by the Predictor in both packages; the NMS is one exported
    paddle_tpu.nms_greedy node in the port's program."""
    from torch_vision_weights import jax_yolo_model
    from paddle_tpu_torch.jit.api import ExportedForward
    from paddle_tpu_torch.models import YOLOv3
    jm = jax_yolo_model(9)
    tm = YOLOv3(num_classes=4, width=4, device="cpu")
    load_jax_params(tm, {k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    jserve, tserve = _JaxServing(jm, 64), _Serving(tm, 64)
    jserve.eval()
    tserve.eval()
    x = (np.random.RandomState(0).randn(2, 3, 64, 64) * 0.5).astype(
        np.float32)
    with torch.no_grad():
        ref_d, ref_c = tserve(torch.from_numpy(x))
    tprefix = os.path.join(str(tmp_path), "t", "yolo")
    jprefix = os.path.join(str(tmp_path), "j", "yolo")
    pt.static.save_inference_model(
        tprefix, layer=tserve,
        input_spec=[InputSpec([2, 3, 64, 64], "float32")])
    paddle.static.save_inference_model(
        jprefix, layer=jserve,
        input_spec=[paddle.jit.InputSpec([2, 3, 64, 64], "float32")])
    ef = ExportedForward.load(tprefix + ".pdmodel")
    assert sum("nms_greedy" in str(n.target)
               for n in ef.ep.graph.nodes) == 1
    pred, _, _ = pt.static.load_inference_model(
        tprefix, executor=pt.static.Executor(pt.CPUPlace()))
    jpred, _, _ = paddle.static.load_inference_model(jprefix)
    out = pred.run([x])
    jout = jpred.run([x])
    np.testing.assert_allclose(out[0], ref_d.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out[0], jout[0], rtol=1e-4, atol=1e-4)
    assert np.abs(out[1].astype(np.int64)
                  - ref_c.numpy().astype(np.int64)).max() <= 1
    assert np.abs(out[1].astype(np.int64)
                  - np.asarray(jout[1]).astype(np.int64)).max() <= 1

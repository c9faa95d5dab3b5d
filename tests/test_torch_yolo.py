"""YOLOv3 (BASELINE config 4) in the port (paddle_tpu_torch/models/yolo.py)
against the JAX package's paddle_tpu/models/yolo.py, on the CPU.

The JAX model gets weights and non-trivial running statistics from a
numpy seed (tests/torch_vision_weights.py jax_yolo_model); the port
takes them by name (load_jax_params). Width 4, 4 classes. Tolerances,
float32: head outputs within 1e-4 x the tensor's max |ref|; the loss at
1e-5 relative and every gradient within 1e-4 of its tensor's max |ref|
(jax.value_and_grad of the JAX loss); a 3-step Adam TrainStep
trajectory (losses, parameters, running statistics) within 1e-4 x
max(1, max|ref|); one O1 bf16 step within 2e-2, the vision path's bf16
tolerance (bf16 rounds at other places in the two packages). predict is
fed the same head outputs on both sides: labels, counts exact; scores
and boxes within 1e-5 x max(1, max|ref|).

Everything runs at 2 x 3 x 64 x 64 (heads at 2 x 2, 4 x 4 and 8 x 8
cells). The gradients are held with the BatchNorms in eval mode. In
train mode a BatchNorm's backward takes sums over N x H x W whose terms
nearly cancel under this loss (objectness terms of one sign at every
cell), so two summation orders part: the JAX package's own eager tape
and its compiled step differ from each other by up to 2.7% of a
gradient's max on seed 1's batch (backbone.d1.bn.weight), and the port
agrees with the eager tape to 2e-5 there. The train-mode backward is
held through the TrainStep trajectory, whose batches keep those sums
well conditioned; at 32 x 32 the stride-32 maps are 1 x 1, a BatchNorm
there normalises 2 values, and no order-free comparison is possible.
Where a tensor after the trajectory's last step parts from the JAX
step's by more than 1e-4, it is held three ways instead
(torch_vision_weights nearer_f64): the port's f32 value may lie no
further from that step in float64 (the JAX TrainStep under
jax.enable_x64 from the JAX trajectory's state and Adam state before
it) than the JAX package's f32 value does, and both within 1e-2 of it.
On some CPUs the JAX package's backbone.d9.conv.weight after the third
step lies 1.3e-3 from the f64 step's, the port's 1.3e-6 from it
(tests/bn_rounding_report.py prints these distances).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import functionalize
from paddle_tpu.static import TrainStep as JStep
from paddle_tpu_torch.models import YOLOv3, load_jax_params
from paddle_tpu_torch.optimizer import Adam as TAdam
from paddle_tpu_torch.static import TrainStep as TStep
from torch_vision_weights import jax_f64_steps, jax_yolo_model, nearer_f64

LR = 1e-3
BF16 = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: tier-1 runs several workers on the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=0):
    jm = jax_yolo_model(seed)
    tm = YOLOv3(num_classes=4, width=4, device="cpu")
    load_jax_params(tm, {k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(size, n=2, seed=0):
    """Images, and 50 gt slots an image (PaddleDetection's num_max_boxes)
    of which 3 and 2 are valid; labels int32."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 3, size, size) * 0.5).astype(np.float32)
    box = np.zeros((n, 50, 4), np.float32)
    box[:, 0] = [0.5, 0.5, 0.4, 0.3]
    box[:, 1] = [0.25, 0.3, 0.2, 0.25]
    box[0, 2] = [0.7, 0.6, 0.1, 0.2]
    lbl = rng.randint(0, 4, (n, 50)).astype(np.int32)
    return x, box, lbl


def _close(got, want, tol, scale=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    s = max(1.0, float(np.abs(want).max())) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * s)


def _stats(state):
    return {k: np.asarray(v) for k, v in state.items()
            if k.endswith(("_mean", "_variance"))}


@pytest.mark.parametrize("training", [True, False])
def test_forward_matches_jax(training):
    jm, tm = _pair()
    if not training:
        jm.eval()
    tm.train(training)
    x, _, _ = _batch(64)
    j_out = jm(paddle.to_tensor(x))
    t_out = tm(torch.from_numpy(x))
    a = 3 * (5 + 4)
    for jo, to, cells in zip(j_out, t_out, (2, 4, 8)):
        assert list(to.shape) == [2, a, cells, cells]
        ref = jo.numpy()
        _close(to, ref, 1e-4, float(np.abs(ref).max()))
    tstate = {k: v.numpy() for k, v in tm.state_dict().items()}
    for k, v in _stats({k: t.numpy() for k, t in
                        jm.state_dict().items()}).items():
        _close(torch.from_numpy(tstate[k]), v, 1e-5)


def test_loss_and_gradients_match_jax():
    """The loss and every parameter's gradient, BatchNorms in eval mode
    (see the module's note), against jax.value_and_grad of the JAX
    model's loss."""
    jm, tm = _pair(1)
    jm.eval()
    tm.eval()
    x, box, lbl = _batch(64, seed=1)
    names = [k for k, p in jm.named_parameters() if not p.stop_gradient]
    state = {k: t._data for k, t in jm.state_dict().items()}
    params = {k: state[k] for k in names}
    rest = {k: v for k, v in state.items() if k not in params}
    pure = functionalize(lambda xx, bb, ll: jm.loss(jm(xx), bb, ll), jm)

    def f(p, xx, bb, ll):
        out, _ = pure({**rest, **p}, jax.random.PRNGKey(0), xx, bb, ll)
        return out

    jv, jg = jax.jit(jax.value_and_grad(f))(params, x, box, lbl)
    loss = tm.loss(tm(torch.from_numpy(x)), torch.from_numpy(box),
                   torch.from_numpy(lbl))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-5)
    tparams = dict(tm.named_parameters())
    assert sorted(tparams) == sorted(names)
    for k in names:
        ref = np.asarray(jg[k])
        _close(tparams[k].grad, ref, 1e-4, float(np.abs(ref).max()))


def _steps(jm, tm, batches, amp=None):
    jstep = JStep(jm, lambda o, b, l: jm.loss(o, b, l),
                  paddle.optimizer.Adam(learning_rate=LR,
                                        parameters=jm.parameters()),
                  **({} if amp is None else dict(amp_level=amp,
                                                 amp_dtype="bfloat16")))
    tstep = TStep(tm, lambda o, b, l: tm.loss(o, b, l),
                  TAdam(learning_rate=LR, parameters=tm.parameters()),
                  **({} if amp is None else dict(amp_level=amp,
                                                 amp_dtype="bfloat16")))
    jl, tl = [], []
    for x, box, lbl in batches:
        # the JAX state and Adam state before the last step
        jstep.sync_to_layer()
        before = ({k: np.asarray(v.numpy())
                   for k, v in jm.state_dict().items()},
                  jax.tree_util.tree_map(np.asarray, jstep.opt_state))
        jl.append(float(jstep(paddle.to_tensor(x),
                              (paddle.to_tensor(box),
                               paddle.to_tensor(lbl)))))
        tl.append(float(tstep(torch.from_numpy(x),
                              (torch.from_numpy(box),
                               torch.from_numpy(lbl)))))
    jstate = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tstate = {k: v.detach().float().numpy()
              for k, v in tm.state_dict().items()}
    return jl, tl, jstate, tstate, tstep, before


def _f64_step(before, batch):
    """The JAX Adam step in float64 (jax_f64_steps) from `before`, the
    JAX state and Adam state _steps saw before its last step: the state
    after."""
    m = jax_yolo_model()
    x, box, lbl = batch
    return jax_f64_steps(
        m, lambda o, b, l: m.loss(o, b, l),
        lambda ps: paddle.optimizer.Adam(learning_rate=LR, parameters=ps),
        before[0], [(x, (box, lbl))], opt_state=before[1])[1]


def test_three_adam_steps_match_the_jax_train_step():
    jm, tm = _pair(2)
    batches = [_batch(64, seed=s) for s in (2, 3, 4)]
    jl, tl, jstate, tstate, _, before = _steps(jm, tm, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert jl[-1] < jl[0]
    want64 = None
    for k, v in jstate.items():
        if np.abs(tstate[k] - v).max() > 1e-4 * max(1.0, np.abs(v).max()):
            if want64 is None:
                want64 = _f64_step(before, batches[-1])
            ok, seen = nearer_f64(tstate[k], v, want64[k])
            assert ok, (k, seen)
        else:
            _close(torch.from_numpy(tstate[k]), v, 1e-4)


def test_one_o1_bf16_step():
    jm, tm = _pair(3)
    jl, tl, jstate, tstate, _, _ = _steps(jm, tm, [_batch(64, seed=5)],
                                          amp="O1")
    np.testing.assert_allclose(tl, jl, rtol=BF16)
    for k, v in jstate.items():
        _close(torch.from_numpy(tstate[k]), v, BF16)


def test_two_input_sizes_are_two_programs():
    """The bucketing contract: one program per input shape, no more."""
    _, tm = _pair(4)
    step = TStep(tm, lambda o, b, l: tm.loss(o, b, l),
                 TAdam(learning_rate=LR, parameters=tm.parameters()))
    for size in (32, 64, 32, 64, 32):
        x, box, lbl = _batch(size, seed=size)
        loss = step(torch.from_numpy(x), (torch.from_numpy(box),
                                          torch.from_numpy(lbl)))
        assert torch.isfinite(loss)
    assert step.programs == 2


def _heads(seed):
    """Head outputs of 2 images at 64 x 64 (2, 4 and 8 cells), with
    objectness spread so that some candidates clear conf_thresh."""
    rng = np.random.RandomState(seed)
    outs = []
    for cells in (2, 4, 8):
        o = rng.randn(2, 3, 9, cells, cells).astype(np.float32)
        o[:, :, 4] = o[:, :, 4] * 2.0 - 1.0
        outs.append(o.reshape(2, 27, cells, cells))
    return outs


@pytest.mark.parametrize("nms_type", ["hard", "matrix"])
def test_predict_matches_jax(nms_type):
    jm, tm = _pair(5)
    heads = _heads(6)
    im = np.array([[64, 64], [64, 60]], np.int32)
    kw = dict(conf_thresh=0.1, keep_top_k=40, nms_type=nms_type)
    jd, jc = jm.predict(tuple(paddle.to_tensor(h) for h in heads),
                        paddle.to_tensor(im), **kw)
    td, tc = tm.predict(tuple(torch.from_numpy(h) for h in heads),
                        torch.from_numpy(im), **kw)
    jd, jc = jd.numpy(), jc.numpy()
    assert td.shape == (2, 40, 6)
    np.testing.assert_array_equal(td[..., 0].numpy(), jd[..., 0])
    np.testing.assert_array_equal(tc.numpy(), jc)
    _close(td[..., 1:], jd[..., 1:], 1e-5)
    assert (jc > 0).all()
    with pytest.raises(ValueError, match="nms_type"):
        tm.predict(tuple(torch.from_numpy(h) for h in heads),
                   torch.from_numpy(im), nms_type="soft")

"""BatchNorm under data parallelism: the port on 2 gloo ranks against the
JAX package's data-parallel TrainStep on the global batch.

The JAX DataParallel and TrainStep(mesh=, sharding_plan=) shard the
global batch over dp and run one SPMD program, so a BatchNorm's mean is
the global batch's (the partitioner inserts the reduction). The first
test confirms that on a 2-device CPU mesh: the mesh step's loss and
running statistics equal the one-device step's on the whole batch, and
differ from a BatchNorm over each half. The port runs one process per
rank on its half of the batch; above one data rank its BatchNorm
averages the batch moments over the data axes (nn/functional/norm.py
batch_stat_scope), in TrainStep(mesh=) and in DataParallel, and
SyncBatchNorm does the same.

resnet18(num_classes=10), a global batch of 8x3x32x32 (4 a rank), f32,
Momentum(0.1, momentum 0.9, weight_decay 1e-4), softmax cross-entropy,
weights from a numpy seed (tests/torch_vision_weights.py). The JAX step runs 2 steps and writes the
state before each (parameters, running statistics, Momentum
velocities); this file is also the ranks' script (started by the port's
launcher with CUDA hidden), and each rank starts each of its steps from
that state, three ways: TrainStep over a dp mesh; the model converted to
SyncBatchNorm under DataParallel in an eager loop; and, as the control
that lets the test fail, TrainStep without a mesh (a local BatchNorm)
with its loss averaged over the ranks. The first two must give the JAX
step's loss (1e-5 relative), running statistics (1e-5) and updated
parameters (1e-4, the gradients' tolerance, relative to max(1,
max|ref|): see tests/test_torch_resnet_train.py) on both ranks; the
control must miss the loss and the statistics by more than 1e-3.
"""
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
B, STEPS, LR = 8, 2, 0.1
LOSS, BUF, PARAM = 1e-5, 1e-5, 1e-4


def _batch():
    rng = np.random.RandomState(0)
    x = rng.randn(B, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, (B,)).astype(np.int64)
    return x, y


# -- the rank side: torch and the port only -----------------------------------

def _rank_main(out_dir):
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as c
    from paddle_tpu_torch.models import load_jax_params
    from paddle_tpu_torch.nn import SyncBatchNorm
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.static import TrainStep
    from paddle_tpu_torch.vision.models import resnet18
    torch.set_num_threads(1)
    pt.set_device("cpu")
    env = dist.init_parallel_env()
    rank, n = env.rank, env.world_size
    data = np.load(os.path.join(out_dir, "states.npz"))
    x, y = _batch()
    half = B // n
    x = torch.from_numpy(x[rank * half:(rank + 1) * half])
    y = torch.from_numpy(y[rank * half:(rank + 1) * half])

    def state(s):
        pre = f"s{s}__"
        return {k[len(pre):]: data[k] for k in data.files
                if k.startswith(pre)}

    def velocity(s, name):
        return torch.from_numpy(data[f"v{s}__{name}"])

    def force(m, opt, names, s):
        load_jax_params(m, state(s))
        with torch.no_grad():
            for name, p in names:
                opt._state_of(p)["velocity"].copy_(velocity(s, name))

    def snapshot(m):
        return {k: v.detach().numpy().copy()
                for k, v in m.state_dict().items()}

    res = {"rank": rank}
    for way in ("step", "sync_dp", "local"):
        m = resnet18(num_classes=10, device="cpu")
        opt = Momentum(learning_rate=LR, momentum=0.9, weight_decay=1e-4,
                       parameters=list(m.parameters()))
        names = list(m.named_parameters())
        losses, states = [], []
        if way == "sync_dp":
            m = SyncBatchNorm.convert_sync_batchnorm(m)
            names = list(m.named_parameters())
            opt = Momentum(learning_rate=LR, momentum=0.9,
                           weight_decay=1e-4,
                           parameters=[p for _, p in names])
            dp = dist.DataParallel(m)
            for s in range(STEPS):
                force(m, opt, names, s)
                loss = cross_entropy(dp(x), y)
                loss.backward()
                dp.apply_collective_grads()
                opt.step()
                opt.clear_grad()
                losses.append(float(c.all_reduce(loss.detach().clone(),
                                                 op="avg")))
                states.append(snapshot(m))
        else:
            mesh = dist.get_mesh() if way == "step" else None
            st = TrainStep(m, cross_entropy, opt, mesh=mesh)
            for s in range(STEPS):
                force(m, opt, names, s)
                loss = st(x, y)
                if mesh is None:
                    loss = c.all_reduce(loss.clone(), op="avg")
                losses.append(float(loss))
                states.append(snapshot(m))
        res[way] = (losses, states)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
    sys.exit(0)


# -- the test side ----------------------------------------------------------------

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.distributed as jdist  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402
from torch_vision_weights import (ce64, jax_f64_steps,  # noqa: E402
                                  jax_vision_model, nearer_f64)


def _jax_step(mesh=None):
    m = jax_vision_model("resnet18")
    kw = {}
    if mesh is not None:
        kw = dict(mesh=mesh, sharding_plan=jdist.ShardingPlan(mesh,
                                                              zero_stage=0))
    step = JaxTrainStep(m, lambda o, y: JF.cross_entropy(o, y),
                        paddle.optimizer.Momentum(
                            learning_rate=LR, momentum=0.9,
                            parameters=m.parameters(), weight_decay=1e-4),
                        **kw)
    return m, step


def _state(m, step):
    step.sync_to_layer()
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _start_ranks(out_dir):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", __file__, str(out_dir)]
    return subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


def _finish_ranks(proc, out_dir, timeout=200):
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"2 ranks hung\n{log[-4000:]}")
    assert proc.returncode == 0, f"2 ranks failed\n{log[-6000:]}"
    out = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX dp step's 2 steps on the global batch (the state before
    each and after the last, the losses), then the ranks from those
    states."""
    out = tmp_path_factory.mktemp("bn_dp")
    mesh = jdist.build_mesh({"dp": 2}, devices=jax.devices()[:2])
    m, step = _jax_step(mesh)
    x, y = _batch()
    saved, states, losses = {}, [], []
    for s in range(STEPS):
        st = _state(m, step)
        states.append(st)
        saved.update({f"s{s}__{k}": v for k, v in st.items()})
        saved.update({f"v{s}__{k}": np.asarray(v["velocity"])
                      for k, v in step.opt_state.items()})
        losses.append(float(step(paddle.to_tensor(x),
                                 paddle.to_tensor(y.astype(np.int32)))))
    states.append(_state(m, step))
    np.savez(out / "states.npz", **saved)
    return (losses, states), _finish_ranks(_start_ranks(out), out)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _f64_step(state, x, y):
    """The one-device JAX step on the global batch in float64
    (jax_f64_steps, the cross-entropy in f64) from `state`, the JAX
    step's state before it: (loss, state after)."""
    (loss,), after = jax_f64_steps(
        jax_vision_model("resnet18"), ce64,
        lambda ps: paddle.optimizer.Momentum(
            learning_rate=LR, momentum=0.9, parameters=ps,
            weight_decay=1e-4),
        state, [(x, y.astype(np.int32))])
    return loss, after


def test_jax_dp_step_normalises_over_the_global_batch(runs):
    """The JAX step on a 2-device mesh (the `runs` fixture's first step)
    is the one-device step on the whole batch (loss 1e-6, running
    statistics 1e-6), not a BatchNorm over each device's half. Where the
    two part by more than that, the mesh step's value may lie no further
    from the one-device step in float64 than the one-device step's f32
    value does, and both within 1e-2 of it (torch_vision_weights
    nearer_f64): on some CPUs the two f32 losses lie 1.3e-6 apart,
    2.3e-6 and 3.5e-6 from the f64 one."""
    (jlosses, jstates), _ = runs
    x, y = _batch()
    m, step = _jax_step()
    loss = float(step(paddle.to_tensor(x),
                      paddle.to_tensor(y.astype(np.int32))))
    one = _state(m, step)
    ref = None
    if abs(jlosses[0] - loss) > 1e-6 * abs(loss):
        ref = _f64_step(jstates[0], x, y)
        ok, seen = nearer_f64(jlosses[0], loss, ref[0])
        assert ok, (jlosses[0], loss, seen)
    for k in one:
        if not k.endswith(("_mean", "_variance")):
            continue
        if _rel(jstates[1][k], one[k]) > 1e-6:
            if ref is None:
                ref = _f64_step(jstates[0], x, y)
            ok, seen = nearer_f64(jstates[1][k], one[k], ref[1][k])
            assert ok, (k, seen)
    # a BatchNorm over one half's samples has other statistics
    m = jax_vision_model("resnet18")
    m.train()
    m(paddle.to_tensor(x[:B // 2]))
    half = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    assert _rel(half["bn1._mean"], one["bn1._mean"]) > 1e-3


@pytest.mark.parametrize("way", ["step", "sync_dp"])
def test_batch_norm_over_dp_matches_jax_global_batch(runs, way):
    (jlosses, jstates), reports = runs
    for rep in reports:
        losses, states = rep[way]
        for s in range(STEPS):
            assert abs(losses[s] - jlosses[s]) <= LOSS * abs(jlosses[s]), \
                (way, s, losses[s], jlosses[s])
            want = jstates[s + 1]
            assert list(states[s]) == list(want)
            for k, w in want.items():
                tol = BUF if k.endswith(("_mean", "_variance")) else PARAM
                assert _rel(states[s][k], w) <= tol, \
                    (way, s, k, _rel(states[s][k], w))


def test_local_batch_norm_would_differ(runs):
    """The control: without the sync each rank normalises over its half,
    and the loss and the running statistics leave the JAX step's."""
    (jlosses, jstates), reports = runs
    losses, states = reports[0]["local"]
    assert abs(losses[0] - jlosses[0]) > 1e-3 * abs(jlosses[0])
    assert _rel(states[0]["layer4.1.bn2._mean"],
                jstates[1]["layer4.1.bn2._mean"]) > 1e-3

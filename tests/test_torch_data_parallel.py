"""Data parallel in the port (paddle_tpu_torch/distributed/parallel.py and
TrainStep(mesh=)) against the JAX package's data-parallel TrainStep, on
the CPU.

ERNIE with 2 layers, hidden 64, f32, dropout 0, Momentum, 3 steps of a
global batch of 4 (Momentum and not AdamW: AdamW divides by sqrt(v),
which turns the rounding noise of a gradient that is zero in exact
arithmetic, as the key bias's is, into steps of lr, far above 1e-5). The JAX reference is TrainStep(mesh={"dp": 2},
sharding_plan=ShardingPlan(mesh, zero_stage=0)) on the global batch
(its partitioner averages the grads of the global batch). The port runs
2 gloo ranks (this file is their script, started by the port's
launcher), each on its local half of the batch, four ways: TrainStep
over a dp mesh (the grads averaged inside the step); the same with the
comm planner's f32 sync as its grad_transform (the transform does the dp
reduction); DataParallel in an eager loop (apply_collective_grads); and
DataParallel with a CommConfig. Every way's per-step losses and final
parameters must be within 1e-5 of the JAX step's on both ranks, and the
ranks' parameters equal. DataParallel also broadcasts rank 0's weights
when it wraps (rank 1 starts from other weights). Every label is valid,
so the mean over the global batch is the mean of the ranks' means; the
loss has its NSP term, so every parameter has a gradient. With a
GradScaler over dp, an overflow on one rank skips the step on both.
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
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S, STEPS, LR = 4, 16, 3, 0.05


def _batches():
    """(ids, mlm labels, nsp labels) a step: the NSP head too has a
    gradient, so an eager step (which skips a parameter without one)
    updates what the compiled step updates."""
    rng = np.random.RandomState(3)
    return [(rng.randint(0, 1024, (B, S)).astype(np.int64),
             rng.randint(0, 1024, (B, S)).astype(np.int64),
             rng.randint(0, 2, (B,)).astype(np.int64))
            for _ in range(STEPS)]


# -- the rank side: torch and the port only -----------------------------------

def _rank_main(out_dir):
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as c
    from paddle_tpu_torch.distributed.comm import CommConfig
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        make_comm_sync_transform
    from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                         load_jax_params)
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.static import TrainStep
    torch.set_num_threads(1)
    pt.set_device("cpu")
    env = dist.init_parallel_env()
    rank, n = env.rank, env.world_size
    init = dict(np.load(os.path.join(out_dir, "init.npz")))
    half = B // n
    local = [tuple(torch.from_numpy(a[rank * half:(rank + 1) * half])
                   for a in batch) for batch in _batches()]

    def model():
        m = ErnieForPretraining(ErnieConfig.tiny(**NO_DROP), device="cpu")
        return load_jax_params(m, init)

    def opt(m):
        return Momentum(learning_rate=LR, momentum=0.9,
                        parameters=m.parameters())

    loss_fn = ErnieForPretraining.pretraining_loss
    res = {"rank": rank}
    for way in ("step", "step_comm", "eager", "eager_comm"):
        m = model()
        losses = []
        if way.startswith("step"):
            kw = {}
            if way == "step_comm":
                init_fn, fn = make_comm_sync_transform(CommConfig())
                kw = dict(grad_transform=fn, strategy_state=init_fn(
                    dict(m.named_parameters())))
            st = TrainStep(m, loss_fn, opt(m), mesh=dist.get_mesh(), **kw)
            for x, y, nsp in local:
                losses.append(float(st(x, (y, nsp))))
        else:
            if rank == 1:       # DataParallel takes rank 0's weights
                with torch.no_grad():
                    for p in m.parameters():
                        p.add_(1.0)
            dp = dist.DataParallel(
                m, comm_config=CommConfig() if way == "eager_comm" else None)
            o = opt(m)
            for x, y, nsp in local:
                loss = dp.scale_loss(loss_fn(dp(x), y, nsp))
                loss.backward()
                dp.apply_collective_grads()
                o.step()
                o.clear_grad()
                losses.append(float(c.all_reduce(loss.detach().clone(),
                                                 op="avg")))
        res[way] = (losses, {k: v.numpy() for k, v in m.state_dict().items()})
    # loss scaling over dp: an overflow on rank 0 alone skips the step on
    # both ranks, as the global batch's finite check would
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import SGD
    pt.seed(1)
    lin = Linear(4, 2, device="cpu")
    st = TrainStep(lin, lambda o, y: ((o - y) ** 2).mean(),
                   SGD(learning_rate=0.1, parameters=lin.parameters()),
                   scaler=GradScaler(init_loss_scaling=2.0 ** 10),
                   mesh=dist.get_mesh())
    before = [p.detach().clone() for p in lin.parameters()]
    x = torch.ones(2, 4) * (1e30 if rank == 0 else 1.0)
    st(x, torch.zeros(2, 2))
    skipped = [torch.equal(a, b) for a, b in zip(before, lin.parameters())]
    st(torch.ones(2, 4), torch.zeros(2, 2))
    res["overflow"] = dict(
        skipped=skipped, amp_skipped=int(st.strategy_state["amp_skipped"]),
        scale=float(st.strategy_state["amp_scale"]),
        after=[p.detach().numpy().copy() for p in lin.parameters()])
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
from paddle_tpu.models import ErnieConfig as JaxConfig  # noqa: E402
from paddle_tpu.models import ErnieForPretraining as JaxErnie  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402


def start_ranks(n, out_dir):
    """This file run as `n` gloo ranks by the port's launcher (CUDA
    hidden, one torch thread each), in the background."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(n), __file__, str(out_dir)]
    return subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


def finish_ranks(proc, n, out_dir, timeout=150):
    """Each rank's pickled result. A hang fails at `timeout` (the process
    group killed)."""
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"{n} ranks hung\n{log[-4000:]}")
    assert proc.returncode == 0, f"{n} ranks failed\n{log[-6000:]}"
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    paddle.seed(0)
    jm = JaxErnie(JaxConfig.tiny(**NO_DROP))
    init = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    np.savez(out / "init.npz", **init)
    proc = start_ranks(2, out)      # the ranks run beside the JAX step
    mesh = jdist.build_mesh({"dp": 2}, devices=jax.devices()[:2])
    step = JaxTrainStep(
        jm, lambda o, y, nsp: JaxErnie.pretraining_loss(o, y, nsp),
        paddle.optimizer.Momentum(learning_rate=LR, momentum=0.9),
        mesh=mesh, sharding_plan=jdist.ShardingPlan(mesh, zero_stage=0))
    losses = [float(step(paddle.to_tensor(x.astype(np.int32)),
                         (paddle.to_tensor(y.astype(np.int32)),
                          paddle.to_tensor(nsp.astype(np.int32)))))
              for x, y, nsp in _batches()]
    final = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return (losses, final, init), finish_ranks(proc, 2, out)


@pytest.mark.parametrize("way", ["step", "step_comm", "eager", "eager_comm"])
def test_data_parallel_matches_jax_dp_step(runs, way):
    (jlosses, jfinal, init), reports = runs
    for rep in reports:
        losses, state = rep[way]
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-5)
        assert sorted(state) == sorted(jfinal)
        for k, v in jfinal.items():
            np.testing.assert_allclose(state[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{way} {k}")
    moved = [k for k in jfinal if not np.array_equal(jfinal[k], init[k])]
    assert len(moved) > len(jfinal) // 2
    a, b = (rep[way][1] for rep in reports)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_data_parallel_refuses_a_plan_and_keeps_the_layer_surface():
    import torch
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.distributed import MeshPlan
    lin = Linear(3, 2, device="cpu")
    # plan= is taken since the planner (item 14a): no process group, so
    # the plan's data axes have no group and there is nothing to sync
    planned = DataParallel(lin, plan=MeshPlan(dp=1))
    assert planned._data_groups() == []
    dp = DataParallel(lin)           # no process group: nothing to sync
    assert list(dp.state_dict()) == list(lin.state_dict())
    x = torch.randn(4, 3)
    assert torch.equal(dp(x), lin(x))
    dp(x).sum().backward()
    g = lin.weight.grad.clone()
    dp.apply_collective_grads()
    assert torch.equal(lin.weight.grad, g)


def test_an_overflow_on_one_rank_skips_the_step_on_every_rank(runs):
    _, reports = runs
    for rep in reports:
        ov = rep["overflow"]
        assert ov["skipped"] == [True, True]
        assert ov["amp_skipped"] == 1 and ov["scale"] == 2.0 ** 9
    for a, b in zip(reports[0]["overflow"]["after"],
                    reports[1]["overflow"]["after"]):
        np.testing.assert_array_equal(a, b)

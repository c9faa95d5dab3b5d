"""The port's fleet (paddle_tpu_torch/distributed/fleet/: base.py,
meta_optimizers.py, metrics/metric.py, utils/fs.py) against the JAX
package's, on the CPU.

In one process: the StrategyCompiler's chains and the flags it disables
over every strategy of one to three meta-optimizers, the mesh shapes,
the refusals that wait for item 14, LocalFS, and build_train_step at
world size 1 with amp, gradient_merge, dgc, fp16_allreduce and comm
(int8_ef) against the JAX fleet's step (whose mesh spans its 8 host
devices: the same global-batch gradients).

On 2 gloo ranks (this file is their script, started by the port's
launcher), each on its half of the batch: build_train_step with the same
strategies (comm in f32: with the dp sum on the wire, a quantized tier
rounds other values than the JAX step, whose dp reduction is the
partitioner's) against the JAX fleet step over a dp mesh of 2; LocalSGD
with k 2 against the JAX LocalSGDStep's replicas; the fleet metrics
against the JAX metrics of the summed statistics.

A two-layer tanh MLP (8 -> 16 -> 4), MSE, Momentum (lr 0.05), 3 steps of
16 rows. Tolerances: 1e-5, except under O1 AMP, where the two
frameworks round to bf16 at other places: 2e-2 relative on the losses
(as tests/test_torch_training.py holds O1) and 5e-3 on the parameters.
"""
import itertools
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
LR, STEPS, BATCH = 0.05, 3, 16
CASES = ("amp", "gradient_merge", "dgc", "fp16_allreduce", "comm")
LOOSE = ("amp",)


def _data():
    rng = np.random.RandomState(4)
    return [(rng.randn(BATCH, 8).astype(np.float32),
             rng.randn(BATCH, 4).astype(np.float32)) for _ in range(STEPS)]


def _configure(strategy, case, world):
    """One case's strategy, set on either package's DistributedStrategy."""
    strategy.hybrid_configs = dict(strategy.hybrid_configs, dp_degree=world)
    if case == "amp":
        strategy.amp = True
    elif case == "gradient_merge":
        strategy.gradient_merge = True
        strategy.gradient_merge_configs = {"k_steps": 2, "avg": True}
    elif case == "dgc":
        strategy.dgc = True
        strategy.dgc_configs = {"rampup_begin_step": 1, "rampup_step": 1,
                                "sparsity": [0.5]}
    elif case == "fp16_allreduce":
        strategy.fp16_allreduce = True
    elif case == "comm":
        strategy.comm_opt = True
        strategy.comm_opt_configs = dict(
            strategy.comm_opt_configs, bucket_mb=1e-4,
            compress="int8_ef" if world == 1 else "f32")
    elif case == "localsgd":
        strategy.localsgd = True
        strategy.localsgd_configs = {"k_steps": 2, "begin_step": 1}
    return strategy


def _stats():
    """Per-rank metric statistics of 2 ranks."""
    rng = np.random.RandomState(9)
    return [dict(correct=np.array([rng.randint(0, 50)]),
                 total=np.array([60]),
                 abserr=np.array([rng.rand() * 10]),
                 sqrerr=np.array([rng.rand() * 20]),
                 n=np.array([rng.randint(20, 40)]),
                 pos=rng.randint(0, 9, 16), neg=rng.randint(0, 9, 16),
                 vec=rng.randn(5)) for _ in range(2)]


# -- the rank side: torch and the port only -----------------------------------

def _port_mlp(init):
    import torch
    from paddle_tpu_torch import nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__(device="cpu")
            self.fc1 = nn.Linear(8, 16, device="cpu")
            self.fc2 = nn.Linear(16, 4, device="cpu")

        def forward(self, x):
            return self.fc2(torch.tanh(self.fc1(x)))

    m = MLP()
    m.set_state_dict(init)
    return m


def _port_run(case, world, rank, init):
    """The port's fleet step for `case`: (losses, final params)."""
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import Momentum
    strategy = _configure(fleet.DistributedStrategy(), case, world)
    fleet.fleet._initialized = False
    fleet.init(is_collective=True, strategy=strategy)
    m = _port_mlp(init)
    opt = fleet.distributed_optimizer(
        Momentum(learning_rate=LR, momentum=0.9, parameters=m.parameters()))
    step = opt.build_train_step(m, lambda o, y: ((o - y) ** 2).mean())
    rows = BATCH // world
    losses = []
    for x, y in _data():
        losses.append(float(step(
            torch.from_numpy(x[rank * rows:(rank + 1) * rows]),
            torch.from_numpy(y[rank * rows:(rank + 1) * rows]))))
    return losses, {k: v.detach().numpy().copy()
                    for k, v in m.state_dict().items()}


def _rank_main(out_dir):
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import get_rank
    from paddle_tpu_torch.distributed.fleet.metrics import metric
    torch.set_num_threads(1)
    pt.set_device("cpu")
    init = dict(np.load(os.path.join(out_dir, "init.npz")))
    res = {}
    for c in CASES + ("localsgd",):
        res[c] = _port_run(c, 2, int(os.environ["RANK"]), init)
    rank = get_rank()
    st = _stats()[rank]
    before = {k: v.copy() for k, v in st.items()}
    res["metrics"] = dict(
        acc=metric.acc(st["correct"], st["total"]),
        mae=metric.mae(st["abserr"], st["n"]),
        rmse=metric.rmse(st["sqrerr"], st["n"]),
        auc=metric.auc(st["pos"], st["neg"]),
        sum=metric.sum(st["vec"]), max=metric.max(st["vec"]),
        min=metric.min(st["vec"]),
        tensor_sum=metric.sum(torch.from_numpy(st["vec"])).numpy())
    res["inputs_kept"] = all(np.array_equal(before[k], st[k]) for k in st)
    res["rank"] = rank
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
    sys.exit(0)


# -- the test side ----------------------------------------------------------------

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.distributed as jdist  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.distributed.fleet import meta_optimizers as jmeta  # noqa: E402
from paddle_tpu_torch.distributed import fleet as pfleet  # noqa: E402
from paddle_tpu_torch.distributed import env as penv  # noqa: E402
from paddle_tpu_torch.distributed.fleet import meta_optimizers as pmeta  # noqa: E402


@pytest.fixture(autouse=True)
def _restore_globals():
    """fleet.init installs a global mesh and a fleet state in each
    package; tier-1 shares a worker across files."""
    jmesh, pmesh = jdist.get_mesh(), penv.get_mesh()
    saved = [(f, dict(f.__dict__)) for f in (jfleet.fleet, pfleet.fleet)]
    yield
    jdist.set_mesh(jmesh)
    penv.set_mesh(pmesh)
    for f, d in saved:
        f.__dict__.clear()
        f.__dict__.update(d)


def _jax_mlp(seed=5):
    import paddle_tpu.nn as jnn

    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(8, 16)
            self.fc2 = jnn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(paddle.tanh(self.fc1(x)))

    paddle.seed(seed)
    return MLP()


def _jax_run(case, world):
    """The JAX fleet step for `case` on the global batch: (losses, final
    params; for LocalSGD each replica's), and the initial weights."""
    m = _jax_mlp()
    init = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    strategy = _configure(jfleet.DistributedStrategy(), case, world)
    jfleet.fleet._initialized = False
    jfleet.init(is_collective=True, strategy=strategy)
    opt = jfleet.distributed_optimizer(paddle.optimizer.Momentum(
        learning_rate=LR, momentum=0.9, parameters=m.parameters()))
    step = opt.build_train_step(m, lambda o, y: ((o - y) ** 2).mean())
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for x, y in _data()]
    if case == "localsgd":
        final = {k: np.asarray(v) for k, v in step.params.items()}
    else:
        final = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    return losses, final, init


def _close(case, got, want):
    (gl, gp), (wl, wp) = got, want
    rtol, ptol = (2e-2, 5e-3) if case in LOOSE else (1e-5, 1e-5)
    np.testing.assert_allclose(gl, wl, rtol=rtol, atol=1e-5)
    assert sorted(gp) == sorted(wp)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], rtol=ptol, atol=ptol,
                                   err_msg=f"{case} {k}")


# -- in one process ---------------------------------------------------------------

FLAGS = ("amp", "recompute", "sharding", "pipeline", "tensor_parallel",
         "gradient_merge", "lamb", "lars", "localsgd", "adaptive_localsgd",
         "dgc", "fp16_allreduce", "comm_opt")


@pytest.mark.parametrize("size", [1, 2, 3])
def test_strategy_compiler_chains_equal_jax(size):
    for flags in itertools.combinations(FLAGS, size):
        seen = []
        for fl in (jfleet, pfleet):
            s = fl.DistributedStrategy()
            for f in flags:
                setattr(s, f, True)
            mod = jmeta if fl is jfleet else pmeta
            chain = mod.StrategyCompiler().generate_optimizer(s)
            seen.append(([m.name for m in chain],
                         {f: bool(getattr(s, f)) for f in FLAGS}))
        assert seen[0] == seen[1], flags


def test_mesh_shapes_equal_jax():
    for hybrid in ({}, {"dp_degree": 2}, {"mp_degree": 2},
                   {"pp_degree": 2, "mp_degree": 2}, {"sep_degree": 2},
                   {"fsdp_degree": 2, "dp_degree": 2}):
        for n in (1, 2, 4, 8):
            shapes = []
            for fl in (jfleet, pfleet):
                s = fl.DistributedStrategy()
                s.hybrid_configs = dict(s.hybrid_configs, **hybrid)
                shapes.append(s.mesh_shape(n))
            assert shapes[0] == shapes[1], (hybrid, n)


def test_refusals_cite_item_14():
    """What waits for item 14 now is the pipeline (14b): build_pipeline
    and the pipeline meta-optimizer above degree 1. The planner hooks
    (build_mesh_plan, build_sharding_plan, DistributedStrategy.mesh_plan)
    and the tensor-parallel meta-optimizer came with 14a and run."""
    s = pfleet.DistributedStrategy()
    with pytest.raises(NotImplementedError, match="item 14b"):
        pfleet.fleet.build_pipeline([], None, None)
    assert s.mesh_plan(1).sizes == {"dp": 1, "fsdp": 1, "tp": 1, "pp": 1}
    assert pfleet.fleet.build_mesh_plan().n_devices == 1
    assert pfleet.fleet.build_sharding_plan().zero_stage == 0
    spec = pmeta.TrainStepSpec(layer=None, loss_fn=None, optimizer=None)
    for flag, cfg in (("tensor_parallel", {"tensor_parallel_degree": 2}),
                      ("pipeline", None)):
        s = pfleet.DistributedStrategy()
        setattr(s, flag, True)
        if cfg:
            s.tensor_parallel_configs = cfg
            pmeta.StrategyCompiler().compile(spec, s)
            assert "tensor_parallel" in spec.applied
        else:
            s.hybrid_configs = dict(s.hybrid_configs, pp_degree=2)
            with pytest.raises(NotImplementedError, match="item 14b"):
                pmeta.StrategyCompiler().compile(spec, s)


def test_local_fs_equals_jax(tmp_path):
    from paddle_tpu.distributed.fleet.utils.fs import LocalFS as JFS
    from paddle_tpu_torch.distributed.fleet.utils.fs import LocalFS as PFS
    seen = []
    for name, fs in (("j", JFS()), ("p", PFS())):
        root = tmp_path / name
        log = []
        fs.mkdirs(str(root / "a" / "b"))
        fs.touch(str(root / "a" / "f.txt"))
        log.append(fs.ls_dir(str(root / "a")))
        log.append((fs.is_file(str(root / "a" / "f.txt")),
                    fs.is_dir(str(root / "a" / "b")),
                    fs.is_exist(str(root / "nope"))))
        fs.rename(str(root / "a" / "f.txt"), str(root / "a" / "g.txt"))
        fs.mv(str(root / "a" / "g.txt"), str(root / "h.txt"))
        log.append(sorted(os.listdir(root)))
        fs.delete(str(root / "a"))
        log.append((fs.is_exist(str(root / "a")),
                    fs.list_dirs(str(root))))
        seen.append(log)
    assert seen[0] == seen[1]


@pytest.mark.parametrize("case", CASES)
def test_build_train_step_world_one(case):
    jl, jp, init = _jax_run(case, 1)
    got = _port_run(case, 1, 0, init)
    _close(case, got, (jl, jp))
    assert pfleet.fleet._last_applied == jfleet.fleet._last_applied


# -- on 2 ranks -------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet2")
    np.savez(out / "init.npz", **{k: np.asarray(v.numpy()) for k, v in
                                  _jax_mlp().state_dict().items()})
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", __file__, str(out)]
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    # the JAX references run beside the ranks
    jax_runs = {c: _jax_run(c, 2) for c in CASES + ("localsgd",)}
    try:
        log, _ = proc.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"fleet ranks hung\n{log[-4000:]}")
    assert proc.returncode == 0, f"fleet ranks failed\n{log[-6000:]}"
    reports = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            reports.append(pickle.load(f))
    return jax_runs, reports


@pytest.mark.parametrize("case", CASES)
def test_build_train_step_two_ranks(two_ranks, case):
    jax_runs, reports = two_ranks
    jl, jp, _ = jax_runs[case]
    for rep in reports:
        _close(case, rep[case], (jl, jp))


def test_local_sgd_k2_two_ranks(two_ranks):
    jax_runs, reports = two_ranks
    jl, jp, _ = jax_runs["localsgd"]
    np.testing.assert_allclose(reports[0]["localsgd"][0], jl, rtol=1e-5)
    for rep in reports:
        r = rep["rank"]
        _close("localsgd", (rep["localsgd"][0], rep["localsgd"][1]),
               (jl, {k: v[r] for k, v in jp.items()}))
    # step 3 was local: the replicas differ again
    a, b = (rep["localsgd"][1] for rep in reports)
    assert any(not np.array_equal(a[k], b[k]) for k in a)


def test_fleet_metrics_two_ranks(two_ranks):
    from paddle_tpu.distributed.fleet.metrics import metric as jm
    _, reports = two_ranks
    st = _stats()
    tot = {k: st[0][k] + st[1][k] for k in st[0]}
    want = dict(acc=jm.acc(tot["correct"], tot["total"]),
                mae=jm.mae(tot["abserr"], tot["n"]),
                rmse=jm.rmse(tot["sqrerr"], tot["n"]),
                auc=jm.auc(tot["pos"], tot["neg"]),
                sum=tot["vec"],
                max=np.maximum(st[0]["vec"], st[1]["vec"]),
                min=np.minimum(st[0]["vec"], st[1]["vec"]))
    for rep in reports:
        got = rep["metrics"]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(got["tensor_sum"], tot["vec"],
                                   rtol=1e-12)
        assert rep["inputs_kept"]


def test_fleet_metrics_identity_at_world_size_one():
    from paddle_tpu.distributed.fleet.metrics import metric as jm
    from paddle_tpu_torch.distributed.fleet.metrics import metric as pm
    s = _stats()[0]
    for name, args in (("acc", ("correct", "total")), ("mae", ("abserr", "n")),
                       ("rmse", ("sqrerr", "n")), ("auc", ("pos", "neg"))):
        assert getattr(pm, name)(*(s[a] for a in args)) == \
            getattr(jm, name)(*(s[a] for a in args))
    for name in ("sum", "max", "min"):
        np.testing.assert_array_equal(getattr(pm, name)(s["vec"]),
                                      getattr(jm, name)(s["vec"]))


@pytest.mark.parametrize("case", ["dgc", "comm"])
def test_strategy_state_rides_the_checkpoint(case, tmp_path):
    """A grad transform's state (DGC's nested buffers, int8_ef residuals)
    travels in TrainStep.state_dict, through a checkpoint file, and is
    restored into the live tensors in place: the steps after a restore
    repeat the steps after the save bit for bit."""
    import torch
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.optimizer import Momentum
    _, _, init = _jax_run(case, 1)
    strategy = _configure(pfleet.DistributedStrategy(), case, 1)
    pfleet.fleet._initialized = False
    pfleet.init(is_collective=True, strategy=strategy)
    m = _port_mlp(init)
    step = pfleet.distributed_optimizer(Momentum(
        learning_rate=LR, momentum=0.9, parameters=m.parameters())
    ).build_train_step(m, lambda o, y: ((o - y) ** 2).mean())
    data = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in _data()]
    step(*data[0])
    ck.save_sharded(step.state_dict(), str(tmp_path / "s"))
    live = {id(t) for t in _tensors(step.strategy_state)}
    assert live
    first = [float(step(*d)) for d in data[1:]]
    step.set_state_dict(ck.load_sharded(str(tmp_path / "s")))
    assert {id(t) for t in _tensors(step.strategy_state)} == live
    assert [float(step(*d)) for d in data[1:]] == first


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []

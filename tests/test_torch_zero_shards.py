"""TrainStep under ZeRO and fsdp on 2 gloo ranks against the JAX
TrainStep with the same plan over 2 host devices:

- Lamb and Lars under ZeRO-1 and fsdp: the update of a shard takes the
  whole tensor's norms (each block's squared norms summed over its ranks,
  Optimizer._norms), as the JAX step's update on whole arrays does;
- ZeRO-3 and fsdp hold each parameter as this rank's block between
  steps: the bytes a rank keeps in the layer's parameters are half the
  whole model's, every gradient collective of a step is a reduce-scatter
  (counted through the comm layer's schedule capture,
  distributed/collective.py _record), and state_dict/set_state_dict
  still take and give whole tensors.

- hapi.Model under ZeRO-3 and fsdp: fit (with eval_data), evaluate and
  predict run on whole parameters, save writes whole tensors (the
  optimizer's state too) and load cuts them back; the layer's own
  state_dict() and a no_grad forward give whole tensors and values.

A small MLP (8 -> 16 -> 4, tanh, squared error) takes 4 steps on a
global batch of 8 (each rank its 4 rows). The 4 losses (the last sees
the third update) are held at 1e-5; the weights after the 4 updates
elementwise at 5% of the smaller of their whole move from the start and
the learning rate, plus 1e-5 (the ranks reduce in another order than
XLA, and an adaptive update turns a rounding-level difference into a
larger one; a move held at 5% of itself still fails an update that did
nothing or went wrong). The hapi
cases take 4 Adam steps (2 epochs of 2 batches of 4, the same batches
on both ranks) against the JAX Model on one device: losses, evaluation
and predictions at 1e-5.

This file is also the ranks' script: above the __main__ guard it
imports torch and the port only.
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
STEPS, TOL = 4, 1e-5
# name -> (optimizer, its learning rate, plan kind, ZeRO stage)
CASES = {"lamb_zero1": ("Lamb", 0.01, "dp", 1),
         "lars_zero1": ("Lars", 1.0, "dp", 1),
         "lamb_fsdp": ("Lamb", 0.01, "fsdp", 0),
         "lars_fsdp": ("Lars", 1.0, "fsdp", 0),
         "adam_zero3": ("Adam", 0.01, "dp", 3),
         "adam_fsdp": ("Adam", 0.01, "fsdp", 0)}
RESIDENT = ("adam_zero3", "adam_fsdp", "lamb_fsdp", "lars_fsdp")
#: hapi.Model cases: plan kind -> ZeRO stage
HAPI = {"zero3": ("dp", 3), "fsdp": ("fsdp", 0)}
PARAMS = ("0.weight", "0.bias", "2.weight", "2.bias")


def _inputs():
    rng = np.random.RandomState(0)
    return {"0.weight": rng.randn(8, 16).astype(np.float32) * 0.4,
            "0.bias": rng.randn(16).astype(np.float32) * 0.1,
            "2.weight": rng.randn(16, 4).astype(np.float32) * 0.4,
            "2.bias": rng.randn(4).astype(np.float32) * 0.1,
            "x": rng.randn(8, 8).astype(np.float32),
            "y": rng.randn(8, 4).astype(np.float32)}


def _rows(mod, g):
    """The (x, y) rows as a Dataset of the package `mod`'s io."""
    return type("Rows", (mod.Dataset,), {
        "__len__": lambda self: len(g["x"]),
        "__getitem__": lambda self, i: (g["x"][i], g["y"][i])})()


def _recorder(base):
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"][0])
    return Rec()


def _opt(mod, name, lr, params=None):
    kw = {"parameters": params} if params is not None else {}
    if name == "Lars":
        return mod.Lars(lr, lars_coeff=0.01, **kw)
    return getattr(mod, name)(learning_rate=lr, **kw)


# -- the rank side: torch and the port only -----------------------------------

def _mesh_plan(dist, kind, zero):
    if kind == "fsdp":
        mp = dist.MeshPlan(fsdp=2)
        mesh, plan = mp.build_mesh(), mp.sharding_plan()
    else:
        mesh = dist.build_mesh({"dp": 2})
        plan = dist.ShardingPlan(mesh, zero_stage=zero)
    dist.set_mesh(mesh)
    return plan


def _net(pt, g):
    nn = pt.nn
    m = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.Tanh(),
                      nn.Linear(16, 4, device="cpu"))
    m.set_state_dict({k: g[k] for k in PARAMS})
    return m


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _rank_case(name, g, pt, dist):
    import torch
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.static import TrainStep
    opt_name, lr, kind, zero = CASES[name]
    plan = _mesh_plan(dist, kind, zero)
    m = _net(pt, g)
    whole = sum(p.numel() * p.element_size() for p in m.parameters())
    step = TrainStep(m, _mse, _opt(pt.optimizer, opt_name, lr),
                     sharding_plan=plan)
    x, y = plan.place_batch((torch.from_numpy(g["x"]),
                             torch.from_numpy(g["y"])))
    losses = [float(step(x, y))]
    coll._schedule_capture = []
    losses.append(float(step(x, y)))
    ops = [(e["op"], e["axis"]) for e in coll._schedule_capture]
    coll._schedule_capture = None
    losses += [float(step(x, y)) for _ in range(STEPS - 2)]
    held = sum(p.numel() * p.element_size() for p in m.parameters())
    full = step.state_dict()
    shapes = {k: tuple(v.shape) for k, v in full["model"].items()}
    step.set_state_dict(full)
    again = step.state_dict()
    same = all(torch.equal(full["model"][k], again["model"][k])
               for k in full["model"])
    out = dict(losses=losses, whole=whole, held=held, ops=ops,
               shapes=shapes, roundtrip=same, resident=len(step._resident),
               model={k: v.numpy() for k, v in full["model"].items()})
    dist.set_mesh(None)
    return out


def _rank_hapi(kind, g, pt, dist, path):
    """hapi.Model under a plan whose parameters are resident shards:
    fit with eval_data, evaluate, predict, save, the layer's own views,
    and load into a fresh Model (one more epoch on both)."""
    import torch
    stage = HAPI[kind]
    plan = _mesh_plan(dist, *stage)

    def model():
        m = _net(pt, g)
        md = pt.Model(m)
        md.prepare(pt.optimizer.Adam(learning_rate=0.01,
                                     parameters=m.parameters()),
                   loss=_mse, sharding_plan=plan)
        return m, md

    m, md = model()
    whole = sum(g[k].nbytes for k in PARAMS)
    rec = _recorder(pt.hapi.Callback)
    md.fit(_rows(pt.io, g), eval_data=_rows(pt.io, g), batch_size=4,
           epochs=2, shuffle=False, verbose=0, callbacks=[rec])
    held = sum(p.numel() * p.element_size() for p in m.parameters())
    ev = md.evaluate(_rows(pt.io, g), batch_size=4, verbose=0)["loss"][0]
    pred = md.predict(_rows(pt.io, g), batch_size=8, stack_outputs=True)[0]
    with torch.no_grad():
        direct = m(torch.from_numpy(g["x"])).numpy()
    try:
        m(torch.from_numpy(g["x"]))
        refused = False
    except RuntimeError:
        refused = True
    own = {k: v.numpy() for k, v in m.state_dict().items()}
    md.save(path)
    saved = {k: np.asarray(v)
             for k, v in pt.load(path + ".pdparams").items()}
    opt = pt.load(path + ".pdopt")
    moments = {k: tuple(v["moment1"].shape) for k, v in opt.items()
               if k.startswith("param_")}
    m2, fresh = model()
    fresh.load(path)
    ev2 = fresh.evaluate(_rows(pt.io, g), batch_size=4, verbose=0)["loss"][0]
    more = [_recorder(pt.hapi.Callback) for _ in range(2)]
    for mdl, r in ((md, more[0]), (fresh, more[1])):
        mdl.fit(_rows(pt.io, g), batch_size=4, epochs=1, shuffle=False,
                verbose=0, callbacks=[r])
    # prepared again: the new step takes the layer's parameters whole
    before = {k: v.numpy() for k, v in m.state_dict().items()}
    md.prepare(pt.optimizer.Adam(learning_rate=0.01,
                                 parameters=m.parameters()),
               loss=_mse, sharding_plan=plan)
    kept = all(np.array_equal(v.numpy(), before[k])
               for k, v in m.state_dict().items())
    again = _recorder(pt.hapi.Callback)
    md.fit(_rows(pt.io, g), batch_size=4, epochs=1, shuffle=False,
           verbose=0, callbacks=[again])
    held_again = sum(p.numel() * p.element_size() for p in m.parameters())
    dist.set_mesh(None)
    return dict(losses=rec.losses, whole=whole, held=held, eval=ev,
                pred=pred, direct=direct, refused=refused, own=own,
                saved=saved, moments=moments, eval_loaded=ev2,
                more=[r.losses for r in more], kept=kept,
                again=again.losses, held_again=held_again)


def _rank_main(out_dir):
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    torch.set_num_threads(1)
    pt.set_device("cpu")
    dist.init_parallel_env()
    rank = dist.get_rank()
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    g = {k: data[k] for k in data.files}
    res = {"rank": rank, "cases": {n: _rank_case(n, g, pt, dist)
                                   for n in CASES},
           "hapi": {k: _rank_hapi(k, g, pt, dist, os.path.join(
               out_dir, f"hapi_{k}_{rank}")) for k in HAPI}}
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


def _launch_once(out_dir, timeout=180):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", __file__, str(out_dir)]
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"2 ranks hung\n{log[-4000:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"2 ranks failed\n{log[-6000:]}")
    out = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results (a launch that fails is made once more:
    the rendezvous port may be taken by another test's launch)."""
    d = tmp_path_factory.mktemp("zero")
    np.savez(d / "inputs.npz", **_inputs())
    try:
        return _launch_once(d)
    except RuntimeError as first:
        try:
            return _launch_once(d)
        except RuntimeError as second:
            raise AssertionError(f"{first}\n-- again --\n{second}")


_JAX = {}


def _jax_case(name):
    if name in _JAX:
        return _JAX[name]
    from paddle_tpu.distributed.sharding import MeshPlan, ShardingPlan
    from paddle_tpu.static import TrainStep as JStep
    g = _inputs()
    opt_name, lr, kind, zero = CASES[name]
    if kind == "fsdp":
        mp = MeshPlan(fsdp=2)
        mesh, plan = mp.build_mesh(devices=jax.devices()[:2]), \
            mp.sharding_plan()
    else:
        mesh = jdist.build_mesh({"dp": 2}, devices=jax.devices()[:2])
        plan = ShardingPlan(mesh, zero_stage=zero)
    jdist.set_mesh(mesh)
    nn = paddle.nn
    m = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
    m.set_state_dict({k: g[k] for k in PARAMS})
    step = JStep(m, lambda out, y: paddle.mean((out - y) ** 2),
                 _opt(paddle.optimizer, opt_name, lr, m.parameters()),
                 mesh=mesh, sharding_plan=plan)
    x, y = paddle.to_tensor(g["x"]), paddle.to_tensor(g["y"])
    losses = [float(step(x, y).numpy()) for _ in range(STEPS)]
    model = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    jdist.set_mesh(None)
    _JAX[name] = (losses, model, lr)
    return _JAX[name]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_equals_jax(ranks, name):
    want_losses, want_model, lr = _jax_case(name)
    start = _inputs()
    for rep in ranks:
        got = rep["cases"][name]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=TOL,
                                   atol=TOL, err_msg=name)
        assert got["roundtrip"], name
        assert sorted(got["model"]) == sorted(want_model)
        for k, v in want_model.items():
            err = np.abs(got["model"][k] - v)
            lim = 0.05 * np.minimum(np.abs(v - start[k]), lr) + TOL
            assert (err <= lim).all(), (name, k, float((err / lim).max()))


@pytest.mark.parametrize("name", RESIDENT)
def test_stage3_and_fsdp_hold_shards_and_reduce_scatter(ranks, name):
    """Between steps a rank's parameters hold half the model's bytes;
    one step's gradient collectives over the sharded axis are
    reduce-scatters, one a parameter, and none is an all-reduce;
    state_dict gives whole tensors."""
    axis = "fsdp" if "fsdp" in name else "dp"
    for rep in ranks:
        got = rep["cases"][name]
        assert got["resident"] == 4, name
        assert got["held"] * 2 == got["whole"], (got["held"], got["whole"])
        on_axis = [op for op, ax in got["ops"] if ax == axis]
        assert on_axis == ["reduce_scatter"] * 4, got["ops"]
        assert got["shapes"] == {"0.weight": (8, 16), "0.bias": (16,),
                                 "2.weight": (16, 4), "2.bias": (4,)}


def test_zero1_keeps_whole_parameters(ranks):
    """ZeRO-1 shards the optimizer state only: the layer keeps its whole
    parameters and the gradients are all-reduced."""
    for rep in ranks:
        got = rep["cases"]["lamb_zero1"]
        assert got["resident"] == 0 and got["held"] == got["whole"]
        assert got["ops"] == [("allreduce_avg", "dp")]


_JAX_HAPI = []


def _jax_hapi():
    """The JAX Model on one device: 2 epochs with eval_data, evaluate,
    predict, one more epoch."""
    if _JAX_HAPI:
        return _JAX_HAPI[0]
    from paddle_tpu import hapi as jhapi
    g = _inputs()
    nn = paddle.nn
    m = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
    m.set_state_dict({k: g[k] for k in PARAMS})
    md = jhapi.Model(m)
    md.prepare(paddle.optimizer.Adam(learning_rate=0.01,
                                     parameters=m.parameters()),
               loss=lambda out, y: paddle.mean((out - y) ** 2))
    rec = _recorder(jhapi.Callback)
    md.fit(_rows(paddle.io, g), eval_data=_rows(paddle.io, g), batch_size=4,
           epochs=2, shuffle=False, verbose=0, callbacks=[rec])
    ev = md.evaluate(_rows(paddle.io, g), batch_size=4, verbose=0)["loss"][0]
    pred = md.predict(_rows(paddle.io, g), batch_size=8,
                      stack_outputs=True)[0]
    model = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    more = _recorder(jhapi.Callback)
    md.fit(_rows(paddle.io, g), batch_size=4, epochs=1, shuffle=False,
           verbose=0, callbacks=[more])
    md.prepare(paddle.optimizer.Adam(learning_rate=0.01,
                                     parameters=m.parameters()),
               loss=lambda out, y: paddle.mean((out - y) ** 2))
    again = _recorder(jhapi.Callback)
    md.fit(_rows(paddle.io, g), batch_size=4, epochs=1, shuffle=False,
           verbose=0, callbacks=[again])
    _JAX_HAPI.append(dict(losses=rec.losses, eval=ev, pred=pred,
                          model=model, more=more.losses,
                          again=again.losses))
    return _JAX_HAPI[0]


@pytest.mark.parametrize("kind", list(HAPI))
def test_hapi_model_on_resident_shards_equals_jax(ranks, kind):
    """fit (eval_data included), evaluate and predict on shards held
    between steps give the JAX Model's values; the layer keeps half the
    bytes; its state_dict(), a no_grad forward and Model.save give whole
    tensors (the optimizer's moments too); a grad forward outside the
    step is refused; a Model loaded from the file evaluates and trains
    on as the saved one does; prepared again, the Model's new step takes
    the parameters whole from the old one and trains on as the JAX
    Model does."""
    want = _jax_hapi()
    shapes = {k: v.shape for k, v in want["model"].items()}
    for rep in ranks:
        got = rep["hapi"][kind]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["eval"], want["eval"], rtol=TOL)
        np.testing.assert_allclose(got["pred"], want["pred"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["direct"], got["pred"], rtol=0,
                                   atol=0)
        assert got["held"] * 2 == got["whole"]
        assert got["refused"]
        for key in ("own", "saved"):
            assert {k: v.shape for k, v in got[key].items()} == shapes
        for k in shapes:
            np.testing.assert_array_equal(got["saved"][k], got["own"][k])
        assert sorted(got["moments"].values()) == sorted(shapes.values())
        assert got["eval_loaded"] == got["eval"]
        assert got["more"][1] == got["more"][0]
        np.testing.assert_allclose(got["more"][0], want["more"], rtol=TOL,
                                   atol=TOL)
        assert got["kept"] and got["held_again"] * 2 == got["whole"]
        np.testing.assert_allclose(got["again"], want["again"], rtol=TOL,
                                   atol=TOL)

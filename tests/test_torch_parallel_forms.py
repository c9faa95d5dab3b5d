"""The port's parallel forms on 2 and 4 gloo ranks against the JAX
package on as many host devices: tensor parallelism
(paddle_tpu_torch/distributed/parallel_layers.py), ring and Ulysses
attention (ring.py), MoE over ep and dp (moe.py), and TrainStep with a
sharding plan (static/train_step.py over sharding.py).

The ranks are this file run by the port's launcher with CUDA hidden, a
free port and a timeout that kills the process group, once per world
size (a module fixture); the rank side, above the __main__ guard,
imports torch and the port only. The fixture first writes the global
inputs and the JAX models' initial weights to an .npz the ranks read.
Each rank pickles what it computed on its block; the tests hold the
blocks against the JAX package's global computation (the JAX layers on
the whole batch, jax.grad of a shard_map over 'sp', the JAX TrainStep
with a ShardingPlan or MeshPlan over a mesh of host devices), within
1e-5 (values and gradients; f32).

Gradients are held as a TrainStep uses them: each rank's loss is its
block's sum plus the replicated aux term, and the gradients are averaged
over the data ranks; the JAX objective is the same global function
(the blocks' sums averaged over dp, plus the aux term).
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
TOL = 1e-5

# tiny ERNIE widths for the TrainStep trajectories (ErnieConfig.tiny's)
TINY = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
CONFIGS = {"dense": {}, "moe": dict(moe_num_experts=4, moe_top_k=2),
           "ring": dict(sequence_parallel="ring"),
           "ulysses": dict(sequence_parallel="ulysses")}
# name -> (config, mesh shape, plan kind, ZeRO stage); plan kind
# "sharding" is ShardingPlan(mesh, zero_stage=...), "mesh" is
# MeshPlan(**shape).sharding_plan()
TRAIN = {"zero1": ("dense", {"dp": 2}, "sharding", 1),
         "zero2": ("dense", {"dp": 2}, "sharding", 2),
         "zero3": ("dense", {"dp": 2}, "sharding", 3),
         "fsdp2": ("dense", {"fsdp": 2}, "mesh", 0),
         "tp2": ("dense", {"tp": 2}, "sharding", 0),
         "ep2": ("moe", {"ep": 2}, "sharding", 0),
         "sp2_ring": ("ring", {"sp": 2}, "sharding", 0),
         "sp2_ulysses": ("ulysses", {"sp": 2}, "sharding", 0)}
TRAIN_BATCH, TRAIN_STEPS, LR = (4, 32), 3, 1e-3
ATTN = dict(b=2, s=16, n=4, d=8)
MOE = dict(d=8, h=16, e=4, top_k=2, cf=1.0, b=4, s=6)
MOE_MESHES = {2: {"ep2": {"ep": 2}, "dp2": {"dp": 2}},
              4: {"ep2_dp2": {"dp": 2, "ep": 2}}}


def _inputs():
    """Every global input, from numpy seeds (the same on each side)."""
    rng = np.random.RandomState(0)
    a = ATTN
    out = {f"attn_{t}": rng.randn(a["b"], a["s"], a["n"], a["d"])
           .astype(np.float32) for t in ("q", "k", "v", "c")}
    out.update(
        lin_x=rng.randn(3, 8).astype(np.float32),
        lin_w=rng.randn(8, 12).astype(np.float32) * 0.3,
        lin_b=rng.randn(12).astype(np.float32) * 0.1,
        lin_w2=rng.randn(12, 8).astype(np.float32) * 0.3,
        lin_b2=rng.randn(8).astype(np.float32) * 0.1,
        lin_c=rng.randn(3, 12).astype(np.float32),
        lin_c2=rng.randn(3, 8).astype(np.float32),
        emb_w=rng.randn(16, 6).astype(np.float32),
        emb_ids=rng.randint(0, 16, (3, 5)).astype(np.int64),
        emb_c=rng.randn(3, 5, 6).astype(np.float32))
    m = MOE
    out.update(
        moe_x=rng.randn(m["b"], m["s"], m["d"]).astype(np.float32),
        moe_c=rng.randn(m["b"], m["s"], m["d"]).astype(np.float32),
        moe_gate=rng.randn(m["d"], m["e"]).astype(np.float32) * 0.5,
        moe_w1=rng.randn(m["e"], m["d"], m["h"]).astype(np.float32) * 0.3,
        moe_b1=rng.randn(m["e"], m["h"]).astype(np.float32) * 0.1,
        moe_w2=rng.randn(m["e"], m["h"], m["d"]).astype(np.float32) * 0.3,
        moe_b2=rng.randn(m["e"], m["d"]).astype(np.float32) * 0.1)
    b, s = TRAIN_BATCH
    out["train_ids"] = rng.randint(0, 1024, (b, s)).astype(np.int64)
    out["train_lbl"] = rng.randint(0, 1024, (b, s)).astype(np.int64)
    return out


# -- the rank side: torch and the port only -----------------------------------

def _rank_layers(g, pt, dist, sh, pl):
    """tp 2: ColumnParallel (gathered), Column -> RowParallel (the MLP
    pair), RowParallel on a full input, VocabParallelEmbedding; each
    loss's gradients, the split weights' gathered to full."""
    import torch
    mesh = dist.build_mesh({"tp": 2})
    dist.set_mesh(mesh)

    def load(param, arr):
        with torch.no_grad():
            param.copy_(sh.block_of(torch.from_numpy(arr),
                                    sh.model_layout(param), mesh))

    def full_grad(param):
        return sh.gather_of(param.grad, sh.model_layout(param), mesh).numpy()

    out = {}
    x = torch.from_numpy(g["lin_x"]).requires_grad_(True)
    col = pl.ColumnParallelLinear(8, 12, device="cpu")
    load(col.weight, g["lin_w"])
    load(col.bias, g["lin_b"])
    y = col(x)
    (y * torch.from_numpy(g["lin_c"])).sum().backward()
    out["col"] = dict(y=y.detach().numpy(), x=x.grad.numpy(),
                      w=full_grad(col.weight), b=full_grad(col.bias))
    # the Megatron MLP pair: column (not gathered) -> row (parallel in)
    x = torch.from_numpy(g["lin_x"]).requires_grad_(True)
    c2 = pl.ColumnParallelLinear(8, 12, gather_output=False, device="cpu")
    r2 = pl.RowParallelLinear(12, 8, input_is_parallel=True, device="cpu")
    for p, k in ((c2.weight, "lin_w"), (c2.bias, "lin_b"),
                 (r2.weight, "lin_w2"), (r2.bias, "lin_b2")):
        load(p, g[k])
    y = r2(torch.relu(c2(x)))
    (y * torch.from_numpy(g["lin_c2"])).sum().backward()
    out["mlp"] = dict(y=y.detach().numpy(), x=x.grad.numpy(),
                      w1=full_grad(c2.weight), b1=full_grad(c2.bias),
                      w2=full_grad(r2.weight), b2=r2.bias.grad.numpy())
    # row-parallel on a full input (split inside)
    x = torch.from_numpy(g["lin_c"]).requires_grad_(True)
    row = pl.RowParallelLinear(12, 8, device="cpu")
    load(row.weight, g["lin_w2"])
    load(row.bias, g["lin_b2"])
    y = row(x)
    (y * torch.from_numpy(g["lin_c2"])).sum().backward()
    out["row"] = dict(y=y.detach().numpy(), x=x.grad.numpy(),
                      w=full_grad(row.weight), b=row.bias.grad.numpy())
    emb = pl.VocabParallelEmbedding(16, 6, device="cpu")
    load(emb.weight, g["emb_w"])
    y = emb(torch.from_numpy(g["emb_ids"]))
    (y * torch.from_numpy(g["emb_c"])).sum().backward()
    out["vocab"] = dict(y=y.detach().numpy(), w=full_grad(emb.weight))
    # split(): the layer it makes from the seed, run split and whole
    pt.seed(3)
    ys = pl.split(torch.from_numpy(g["lin_x"]), (8, 12), "linear", axis=1)
    out["split"] = ys.detach().numpy()
    dist.set_mesh(None)
    return out


def _rank_attention(g, n, dist, ring):
    """sp n: ring (causal and not, and the bf16 KV wire) and Ulysses on
    this rank's sequence block; out, dq, dk, dv of sum(out * c)."""
    import torch
    from paddle_tpu_torch.distributed.comm import CommConfig
    mesh = dist.build_mesh({"sp": n})
    dist.set_mesh(mesh)
    me = mesh.coords(dist.get_rank())["sp"]
    s_loc = ATTN["s"] // n
    blk = {k: torch.from_numpy(g[f"attn_{k}"][:, me * s_loc:
                                              (me + 1) * s_loc].copy())
           for k in ("q", "k", "v", "c")}
    out = {}
    for name, fn in (
            ("ring", lambda q, k, v: ring.ring_flash_attention(
                q, k, v, False, group="sp")),
            ("ring_causal", lambda q, k, v: ring.ring_flash_attention(
                q, k, v, True, group="sp")),
            ("ring_bf16", lambda q, k, v: ring.ring_flash_attention(
                q, k, v, False, group="sp",
                comm_config=CommConfig(compress="bf16"))),
            ("ulysses", lambda q, k, v: ring.ulysses_attention(
                q, k, v, False, group="sp")),
            ("ulysses_causal", lambda q, k, v: ring.ulysses_attention(
                q, k, v, True, group="sp"))):
        q, k, v = (blk[t].clone().requires_grad_(True) for t in "qkv")
        o = fn(q, k, v)
        (o * blk["c"]).sum().backward()
        out[name] = dict(o=o.detach().numpy(), dq=q.grad.numpy(),
                         dk=k.grad.numpy(), dv=v.grad.numpy())
    dist.set_mesh(None)
    return out


def _rank_moe(g, shape, dist, sh, moe):
    """MoELayer on this rank's batch block (dp) and expert block (ep):
    y, aux, and the gradients of sum(y * c) + 0.5 aux, averaged over
    dp (x's divided by the dp size: the global objective's)."""
    import torch
    from paddle_tpu_torch.distributed import collective as c
    mesh = dist.build_mesh(shape)
    dist.set_mesh(mesh)
    m = MOE
    layer = moe.MoELayer(m["d"], m["h"], m["e"], top_k=m["top_k"],
                         capacity_factor=m["cf"], device="cpu")
    for name in ("gate", "w1", "b1", "w2", "b2"):
        p = getattr(layer, name)
        with torch.no_grad():
            p.copy_(sh.block_of(torch.from_numpy(g[f"moe_{name}"]),
                                sh.model_layout(p), mesh))
    coords = mesh.coords(dist.get_rank())
    dp = shape.get("dp", 1)
    rows = m["b"] // dp
    i = coords.get("dp", 0)
    x = torch.from_numpy(g["moe_x"][i * rows:(i + 1) * rows].copy()) \
        .requires_grad_(True)
    cc = torch.from_numpy(g["moe_c"][i * rows:(i + 1) * rows].copy())
    y = layer(x)
    ((y * cc).sum() + 0.5 * layer.aux_loss).backward()
    grads = {name: getattr(layer, name).grad for name in
             ("gate", "w1", "b1", "w2", "b2")}
    if dp > 1:
        for t in grads.values():
            c.all_reduce(t, op="avg", group="dp")
    out = dict(coords=coords, y=y.detach().numpy(),
               aux=float(layer.aux_loss), x=x.grad.numpy() / dp,
               capacity=layer.last_capacity,
               kept=int(layer.last_kept),
               **{k: v.numpy() for k, v in grads.items()})
    dist.set_mesh(None)
    return out


def _rank_train(g, name, states, pt, dist):
    """TRAIN[name]: tiny ERNIE made on the mesh (the model axes split),
    the JAX model's weights loaded (convert cuts the blocks), AdamW,
    TRAIN_STEPS steps on this rank's batch block; the losses, and on
    rank 0 the full state_dict's model."""
    import torch
    from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                         load_jax_params)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    cfg_name, shape, kind, zero = TRAIN[name]
    if kind == "mesh":
        mp = dist.MeshPlan(**shape)
        mesh = mp.build_mesh()
        plan = mp.sharding_plan()
    else:
        mesh = dist.build_mesh(shape)
        plan = dist.ShardingPlan(mesh, zero_stage=zero)
    dist.set_mesh(mesh)
    cfg = ErnieConfig(**TINY, **CONFIGS[cfg_name])
    m = ErnieForPretraining(cfg, device="cpu").train()
    load_jax_params(m, states[cfg_name])

    def loss(out, y):
        l = ErnieForPretraining.pretraining_loss(out, y)
        aux = m.moe_aux_loss()
        return l if aux is None else l + cfg.moe_aux_weight * aux
    step = TrainStep(m, loss, AdamW(learning_rate=LR), sharding_plan=plan)
    ids, lbl = plan.place_batch((torch.from_numpy(g["train_ids"]),
                                 torch.from_numpy(g["train_lbl"])))
    losses = [float(step(ids, lbl)) for _ in range(TRAIN_STEPS)]
    full = step.state_dict()
    # the full state back in (every rank keeps its blocks), then out
    # again: the same tensors
    step.set_state_dict(full)
    again = step.state_dict()

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b
    out = dict(losses=losses, shards=len(step._shards),
               roundtrip=same(full["model"], again["model"])
               and same(full["opt"], again["opt"]),
               split=sum(1 for p in step.params
                         if getattr(p, "_pd_full_shape", None) is not None
                         and tuple(p._pd_full_shape) != tuple(p.shape)))
    if dist.get_rank() == 0:
        out["model"] = {k: v.numpy() for k, v in full["model"].items()}
        out["opt_m1"] = {k: v["moment1"].numpy() for k, v in
                         full["opt"].items() if isinstance(v, dict)
                         and "moment1" in v}
    dist.set_mesh(None)
    return out


def _rank_main(out_dir):
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import moe, ring
    from paddle_tpu_torch.distributed import parallel_layers as pl
    from paddle_tpu_torch.distributed import sharding as sh
    torch.set_num_threads(1)
    pt.set_device("cpu")
    n = int(os.environ["WORLD_SIZE"])
    dist.init_parallel_env()
    rank = dist.get_rank()
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    g = {k: data[k] for k in data.files if not k.startswith("state__")}
    states = {}
    for k in data.files:
        if k.startswith("state__"):
            _, cfg, name = k.split("__", 2)
            states.setdefault(cfg, {})[name] = data[k]
    res = {"rank": rank}
    if n == 2:
        res["layers"] = _rank_layers(g, pt, dist, sh, pl)
    res["attention"] = _rank_attention(g, n, dist, ring)
    res["moe"] = {k: _rank_moe(g, shape, dist, sh, moe)
                  for k, shape in MOE_MESHES[n].items()}
    if n == 2:
        res["train"] = {name: _rank_train(g, name, states, pt, dist)
                        for name in TRAIN}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
    sys.exit(0)


# -- the test side ----------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.distributed as jdist  # noqa: E402
from paddle_tpu.models import ErnieConfig as JConfig  # noqa: E402
from paddle_tpu.models import ErnieForPretraining as JErnie  # noqa: E402


def _jax_states():
    """The JAX models' initial weights (paddle.seed(0)), per config."""
    out = {}
    for name, kw in CONFIGS.items():
        paddle.seed(0)
        jm = JErnie(JConfig(**TINY, **kw))
        for k, v in jm.state_dict().items():
            out[f"state__{name}__{k}"] = np.asarray(v.numpy())
    return out


def launch_ranks(n, out_dir, timeout=240):
    """This file run as `n` gloo ranks; each rank's pickled result. A
    launch whose ranks exit with an error is made once more (the
    rendezvous takes a free port that another test's launch may take
    first); a second failure, or a hang, fails with both logs."""
    try:
        return _launch_once(n, out_dir, timeout)
    except RuntimeError as first:
        try:
            return _launch_once(n, out_dir, timeout)
        except RuntimeError as second:
            raise AssertionError(f"{first}\n-- again --\n{second}")


def _launch_once(n, out_dir, timeout):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(n), __file__, str(out_dir)]
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"{n} ranks hung\n{log[-4000:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"{n} ranks failed\n{log[-6000:]}")
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


_LAUNCHED = {}


def _ranks(n, tmp_path_factory, inputs):
    """The ranks of an n-rank world, launched once per file."""
    if n not in _LAUNCHED:
        d = tmp_path_factory.mktemp(f"forms{n}")
        np.savez(d / "inputs.npz", **inputs, **(_jax_states() if n == 2
                                                else {}))
        _LAUNCHED[n] = (n, launch_ranks(n, d))
    return _LAUNCHED[n]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory, inputs):
    return _ranks(request.param, tmp_path_factory, inputs)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, inputs):
    return _ranks(2, tmp_path_factory, inputs)


@pytest.fixture(autouse=True)
def fresh_mesh():
    jdist.set_mesh(None)
    yield
    jdist.set_mesh(None)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


def _jt(a, grad=False):
    return paddle.to_tensor(np.asarray(a), stop_gradient=not grad)


def test_tensor_parallel_layers_equal_jax(ranks2, inputs):
    n, reps = ranks2
    from paddle_tpu.distributed import (ColumnParallelLinear,
                                        RowParallelLinear,
                                        VocabParallelEmbedding)
    g = inputs
    x = _jt(g["lin_x"], True)
    col = ColumnParallelLinear(8, 12)
    col.inner.weight.set_value(g["lin_w"])
    col.inner.bias.set_value(g["lin_b"])
    y = col(x)
    (y * _jt(g["lin_c"])).sum().backward()
    want_col = dict(y=y.numpy(), x=x.grad.numpy(),
                    w=col.weight.grad.numpy(), b=col.bias.grad.numpy())
    x = _jt(g["lin_x"], True)
    c2 = ColumnParallelLinear(8, 12, gather_output=False)
    r2 = RowParallelLinear(12, 8, input_is_parallel=True)
    c2.inner.weight.set_value(g["lin_w"])
    c2.inner.bias.set_value(g["lin_b"])
    r2.inner.weight.set_value(g["lin_w2"])
    r2.inner.bias.set_value(g["lin_b2"])
    import paddle_tpu.nn.functional as JF
    y = r2(JF.relu(c2(x)))
    (y * _jt(g["lin_c2"])).sum().backward()
    want_mlp = dict(y=y.numpy(), x=x.grad.numpy(),
                    w1=c2.weight.grad.numpy(), b1=c2.bias.grad.numpy(),
                    w2=r2.weight.grad.numpy(), b2=r2.bias.grad.numpy())
    x = _jt(g["lin_c"], True)
    row = RowParallelLinear(12, 8)
    row.inner.weight.set_value(g["lin_w2"])
    row.inner.bias.set_value(g["lin_b2"])
    y = row(x)
    (y * _jt(g["lin_c2"])).sum().backward()
    want_row = dict(y=y.numpy(), x=x.grad.numpy(),
                    w=row.weight.grad.numpy(), b=row.bias.grad.numpy())
    emb = VocabParallelEmbedding(16, 6)
    emb.inner.weight.set_value(g["emb_w"])
    y = emb(_jt(g["emb_ids"].astype(np.int32)))
    (y * _jt(g["emb_c"])).sum().backward()
    want_vocab = dict(y=y.numpy(), w=emb.inner.weight.grad.numpy())
    for rep in reps:
        got = rep["layers"]
        for case, want in (("col", want_col), ("mlp", want_mlp),
                           ("row", want_row), ("vocab", want_vocab)):
            for k, v in want.items():
                _close(got[case][k], v, f"{case}.{k} rank {rep['rank']}")
    # split() on 2 ranks equals the port's own unsplit layer from the
    # same seed (the JAX package draws its weights from another stream)
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import split
    pt.seed(3)
    whole = split(torch.from_numpy(g["lin_x"]), (8, 12), "linear", axis=1)
    for rep in reps:
        _close(rep["layers"]["split"], whole.detach().numpy(), "split")


_ATTN_CACHE = {}


def _jax_attention(n, name):
    key = (n, name)
    if key in _ATTN_CACHE:
        return _ATTN_CACHE[key]
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu.distributed.comm import CommConfig
    g = _inputs()
    mesh = jdist.build_mesh({"sp": n}, devices=jax.devices()[:n])
    causal = name.endswith("causal")

    def body(q, k, v):
        if name.startswith("ulysses"):
            return jdist.ulysses_attention(q, k, v, causal, group="sp")
        cc = CommConfig(compress="bf16") if name == "ring_bf16" else None
        return jdist.ring_flash_attention(q, k, v, causal, group="sp",
                                          comm_config=cc)
    spec = JP(None, "sp", None, None)
    fn = jdist.shard_parallel(body, mesh, in_specs=(spec, spec, spec),
                              out_specs=spec,
                              axes=("sp",)).__wrapped_smap__
    c = jnp.asarray(g["attn_c"])

    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o * c), o
    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(g[f"attn_{t}"]) for t in "qkv"))
    out = dict(o=np.asarray(o), dq=np.asarray(grads[0]),
               dk=np.asarray(grads[1]), dv=np.asarray(grads[2]))
    _ATTN_CACHE[key] = out
    return out


@pytest.mark.parametrize("name", ["ring", "ring_causal", "ring_bf16",
                                  "ulysses", "ulysses_causal"])
def test_sequence_parallel_attention_equals_jax_shard_map(ranks, name):
    n, reps = ranks
    want = _jax_attention(n, name)
    s_loc = ATTN["s"] // n
    for rep in reps:
        r = rep["rank"]
        for k in ("o", "dq", "dk", "dv"):
            _close(rep["attention"][name][k],
                   want[k][:, r * s_loc:(r + 1) * s_loc],
                   f"{name}.{k} rank {r} of {n}")


def _jax_moe(dp):
    """The JAX MoELayer on the whole batch: y, aux and the gradients of
    (1/dp) sum(y * c) + 0.5 aux."""
    from paddle_tpu.distributed import MoELayer
    g, m = _inputs(), MOE
    layer = MoELayer(m["d"], m["h"], m["e"], top_k=m["top_k"],
                     capacity_factor=m["cf"])
    for name in ("gate", "w1", "b1", "w2", "b2"):
        getattr(layer, name).set_value(g[f"moe_{name}"])
    x = _jt(g["moe_x"], True)
    y = layer(x)
    ((y * _jt(g["moe_c"])).sum() * (1.0 / dp)
     + 0.5 * layer.aux_loss).backward()
    cap = layer._capacity(m["b"] * m["s"])
    return dict(y=y.numpy(), aux=float(layer.aux_loss.numpy()),
                x=x.grad.numpy(), capacity=cap,
                **{k: getattr(layer, k).grad.numpy()
                   for k in ("gate", "w1", "b1", "w2", "b2")})


def test_moe_over_ep_and_dp_equals_jax(ranks):
    """The global capacity and slot order (dp), the expert blocks (ep)
    and the aux loss's global means: every rank's block of y and of each
    gradient equals the JAX layer's on the whole batch; some slots are
    dropped (capacity factor 1)."""
    n, reps = ranks
    m = MOE
    for case, shape in MOE_MESHES[n].items():
        dp, ep = shape.get("dp", 1), shape.get("ep", 1)
        want = _jax_moe(dp)
        rows, e_loc = m["b"] // dp, m["e"] // ep
        kept = 0
        for rep in reps:
            got = rep["moe"][case]
            i, j = got["coords"].get("dp", 0), got["coords"].get("ep", 0)
            what = f"{case} rank {rep['rank']}"
            assert got["capacity"] == want["capacity"], what
            _close(got["y"], want["y"][i * rows:(i + 1) * rows], what)
            _close(got["x"], want["x"][i * rows:(i + 1) * rows], what)
            np.testing.assert_allclose(got["aux"], want["aux"], rtol=TOL)
            _close(got["gate"], want["gate"], what + " gate")
            for k in ("w1", "b1", "w2", "b2"):
                _close(got[k], want[k][j * e_loc:(j + 1) * e_loc],
                       f"{what} {k}")
            if j == 0:
                kept += got["kept"]
        assert kept < m["b"] * m["s"] * m["top_k"], case


_TRAIN_CACHE = {}


def _jax_train(name):
    if name in _TRAIN_CACHE:
        return _TRAIN_CACHE[name]
    from paddle_tpu.distributed.sharding import MeshPlan, ShardingPlan
    from paddle_tpu.static import TrainStep as JStep
    g = _inputs()
    cfg_name, shape, kind, zero = TRAIN[name]
    n = int(np.prod(list(shape.values())))
    if kind == "mesh":
        mp = MeshPlan(**shape)
        mesh = mp.build_mesh(devices=jax.devices()[:n])
        plan = mp.sharding_plan()
    else:
        mesh = jdist.build_mesh(shape, devices=jax.devices()[:n])
        plan = ShardingPlan(mesh, zero_stage=zero)
    jdist.set_mesh(mesh)
    cfg = JConfig(**TINY, **CONFIGS[cfg_name])
    paddle.seed(0)
    jm = JErnie(cfg)

    def loss(out, y):
        l = JErnie.pretraining_loss(out, y)
        aux = jm.moe_aux_loss()
        return l if aux is None else l + cfg.moe_aux_weight * aux
    step = JStep(jm, loss, paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jm.parameters()), mesh=mesh,
        sharding_plan=plan)
    ids = _jt(g["train_ids"].astype(np.int32))
    lbl = _jt(g["train_lbl"].astype(np.int32))
    losses = [float(step(ids, lbl).numpy()) for _ in range(TRAIN_STEPS)]
    model = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    out = dict(losses=losses, model=model)
    _TRAIN_CACHE[name] = out
    jdist.set_mesh(None)
    return out


@pytest.fixture(scope="module", params=list(TRAIN))
def jax_train(request):
    """(name, the JAX TrainStep's run of TRAIN[name]): made at setup, the
    test holds the ranks against it."""
    return request.param, _jax_train(request.param)


def test_trainstep_with_a_plan_equals_jax(ranks2, jax_train):
    """3 steps of tiny ERNIE on 2 ranks: every rank's losses, and the
    full weights rank 0's state_dict gathers, against the JAX TrainStep
    with the same plan over 2 host devices. ZeRO and fsdp update shards
    (the rank holds them), tp and ep split the model (every split
    parameter's block), sp splits attention's sequence."""
    n, reps = ranks2
    name, want = jax_train
    for rep in reps:
        got = rep["train"][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL,
                                   atol=TOL, err_msg=f"{name} rank "
                                   f"{rep['rank']}")
        assert got["roundtrip"], name
        if name.startswith(("zero", "fsdp")):
            assert got["shards"] > 0, name
        if name in ("tp2", "ep2"):
            assert got["split"] > 0, name
    # the weights after the steps: AdamW's update m / sqrt(v) turns a
    # rounding-level difference in a near-zero gradient (the grads are
    # reduced in another order than XLA's) into up to 2 lr on that
    # parameter, so they are held at 5% of the learning rate
    model = reps[0]["train"][name]["model"]
    assert sorted(model) == sorted(want["model"])
    for k, v in want["model"].items():
        np.testing.assert_allclose(model[k], v, atol=0.05 * LR, rtol=TOL,
                                   err_msg=f"{name} {k}")
    assert reps[0]["train"][name]["opt_m1"], name

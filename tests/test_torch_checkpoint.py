"""The port's checkpoint plane (paddle_tpu_torch/distributed/checkpoint.py,
paddle_tpu_torch/serialization.py) against the JAX package's pickle
layout, on the CPU, and a restored TrainStep against the uninterrupted
one.

The JAX package writes the pickle layout when orbax is absent; the tests
make it so by monkeypatching its `_orbax` to return None. For the same
numpy trees: equal integrity manifests and topology manifests, files
either package reads, equal rollback plans and data-cursor indices
across a dp shrink from 2 to 1, and the same fallback from a corrupt,
truncated, bit-flipped or half-committed primary. An async save
followed at once by an in-place update writes the state as it was at
the save; bfloat16 tensors round-trip exactly through float32. A tiny GPT TrainStep with dropout 0.1 runs 6 steps; a second
one, built from other weights and restored from the checkpoint after
step 3, gives steps 4-6 losses and final parameters bit-equal to the
first's (the seed stream travels in the state). train_epoch_range
resumes an interrupted epoch loop where the JAX package's does.
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import chaos as jchaos
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu_torch.distributed import checkpoint as pck
from paddle_tpu_torch.observability import metrics as pmetrics


@pytest.fixture(autouse=True)
def _jax_pickle_layout(monkeypatch):
    monkeypatch.setattr(jck, "_orbax", lambda: None)
    monkeypatch.delenv("PD_CKPT_KEEP_OLD", raising=False)


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"params": {"w": rng.randn(3, 4).astype(np.float32),
                       "blocks": [{"a": rng.randn(5).astype(np.float32)},
                                  {"a": np.ones(2, np.float16)}]},
            "opt": {"_step_count": np.asarray(3, np.int64),
                    "m": rng.randn(3, 4).astype(np.float32)},
            "seed": {"seed": 7, "streams": {"cuda:0": 4}},
            "pair": (1.5, np.arange(3, dtype=np.int32)), "none": None}


def _equal_trees(a, b):
    fa, fb = pck._flatten(a), pck._flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_manifest_and_topology_equal_jax():
    tree = _tree()
    assert pck._manifest_doc(tree) == jck._manifest_doc(tree)
    cur = pck.DataShardCursor(64, 8, offset=16, epoch=1).state_dict()
    for kw in (dict(step=5, data_cursor=cur, dp=2, global_batch=8,
                    extra={"k": 1}, health={"healthy": True, "step": 5}),
               dict(step=0), dict(step=3, data_cursor=cur)):
        assert pck.topology_manifest(**kw) == jck.topology_manifest(**kw)
    # a tree of tensors gets the manifest of its numpy image
    ttree = {"w": torch.from_numpy(tree["params"]["w"]), "n": 3}
    assert pck._manifest_doc(pck._snapshot(ttree, reuse=False)) == \
        jck._manifest_doc({"w": tree["params"]["w"], "n": 3})


def test_each_package_reads_the_others_files(tmp_path):
    tree = _tree()
    topo = jck.topology_manifest(2, dp=1, global_batch=8)
    jck.save_sharded(tree, str(tmp_path / "j"), topology=topo)
    state, got_topo = pck.load_with_topology(str(tmp_path / "j"))
    assert got_topo == topo
    _equal_trees(state, jck.load_sharded(str(tmp_path / "j")))
    pck.save_sharded(tree, str(tmp_path / "p"), topology=topo)
    for suffix in ("", ".manifest.json", ".topology.json"):
        assert os.path.exists(str(tmp_path / "p.pkl") + suffix)
    _equal_trees(jck.load_sharded(str(tmp_path / "p")),
                 pck.load_sharded(str(tmp_path / "p")))
    assert jck.load_topology(str(tmp_path / "p")) == topo
    # with a target, the leaves it holds tensors at come back as tensors
    placed = pck.load_sharded(str(tmp_path / "p"),
                              target={"params": {"w": torch.zeros(1)}})
    assert isinstance(placed["params"]["w"], torch.Tensor)
    assert isinstance(placed["opt"]["m"], np.ndarray)
    np.testing.assert_array_equal(placed["params"]["w"].numpy(),
                                  tree["params"]["w"])
    # the JAX package's wrapped Tensors (paddle.save) read as tensors
    import paddle_tpu as paddle
    from paddle_tpu_torch import serialization
    paddle.save({"t": paddle.to_tensor(np.arange(4.0, dtype=np.float32))},
                str(tmp_path / "t.pd"))
    got = serialization.load(str(tmp_path / "t.pd"))
    assert isinstance(got["t"], torch.Tensor)
    assert got["t"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_rollback_plan_and_cursor_match_jax_across_dp_shrink():
    cands = [{"name": "slot0.pkl", "step": 9, "healthy": False},
             {"name": "slot0.pkl.old", "step": 7, "healthy": True},
             {"name": "slot0.pkl.old2", "step": 5, "healthy": True},
             {"name": "x", "step": None, "healthy": False}]
    for step in (4, 5, 7, 8, 10):
        for be in (True, False):
            for rh in (True, False):
                assert pck.rollback_plan(cands, step, be, rh) == \
                    jck.rollback_plan(cands, step, be, rh)
    pc, jc = pck.DataShardCursor(40, 8), jck.DataShardCursor(40, 8)
    for dp in (2, 2, 2, 1, 1, 1, 1):        # shrink from 2 to 1
        for rank in range(dp):
            np.testing.assert_array_equal(pc.indices(rank, dp),
                                          jc.indices(rank, dp))
        pc.advance()
        jc.advance()
        assert pc.state_dict() == jc.state_dict()
    resumed = pck.DataShardCursor.from_state(jc.state_dict())
    np.testing.assert_array_equal(resumed.indices(0, 1), jc.indices(0, 1))
    with pytest.raises(ValueError, match="not divisible"):
        pc.indices(0, 3)


def _break(kind, path):
    pkl = path + ".pkl"
    if kind == "garbage":
        jchaos._corrupt(path)
    elif kind == "truncated":
        with open(pkl, "rb") as f:
            data = f.read()
        with open(pkl, "wb") as f:
            f.write(data[:len(data) // 2])
    elif kind == "bitflip":
        with open(pkl, "rb") as f:
            data = bytearray(f.read())
        data[len(data) // 2] ^= 0xFF
        with open(pkl, "wb") as f:
            f.write(bytes(data))
    elif kind == "half_committed":
        # a death between the rotation and the commit: the primary has
        # gone to .old, the new payload is still .tmp
        os.replace(pkl + ".old", pkl + ".old2")
        os.replace(pkl, pkl + ".old")
        for side in (".manifest.json", ".topology.json"):
            os.replace(pkl + ".old" + side, pkl + ".old2" + side)
            os.replace(pkl + side, pkl + ".old" + side)
        with open(pkl + ".tmp", "wb") as f:
            f.write(b"\x80\x04partial")


@pytest.mark.parametrize("kind", ["garbage", "truncated", "bitflip",
                                  "half_committed"])
def test_broken_candidates_fall_back_as_in_jax(tmp_path, kind):
    got = {}
    for name, mod in (("jax", jck), ("port", pck)):
        path = str(tmp_path / name / "slot0")
        os.makedirs(os.path.dirname(path))
        for step in (1, 2, 3):
            mod.save_sharded({"w": np.full((64,), step, np.float32),
                              "step": step}, path,
                             topology=mod.topology_manifest(step))
        _break(kind, path)
        pmetrics.reset()
        state, topo = mod.load_with_topology(path)
        at1, topo1 = mod.load_at_or_before(path, 1)
        got[name] = (topo["step"], float(np.asarray(state["w"])[0]),
                     topo1["step"], float(np.asarray(at1["w"])[0]),
                     mod.load_topology(path)["step"])
    assert got["port"] == got["jax"]
    if kind == "half_committed":
        # the newest intact save is the rotated primary (.old, step 3);
        # step 1's fell off the depth-2 retention, so the cut at 1 lands
        # on the oldest survivor, step 2, as a recorded gap
        assert got["port"][:4] == (3, 3.0, 2, 2.0)
    else:
        assert got["port"][:4] == (2, 2.0, 1, 1.0)


def test_async_save_holds_the_state_at_the_save(tmp_path):
    w = torch.randn(256, 64)
    m = torch.zeros(256, 64)
    before = (w.clone(), m.clone())
    path = str(tmp_path / "a")
    pck.save_sharded({"w": w, "m": m, "step": 1}, path, async_write=True,
                     topology=pck.topology_manifest(1))
    # the next step's in-place update, at once
    w.add_(1.0)
    m.copy_(w)
    assert pck.wait_pending()
    out = pck.load_sharded(path)
    np.testing.assert_array_equal(out["w"], before[0].numpy())
    np.testing.assert_array_equal(out["m"], before[1].numpy())
    assert pck.last_save["block_ms"] >= 0 and pck.last_save["write_ms"] > 0
    # the next save reuses the host buffers and writes the new state
    pck.save_sharded({"w": w, "m": m, "step": 2}, path, async_write=True)
    w.zero_()
    pck.wait_pending()
    np.testing.assert_array_equal(pck.load_sharded(path)["w"],
                                  (before[0] + 1.0).numpy())


@pytest.mark.parametrize("async_write", [False, True])
def test_bfloat16_round_trips_through_float32(tmp_path, async_write):
    """numpy has no bfloat16: such a tensor is written as its float32
    values, and copied back into a bfloat16 tensor it is bit-equal."""
    w = torch.randn(64, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    path = str(tmp_path / "b")
    pck.save_sharded({"w": w}, path, async_write=async_write)
    pck.wait_pending()
    out = pck.load_sharded(path)
    assert out["w"].dtype == np.float32
    back = torch.empty_like(w).copy_(torch.as_tensor(out["w"]))
    assert torch.equal(back, w)


def test_reads_the_jax_packages_bfloat16(tmp_path):
    """The JAX package keeps bfloat16 as ml_dtypes arrays, in paddle.save
    files and in the checkpoint's pickle layout. The port reads both:
    serialization.load gives bfloat16 tensors (numpy arrays unchanged
    with return_numpy=True), and load_sharded with a target gives
    tensors of the target's dtype, bit-equal to the values saved; the
    restore paths that take arrays (a layer's set_state_dict, the
    optimizer's, TrainStep's) take them too."""
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu_torch import serialization
    from paddle_tpu_torch.nn import Linear
    vals = np.random.RandomState(3).randn(6, 5).astype(np.float32)
    ref = torch.from_numpy(vals).to(torch.bfloat16)
    jbf = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    assert jbf.dtype.name == "bfloat16"
    paddle.save({"w": paddle.to_tensor(vals).astype("bfloat16")},
                str(tmp_path / "w.pd"))
    got = serialization.load(str(tmp_path / "w.pd"))
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], ref)
    raw = serialization.load(str(tmp_path / "w.pd"), return_numpy=True)
    assert raw["w"].dtype.name == "bfloat16"
    assert np.array_equal(raw["w"].astype(np.float32), jbf.astype(np.float32))
    jck.save_sharded({"w": jbf, "m": vals}, str(tmp_path / "c"))
    for dtype in (torch.bfloat16, torch.float32):
        out = pck.load_sharded(str(tmp_path / "c"),
                               target={"w": torch.zeros(1, dtype=dtype)})
        assert out["w"].dtype == dtype
        assert torch.equal(out["w"], ref.to(dtype))
        assert isinstance(out["m"], np.ndarray)
    bare = pck.load_sharded(str(tmp_path / "c"))
    assert bare["w"].dtype.name == "bfloat16"
    lin = Linear(6, 5, device="cpu").to(torch.bfloat16)
    lin.set_state_dict({"weight": bare["w"], "bias": jbf[0]})
    assert torch.equal(lin.weight.detach(), ref)
    assert torch.equal(lin.bias.detach(), ref[0])


TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=64, dropout=0.1)


def _tiny_step(seed):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    pt.seed(seed)
    model = GPTForCausalLM(GPTConfig(**TINY), device="cpu").train()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    return model, TrainStep(model, GPTForCausalLM.lm_loss, opt)


def _batches():
    out = []
    for i in range(6):
        tok = np.random.RandomState(100 + i).randint(0, 97, (2, 17))
        out.append((torch.from_numpy(tok[:, :-1]),
                    torch.from_numpy(tok[:, 1:])))
    return out


def test_restored_train_step_continues_bit_equal(tmp_path):
    batches = _batches()
    model, step = _tiny_step(0)
    path = str(tmp_path / "train")
    losses = []
    for i, (x, y) in enumerate(batches):
        losses.append(float(step(x, y)))
        if i == 2:
            pck.save_sharded({"train": step.state_dict()}, path,
                             async_write=True,
                             topology=pck.topology_manifest(i))
    pck.wait_pending()
    final = {k: v.clone() for k, v in model.state_dict().items()}

    model2, step2 = _tiny_step(1)       # other weights, other stream
    state, topo = pck.load_with_topology(path)
    assert topo["step"] == 2
    step2.set_state_dict(state["train"])
    resumed = [float(step2(x, y)) for x, y in batches[3:]]
    assert resumed == losses[3:]
    for k, v in model2.state_dict().items():
        assert torch.equal(v, final[k]), k
    assert step2.optimizer._step_count == step.optimizer._step_count == 6
    assert step2._steps_done == 6
    # without the seed stream the masks differ: the state carries it
    model3, step3 = _tiny_step(1)
    bare = dict(state["train"])
    bare.pop("seed")
    step3.set_state_dict(bare)
    assert float(step3(*batches[3])) != losses[3]


def test_generator_state_round_trip():
    from paddle_tpu_torch.core import generator as g
    g.seed(11)
    a = [g.next_seed("cpu") for _ in range(3)]
    st = g.get_state()
    b = [g.next_seed("cpu") for _ in range(3)]
    g.seed(99)
    g.set_state({"seed": np.asarray(st["seed"]),
                 "streams": {k: np.asarray(v)
                             for k, v in st["streams"].items()}})
    assert [g.next_seed("cpu") for _ in range(3)] == b
    assert a != b


def test_train_epoch_range_resumes_like_jax(tmp_path):
    """An epoch loop left during epoch 1 (before that epoch's save)
    resumes at epoch 1 in both packages; the port's model and optimizer
    come back as epoch 0 left them."""
    from paddle_tpu.distributed.checkpoint import \
        train_epoch_range as jrange
    seen = {"jax": [], "port": []}
    for name, rng_fn in (("jax", jrange), ("port", pck.train_epoch_range)):
        kw = dict(job_id="job", checkpoint_dir=str(tmp_path / name))
        if name == "port":
            model, step = _tiny_step(0)
            kw.update(model=model, optimizer=step.optimizer)
        for epoch in rng_fn(4, **kw):
            seen[name].append(epoch)
            if name == "port":
                float(step(*_batches()[epoch]))
                if epoch == 0:
                    after0 = {k: v.clone()
                              for k, v in model.state_dict().items()}
            if epoch == 1:
                break
        if name == "port":
            model2, step2 = _tiny_step(1)
            kw.update(model=model2, optimizer=step2.optimizer)
        seen[name].append("restart")
        seen[name] += list(rng_fn(4, **kw))
    assert seen["port"] == seen["jax"] == [0, 1, "restart", 1, 2, 3]
    assert step2.optimizer._step_count == 1
    for k, v in model2.state_dict().items():
        assert torch.equal(v, after0[k]), k

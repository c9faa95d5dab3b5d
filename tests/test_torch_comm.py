"""The port's gradient-sync planner (paddle_tpu_torch/distributed/comm.py)
against the JAX package's, on the CPU.

In one process (no process group, so no live axis, as the JAX package
outside a shard_map): the bucket specs of the same grads, the planner's
choice over a grid of (bytes, axes, config) including its refusals, the
int8 codes and scales (bit-equal; both round half to even, ties
included), the wire bytes, and GradSynchronizer's outputs, residuals and
receipts (comm.* counters, the flight recorder's fused-collective
sequence) over 3 steps of each wire tier.

Across ranks (gloo, started by the port's launcher; this file is the
ranks' script): planned_all_reduce flat and rs_ag on 2 ranks and
hierarchical on a (host, chip) = (2, 2) mesh of 4, and the int8_ef
GradSynchronizer's outputs and residuals over 3 steps on 2 ranks, and
ParamSynchronizer's shard, gather and scatter_grads over an fsdp axis of
2 ranks in each tier, each held against the JAX package under shard_map
on as many host devices: f32 sums bit-equal on 2 ranks, 1e-6 on 4;
int8_ef within 1e-6.
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
SMALL_BUCKETS = 64       # bytes: the two grads below land in two buckets


def _grads(seed, n=1):
    """Named grads of n ranks, stacked along dim 0 (rank r's rows are
    block r)."""
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(n * 6, 5).astype(np.float32),
            "b": rng.randn(n * 3, 7).astype(np.float32)}


def _vec(seed, n):
    return np.random.RandomState(seed).randn(n * 4096).astype(np.float32)


# -- the rank side: torch and the port only -----------------------------------

def _rank_main(case, out_dir):
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import comm
    torch.set_num_threads(1)
    pt.set_device("cpu")
    n = int(os.environ["WORLD_SIZE"])
    dist.init_parallel_env({"host": 2, "chip": 2} if case == "hier" else None)
    rank = dist.get_rank()
    res = {"rank": rank}
    if case == "hier":
        x = torch.from_numpy(_vec(5, n)[rank * 4096:(rank + 1) * 4096])
        cfg = comm.CommConfig(hierarchy=("host", "chip"))
        res["hier"] = comm.planned_all_reduce(x.clone(), cfg).numpy()
        res["bf16_hier"] = comm.planned_all_reduce(
            x.clone(), comm.CommConfig(hierarchy=("host", "chip"),
                                       compress="bf16")).numpy()
    else:
        x = torch.from_numpy(_vec(5, n)[rank * 4096:(rank + 1) * 4096])
        for algo in ("flat", "rs_ag"):
            res[algo] = comm.planned_all_reduce(
                x.clone(), comm.CommConfig(algorithm=algo)).numpy()
        res["bf16"] = comm.planned_all_reduce(
            x.clone(), comm.CommConfig(compress="bf16")).numpy()
        sync = comm.GradSynchronizer(comm.CommConfig(
            compress="int8_ef", bucket_bytes=SMALL_BUCKETS))
        state = None
        steps = []
        for step in range(3):
            g = _grads(20 + step, n)
            local = {k: torch.from_numpy(v[rank * (v.shape[0] // n):
                                           (rank + 1) * (v.shape[0] // n)])
                     for k, v in g.items()}
            if state is None:
                state = sync.init_state(local)
            out, state = sync(local, state)
            steps.append(({k: v.numpy() for k, v in out.items()},
                          {k: v.numpy() for k, v in state.items()}))
        res["int8_ef"] = steps
        # ParamSynchronizer over an fsdp axis of the same 2 ranks
        dist.init_parallel_env({"fsdp": n})
        params = {k: torch.from_numpy(v) for k, v in _grads(40).items()}
        grads = {k: torch.from_numpy(v[rank * (v.shape[0] // n):
                                       (rank + 1) * (v.shape[0] // n)])
                 for k, v in _grads(41, n).items()}
        for compress in ("f32", "bf16", "int8_ef"):
            ps = comm.ParamSynchronizer(comm.CommConfig(
                compress=compress, bucket_bytes=SMALL_BUCKETS))
            chunks = ps.shard(params)
            full = ps.gather(chunks, params)
            owned, state = ps.scatter_grads(grads, {})
            res["fsdp_" + compress] = (
                {k: v.numpy() for k, v in chunks.items()},
                {k: v.numpy() for k, v in full.items()},
                {k: v.numpy() for k, v in owned.items()},
                {k: v.numpy() for k, v in state.items()})
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


# -- the test side ----------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.distributed as jdist  # noqa: E402
from paddle_tpu.distributed import comm as jcomm  # noqa: E402
from paddle_tpu.observability import flight_recorder as jfr  # noqa: E402
from paddle_tpu.observability import metrics as jmetrics  # noqa: E402
from paddle_tpu_torch.distributed import comm  # noqa: E402
from paddle_tpu_torch.observability import flight_recorder as pfr  # noqa: E402
from paddle_tpu_torch.observability import metrics as pmetrics  # noqa: E402


def launch_ranks(case, n, out_dir, timeout=120):
    """This file run as `n` gloo ranks by the port's launcher; each
    rank's pickled result. A hang fails at `timeout` (the process group
    killed)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(n), __file__, case, str(out_dir)]
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"{case} on {n} ranks hung\n{log[-4000:]}")
    assert proc.returncode == 0, f"{case} on {n} ranks failed\n{log[-6000:]}"
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _spec_tuple(s):
    return (s.index, str(s.dtype), s.names, tuple(map(tuple, s.shapes)),
            tuple(s.sizes), s.nbytes, s.residual_key)


# -- in one process ---------------------------------------------------------------

@pytest.mark.parametrize("target", [64, 200, 8 << 10, 4 << 20])
def test_bucket_specs_equal_jax(target):
    rng = np.random.RandomState(1)
    arrays = {f"p{i:02d}": rng.randn(*shape).astype(np.float32)
              for i, shape in enumerate([(33, 17), (5,), (64, 64), (3, 2, 7),
                                         (1,), (129,)])}
    arrays["ints"] = np.arange(5, dtype=np.int32)
    jg = {k: jnp.asarray(v) for k, v in arrays.items()}
    jg["half"] = jnp.asarray(rng.randn(9, 3), jnp.bfloat16)
    tg = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tg["half"] = torch.from_numpy(
        np.asarray(jg["half"]).astype(np.float32)).to(torch.bfloat16)
    want = [_spec_tuple(s) for s in jcomm.build_buckets(jg, target)]
    got = [_spec_tuple(s) for s in comm.build_buckets(tg, target)]
    assert got == want
    for s in comm.build_buckets(tg, target):
        back = comm.unflatten_bucket(comm.flatten_bucket(tg, s), s)
        for k in s.names:
            assert torch.equal(back[k], tg[k])


CONFIGS = [dict(), dict(algorithm="flat"), dict(algorithm="rs_ag"),
           dict(algorithm="hierarchical"), dict(compress="int8_ef"),
           dict(compress="bf16"), dict(hierarchy=("host", "chip")),
           dict(flat_threshold=1 << 20)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: repr(c))
def test_choose_algorithm_grid_equals_jax(cfg):
    def outcome(mod, nbytes, axes):
        try:
            return mod.choose_algorithm(nbytes, axes, mod.CommConfig(**cfg))
        except ValueError as e:
            return ("ValueError", str(e))
    for nbytes in (0, 1, (128 << 10) - 1, 128 << 10, 1 << 30):
        for axes in ((), ("dp",), ("host", "chip"), ("a", "b", "c")):
            assert outcome(comm, nbytes, axes) == \
                outcome(jcomm, nbytes, axes), (nbytes, axes)


def test_config_refusals_equal_jax():
    for bad in (dict(algorithm="nccl_ring"), dict(compress="fp4"),
                dict(hierarchy=("host",)), dict(bucket_bytes=0),
                dict(algorithm="hierarchical", compress="int8_ef"),
                dict(compress="int8_ef", hierarchy=("host", "chip"))):
        with pytest.raises(ValueError) as je:
            jcomm.CommConfig(**bad)
        with pytest.raises(ValueError) as pe:
            comm.CommConfig(**bad)
        assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("block", [256, 64, 7])
def test_int8_codes_and_scales_bit_equal(block):
    rng = np.random.RandomState(block)
    y = (rng.randn(1000) * rng.choice([1e-3, 1.0, 40.0], 1000)).astype(
        np.float32)
    # exact ties: a block's amax 127 makes the scale 1, so k + 0.5 is a
    # tie that half-to-even rounds to the even neighbour
    y[:block] = np.arange(block, dtype=np.float32) % 9 - 4.5
    y[0] = 127.0
    jq, js, jn = jcomm._quantize_int8(jnp.asarray(y), block)
    tq, ts, tn = comm._quantize_int8(torch.from_numpy(y), block)
    assert jn == tn
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        comm._dequantize_int8(tq, ts, tn).numpy(),
        np.asarray(jcomm._dequantize_int8(jq, js, jn)))


def test_wire_bytes_equal_jax():
    for algo in ("flat", "rs_ag", "hier", "q_ag"):
        for compress in ("f32", "bf16", "int8_ef"):
            for n, item, blk in ((1, 4, 256), (1000, 4, 256),
                                 (257, 2, 7), (4096, 8, 64)):
                assert comm._wire_bytes(algo, compress, n, item, blk) == \
                    jcomm._wire_bytes(algo, compress, n, item, blk)


@pytest.mark.parametrize("compress", ["f32", "bf16", "int8_ef"])
def test_grad_synchronizer_local_steps_and_receipts(compress):
    """No live axis: f32 is the identity bit for bit, bf16 a round trip,
    int8_ef quantized with the residual carried; 3 steps against the
    JAX package (f32 and bf16 bit-equal, int8_ef 1e-6), and the same
    comm.* counters and fused-collective sequence."""
    cfg = dict(compress=compress, bucket_bytes=SMALL_BUCKETS)
    jsync = jcomm.GradSynchronizer(jcomm.CommConfig(**cfg))
    tsync = comm.GradSynchronizer(comm.CommConfig(**cfg))
    receipts = []
    for sync, mets, fr, conv in (
            (jsync, jmetrics, jfr, jnp.asarray),
            (tsync, pmetrics, pfr, torch.from_numpy)):
        mets.enable()
        fr.enable()
        mets.reset("comm.")
        fr.reset()
        try:
            state, outs = None, []
            for step in range(3):
                g = {k: conv(v) for k, v in _grads(30 + step).items()}
                if state is None:
                    state = sync.init_state(g)
                out, state = sync(g, state)
                outs.append(({k: np.asarray(v) for k, v in out.items()},
                             {k: np.asarray(v) for k, v in state.items()}))
            snap = {k: v["value"] for k, v in mets.snapshot("comm.").items()}
            seq = [(e["op"], e["axis"], e["seq"], e["bytes"])
                   for e in fr.get_recorder().events()
                   if e["k"] == "collective.enter"]
        finally:
            mets.disable()
            fr.disable()
        receipts.append((outs, snap, seq))
    (jouts, jsnap, jseq), (touts, tsnap, tseq) = receipts
    assert tsnap == jsnap and tseq == jseq
    assert len(tseq) == 6
    for (jo, js), (to, ts) in zip(jouts, touts):
        assert sorted(ts) == sorted(js)
        for k in jo:
            if compress == "int8_ef":
                np.testing.assert_allclose(to[k], jo[k], atol=1e-6)
            else:
                np.testing.assert_array_equal(to[k], jo[k])
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], atol=1e-6)
    if compress == "f32":
        for k, v in _grads(32).items():
            np.testing.assert_array_equal(touts[-1][0][k], v)


def test_purge_residual_state():
    st = {"residual_0_ab": 1, "residual_1_cd": 2, "amp_scale": 3}
    assert comm.purge_residual_state(st) == 2 and st == {"amp_scale": 3}


# -- across ranks -----------------------------------------------------------------

def _jax_planned(n, mesh_shape, configs):
    devs = jax.devices()[:n]
    mesh = jdist.build_mesh(mesh_shape, devices=devs)
    axes = tuple(mesh_shape)
    x = _vec(5, n)

    def body(t):
        return tuple(jcomm.planned_all_reduce(t.clone(), cfg)
                     for cfg in configs)

    spec = JP(axes if len(axes) > 1 else axes[0])
    w = jdist.shard_parallel(body, mesh, in_specs=spec,
                             out_specs=tuple(spec for _ in configs),
                             axes=axes)
    return [np.asarray(o.numpy()) for o in w(paddle.to_tensor(x))]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return launch_ranks("dp2", 2, tmp_path_factory.mktemp("comm2"))


def test_planned_all_reduce_flat_rs_ag_bf16_on_two_ranks(two_ranks):
    flat, rs_ag, bf16 = _jax_planned(
        2, {"dp": 2}, [jcomm.CommConfig(algorithm="flat"),
                       jcomm.CommConfig(algorithm="rs_ag"),
                       jcomm.CommConfig(compress="bf16")])
    for rep in two_ranks:
        r = rep["rank"]
        blk = slice(r * 4096, (r + 1) * 4096)
        np.testing.assert_array_equal(rep["flat"], flat[blk])
        np.testing.assert_array_equal(rep["rs_ag"], rs_ag[blk])
        np.testing.assert_array_equal(rep["bf16"], bf16[blk])


def test_int8_ef_residuals_over_three_steps_on_two_ranks(two_ranks):
    n = 2
    mesh = jdist.build_mesh({"dp": n}, devices=jax.devices()[:n])
    sync = jcomm.GradSynchronizer(jcomm.CommConfig(
        compress="int8_ef", bucket_bytes=SMALL_BUCKETS))
    local = {k: jnp.asarray(v[:v.shape[0] // n])
             for k, v in _grads(20, n).items()}
    keys = [s.residual_key for s in sync.buckets_for(local)]
    res = [np.zeros((n * s.num_elements,), np.float32)
           for s in sync.buckets_for(local)]

    def body(w, b, r0, r1):
        out, st = sync({"w": w._data, "b": b._data},
                       {keys[0]: r0._data, keys[1]: r1._data})
        return out["w"], out["b"], st[keys[0]], st[keys[1]]

    spec = JP("dp")
    # one compile for the 3 steps
    step_fn = jax.jit(jdist.shard_parallel(
        body, mesh, in_specs=(spec,) * 4, out_specs=(spec,) * 4,
        axes=("dp",)).__wrapped_smap__)
    for step in range(3):
        g = _grads(20 + step, n)
        w, b, r0, r1 = step_fn(g["w"], g["b"], res[0], res[1])
        res = [np.asarray(r0), np.asarray(r1)]
        want = {"w": np.asarray(w), "b": np.asarray(b)}
        for rep in two_ranks:
            r = rep["rank"]
            out, state = rep["int8_ef"][step]
            assert sorted(state) == sorted(keys)
            for k, v in want.items():
                per = v.shape[0] // n
                np.testing.assert_allclose(out[k], v[r * per:(r + 1) * per],
                                           atol=1e-6)
            for k, full in zip(keys, res):
                per = full.shape[0] // n
                np.testing.assert_allclose(
                    state[k], full[r * per:(r + 1) * per], atol=1e-6)


def test_hierarchical_on_a_two_by_two_mesh(tmp_path):
    reports = launch_ranks("hier", 4, tmp_path)
    hier, bf16 = _jax_planned(
        4, {"host": 2, "chip": 2},
        [jcomm.CommConfig(hierarchy=("host", "chip")),
         jcomm.CommConfig(hierarchy=("host", "chip"), compress="bf16")])
    total = _vec(5, 4).reshape(4, 4096).sum(0)
    for rep in reports:
        r = rep["rank"]
        blk = slice(r * 4096, (r + 1) * 4096)
        np.testing.assert_allclose(rep["hier"], hier[blk], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(rep["hier"], total, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rep["bf16_hier"], bf16[blk], rtol=1e-2,
                                   atol=1e-2)


@pytest.mark.parametrize("compress", ["f32", "bf16", "int8_ef"])
def test_param_synchronizer_on_two_ranks(two_ranks, compress):
    """shard, gather and scatter_grads over an fsdp axis of 2 ranks
    against the JAX ParamSynchronizer under shard_map."""
    n = 2
    mesh = jdist.build_mesh({"fsdp": n}, devices=jax.devices()[:n])
    ps = jcomm.ParamSynchronizer(jcomm.CommConfig(
        compress=compress, bucket_bytes=SMALL_BUCKETS))
    params = _grads(40)
    like = {k: jnp.asarray(v) for k, v in params.items()}
    keys = [s.residual_key for s in ps.buckets_for(like)]

    def body(w, b, gw, gb):
        chunks = ps.shard({"w": w._data, "b": b._data})
        full = ps.gather(chunks, {"w": w._data, "b": b._data})
        owned, state = ps.scatter_grads({"w": gw._data, "b": gb._data}, {})
        out = [chunks[k] for k in keys] + [full["w"], full["b"]] + \
            [owned[k] for k in keys]
        if compress == "int8_ef":
            out += [state[k] for k in keys]
        return tuple(out)

    nout = 2 * len(keys) + 2 + (len(keys) if compress == "int8_ef" else 0)
    specs = [JP("fsdp")] * len(keys) + [JP(), JP()] + \
        [JP("fsdp")] * (nout - len(keys) - 2)
    g = _grads(41, n)
    w = jax.jit(jdist.shard_parallel(
        body, mesh, in_specs=(JP(), JP(), JP("fsdp"), JP("fsdp")),
        out_specs=tuple(specs), axes=("fsdp",)).__wrapped_smap__)
    outs = [np.asarray(o) for o in w(params["w"], params["b"], g["w"],
                                     g["b"])]
    j_chunks = dict(zip(keys, outs[:len(keys)]))
    j_full = {"w": outs[len(keys)], "b": outs[len(keys) + 1]}
    j_owned = dict(zip(keys, outs[len(keys) + 2:2 * len(keys) + 2]))
    j_state = dict(zip(keys, outs[2 * len(keys) + 2:]))
    for rep in two_ranks:
        r = rep["rank"]
        chunks, full, owned, state = rep["fsdp_" + compress]
        for k in keys:
            per = j_chunks[k].shape[0] // n
            np.testing.assert_array_equal(chunks[k],
                                          j_chunks[k][r * per:(r + 1) * per])
            per = j_owned[k].shape[0] // n
            np.testing.assert_allclose(owned[k],
                                       j_owned[k][r * per:(r + 1) * per],
                                       atol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_array_equal(full[k], j_full[k])
        assert sorted(state) == sorted(j_state)
        for k, v in j_state.items():
            per = v.shape[0] // n
            np.testing.assert_allclose(state[k], v[r * per:(r + 1) * per],
                                       atol=1e-6)

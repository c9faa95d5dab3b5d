"""The port's collectives, mesh and shard_parallel
(paddle_tpu_torch/distributed/{env,collective,shard_map_util,rendezvous}.py)
against the JAX package's, on the CPU.

The port runs one process per rank: 2 (and 4) gloo ranks, started by the
port's launcher with a free port and a timeout of their own, run this
file as their script (the rank side below imports torch and the port
only). The JAX side runs the same body under shard_map over as many of
the 8 host devices (tests/conftest.py) on the same global inputs; rank
r's result must equal block r of the shard_map's. Tolerances: f32
bit-equal on 2 ranks (a sum of two), 1e-6 on 4 (the reduction order may
differ). PROD is held at 1e-6 on positive inputs: the JAX package
computes exp(psum(log x)), which rounds otherwise and is NaN for x <= 0;
the port multiplies. Also: every op is the identity at world size 1,
collective.calls/bytes and the flight recorder's (op, axis, seq)
sequence equal the JAX package's for the same calls, shard_parallel
(split and replicated outputs, on one and two axes) returns the JAX
shard_map's arrays, the groups of a two-axis mesh give the expected
sums, and a JAX rank 0
bootstraps a port peer through rendezvous (and the other way round).
"""
import json
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
OPS = ("sum", "max", "min", "avg", "prod")


def _inputs(n):
    """The global inputs: x [n*4, 3] (positive: PROD), r [8, 3] (the
    same on every rank: scatter)."""
    rng = np.random.RandomState(11 + n)
    return {"x": (rng.rand(n * 4, 3) + 0.5).astype(np.float32),
            "r": rng.randn(8, 3).astype(np.float32)}


def _body(c, x, r, n):
    """The calls both packages make, in this order (`c` is the JAX or the
    port collective module; x this rank's block, r the replicated one)."""
    out = {}
    for op in OPS:
        out["ar_" + op] = c.all_reduce(x.clone(), op=op)
    out["ag"] = c.all_gather(x)
    lst = []
    c.all_gather(lst, x)
    out["ag_list"] = lst
    out["bc"] = c.broadcast(x.clone(), src=1)
    for op in ("sum", "max", "min"):
        out["red_" + op] = c.reduce(x.clone(), dst=1, op=op)
    out["scatter"] = c.scatter(r.clone())
    out["rs"] = c.reduce_scatter(x.clone())
    out["a2a"] = c.all_to_all(x.clone())
    out["a2a_cat1"] = c.all_to_all(x.clone(), split_axis=0, concat_axis=1)
    out["shift"] = c.p2p_shift(x, shift=1)
    c.send(x, dst=n - 1)
    out["recv"] = c.recv(x.clone(), src=0)
    c.barrier()
    return out


def _sp_body(c, a):
    """shard_parallel's body in both packages: a sum over the group (its
    output split, then replicated) and a blockwise product."""
    return c.all_reduce(a * 2.0), c.all_reduce(a.clone()), a * 3.0


# -- the rank side: torch and the port only -----------------------------------

def _os_threads():
    """The names of this process's OS threads (gloo names its tcp loop
    and workers, the store its server thread)."""
    names = []
    for t in sorted(os.listdir("/proc/self/task")):
        try:
            with open(f"/proc/self/task/{t}/comm") as f:
                names.append(f.read().strip())
        except OSError:
            pass
    return names


def _record_threads_at_exit(out_dir, rank):
    """At interpreter exit, after the port's teardown (atexit runs its
    handlers last in, first out, and this one is registered before the
    process group starts), write the threads still alive."""
    import atexit
    import json

    def write():
        with open(os.path.join(out_dir, f"threads{rank}.json"), "w") as f:
            json.dump(_os_threads(), f)
    atexit.register(write)


def _rank_main(out_dir):
    """One rank: every call of _body, then the world group, shard_parallel,
    an explicit group and a two-axis mesh; the results pickled."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as c
    from paddle_tpu_torch.observability import flight_recorder as fr
    from paddle_tpu_torch.observability import metrics
    torch.set_num_threads(1)
    pt.set_device("cpu")
    n = int(os.environ["WORLD_SIZE"])
    _record_threads_at_exit(out_dir, int(os.environ["RANK"]))
    dist.init_parallel_env()
    rank = dist.get_rank()
    res = {"rank": rank, "world": dist.get_world_size(),
           "threads_in_work": _os_threads()}
    g = _inputs(n)
    x = torch.from_numpy(g["x"][rank * 4:(rank + 1) * 4])
    r = torch.from_numpy(g["r"])
    metrics.enable()
    fr.enable()
    metrics.reset("collective.")
    fr.reset()
    with dist.axis_context("dp"):
        out = _body(c, x, r, n)
    res["calls"] = {k: v["value"] for k, v in
                    metrics.snapshot("collective.").items()}
    res["seq"] = [(e["op"], e["axis"], e["seq"]) for e in
                  fr.get_recorder().events()
                  if e["k"] == "collective.enter"]
    metrics.disable()
    fr.disable()
    out["ag_list"] = torch.stack(out["ag_list"])
    res["out"] = {k: v.numpy() for k, v in out.items()}
    # no axis context: the world's group
    res["world_sum"] = c.all_reduce(x.clone()).numpy()
    # the one composed op: gloo's AVG of integers (SUM, truncating div)
    res["int_avg"] = c.all_reduce(
        torch.tensor([3 * rank + 1, -(5 * rank + 2)], dtype=torch.int32),
        op="avg").numpy()
    # shard_parallel: blocks in, assembled global arrays out
    sp = dist.shard_parallel(
        lambda a: _sp_body(c, a), in_specs=dist.P("dp"),
        out_specs=(dist.P("dp"), dist.P(), dist.P("dp")))
    res["sp"] = [t.numpy() for t in sp(torch.from_numpy(g["x"]))]
    # an explicit group over ranks 0 and 1 (collective to make)
    grp = c.new_group([0, 1])
    if rank < 2:
        res["group01"] = c.all_reduce(x.clone(), group=grp).numpy()
    # a two-axis mesh over the same ranks: (host, chip) = (n/2, 2)
    mesh = dist.build_mesh({"host": n // 2, "chip": 2})
    dist.set_mesh(mesh)
    res["coords"] = mesh.coords(rank)
    v = torch.full((2,), float(rank + 1))
    res["host_sum"] = c.all_reduce(v.clone(), group="host").numpy()
    res["chip_sum"] = c.all_reduce(v.clone(), group="chip").numpy()
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    sp = dist.shard_parallel(
        lambda a: c.all_reduce(a, group="chip"), mesh,
        in_specs=dist.P("host", "chip"), out_specs=dist.P("host", "chip"))
    res["sp2"] = sp(x).numpy()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1])
    sys.exit(0)


# -- the test side ----------------------------------------------------------------

import torch  # noqa: E402


def launch_ranks(n, out_dir, timeout=120):
    """This file run as `n` gloo ranks by the port's launcher (CUDA
    hidden, one torch thread each); returns each rank's pickled result. A
    hang fails this call at `timeout`, the whole process group killed."""
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
    assert proc.returncode == 0, f"{n} ranks failed\n{log[-6000:]}"
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
        with open(os.path.join(out_dir, f"threads{r}.json")) as f:
            out[-1]["threads_at_exit"] = json.load(f)
    return out


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    n = request.param
    return n, launch_ranks(n, tmp_path_factory.mktemp(f"coll{n}"))


_JAX_CACHE = {}


def _jax_run(n):
    """The JAX package's results of _body under shard_map over n host
    devices, its counters and its recorder's sequence."""
    if n in _JAX_CACHE:
        return _JAX_CACHE[n]
    import jax
    import paddle_tpu as paddle
    import paddle_tpu.distributed as jdist
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu.distributed import collective as jc
    from paddle_tpu.observability import flight_recorder as jfr
    from paddle_tpu.observability import metrics as jmetrics
    g = _inputs(n)
    mesh = jdist.build_mesh({"dp": n}, devices=jax.devices()[:n])
    keys = []

    def body(x, r):
        out = _body(jc, x, r, n)
        out["ag_list"] = paddle.stack(out["ag_list"])
        keys[:] = sorted(out)
        return tuple(out[k] for k in sorted(out))

    names = sorted(_body_keys())
    specs = tuple(JP(None, "dp") if k in ("ag", "ag_list") else JP("dp")
                  for k in names)
    jmetrics.enable()
    jfr.enable()
    jmetrics.reset("collective.")
    jfr.reset()
    try:
        w = jax.jit(jdist.shard_parallel(
            body, mesh, in_specs=(JP("dp"), JP()), out_specs=specs,
            axes=("dp",)).__wrapped_smap__)
        outs = w(g["x"], g["r"])
        calls = {k: v["value"] for k, v in
                 jmetrics.snapshot("collective.").items()}
        seq = [(e["op"], e["axis"], e["seq"]) for e in
               jfr.get_recorder().events() if e["k"] == "collective.enter"]
    finally:
        jmetrics.disable()
        jfr.disable()
    assert keys == names
    res = {k: np.asarray(o) for k, o in zip(names, outs)}
    _JAX_CACHE[n] = (res, calls, seq)
    return _JAX_CACHE[n]


def _body_keys():
    return (["ar_" + op for op in OPS] + ["ag", "ag_list", "bc"]
            + ["red_" + op for op in ("sum", "max", "min")]
            + ["scatter", "rs", "a2a", "a2a_cat1", "shift", "recv"])


def _block(arr, key, n, rank):
    if key in ("ag", "ag_list"):
        # [n, 4, 3] a rank, laid along dim 1 by the spec (None, "dp")
        return arr[:, rank * 4:(rank + 1) * 4]
    per = arr.shape[0] // n
    return arr[rank * per:(rank + 1) * per]


@pytest.mark.parametrize("key", _body_keys())
def test_collective_matches_shard_map(ranks, key):
    n, reports = ranks
    want, _, _ = _jax_run(n)
    for rep in reports:
        got = rep["out"][key]
        ref = _block(want[key], key, n, rep["rank"])
        assert got.shape == ref.shape, (key, got.shape, ref.shape)
        if n == 2 and key != "ar_prod":
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                       err_msg=key)


def test_telemetry_matches_jax(ranks):
    n, reports = ranks
    _, calls, seq = _jax_run(n)
    for rep in reports:
        assert rep["calls"] == calls
        assert rep["seq"] == seq


def _jax_shard_parallel(fn, mesh_shape, in_spec, out_specs, x):
    import jax
    import paddle_tpu as paddle
    import paddle_tpu.distributed as jdist
    n = int(np.prod(list(mesh_shape.values())))
    mesh = jdist.build_mesh(mesh_shape, devices=jax.devices()[:n])
    w = jdist.shard_parallel(fn, mesh, in_specs=in_spec, out_specs=out_specs,
                             axes=tuple(mesh_shape))
    out = w(paddle.to_tensor(x))
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o.numpy()) for o in outs]


def test_world_group_shard_parallel_and_new_group(ranks):
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu.distributed import collective as jc
    n, reports = ranks
    g = _inputs(n)
    total = g["x"].reshape(n, 4, 3).sum(0)
    want = _jax_shard_parallel(lambda a: _sp_body(jc, a), {"dp": n},
                               JP("dp"), (JP("dp"), JP(), JP("dp")), g["x"])
    ints = np.array([[3 * r + 1, -(5 * r + 2)] for r in range(n)]).sum(0)
    int_avg = np.trunc(ints / n).astype(np.int32)
    for rep in reports:
        np.testing.assert_allclose(rep["world_sum"], total, rtol=1e-6)
        assert rep["int_avg"].dtype == np.int32
        np.testing.assert_array_equal(rep["int_avg"], int_avg)
        assert [a.shape for a in rep["sp"]] == [a.shape for a in want]
        for got, ref in zip(rep["sp"], want):
            np.testing.assert_allclose(got, ref, rtol=1e-6)
        if rep["rank"] < 2:
            np.testing.assert_allclose(
                rep["group01"], g["x"][:4] + g["x"][4:8], rtol=1e-6)


def test_two_axis_mesh_groups(ranks):
    """(host, chip) = (n/2, 2): a host group holds the ranks that share a
    chip coordinate, a chip group those that share a host."""
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu.distributed import collective as jc
    n, reports = ranks
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    want = x.reshape(4, 2, 2).sum(1, keepdims=True).repeat(2, 1).reshape(4, 4)
    spec = JP("host", "chip")
    jax_sp2, = _jax_shard_parallel(lambda a: jc.all_reduce(a, group="chip"),
                                   {"host": n // 2, "chip": 2}, spec, spec, x)
    np.testing.assert_array_equal(jax_sp2, want)
    for rep in reports:
        host, chip = divmod(rep["rank"], 2)
        assert rep["coords"] == {"host": host, "chip": chip}
        assert list(rep["host_sum"]) == [float(sum(
            2 * h + chip + 1 for h in range(n // 2)))] * 2
        assert list(rep["chip_sum"]) == [float(4 * host + 3)] * 2
        np.testing.assert_array_equal(rep["sp2"], want)


def test_exit_teardown_joins_every_gloo_thread(ranks):
    """The rank left its groups, a mesh over two axes and a new_group in
    its globals and module state. The exit teardown
    (distributed/parallel.py _destroy_at_exit) destroys the groups and
    drops those references, so by the time the interpreter finalizes no
    gloo thread and no store thread is left: threads that outlived the
    teardown were what aborted a finished rank under load."""
    _, reports = ranks
    for rep in reports:
        during = rep["threads_in_work"]
        assert any("gloo" in t for t in during), during
        left = [t for t in rep["threads_at_exit"]
                if "gloo" in t or "tcpstore" in t]
        assert not left, (rep["rank"], rep["threads_at_exit"])


def test_identity_at_world_size_one():
    """No process group: every call returns what the JAX package returns
    outside a shard_map."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed import collective as jc
    from paddle_tpu_torch.distributed import collective as c
    g = _inputs(1)
    x, r = torch.from_numpy(g["x"]), torch.from_numpy(g["r"])
    got = _body(c, x, r, 1)
    want = _body(jc, paddle.to_tensor(g["x"]), paddle.to_tensor(g["r"]), 1)
    for k in got:
        a = torch.stack(got[k]).numpy() if isinstance(got[k], list) \
            else got[k].numpy()
        b = np.stack([t.numpy() for t in want[k]]) \
            if isinstance(want[k], list) else want[k].numpy()
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_jax_rank0_bootstraps_a_port_peer():
    """The wire format is shared: a JAX rank 0 serves, a port peer
    fetches; and the other way round."""
    import socket
    import threading
    from paddle_tpu.distributed import rendezvous as jr
    from paddle_tpu_torch.distributed import rendezvous as pr
    for server, client in ((jr, pr), (pr, jr)):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ep = f"127.0.0.1:{port}"
        payload = b"coordinator=10.0.0.1:8476;world=2" + bytes(range(256))
        got = {}
        t = threading.Thread(target=lambda: got.setdefault(
            "srv", server.broadcast_bootstrap(payload, ep, 0, 2,
                                              timeout=20.0)))
        t.start()
        assert client.broadcast_bootstrap(None, ep, 1, 2,
                                          timeout=20.0) == payload
        t.join(30)
        assert got["srv"] == payload


def test_rendezvous_timeout_names_the_endpoint(monkeypatch):
    from paddle_tpu_torch.distributed import rendezvous as pr
    monkeypatch.setenv("PD_RDZV_ATTEMPTS", "2")
    monkeypatch.setenv("PD_RDZV_BACKOFF_S", "0.01")
    rv = pr.Rendezvous("127.0.0.1:1", 1, 2, timeout=0.1)
    assert rv.attempts == 2
    with pytest.raises(TimeoutError, match=r"127\.0\.0\.1:1.*2 attempt"):
        rv.fetch()

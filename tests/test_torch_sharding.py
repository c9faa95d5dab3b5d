"""The port's planner (paddle_tpu_torch/distributed/sharding.py and
observability/calibration.py's analytic half) against the JAX package's.

Spec derivation is layout math, so the two packages must give equal
PartitionSpecs (as tuples) for every parameter of tiny dense and MoE
ERNIE, under ShardingPlan (ZeRO stages 0-3, with and without an fsdp
axis) and MeshPlan (dp, fsdp, tp and pp axes), and equal data specs.
The JAX ShardingPlan holds a jax Mesh over the 8 host devices
(tests/conftest.py); the port's holds an env.Mesh with no process group
(no groups: derivation needs none). The cost model (candidate_layouts,
estimate_layout, choose_layout, MeshPlan.auto with calibration=None)
must pick the same winner with costs and analytic step times within
1e-9 relative. calibration="auto" warns and falls back to the analytic
ranking where the committed table does not match (both packages); where
it matches (cpu, 8 devices) both packages rank with the table: the same
winner, calibrated estimates within 1e-9 relative and the same
receipt. The fleet's mesh_plan,
build_mesh_plan and build_sharding_plan give the JAX fleet's plans.
"""
import warnings

import numpy as np
import pytest

import jax

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import sharding as js
from paddle_tpu.models import ErnieConfig as JConfig
from paddle_tpu.models import ErnieForPretraining as JErnie

import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as pdist
from paddle_tpu_torch.distributed import sharding as ps
from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining

GiB = 2 ** 30


@pytest.fixture(autouse=True)
def fresh_mesh():
    jdist.set_mesh(None)
    pdist.set_mesh(None)
    yield
    jdist.set_mesh(None)
    pdist.set_mesh(None)


def _tup(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


@pytest.fixture(scope="module", params=["dense", "moe"])
def models(request):
    kw = {} if request.param == "dense" else dict(moe_num_experts=4)
    paddle.seed(0)
    jm = JErnie(JConfig.tiny(**kw))
    tm = ErnieForPretraining(ErnieConfig.tiny(**kw), device="cpu")
    jstate = jm.state_dict()
    tstate = tm.state_dict(keep_vars=True)
    assert sorted(jstate) == sorted(tstate)
    return jstate, tstate


SHARDING_MESHES = [({"dp": 4}, None), ({"dp": 2, "fsdp": 2}, "fsdp"),
                   ({"dp": 2, "tp": 2}, None),
                   ({"dp": 2, "ep": 2, "tp": 2}, None)]


@pytest.mark.parametrize("shape,fsdp", SHARDING_MESHES)
@pytest.mark.parametrize("zero", [0, 1, 2, 3])
def test_sharding_plan_specs_equal_jax(models, shape, fsdp, zero):
    jstate, tstate = models
    n = int(np.prod(list(shape.values())))
    jmesh = jdist.build_mesh(shape, devices=jax.devices()[:n])
    tmesh = pdist.build_mesh(shape, devices=list(range(n)))
    jplan = js.ShardingPlan(jmesh, zero_stage=zero, fsdp_axis=fsdp)
    tplan = ps.ShardingPlan(tmesh, zero_stage=zero, fsdp_axis=fsdp)
    assert jplan.data_axes == tplan.data_axes
    for name in jstate:
        for fn in ("param_spec", "state_spec"):
            want = getattr(jplan, fn)(name, jstate[name])
            got = getattr(tplan, fn)(name, tstate[name])
            assert _tup(got) == _tup(want), (fn, name)
    for nd in (0, 1, 2, 3):
        arr = np.zeros((4,) * nd, np.float32)
        assert _tup(tplan.data_spec(arr)) == _tup(jplan.data_spec(arr))


MESH_PLANS = [dict(dp=2), dict(fsdp=2), dict(tp=2), dict(dp=2, fsdp=2),
              dict(fsdp=2, tp=2), dict(dp=2, fsdp=2, tp=2, pp=2),
              dict(tp=4, pp=2)]


@pytest.mark.parametrize("sizes", MESH_PLANS)
def test_mesh_plan_specs_equal_jax(models, sizes):
    jstate, tstate = models
    jplan, tplan = js.MeshPlan(**sizes), ps.MeshPlan(**sizes)
    assert jplan.axis_names() == tplan.axis_names()
    assert jplan.mesh_shape() == tplan.mesh_shape()
    for name in jstate:
        for fn in ("param_spec", "state_spec", "stacked_param_spec"):
            want = getattr(jplan, fn)(name, jstate[name])
            got = getattr(tplan, fn)(name, tstate[name])
            assert _tup(got) == _tup(want), (fn, name)
    for nd in (0, 1, 2, 3):
        arr = np.zeros((8,) * nd, np.float32)
        assert _tup(tplan.data_spec(arr)) == _tup(jplan.data_spec(arr))
    for nd in (1, 2, 3):
        assert _tup(tplan.activation_spec(nd)) == \
            _tup(jplan.activation_spec(nd))
        assert _tup(tplan.stacked_activation_spec(nd + 1)) == \
            _tup(jplan.stacked_activation_spec(nd + 1))
    assert tplan._mesh is None        # derivation built no mesh


def test_mesh_plan_sharding_plan_and_mesh():
    for sizes in MESH_PLANS[:5]:
        jp, tp = js.MeshPlan(**sizes), ps.MeshPlan(**sizes)
        n = jp.n_devices
        jm = jp.build_mesh(devices=jax.devices()[:n])
        tm = tp.build_mesh()
        assert tuple(jm.axis_names) == tm.axis_names
        assert dict(jm.shape) == tm.shape
        js_, ts_ = jp.sharding_plan(), tp.sharding_plan()
        assert (js_.data_axes, js_.dp_axis, js_.fsdp_axis,
                js_.zero_stage) == (ts_.data_axes, ts_.dp_axis,
                                    ts_.fsdp_axis, ts_.zero_stage)


DIMS = [dict(n_params=10_000_000, hidden=1024, n_layers=4, batch=64,
             seq=128),
        dict(n_params=2_000_000_000, hidden=4096, n_layers=24, batch=128,
             seq=512),
        dict(n_params=4_000_000_000, hidden=8192, n_layers=8, batch=16,
             seq=512, largest_layer_params=1_500_000_000),
        dict(n_params=110_000_000, hidden=768, n_layers=12, batch=48,
             seq=512, vocab=30528)]
CASES = [(8, 16 * GiB, {}), (8, 12 * GiB, {}), (8, 12 * GiB,
                                                 {"max_pp": 2}),
         (8, 80e9, {})]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("compress", ["none", "bf16", "int8_ef"])
def test_cost_model_equals_jax(case, compress):
    n, hbm, kw = CASES[case]
    jd, td = js.ModelDims(**DIMS[case]), ps.ModelDims(**DIMS[case])
    assert ps.candidate_layouts(n, **kw) == js.candidate_layouts(n, **kw)
    for cand in js.candidate_layouts(n, **kw):
        a = js.estimate_layout(cand, jd, hbm, compress=compress)
        b = ps.estimate_layout(cand, td, hbm, compress=compress)
        assert a.sizes == b.sizes and a.feasible == b.feasible
        assert a.wire_by_axis.keys() == b.wire_by_axis.keys()
        for x, y in ((a.hbm_per_chip, b.hbm_per_chip),
                     (a.cost, b.cost),
                     (a.analytic_step_time_s, b.analytic_step_time_s)):
            assert _rel(y, x) <= 1e-9
    jbest, jrep = js.choose_layout(n, jd, hbm, compress=compress, **kw)
    tbest, trep = ps.choose_layout(n, td, hbm, compress=compress, **kw)
    assert jbest == tbest
    jp = js.MeshPlan.auto(n, jd, hbm, compress=compress, calibration=None,
                          **kw)
    tp = ps.MeshPlan.auto(n, td, hbm, compress=compress, calibration=None,
                          **kw)
    assert jp.sizes == tp.sizes
    assert [r.as_dict()["sizes"] for r in jp.report] == \
        [r.as_dict()["sizes"] for r in tp.report]
    jr, tr = jp.predict(jd), tp.predict(td)
    assert _rel(tr.predicted_step_time_s, jr.predicted_step_time_s) <= 1e-9
    assert _rel(tr.predicted_hbm_bytes, jr.predicted_hbm_bytes) <= 1e-9
    assert tr.used == jr.used == "analytic"


def test_infeasible_raises_alike():
    d = dict(n_params=4_000_000_000, hidden=8192, n_layers=8, batch=16,
             seq=512)
    msgs = []
    for mod in (js, ps):
        with pytest.raises(ValueError, match="closest") as e:
            mod.choose_layout(8, mod.ModelDims(**d), 1 * GiB)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_auto_warns_and_falls_back_where_the_table_does_not_match():
    """The committed table is cpu-8dev: at 4 devices both packages warn
    STALE, count it, and rank with the analytic constants."""
    from paddle_tpu_torch.observability import metrics
    dims = DIMS[0]
    plans = []
    for mod in (js, ps):
        with pytest.warns(UserWarning, match="STALE"):
            plans.append(mod.MeshPlan.auto(4, mod.ModelDims(**dims),
                                           16 * GiB))
        assert plans[-1].calibration is None
    assert plans[0].sizes == plans[1].sizes
    assert metrics.get("planner.calibration_stale_total").value() >= 1


def test_a_matching_table_or_a_calibration_is_item_17():
    """Item 17 ported the calibrated ranking: the committed cpu-8dev table
    matches 8 devices, and both packages rank with it alike."""
    from paddle_tpu.observability import calibration as jcal
    from paddle_tpu_torch.observability import calibration as tcal
    dims = DIMS[0]
    jp = js.MeshPlan.auto(8, js.ModelDims(**dims), 16 * GiB)
    tp = ps.MeshPlan.auto(8, ps.ModelDims(**dims), 16 * GiB)
    assert jp.calibration is not None and tp.calibration is not None
    assert tp.calibration.table == jp.calibration.table
    assert tp.sizes == jp.sizes
    for a, b in zip(jp.report, tp.report):
        assert b.used == a.used == "calibrated"
        assert _rel(b.calibrated_step_time_s, a.calibrated_step_time_s) \
            <= 1e-9
    jr, tr = jp.predict(), tp.predict()
    assert tr.used == jr.used == "calibrated" and tr.calibration_match
    assert (tr.device_kind, tr.topology) == (jr.device_kind, jr.topology)
    assert _rel(tr.predicted_step_time_s, jr.predicted_step_time_s) <= 1e-9
    assert tp.describe()["calibration"] == jp.describe()["calibration"]
    calib = tcal.Calibration(jcal.build_table("cpu", 8))
    a = js.estimate_layout({"dp": 8}, js.ModelDims(**dims), 16 * GiB,
                           calibration=jcal.Calibration(calib.table))
    b = ps.estimate_layout({"dp": 8}, ps.ModelDims(**dims), 16 * GiB,
                           calibration=calib)
    assert _rel(b.calibrated_step_time_s, a.calibrated_step_time_s) <= 1e-9
    with pytest.raises(NotImplementedError, match="14c"):
        ps.MeshPlan(dp=2).resync_assignments({})


def test_serving_specs_and_qkv_permutation_equal_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(16, 3 * 8).astype(np.float32)
    np.testing.assert_array_equal(
        ps.permute_qkv_heads(w, 4), np.asarray(js.permute_qkv_heads(w, 4)))
    import torch
    np.testing.assert_array_equal(
        ps.permute_qkv_heads(torch.from_numpy(w), 4).numpy(),
        np.asarray(js.permute_qkv_heads(w, 4)))
    snap = {"wte": 0, "blocks": [{"qkv_w": 0, "qkv_b": 0, "proj_w": 0,
                                  "fc1_w": {"q8": 0, "s": 0},
                                  "fc2_w": {"q8": 0, "s": 0}}]}
    got = ps.serving_param_specs(snap)
    want = js.serving_param_specs(snap)
    flat_w = jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, js.PartitionSpec))
    flat_g = jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, ps.PartitionSpec))
    assert [_tup(s) for s in flat_g] == [_tup(s) for s in flat_w]
    assert {k: _tup(v) for k, v in ps.SERVING_TP_RULES.items()} == \
        {k: _tup(v) for k, v in js.SERVING_TP_RULES.items()}


@pytest.mark.parametrize("hybrid", [{}, {"mp_degree": 2},
                                    {"fsdp_degree": 2, "mp_degree": 2},
                                    {"pp_degree": 2, "dp_degree": 2},
                                    {"sep_degree": 2}])
def test_fleet_mesh_plan_equals_jax(hybrid):
    from paddle_tpu.distributed.fleet import base as jfb
    from paddle_tpu_torch.distributed.fleet import base as pfb
    for n in (1, 4, 8):
        plans = []
        for mod in (jfb, pfb):
            s = mod.DistributedStrategy()
            s.hybrid_configs = dict(s.hybrid_configs, **hybrid)
            plans.append(s.mesh_plan(n))
        assert plans[0].sizes == plans[1].sizes, (hybrid, n)


@pytest.mark.parametrize("stage", [None, 1, 2, 3])
def test_fleet_build_sharding_plan_equals_jax(stage):
    from paddle_tpu.distributed.fleet import base as jfb
    from paddle_tpu_torch.distributed.fleet import base as pfb
    plans = []
    for mod in (jfb, pfb):
        s = mod.DistributedStrategy()
        if stage is not None:
            s.sharding = True
            s.sharding_configs = dict(s.sharding_configs, stage=stage)
        f = mod.Fleet()
        f.init(is_collective=True, strategy=s)
        plans.append(f.build_sharding_plan())
        mp = f.build_mesh_plan()
        assert mp.sizes["tp"] == mp.sizes["pp"] == 1
    a, b = plans
    assert (a.zero_stage, a.dp_axis, a.fsdp_axis) == \
        (b.zero_stage, b.dp_axis, b.fsdp_axis)


def test_fleet_build_mesh_plan_auto_equals_jax():
    from paddle_tpu.distributed.fleet import base as jfb
    from paddle_tpu_torch.distributed.fleet import base as pfb
    d = DIMS[3]
    jf, pf = jfb.Fleet(), pfb.Fleet()
    jp = jf.build_mesh_plan(layout="auto", dims=js.ModelDims(**d),
                            hbm_bytes_per_chip=80e9)
    with pytest.warns(UserWarning, match="STALE"):
        pp = pf.build_mesh_plan(layout="auto", dims=ps.ModelDims(**d),
                                hbm_bytes_per_chip=80e9)
    # the JAX fleet plans over its 8 host devices (calibrated: the table
    # matches cpu-8dev), the port's over its world of one rank
    assert jp.n_devices == 8 and pp.n_devices == 1
    assert pp.sizes == {"dp": 1, "fsdp": 1, "tp": 1, "pp": 1}
    with pytest.raises(ValueError, match="dims="):
        pf.build_mesh_plan(layout="auto")


def test_place_batch_and_shard_tensor_without_a_group_are_whole():
    import torch
    plan = ps.MeshPlan(dp=2, tp=2).sharding_plan()
    x = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(plan.place_batch(x), x)
    t = ps.shard_tensor(x, mesh=plan.mesh, spec=ps.PartitionSpec("dp"))
    assert torch.equal(t, x) and tuple(t.sharding_spec) == ("dp",)

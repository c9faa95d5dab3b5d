"""The port's optimizers against the JAX package's, rule by rule.

Each of the eight optimizers added beside Adam/AdamW (SGD, Momentum,
Adagrad, Adadelta, Adamax, RMSProp, Lamb, Lars) runs 5 steps on the same
numpy params and gradients in both packages; params and every state
tensor are compared by name. Tolerances, each for its reason:
- f32: 1e-6 relative (plus 1e-6 absolute for entries near 0): the same
  f32 rule; the foreach ops may round in another order, and Lamb's and
  Lars's norms sum in another order;
- bf16 params under multi_precision: the tolerance of
  test_torch_training.py's test_adamw_multi_precision_bf16_matches_jax
  (1e-6 on the f32 masters and on the params read as f32).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.regularizer import L1Decay, L2Decay
from paddle_tpu_torch import optimizer as topt

SHAPES = [(7, 5), (5,), (3, 4)]
STEPS = 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=3):
    rng = np.random.RandomState(seed)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return init, grads


def _run_pair(name, kw, jdtype, tdtype, seed=3):
    """STEPS updates of `name`(**kw) in both packages from the same
    params and gradients; returns (jax params, jax state, torch params,
    torch optimizer)."""
    import jax.numpy as jnp
    init, grads = _data(seed)
    jo = getattr(jopt, name)(**kw)
    to = getattr(topt, name)(**kw)
    jp = {str(i): jnp.asarray(a).astype(jdtype) for i, a in enumerate(init)}
    js = jo.init_state_tree(jp)
    tp = [torch.from_numpy(a).to(tdtype) for a in init]
    to._parameters = tp
    for gs in grads:
        jp, js = jo.apply_gradients_tree(
            jp, {str(i): jnp.asarray(g).astype(jdtype)
                 for i, g in enumerate(gs)}, js)
        to.apply_gradients(tp, [torch.from_numpy(g).to(tdtype)
                                for g in gs])
    return jp, js, tp, to


CASES = [
    ("SGD", dict(learning_rate=0.1)),
    ("SGD", dict(learning_rate=0.1, weight_decay=L2Decay(0.05))),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9, use_nesterov=True)),
    ("Momentum", dict(learning_rate=0.1, use_nesterov=True,
                      weight_decay=L1Decay(0.02))),
    ("Adagrad", dict(learning_rate=0.1, initial_accumulator_value=0.1)),
    ("Adadelta", dict(learning_rate=0.5, rho=0.9)),
    ("Adamax", dict(learning_rate=0.05, weight_decay=L2Decay(0.01))),
    ("RMSProp", dict(learning_rate=0.05, momentum=0.5)),
    ("RMSProp", dict(learning_rate=0.05, momentum=0.5, centered=True)),
    ("Lamb", dict(learning_rate=0.1, lamb_weight_decay=0.01)),
    ("Lars", dict(learning_rate=0.1, lars_weight_decay=0.001)),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_optimizer_matches_jax_f32(name, kw):
    import jax.numpy as jnp
    jp, js, tp, to = _run_pair(name, kw, jnp.float32, torch.float32)
    for i, p in enumerate(tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[str(i)]),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
        st = to._accumulators[id(p)]
        assert set(st) == set(js[str(i)]), name
        for k, v in st.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(js[str(i)][k]),
                                       atol=1e-6, rtol=1e-6,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict(learning_rate=0.1, multi_precision=True)),
    ("Momentum", dict(learning_rate=0.1, use_nesterov=True,
                      weight_decay=L2Decay(0.01), multi_precision=True)),
])
def test_multi_precision_bf16_matches_jax(name, kw):
    import jax.numpy as jnp
    jp, js, tp, to = _run_pair(name, kw, jnp.bfloat16, torch.bfloat16)
    for i, p in enumerate(tp):
        assert p.dtype == torch.bfloat16
        master = to._accumulators[id(p)]["master_weight"]
        assert master.dtype == torch.float32
        np.testing.assert_allclose(
            master.numpy(), np.asarray(js[str(i)]["master_weight"]),
            atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(
            p.float().numpy(), np.asarray(jp[str(i)], np.float32),
            atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["Lamb", "Lars"])
def test_trust_ratio_branches_on_zero_norms(name):
    """A zero param (Lamb's w = 0) or a zero gradient (Lars's g = 0)
    takes the where(...) branch of 1, decided on the device: the update
    equals the JAX package's."""
    import jax.numpy as jnp
    p0 = np.zeros((4, 3), np.float32)
    g = np.ones((4, 3), np.float32) * (0.0 if name == "Lars" else 0.5)
    p1 = np.full((4, 3), 0.3, np.float32)
    kw = dict(learning_rate=0.1)
    jo, to = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    jp = {"a": jnp.asarray(p0), "b": jnp.asarray(p1)}
    js = jo.init_state_tree(jp)
    jp, js = jo.apply_gradients_tree(jp, {"a": jnp.asarray(g),
                                          "b": jnp.asarray(g)}, js)
    tp = [torch.from_numpy(p0.copy()), torch.from_numpy(p1.copy())]
    to.apply_gradients(tp, [torch.from_numpy(g), torch.from_numpy(g)])
    for t, k in zip(tp, ("a", "b")):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6)


def test_lr_is_a_device_tensor_and_state_restores_in_place():
    """apply_gradients takes lr as a 0-d tensor (a captured step's
    buffer) with the result of the float; set_state_dict writes into the
    existing state tensors (their data_ptr stays) and state_dict is a
    snapshot."""
    init, grads = _data(5)
    runs = []
    for lr in (0.1, torch.tensor(0.1)):
        tp = [torch.from_numpy(a.copy()) for a in init]
        o = topt.Momentum(learning_rate=0.5, parameters=tp)
        o.apply_gradients(tp, [torch.from_numpy(g) for g in grads[0]],
                          lr=lr)
        runs.append((tp, o))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    tp, o = runs[1]
    snap = o.state_dict()
    ptrs = {k: v.data_ptr() for k, v in o._accumulators[id(tp[0])].items()}
    o.apply_gradients(tp, [torch.from_numpy(g) for g in grads[1]])
    assert not torch.equal(snap["param_0"]["velocity"],
                           o._accumulators[id(tp[0])]["velocity"])
    o.set_state_dict(snap)
    st = o._accumulators[id(tp[0])]
    assert {k: v.data_ptr() for k, v in st.items()} == ptrs
    assert torch.equal(st["velocity"], snap["param_0"]["velocity"])

"""nn.BeamSearchDecoder + nn.dynamic_decode against the JAX package's,
and the weight reparameterisations (nn.utils.weight_norm,
remove_weight_norm, spectral_norm).

Decoding: an LSTMCell and a GRUCell (vocab 11, hidden 8, beam 3, batch
2), with an Embedding in and a Linear out, weights carried across by
name; the initial states from one numpy seed. The ids must be equal and
the final scores within 1e-5 x max(1, |ref|); runs that stop early
(every beam finished: the end token's bias raised) must stop at the
same step; time-major output is the transpose.

Weight norms: the same layer in both packages, reparameterised, then
the forward and the gradients of sum(out * w) with respect to the input
and the new parameters (weight_g, weight_v; weight_orig) at 1e-5, and
the state_dict names equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.models import load_jax_params
from torch_ops_parity import close

TOL = 1e-5
V, H, W, B = 11, 8, 3, 2
END = 2


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _copy(j, t):
    load_jax_params(t, {k: np.asarray(v.numpy())
                        for k, v in j.state_dict().items()})
    return t


def _decoders(cell, end_bias, seed):
    jp.seed(seed)
    jcell = getattr(jnn, cell)(H, H)
    jemb, jout = jnn.Embedding(V, H), jnn.Linear(H, V)
    tcell = _copy(jcell, getattr(tnn, cell)(H, H))
    temb = _copy(jemb, tnn.Embedding(V, H))
    tout = _copy(jout, tnn.Linear(H, V))
    if end_bias:
        b = np.asarray(jout.bias.numpy()).copy()
        b[END] += end_bias
        jout.bias.set_value(b)
        with torch.no_grad():
            tout.bias.copy_(torch.from_numpy(b))
    jd = jnn.BeamSearchDecoder(jcell, start_token=1, end_token=END,
                               beam_size=W, embedding_fn=jemb,
                               output_fn=jout)
    td = tnn.BeamSearchDecoder(tcell, start_token=1, end_token=END,
                               beam_size=W, embedding_fn=temb,
                               output_fn=tout)
    return jd, td


def _inits(cell, seed):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, H).astype(np.float32)
    if cell == "LSTMCell":
        c = rng.randn(B, H).astype(np.float32)
        return (jp.to_tensor(h), jp.to_tensor(c)), \
            (torch.from_numpy(h), torch.from_numpy(c))
    return jp.to_tensor(h), torch.from_numpy(h)


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell"])
@pytest.mark.parametrize("end_bias,max_steps", [(0.0, 7), (3.0, 20),
                                                (6.0, 20)])
@pytest.mark.parametrize("time_major", [False, True])
def test_beam_search_matches_jax(cell, end_bias, max_steps, time_major):
    jd, td = _decoders(cell, end_bias, seed=len(cell))
    jinit, tinit = _inits(cell, seed=3)
    jids, jsc = jnn.dynamic_decode(jd, inits=jinit, max_step_num=max_steps,
                                   output_time_major=time_major)
    with torch.no_grad():
        tids, tsc = tnn.dynamic_decode(td, inits=tinit,
                                       max_step_num=max_steps,
                                       output_time_major=time_major)
    jids = np.asarray(jids.numpy())
    assert tids.dtype == torch.int64
    assert tids.shape == jids.shape
    np.testing.assert_array_equal(tids.numpy(), jids)
    close(tsc.numpy(), np.asarray(jsc.numpy()), TOL, "scores")
    steps = tids.shape[0 if time_major else 1]
    if end_bias >= 6.0:
        # every beam finished before max_step_num: the loop stopped early
        assert steps < max_steps
        last = tids[-1] if time_major else tids[:, -1]
        assert (last == END).all()
    if end_bias == 0.0:
        assert steps == max_steps
    # beams come best first
    assert (tsc[:, :-1] >= tsc[:, 1:]).all()


def test_time_major_is_the_transpose():
    jd, td = _decoders("GRUCell", 3.0, seed=5)
    _, tinit = _inits("GRUCell", seed=4)
    with torch.no_grad():
        a, sa = tnn.dynamic_decode(td, inits=tinit, max_step_num=9)
        b, sb = tnn.dynamic_decode(td, inits=tinit, max_step_num=9,
                                   output_time_major=True)
    assert torch.equal(a, b.movedim(0, 1)) and torch.equal(sa, sb)


def test_decoder_base_contract():
    d = tnn.Decoder()
    with pytest.raises(NotImplementedError):
        d.initialize(None)
    with pytest.raises(NotImplementedError):
        d.step(0, None, None)
    assert d.finalize(1, 2, 3) == (1, 2)


# -- weight norms ---------------------------------------------------------------

def _run(layer, x, w, jax_side, names):
    if jax_side:
        xt = jp.to_tensor(x, stop_gradient=False)
        out = layer(xt)
        jp.sum(out * jp.to_tensor(w)).backward()
        params = dict(layer.named_parameters())
        return (np.asarray(out.numpy()), np.asarray(xt.grad.numpy()),
                {n: np.asarray(params[n].grad.numpy()) for n in names})
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    out = layer(xt)
    (out * torch.from_numpy(w)).sum().backward()
    params = dict(layer.named_parameters())
    return (out.detach().numpy(), xt.grad.numpy(),
            {n: params[n].grad.numpy() for n in names})


@pytest.mark.parametrize("kind,dim", [("weight_norm", 0),
                                      ("weight_norm", 1),
                                      ("weight_norm", None),
                                      ("spectral_norm", 0),
                                      ("spectral_norm", 1)])
def test_reparameterisation_matches_jax(kind, dim):
    jp.seed(7)
    j = jnn.Linear(5, 4)
    t = _copy(j, tnn.Linear(5, 4))
    if kind == "weight_norm":
        j = jnn.weight_norm(j, dim=dim)
        t = tnn.weight_norm(t, dim=dim)
        names = ["weight_g", "weight_v", "bias"]
    else:
        j = jnn.spectral_norm(j, dim=dim, n_power_iterations=2)
        t = tnn.spectral_norm(t, dim=dim, n_power_iterations=2)
        names = ["weight_orig", "bias"]
    jstate = {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()}
    assert sorted(t.state_dict()) == sorted(jstate)
    # the power-iteration vectors are drawn anew in each package
    load_jax_params(t, jstate)
    x = np.random.RandomState(8).randn(3, 5).astype(np.float32)
    w = np.random.RandomState(9).randn(3, 4).astype(np.float32)
    jo, jg, jpg = _run(j, x, w, True, names)
    to, tg, tpg = _run(t, x, w, False, names)
    close(to, jo, TOL, "out")
    close(tg, jg, TOL, "grad x")
    for n in names:
        close(tpg[n], jpg[n], TOL, f"grad {n}")


def test_remove_weight_norm_matches_jax():
    jp.seed(10)
    j = jnn.Linear(5, 4)
    t = _copy(j, tnn.Linear(5, 4))
    j = jnn.remove_weight_norm(jnn.weight_norm(j))
    t = tnn.remove_weight_norm(tnn.weight_norm(t))
    assert sorted(dict(t.named_parameters())) == ["bias", "weight"]
    assert sorted(dict(j.named_parameters())) == ["bias", "weight"]
    close(t.weight.detach().numpy(), np.asarray(j.weight.numpy()), TOL,
          "weight")
    x = np.random.RandomState(11).randn(3, 5).astype(np.float32)
    close(t(torch.from_numpy(x)).detach().numpy(),
          np.asarray(j(jp.to_tensor(x)).numpy()), TOL, "out")


def test_weight_norm_hook_module_reexports():
    from paddle_tpu_torch.nn import extension, vision, weight_norm_hook
    assert weight_norm_hook.weight_norm is tnn.weight_norm
    assert weight_norm_hook.remove_weight_norm is tnn.remove_weight_norm
    assert extension.diag_embed is pt.diag_embed
    assert vision.PixelShuffle is tnn.PixelShuffle

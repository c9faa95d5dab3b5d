"""The port's RNNs against the JAX package's: the cells, nn.RNN and
BiRNN over a cell, SimpleRNN, LSTM and GRU (1 and 2 layers,
bidirectional, time-major, with and without initial states), and the
op ops.rnn with sequence_length (multi-layer, bidirectional, the
valid-prefix reversal) beside lstm, fusion_gru and the unit ops.

Weights carry across by name (load_jax_params: the stacked layers'
`_cells.<i>.weight_ih` names are the JAX layer's); the same numpy
inputs go through both. Compared: outputs, final states and the
gradients of sum(out * w) + sum(state * w') with respect to the input,
the initial states and every weight, at 1e-5 x max(1, |ref|) (f32; the
port sums x W_ih + b_ih + b_hh + h W_hh in another order than the JAX
cell step).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu.ops import rnn_ops as jrnn
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.ops import rnn_ops as trnn
from torch_ops_parity import close

TOL = 1e-5
B, T, D, H = 3, 5, 4, 6


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v)]
    return [x]


def _jt(a):
    return jp.to_tensor(a, stop_gradient=a.dtype != np.float32)


def _tt(a):
    return torch.from_numpy(a.copy()).requires_grad_(a.dtype == np.float32)


def _grad(x, jax_side):
    if jax_side:
        return None if x.grad is None else np.asarray(x.grad.numpy())
    return None if x.grad is None else x.grad.numpy()


def _run(layer, args, kwargs, ws, jax_side):
    """layer(*args, **kwargs): its output leaves, and after the backward
    of sum(leaf * w) the gradients of the float args and params."""
    out = _leaves(layer(*args, **kwargs))
    if jax_side:
        loss = sum(jp.sum(o * jp.to_tensor(w)) for o, w in zip(out, ws))
    else:
        loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(out, ws))
    loss.backward()
    vals = [np.asarray(o.numpy()) if jax_side else o.detach().numpy()
            for o in out]
    grads = [_grad(a, jax_side) for a in _leaves(list(args))
             if hasattr(a, "grad")]
    params = {k: _grad(p, jax_side) for k, p in layer.named_parameters()}
    return vals, grads, params


def _compare(jlayer, tlayer, arrays, kwargs_of=lambda t: {},
             state_arrays=None):
    """Carry jlayer's weights into tlayer, run both on `arrays` (and
    initial states), compare everything."""
    state = {k: np.asarray(v.numpy()) for k, v in
             jlayer.state_dict().items()}
    load_jax_params(tlayer, state)
    jargs = [_jt(a) for a in arrays]
    targs = [_tt(a) for a in arrays]
    if state_arrays is not None:
        jargs.append(_nest(state_arrays, _jt))
        targs.append(_nest(state_arrays, _tt))
    probe = _leaves(jlayer(*jargs, **kwargs_of("jax")))
    rng = np.random.RandomState(11)
    ws = [rng.randn(*o.shape).astype(np.float32) for o in probe]
    jargs = [_jt(a) for a in arrays]
    if state_arrays is not None:
        jargs.append(_nest(state_arrays, _jt))
    jv, jg, jpg = _run(jlayer, jargs, kwargs_of("jax"), ws, True)
    tv, tg, tpg = _run(tlayer, targs, kwargs_of("torch"), ws, False)
    assert len(tv) == len(jv)
    for i, (a, b) in enumerate(zip(tv, jv)):
        close(a, b, TOL, f"out[{i}]")
    for i, (a, b) in enumerate(zip(tg, jg)):
        if b is not None:
            close(a, b, TOL, f"grad[{i}]")
    assert sorted(tpg) == sorted(jpg)
    for k in jpg:
        close(tpg[k], jpg[k], TOL, f"grad {k}")


def _nest(arrays, make):
    if isinstance(arrays, (list, tuple)):
        return tuple(_nest(a, make) for a in arrays)
    return make(arrays)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


STACKED = [(cls, layers, direction, tm, init)
           for cls in ("SimpleRNN", "LSTM", "GRU")
           for layers, direction in ((1, "forward"), (2, "forward"),
                                     (2, "bidirect"))
           for tm in (False, True) for init in (False, True)
           if not (tm and init and layers == 1)]


@pytest.mark.parametrize("cls,layers,direction,time_major,init", STACKED,
                         ids=lambda v: str(v))
def test_stacked_layer_matches_jax(cls, layers, direction, time_major,
                                   init):
    jp.seed(1)
    kw = dict(num_layers=layers, direction=direction, time_major=time_major)
    j = getattr(jnn, cls)(D, H, **kw)
    t = getattr(tnn, cls)(D, H, **kw)
    assert sorted(dict(t.named_parameters())) == \
        sorted(dict(j.named_parameters()))
    x = _x(T, B, D) if time_major else _x(B, T, D)
    states = None
    if init:
        n = layers * (2 if direction == "bidirect" else 1)
        h0 = _x(n, B, H, seed=2)
        states = (h0, _x(n, B, H, seed=3)) if cls == "LSTM" else h0
    _compare(j, t, [x], state_arrays=states)


def test_simple_rnn_relu_activation():
    jp.seed(2)
    j = jnn.SimpleRNN(D, H, activation="relu")
    t = tnn.SimpleRNN(D, H, activation="relu")
    _compare(j, t, [_x(B, T, D, seed=4)])


@pytest.mark.parametrize("cls", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("with_state", [False, True])
def test_cell_matches_jax(cls, with_state):
    jp.seed(3)
    j = getattr(jnn, cls)(D, H)
    t = getattr(tnn, cls)(D, H)
    states = None
    if with_state:
        states = ((_x(B, H, seed=5), _x(B, H, seed=6)) if cls == "LSTMCell"
                  else _x(B, H, seed=5))
    _compare(j, t, [_x(B, D, seed=7)], state_arrays=states)


@pytest.mark.parametrize("cls", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("reverse,time_major", [(False, False),
                                                (True, False), (False, True)])
def test_rnn_over_a_cell_matches_jax(cls, reverse, time_major):
    jp.seed(4)
    j = jnn.RNN(getattr(jnn, cls)(D, H), is_reverse=reverse,
                time_major=time_major)
    t = tnn.RNN(getattr(tnn, cls)(D, H), is_reverse=reverse,
                time_major=time_major)
    x = _x(T, B, D, seed=8) if time_major else _x(B, T, D, seed=8)
    _compare(j, t, [x])


def test_birnn_matches_jax_and_ignores_sequence_length():
    """BiRNN over an LSTM and a GRU cell; sequence_length is accepted and
    ignored (the JAX layer's quirk, followed)."""
    jp.seed(5)
    j = jnn.BiRNN(jnn.LSTMCell(D, H), jnn.GRUCell(D, H))
    t = tnn.BiRNN(tnn.LSTMCell(D, H), tnn.GRUCell(D, H))
    x = _x(B, T, D, seed=9)
    _compare(j, t, [x])
    lens = np.array([5, 2, 3])
    a = t(torch.from_numpy(x), sequence_length=torch.from_numpy(lens))[0]
    b = t(torch.from_numpy(x))[0]
    assert torch.equal(a, b)
    lstm = tnn.LSTM(D, H)
    assert torch.equal(lstm(torch.from_numpy(x),
                            sequence_length=torch.from_numpy(lens))[0],
                       lstm(torch.from_numpy(x))[0])


def test_rnn_rejects_another_cell():
    class Cell(tnn.Layer):
        hidden_size = 3
    with pytest.raises(TypeError, match="LSTMCell"):
        tnn.RNN(Cell())(torch.zeros(2, 3, 4))


# -- ops.rnn and the op family ------------------------------------------------

GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _weights(mode, layers, bidirec, seed):
    rng = np.random.RandomState(seed)
    nd = 2 if bidirec else 1
    g = GATES[mode]
    out = []
    for layer in range(layers):
        d_in = D if layer == 0 else H * nd
        for _ in range(nd):
            out += [rng.randn(g * H, d_in).astype(np.float32) * 0.4,
                    rng.randn(g * H, H).astype(np.float32) * 0.4,
                    rng.randn(g * H).astype(np.float32) * 0.1,
                    rng.randn(g * H).astype(np.float32) * 0.1]
    return out


def _op_compare(jfn, tfn, arrays, kw_jax, kw_torch):
    """jfn/tfn over the same float arrays (all take a gradient)."""
    jargs = [jp.to_tensor(a, stop_gradient=False) for a in arrays]
    targs = [torch.from_numpy(a.copy()).requires_grad_(True)
             for a in arrays]
    jo = _leaves(jfn(*jargs, **kw_jax))
    to = _leaves(tfn(*targs, **kw_torch))
    rng = np.random.RandomState(12)
    ws = [rng.randn(*o.shape).astype(np.float32) for o in jo]
    sum(jp.sum(o * jp.to_tensor(w)) for o, w in zip(jo, ws)).backward()
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(to, ws)).backward()
    assert len(to) == len(jo)
    for i, (a, b) in enumerate(zip(to, jo)):
        close(a.detach().numpy(), np.asarray(b.numpy()), TOL, f"out[{i}]")
    for i, (a, b) in enumerate(zip(targs, jargs)):
        want = np.zeros(a.shape, np.float32) if b.grad is None else \
            np.asarray(b.grad.numpy())
        got = np.zeros(a.shape, np.float32) if a.grad is None else \
            a.grad.numpy()
        close(got, want, TOL, f"grad[{i}]")


@pytest.mark.parametrize("mode", ["LSTM", "GRU", "RNN_TANH", "RNN_RELU"])
@pytest.mark.parametrize("layers,bidirec,lengths,time_major", [
    (1, False, None, False), (2, True, None, False),
    (2, True, [5, 2, 3], False), (1, False, [4, 5, 1], True),
    (2, False, [3, 5, 2], False)])
def test_rnn_op_matches_jax(mode, layers, bidirec, lengths, time_major):
    ws = _weights(mode, layers, bidirec, seed=len(mode) + layers)
    x = _x(T, B, D, seed=13) if time_major else _x(B, T, D, seed=13)
    kw = dict(mode=mode, num_layers=layers, is_bidirec=bidirec,
              time_major=time_major)
    jkw = dict(kw, sequence_length=None if lengths is None
               else jp.to_tensor(np.array(lengths)))
    tkw = dict(kw, sequence_length=None if lengths is None
               else torch.tensor(lengths))
    _op_compare(jrnn.rnn, trnn.rnn, [x] + ws, jkw, tkw)


def test_rnn_op_initial_states_match_jax():
    """With initial states (which the JAX op takes as a keyword tuple, so
    its reference comes from jax.vjp of the op's pure function)."""
    import jax
    import jax.numpy as jnp
    ws = _weights("LSTM", 2, True, seed=21)
    x = _x(B, T, D, seed=14)
    h0, c0 = _x(4, B, H, seed=15), _x(4, B, H, seed=16)
    lens = [5, 3, 4]
    kw = dict(mode="LSTM", num_layers=2, is_bidirec=True)

    def jfn(x, h0, c0, *w):
        return jrnn.rnn.__pure_fn__(x, *w, initial_states=(h0, c0),
                                    sequence_length=jnp.array(lens), **kw)
    arrays = [x, h0, c0] + ws
    outs, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    rng = np.random.RandomState(12)
    cot = tuple(rng.randn(*o.shape).astype(np.float32) for o in outs)
    grads = vjp(tuple(jnp.asarray(c) for c in cot))
    targs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    tout = trnn.rnn(targs[0], *targs[3:], initial_states=tuple(targs[1:3]),
                    sequence_length=torch.tensor(lens), **kw)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cot)).backward()
    for i, (a, b) in enumerate(zip(tout, outs)):
        close(a.detach().numpy(), np.asarray(b), TOL, f"out[{i}]")
    for i, (a, b) in enumerate(zip(targs, grads)):
        close(a.grad.numpy(), np.asarray(b), TOL, f"grad[{i}]")


@pytest.mark.parametrize("name", ["lstm", "fusion_lstm", "fusion_gru"])
@pytest.mark.parametrize("lengths,reverse", [(None, False), ([5, 2, 4], True),
                                             (None, True)])
def test_single_layer_ops_match_jax(name, lengths, reverse):
    mode = "GRU" if name == "fusion_gru" else "LSTM"
    ws = _weights(mode, 1, False, seed=31)
    x = _x(B, T, D, seed=17)
    jkw = dict(is_reverse=reverse, sequence_length=None if lengths is None
               else jp.to_tensor(np.array(lengths)))
    tkw = dict(is_reverse=reverse, sequence_length=lengths)
    _op_compare(getattr(jrnn, name), getattr(trnn, name), [x] + ws, jkw, tkw)


def test_unit_and_fusion_ops_match_jax():
    rng = np.random.RandomState(41)

    def r(*s):
        return rng.randn(*s).astype(np.float32)
    _op_compare(jrnn.lstm_unit, trnn.lstm_unit, [r(B, 4 * H), r(B, H)],
                {"forget_bias": 0.5}, {"forget_bias": 0.5})
    for origin in (False, True):
        _op_compare(jrnn.gru_unit, trnn.gru_unit,
                    [r(B, 3 * H), r(B, H), r(H, 3 * H), r(3 * H)],
                    {"origin_mode": origin}, {"origin_mode": origin})
    _op_compare(lambda x, w1, b1, w2, b2: jrnn.fusion_repeated_fc_relu(
        x, [w1, w2], [b1, b2]),
        lambda x, w1, b1, w2, b2: trnn.fusion_repeated_fc_relu(
            x, [w1, w2], [b1, b2]),
        [r(B, D), r(D, H), r(H), r(H, 3), r(3)], {}, {})
    _op_compare(jrnn.fusion_squared_mat_sub, trnn.fusion_squared_mat_sub,
                [r(B, D), r(D, H)], {"scalar": 0.5}, {"scalar": 0.5})
    _op_compare(jrnn.batch_fc, trnn.batch_fc,
                [r(2, B, D), r(2, D, H), r(2, 1, H)], {}, {})
    _op_compare(lambda ref, a, b, w, bias: jrnn.fusion_seqexpand_concat_fc(
        ref, [a, b], w, bias, fc_act="tanh"),
        lambda ref, a, b, w, bias: trnn.fusion_seqexpand_concat_fc(
            ref, [a, b], w, bias, fc_act="tanh"),
        [r(B, T, D), r(B, 2), r(B, 3), r(D + 5, H), r(H)], {}, {})
    lens = [5, 0, 3]
    for pool in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
        _op_compare(lambda a, b: jrnn.fusion_seqpool_concat(
            [a, b], pool, [jp.to_tensor(np.array(lens))] * 2),
            lambda a, b: trnn.fusion_seqpool_concat([a, b], pool,
                                                    [lens, lens]),
            [r(B, T, D), r(B, T, 2)], {}, {})
    for length in (None, [5, 2, 4]):
        jl = None if length is None else jp.to_tensor(np.array(length))
        _op_compare(jrnn.fusion_seqconv_eltadd_relu,
                    trnn.fusion_seqconv_eltadd_relu,
                    [r(B, T, D), r(3 * D, H), r(H)], {"length": jl},
                    {"length": length})
    rank = np.array([2, 0, 1])
    _op_compare(lambda x, p: jrnn.rank_attention(x, jp.to_tensor(rank), p),
                lambda x, p: trnn.rank_attention(x, torch.from_numpy(rank),
                                                 p),
                [r(B, D), r(3, D, H)], {}, {})

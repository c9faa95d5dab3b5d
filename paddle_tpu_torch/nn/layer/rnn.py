"""RNN layers (counterpart of paddle_tpu/nn/layer/rnn.py).

The cells compute one step each. RNN runs a cell over time through
ops/rnn_ops.py's _scan_layer: the input projection of the whole
sequence is one GEMM and each step one GEMM of the state (the JAX
package's lax.scan becomes a Python loop over torch ops). SimpleRNN,
LSTM and GRU stack cells by layer and direction under the JAX layer's
names (`_cells.<i>.weight_ih`, ...), so models/convert.py's
load_jax_params carries their weights 1:1.

Under auto_cast the cells and RNN's scan are AMP white-list ops
("lstm_cell", "gru_cell", "simple_rnn_cell", "rnn_scan"), as the JAX
package registers them.

As in the JAX package, nn.RNN, BiRNN and the stacked layers accept
`sequence_length` and ignore it (a reference quirk, kept; ROADMAP.md
queue C's notes): only ops.rnn masks by length.
"""
from __future__ import annotations

import math

import torch

from ...amp.auto_cast import amp_cast
from ...core.dtypes import convert_dtype
from ...ops.rnn_ops import _scan_layer
from .. import functional as F
from ..initializer import Uniform
from .container import LayerList
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        return torch.full((batch, self.hidden_size), init_value,
                          dtype=convert_dtype(dtype or "float32"),
                          device=batch_ref.device)

    def _make_weights(self, gates, input_size, hidden_size, attrs):
        """weight_ih [G*H, in], weight_hh [G*H, H], bias_ih and bias_hh
        [G*H], each Uniform(-1/sqrt(H), 1/sqrt(H)) unless its attr says
        otherwise."""
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        wih, whh, bih, bhh = attrs
        self.weight_ih = self.create_parameter(
            (gates * hidden_size, input_size), attr=wih,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            (gates * hidden_size, hidden_size), attr=whh,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            (gates * hidden_size,), attr=bih, default_initializer=init,
            is_bias=True)
        self.bias_hh = self.create_parameter(
            (gates * hidden_size,), attr=bhh, default_initializer=init,
            is_bias=True)

    def _params(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, device=None):
        super().__init__(device=device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        self._make_weights(1, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    @property
    def state_shape(self):
        return (self.hidden_size,)

    @property
    def _mode(self):
        return "RNN_TANH" if self.activation == "tanh" else "RNN_RELU"

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        inputs, states, wih, whh, bih, bhh = amp_cast(
            "simple_rnn_cell", inputs, states, *self._params())
        z = inputs @ wih.t() + bih + states @ whh.t() + bhh
        out = torch.tanh(z) if self.activation == "tanh" else torch.relu(z)
        return out, out


class LSTMCell(RNNCellBase):
    _mode = "LSTM"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None, device=None):
        super().__init__(device=device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._make_weights(4, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            h = c = self.get_initial_states(inputs)
        else:
            h, c = states
        inputs, h, c, wih, whh, bih, bhh = amp_cast(
            "lstm_cell", inputs, h, c, *self._params())
        gates = inputs @ wih.t() + bih + h @ whh.t() + bhh
        i, f, g, o = gates.chunk(4, -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    _mode = "GRU"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None):
        super().__init__(device=device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._make_weights(3, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        inputs, states, wih, whh, bih, bhh = amp_cast(
            "gru_cell", inputs, states, *self._params())
        ri, zi, ni = (inputs @ wih.t() + bih).chunk(3, -1)
        rh, zh, nh = (states @ whh.t() + bhh).chunk(3, -1)
        r = torch.sigmoid(ri + rh)
        z = torch.sigmoid(zi + zh)
        n = torch.tanh(ni + r * nh)
        h = (1 - z) * n + z * states
        return h, h


class RNN(Layer):
    """Runs a SimpleRNNCell, LSTMCell or GRUCell over time (the
    recurrent_op analogue): outputs [B, T, H] ([T, B, H] time-major) and
    the final state, (h, c) for an LSTM cell."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        cell = self.cell
        mode = getattr(cell, "_mode", None)
        if mode is None:
            raise TypeError(f"nn.RNN runs SimpleRNNCell, LSTMCell or "
                            f"GRUCell, not {type(cell).__name__}")
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        if initial_states is None:
            h0 = c0 = xs.new_zeros((xs.shape[1], cell.hidden_size))
        elif mode == "LSTM":
            h0, c0 = initial_states
        else:
            h0 = c0 = initial_states
        if self.is_reverse:
            xs = xs.flip(0)
        # the JAX layer's one "rnn_scan" op: an AMP white-list op
        xs, h0, c0, *params = amp_cast("rnn_scan", xs, h0, c0,
                                       *cell._params())
        outs, h_t, c_t = _scan_layer(xs, h0, c0, *params, mode, None)
        if self.is_reverse:
            outs = outs.flip(0)
        if not self.time_major:
            outs = outs.transpose(0, 1)
        return outs, ((h_t, c_t) if mode == "LSTM" else h_t)


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states = initial_states or (None, None)
        out_f, st_f = self.rnn_fw(inputs, states[0])
        out_b, st_b = self.rnn_bw(inputs, states[1])
        return torch.cat([out_f, out_b], -1), (st_f, st_b)


class _RNNBase(Layer):
    cell_cls = None
    n_states = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation=None, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 device=None):
        super().__init__(device=device)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        num_dir = 2 if self.bidirectional else 1
        self.num_directions = num_dir
        kwargs = dict(device=device)
        if activation is not None and self.cell_cls is SimpleRNNCell:
            kwargs["activation"] = activation
        self._cells = LayerList()
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * num_dir
            for _ in range(num_dir):
                self._cells.append(self.cell_cls(
                    in_size, hidden_size, weight_ih_attr=weight_ih_attr,
                    weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                    bias_hh_attr=bias_hh_attr, **kwargs))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        num_dir = self.num_directions
        x = inputs
        final_h, final_c = [], []
        for layer in range(self.num_layers):
            outs = []
            for d in range(num_dir):
                idx = layer * num_dir + d
                rnn = RNN(self._cells[idx], is_reverse=(d == 1),
                          time_major=self.time_major)
                init = None
                if initial_states is not None:
                    if self.n_states == 2:
                        h0s, c0s = initial_states
                        init = (h0s[idx], c0s[idx])
                    else:
                        init = initial_states[idx]
                out, st = rnn(x, init)
                outs.append(out)
                if self.n_states == 2:
                    final_h.append(st[0])
                    final_c.append(st[1])
                else:
                    final_h.append(st)
            x = outs[0] if num_dir == 1 else torch.cat(outs, -1)
            if self.dropout > 0 and layer < self.num_layers - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        if self.n_states == 2:
            return x, (torch.stack(final_h), torch.stack(final_c))
        return x, torch.stack(final_h)


class SimpleRNN(_RNNBase):
    cell_cls = SimpleRNNCell


class LSTM(_RNNBase):
    cell_cls = LSTMCell
    n_states = 2


class GRU(_RNNBase):
    cell_cls = GRUCell

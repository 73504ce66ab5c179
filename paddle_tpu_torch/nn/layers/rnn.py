"""Recurrent layers (counterpart of ``paddle_tpu/nn/layers/rnn.py``).

The cells (``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``) compute one step;
``SimpleRNN``, ``LSTM`` and ``GRU`` run stacked layers, one or two
directions, over a sequence; ``RNN`` and ``BiRNN`` run a cell over one.
Gate order is paddle's ``[i, f, g, o]`` (LSTM) and ``[r, z, c]`` (GRU),
with the weights ``[gates * hidden, in]`` (``weight_ih``) and ``[gates *
hidden, hidden]`` (``weight_hh``), per layer and direction
``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``, ``bias_hh_l{k}``
and the ``_reverse`` ones, so a ``paddle_tpu`` state dict loads as it is.

The JAX package runs the time loop as ``jax.lax.scan`` over plain ops (no
Pallas kernel); here it is a Python loop of torch ops with the same
arithmetic. The input products of a layer do not depend on the carry, so
they run as one product over every step before the loop; each step then
adds the hidden product: ``(x W_ih^T + b_ih) + h W_hh^T + b_hh``, the
reference's order. Inter-layer dropout (training, ``dropout`` > 0) masks
each layer's output but the last, drawn from the layer's generator
between layers, never inside the time loop. ``sequence_length`` is taken
and not applied, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from ...core.random import default_generator
from ...core.tensor import tensor_boundary
from ..functional.common import dropout as _dropout
from ..initializer import Uniform
from ..layer import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "SimpleRNN", "LSTM", "GRU", "BiRNN"]

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _step(mode, gi, h, c, wh, bh):
    """One time step from the input part ``gi = x W_ih^T + b_ih``: the new
    ``(h, c)`` (``c`` None but for the LSTM)."""
    if mode == "GRU":
        gh = torch.matmul(h, wh.t()) + bh
        ir, iz, ic = gi.chunk(3, dim=-1)
        hr, hz, hc = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        cand = torch.tanh(ic + r * hc)
        return (1 - z) * cand + z * h, None
    g = gi + torch.matmul(h, wh.t()) + bh
    if mode == "LSTM":
        i, f, gg, o = g.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    return (torch.relu(g) if mode == "RNN_RELU" else torch.tanh(g)), None


def _scan(mode, xs, h, c, wi, wh, bi, bh, reverse=False):
    """One layer and direction over ``xs`` ``[T, B, I]``: returns the
    outputs ``[T, B, H]`` and the last ``(h, c)``."""
    gis = torch.matmul(xs, wi.t()) + bi
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    ys = [None] * xs.shape[0]
    for t in steps:
        h, c = _step(mode, gis[t], h, c, wh, bh)
        ys[t] = h
    return torch.stack(ys, 0), h, c


class RNNCellBase(Layer):
    """A cell: ``forward(inputs, states=None) -> (output, new_states)``."""

    _is_lstm = False

    @tensor_boundary
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        h = torch.full((batch, self.hidden_size), init_value,
                       dtype=self._dtype, device=batch_ref.device)
        return (h, h.clone()) if self._is_lstm else h

    def _make(self, gates, input_size, hidden_size, attrs, device,
              generator):
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        kw = dict(default_initializer=init, device=device,
                  generator=generator)
        w_ih, w_hh, b_ih, b_hh = attrs
        n = gates * hidden_size
        self.weight_ih = self.create_parameter([n, input_size], w_ih, **kw)
        self.weight_hh = self.create_parameter([n, hidden_size], w_hh, **kw)
        self.bias_ih = self.create_parameter([n], b_ih, is_bias=True, **kw)
        self.bias_hh = self.create_parameter([n], b_hh, is_bias=True, **kw)

    def _run(self, mode, x, h, c=None):
        gi = torch.matmul(x, self.weight_ih.t()) + self.bias_ih
        return _step(mode, gi, h, c, self.weight_hh, self.bias_hh)


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, act tanh or
    relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self.activation = activation
        self._make(1, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        mode = "RNN_TANH" if self.activation == "tanh" else "RNN_RELU"
        h, _ = self._run(mode, inputs, states)
        return h, h


class LSTMCell(RNNCellBase):
    """Gates ``[i, f, g, o]``: ``c' = sigmoid(f) c + sigmoid(i) tanh(g)``,
    ``h' = sigmoid(o) tanh(c')``; states ``(h, c)``."""

    _is_lstm = True

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self._make(4, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = self._run("LSTM", inputs, *states)
        return h, (h, c)


class GRUCell(RNNCellBase):
    """Gates ``[r, z, c]``: ``c~ = tanh(x_c + r (h W_c + b_c))``, ``h' =
    (1 - z) c~ + z h``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self._make(3, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, _ = self._run("GRU", inputs, states)
        return h, h


class _RNNBase(Layer):
    """Stacked recurrent layers over ``[B, T, I]`` (``[T, B, I]`` with
    ``time_major``): ``forward(inputs, initial_states=None,
    sequence_length=None) -> (outputs, final_states)``, the states
    ``[num_layers * num_directions, B, H]`` (a pair for the LSTM)."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        if direction == "forward":
            self.num_directions = 1
        elif direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        else:
            raise ValueError(f"unknown direction {direction}")
        self._generator = generator
        n = _GATES[mode] * hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        kw = dict(default_initializer=Uniform(-std, std), device=device,
                  generator=generator)
        self._param_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                isz = input_size if layer == 0 \
                    else hidden_size * self.num_directions
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                for pname, shape, attr, bias in (
                        ("weight_ih", [n, isz], weight_ih_attr, False),
                        ("weight_hh", [n, hidden_size], weight_hh_attr,
                         False),
                        ("bias_ih", [n], bias_ih_attr, True),
                        ("bias_hh", [n], bias_hh_attr, True)):
                    self.add_parameter(pname + sfx, self.create_parameter(
                        shape, attr, is_bias=bias, **kw))
                self._param_names.append(tuple(
                    p + sfx for p in ("weight_ih", "weight_hh", "bias_ih",
                                      "bias_hh")))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        L, D, H = self.num_layers, self.num_directions, self.hidden_size
        lstm = self.mode == "LSTM"
        cur = inputs if self.time_major else inputs.transpose(0, 1)
        if initial_states is None:
            z = torch.zeros(L * D, cur.shape[1], H, dtype=cur.dtype,
                            device=cur.device)
            initial_states = (z, z) if lstm else z
        h0, c0 = initial_states if lstm else (initial_states, None)
        drop = self.dropout if self.training and self.dropout > 0 else 0.0
        hs, cs = [], []
        for layer in range(L):
            outs = []
            for d in range(D):
                idx = layer * D + d
                ys, h, c = _scan(
                    self.mode, cur, h0[idx], None if c0 is None else c0[idx],
                    *(getattr(self, n) for n in self._param_names[idx]),
                    reverse=d == 1)
                hs.append(h)
                cs.append(c)
                outs.append(ys)
            cur = torch.cat(outs, dim=-1) if D == 2 else outs[0]
            if drop and layer < L - 1:
                cur = _dropout(cur, drop, training=True,
                               generator=self._generator
                               or default_generator(cur.device))
        out = cur if self.time_major else cur.transpose(0, 1)
        if lstm:
            return out, (torch.stack(hs, 0), torch.stack(cs, 0))
        return out, torch.stack(hs, 0)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class RNN(Layer):
    """A cell run over the time axis, step by step (reversed with
    ``is_reverse``): ``forward(inputs, initial_states=None,
    sequence_length=None) -> (outputs, final_states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        axis = 0 if self.time_major else 1
        T = inputs.shape[axis]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        states, outs = initial_states, [None] * T
        for t in steps:
            outs[t], states = self.cell(inputs.select(axis, t), states)
        return torch.stack(outs, axis), states


class BiRNN(Layer):
    """A forward and a reversed cell over one sequence, their outputs
    concatenated: ``(outputs, (states_fw, states_bw))``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = initial_states if initial_states is not None \
            else (None, None)
        out_fw, st_fw = self.rnn_fw(inputs, s_fw)
        out_bw, st_bw = self.rnn_bw(inputs, s_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)

"""The fused recurrent layers ``RNN``, ``LSTM`` and ``GRU`` — the port of
``mxnet_tpu/gluon/rnn/rnn_layer.py``.

Each runs its whole multi-layer stack through the ``RNN`` op
(``ops/nn.py``: cuDNN's RNN kernels on the card).  Parameters are held
one per (layer, direction, i2h/h2h, weight/bias), named
``{l|r}{k}_{i2h|h2h}_{weight|bias}`` as in the reference, and packed into
the op's flat vector at each forward in ``_param_order``: all weights
layer-major, then all biases.  Layouts TNC and NTC.  Called on tensors
(inside a hybridized parent) without states, a layer starts from zero
states on the input's device.
"""

from __future__ import annotations

import torch

from ...base import MXNetError
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock
from . import rnn_cell

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"invalid layout {layout!r}; use TNC or NTC")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size

        with self.name_scope():
            for i in range(num_layers):
                for j in ("l", "r")[:self._dir]:
                    in_sz = ni if i == 0 else nh * self._dir
                    setattr(self, f"{j}{i}_i2h_weight", self.params.get(
                        f"{j}{i}_i2h_weight", shape=(ng * nh, in_sz),
                        init=i2h_weight_initializer,
                        allow_deferred_init=True))
                    setattr(self, f"{j}{i}_h2h_weight", self.params.get(
                        f"{j}{i}_h2h_weight", shape=(ng * nh, nh),
                        init=h2h_weight_initializer,
                        allow_deferred_init=True))
                    setattr(self, f"{j}{i}_i2h_bias", self.params.get(
                        f"{j}{i}_i2h_bias", shape=(ng * nh,),
                        init=i2h_bias_initializer, allow_deferred_init=True))
                    setattr(self, f"{j}{i}_h2h_bias", self.params.get(
                        f"{j}{i}_h2h_bias", shape=(ng * nh,),
                        init=h2h_bias_initializer, allow_deferred_init=True))

    def __repr__(self):
        mapping = f"{self._input_size or None} -> {self._hidden_size}"
        if self._dir == 2:
            mapping += " (bidirectional)"
        return (f"{type(self).__name__}({mapping}, {self._layout}, "
                f"num_layers={self._num_layers})")

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _param_order(self):
        names = []
        for i in range(self._num_layers):
            for j in ("l", "r")[:self._dir]:
                names.append(f"{j}{i}_i2h_weight")
                names.append(f"{j}{i}_h2h_weight")
        for i in range(self._num_layers):
            for j in ("l", "r")[:self._dir]:
                names.append(f"{j}{i}_i2h_bias")
                names.append(f"{j}{i}_h2h_bias")
        return names

    def infer_param_shapes(self, args):
        x = args[0]
        in_sz = x.shape[-1]
        ng, nh = self._gates, self._hidden_size
        for j in ("l", "r")[:self._dir]:
            getattr(self, f"{j}0_i2h_weight").shape_mismatch_update(
                (ng * nh, in_sz))

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as nd
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            states.append(func(info["shape"], **kwargs))
        return states

    def forward(self, inputs, states=None):
        skip_states = states is None
        if skip_states:
            batch = inputs.shape[self._layout.find("N")]
            if isinstance(inputs, NDArray):
                states = self.begin_state(batch, ctx=inputs.ctx,
                                          dtype=inputs.dtype)
            else:
                states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                      device=inputs.device)
                          for info in self.state_info(batch)]
        if not isinstance(states, (list, tuple)):
            states = [states]
        out = super().forward(inputs, *states)
        if isinstance(out, (list, tuple)):
            output, out_states = out[0], list(out[1:])
        else:
            output, out_states = out, []
        if skip_states:
            return output
        return output, out_states

    def hybrid_forward(self, F, inputs, *states, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        flat = F.concat(*[params[n].reshape((-1,))
                          for n in self._param_order()], dim=0)
        res = F.RNN(inputs, flat, *states,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        if isinstance(res, (list, tuple)):
            output, out_states = res[0], list(res[1:])
        else:
            output, out_states = res, []
        if self._layout == "NTC":
            output = F.swapaxes(output, dim1=0, dim2=1)
        return tuple([output] + out_states)

    def _unfuse(self):
        """The same stack as cells, under the layer's parameter names
        (new Parameters: copy values across by name)."""
        get_cell = {
            "rnn_relu": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="relu", **kw),
            "rnn_tanh": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="tanh", **kw),
            "lstm": lambda **kw: rnn_cell.LSTMCell(self._hidden_size, **kw),
            "gru": lambda **kw: rnn_cell.GRUCell(self._hidden_size, **kw),
        }[self._mode]
        stack = rnn_cell.HybridSequentialRNNCell(prefix=self.prefix)
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                if self._dir == 2:
                    stack.add(rnn_cell.BidirectionalCell(
                        get_cell(prefix=f"l{i}_", input_size=ni),
                        get_cell(prefix=f"r{i}_", input_size=ni)))
                else:
                    stack.add(get_cell(prefix=f"l{i}_", input_size=ni))
                if self._dropout > 0 and i != self._num_layers - 1:
                    stack.add(rnn_cell.DropoutCell(self._dropout))
                ni = self._hidden_size * self._dir
        return stack


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (relu or tanh) — reference gluon.rnn.RNN."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM — reference gluon.rnn.LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU — reference gluon.rnn.GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]

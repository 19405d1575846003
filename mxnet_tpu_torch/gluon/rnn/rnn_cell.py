"""Recurrent cells and ``unroll`` — the port of
``mxnet_tpu/gluon/rnn/rnn_cell.py``, cell for cell.

One step per call; the gate math is the fused ``RNN`` op's
(``ops/nn.py``): LSTM gates [i, f, g, o]; GRU gates [r, z, n] with
``n = tanh(i2h_n + r * h2h_n)``; i2h and h2h biases apart, as cuDNN keeps
them.  Names and parameter shapes are the reference's, so weights carry
across by ``collect_params()`` name.  ``unroll`` is a Python loop over the
steps (each step a few library calls); the fused layers of
``rnn_layer.py`` run a whole sequence in one call.  ``ZoneoutCell`` draws
its masks from the device's generator, so it agrees with the reference in
distribution, not draw for draw.
"""

from __future__ import annotations

from ...base import MXNetError
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "BidirectionalCell",
           "ModifierCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """Normalize unroll inputs: returns (list_or_tensor, axis, batch)."""
    from ... import ndarray as nd
    assert layout in ("NTC", "TNC"), f"invalid layout {layout}"
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        if length is not None and len(inputs) != length:
            raise MXNetError(f"unroll length {length} != inputs {len(inputs)}")
        seq = list(inputs)
        batch = seq[0].shape[0]
        if merge:
            stacked = nd.stack(*seq, axis=axis)
            return stacked, axis, batch
        return seq, axis, batch
    # single tensor
    batch = inputs.shape[batch_axis]
    if length is not None and inputs.shape[axis] != length:
        raise MXNetError(
            f"unroll length {length} != inputs.shape[{axis}] {inputs.shape[axis]}")
    if merge is False:
        n = inputs.shape[axis]
        seq = [s.squeeze(axis=axis) for s in nd.split(
            inputs, num_outputs=n, axis=axis, squeeze_axis=False)] \
            if n > 1 else [inputs.squeeze(axis=axis)]
        return seq, axis, batch
    return inputs, axis, batch


class RecurrentCell(Block):
    """Abstract single-step cell (reference RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counter used for state-name generation."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states: list of zeros (or ``func``) per state_info row."""
        assert not self._modified, \
            "After applying a modifier cell, call begin_state on the base cell"
        from ... import ndarray as nd
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            shape = tuple(batch_size if s == 0 else s
                          for s in info["shape"])
            info = {k: v for k, v in info.items() if k != "shape"}
            info.update(kwargs)
            states.append(func(shape, **info) if "shape" not in info
                          else func(**info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps (reference unroll contract).

        Returns (outputs, states); outputs is a single stacked tensor when
        ``merge_outputs`` is True (or None with tensor input), else a list.
        """
        from ... import ndarray as nd
        self.reset()
        seq, axis, batch = _format_sequence(length, inputs, layout, False)
        length = len(seq)
        states = begin_state if begin_state is not None \
            else self.begin_state(batch, ctx=seq[0].ctx, dtype=seq[0].dtype)
        outputs = []
        all_states = []
        for i in range(length):
            out, states = self(seq[i], states)
            outputs.append(out)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            # mask steps beyond each sample's valid length; final states are
            # the states at the last VALID step (reference SequenceLast role)
            steps = nd.arange(length, ctx=seq[0].ctx)
            vl = valid_length.astype("float32")
            picked = []
            for s_idx in range(len(states)):
                stacked = nd.stack(*[s[s_idx] for s in all_states], axis=0)
                idx = (vl - 1).astype("int32")
                picked.append(_pick_batchwise(stacked, idx))
            states = picked
            mask = (steps.reshape((1, -1)) <
                    vl.reshape((-1, 1))).astype(seq[0].dtype)
            outputs = [o * mask[:, i:i + 1] for i, o in enumerate(outputs)]
        if merge_outputs is None:
            merge_outputs = not isinstance(inputs, (list, tuple))
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

def _pick_batchwise(stacked, idx):
    """stacked (T, N, H), idx (N,) → (N, H) picking per-sample step."""
    from ... import ndarray as nd
    T, N = stacked.shape[0], stacked.shape[1]
    flat = stacked.swapaxes(0, 1).reshape((N * T,) + stacked.shape[2:])
    base = nd.arange(N, ctx=stacked.ctx).astype("int32") * T
    return nd.take(flat, base + idx, axis=0)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Cells whose step is hybridizable."""

    def __init__(self, prefix=None, params=None):
        RecurrentCell.__init__(self, prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        if isinstance(states, (list, tuple)):
            flat = list(states)
        else:
            flat = [states]
        res = HybridBlock.forward(self, inputs, *flat)
        return res

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _BaseGatedCell(HybridRecurrentCell):
    """Shared param plumbing for RNN/LSTM/GRU cells."""

    _num_gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = self._num_gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(ng * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(ng * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def infer_param_shapes(self, args):
        x = args[0]
        self.i2h_weight.shape_mismatch_update(
            (self._num_gates * self._hidden_size, x.shape[-1]))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def __repr__(self):
        shape = self.i2h_weight.shape
        in_sz = shape[1] if shape and len(shape) > 1 else None
        return f"{type(self).__name__}({in_sz} -> {self._hidden_size})"


class RNNCell(_BaseGatedCell):
    """Elman RNN cell: h' = act(W_i x + b_i + W_h h + b_h)."""

    _num_gates = 1

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size, flatten=False)
        h2h = F.FullyConnected(states, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size, flatten=False)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_BaseGatedCell):
    """LSTM cell, gate order [i, f, g, o] (reference rnn_cell.LSTMCell)."""

    _num_gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, h, c, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        ng = 4 * self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=ng,
                               flatten=False)
        h2h = F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=ng,
                               flatten=False)
        gates = i2h + h2h
        i, f, g, o = F.split(gates, num_outputs=4, axis=-1)
        i = F.sigmoid(i)
        f = F.sigmoid(f)
        g = F.tanh(g)
        o = F.sigmoid(o)
        c2 = f * c + i * g
        h2 = o * F.tanh(c2)
        return h2, [h2, c2]


class GRUCell(_BaseGatedCell):
    """GRU cell, gates [r, z, n], n = tanh(i2h_n + r * h2h_n)."""

    _num_gates = 3

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        ng = 3 * self._hidden_size
        prev = states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=ng,
                               flatten=False)
        h2h = F.FullyConnected(prev, h2h_weight, h2h_bias, num_hidden=ng,
                               flatten=False)
        xr, xz, xn = F.split(i2h, num_outputs=3, axis=-1)
        hr, hz, hn = F.split(h2h, num_outputs=3, axis=-1)
        r = F.sigmoid(xr + hr)
        z = F.sigmoid(xz + hz)
        n = F.tanh(xn + r * hn)
        out = (1.0 - z) * n + z * prev
        return out, [out]


class SequentialRNNCell(RecurrentCell):
    """Stack cells layer-wise (reference SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, func=func, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states

    def forward(self, inputs, states):
        return self.__call__(inputs, states)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class HybridSequentialRNNCell(SequentialRNNCell):
    """Same stacking; kept for API parity (cells hybridize individually)."""


class ModifierCell(HybridRecurrentCell):
    """Base for cells wrapping another cell (reference ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        base_cell._modified = True
        self.base_cell = base_cell
        self.register_child(base_cell, "base_cell")

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs)
        self.base_cell._modified = True
        return begin

    def __repr__(self):
        return f"{type(self).__name__}({self.base_cell!r})"


class DropoutCell(HybridRecurrentCell):
    """Apply dropout on the input of every step."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):  # noqa: ARG002
        return []

    def hybrid_forward(self, F, inputs, *states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, list(states)

    def forward(self, inputs, states):
        self._counter += 1
        out = HybridBlock.forward(self, inputs, *states) \
            if states else HybridBlock.forward(self, inputs)
        if isinstance(out, tuple):
            return out
        return out, []


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (Krueger et al.): randomly keep old state."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout; apply per direction"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        from ... import ndarray as nd
        from ... import autograd
        self._counter += 1
        next_output, next_states = self.base_cell(inputs, states)
        if not autograd.is_training():
            return next_output, next_states

        def mask(p, like):
            return nd.random.uniform(low=0.0, high=1.0, shape=like.shape,
                                     ctx=like.ctx) < (1 - p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = nd.zeros_like(next_output)
        if self.zoneout_outputs > 0:
            m = mask(self.zoneout_outputs, next_output).astype(
                next_output.dtype)
            next_output = m * next_output + (1 - m) * prev_output
        if self.zoneout_states > 0:
            out_states = []
            for new_s, old_s in zip(next_states, states):
                m = mask(self.zoneout_states, new_s).astype(new_s.dtype)
                out_states.append(m * new_s + (1 - m) * old_s)
            next_states = out_states
        self._prev_output = next_output
        return next_output, next_states

    def forward(self, inputs, states):
        return self.__call__(inputs, states)


class ResidualCell(ModifierCell):
    """Add the input to the cell's output (residual connection)."""

    def __call__(self, inputs, states):
        self._counter += 1
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def forward(self, inputs, states):
        return self.__call__(inputs, states)


class BidirectionalCell(RecurrentCell):
    """Run two cells over the sequence in opposite directions; only usable
    via ``unroll`` (reference BidirectionalCell contract)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix=None, params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):  # noqa: ARG002
        raise MXNetError(
            "BidirectionalCell cannot be stepped; use unroll() "
            "(reference contract)")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, func=func, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd
        self.reset()
        seq, axis, batch = _format_sequence(length, inputs, layout, False)
        length = len(seq)
        states = begin_state if begin_state is not None \
            else self.begin_state(batch, ctx=seq[0].ctx, dtype=seq[0].dtype)
        l_cell, r_cell = self._children.values()
        nl = len(l_cell.state_info())
        l_out, l_states = l_cell.unroll(
            length, seq, states[:nl], layout="NTC" if axis == 1 else layout,
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_seq = list(reversed(seq))
        else:
            # per-sample reverse so each sample's VALID portion is
            # front-aligned for the backward cell (reference SequenceReverse
            # with use_sequence_length — plain reversed() would feed padding
            # first for short samples)
            stacked = nd.stack(*seq, axis=0)  # (T, N, C)
            rev = nd.sequence_reverse(stacked, valid_length.astype("float32"),
                                      use_sequence_length=True)
            r_seq = [rev[t] for t in range(length)]
        r_out, r_states = r_cell.unroll(
            length, r_seq, states[nl:],
            layout="NTC" if axis == 1 else layout, merge_outputs=False,
            valid_length=valid_length)
        if valid_length is None:
            r_out = list(reversed(r_out))
        else:
            # un-reverse per sample (same op is its own inverse)
            stacked = nd.stack(*r_out, axis=0)
            rev = nd.sequence_reverse(stacked, valid_length.astype("float32"),
                                      use_sequence_length=True)
            r_out = [rev[t] for t in range(length)]
        outputs = [nd.concat(lo, ro, dim=-1) for lo, ro in zip(l_out, r_out)]
        if merge_outputs is None:
            merge_outputs = not isinstance(inputs, (list, tuple))
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states

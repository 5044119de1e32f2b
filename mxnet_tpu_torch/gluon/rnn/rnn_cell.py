"""Gluon recurrent cells: stepwise recurrent building blocks.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference
python/mxnet/gluon/rnn/rnn_cell.py :805): the cell zoo as HybridBlocks on
the port's ``HybridBlock``, ``Parameter`` and ``autograd``. ``unroll``
runs the cell a step at a time (FullyConnected and elementwise ops, no
hand kernel); hybridized, each call runs through the block's cached op.
A cell's parameters are ``i2h_weight``, ``h2h_weight``, ``i2h_bias`` and
``h2h_bias`` under its prefix, the pieces ``gluon.rnn.LSTM`` keeps a
layer and direction, so a layer's weights load into a stack of cells.
Imperative begin states are zeros on the input's device.
"""
from __future__ import annotations

import functools

from ... import ndarray
from ... import symbol as _symbol
from ...base import MXNetError
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is None:
        if F is ndarray or F.__name__.endswith("ndarray"):
            begin_state = cell.begin_state(
                func=functools.partial(ndarray.zeros,
                                       ctx=inputs[0].context),
                batch_size=batch_size)
        else:
            def func(name=None, shape=None, **kw):
                return getattr(_symbol, "_begin_state_zeros")(
                    inputs, shape=shape, batch_axis=0, name=name)
            begin_state = cell.begin_state(func=func, batch_size=0)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """inputs ↔ per-step list (reference gluon/rnn/rnn_cell.py helpers)."""
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    batch_size = 0
    in_axis = (in_layout or layout).find("T")
    if isinstance(inputs, (NDArray, _symbol.Symbol)) and \
            not isinstance(inputs, list):
        F = _symbol if isinstance(inputs, _symbol.Symbol) else ndarray
        if hasattr(inputs, "shape") and not isinstance(inputs,
                                                       _symbol.Symbol):
            batch_size = inputs.shape[batch_axis]
        if merge is False:
            if length is None:
                raise MXNetError("length must be given to split a fused "
                                 "sequence input")
            inputs = F.split(inputs, axis=in_axis, num_outputs=length,
                             squeeze_axis=1)
            inputs = list(inputs) if length > 1 else [inputs]
    else:
        F = _symbol if isinstance(inputs[0], _symbol.Symbol) else ndarray
        if hasattr(inputs[0], "shape") and not isinstance(
                inputs[0], _symbol.Symbol):
            batch_size = inputs[0].shape[0]
        if merge is True:
            inputs = [F.expand_dims(i, axis=axis) for i in inputs]
            inputs = F.Concat(*inputs, dim=axis)
    return inputs, axis, F, batch_size


class RecurrentCell(HybridBlock):
    """Abstract stepwise cell (reference
    gluon/rnn/rnn_cell.py:RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=ndarray.zeros, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called "\
            "directly. Call the modifier cell instead."
        def make_state(info):
            self._init_counter += 1
            spec = dict(kwargs) if info is None else {**info, **kwargs}
            spec = {k: v for k, v in spec.items()
                    if not k.startswith("__")}
            return func(name=f"{self._prefix}begin_state_"
                        f"{self._init_counter}", **spec)

        return [make_state(info) for info in self.state_info(batch_size)]

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        seq, axis, F, batch_size = _format_sequence(length, inputs,
                                                    layout, False)
        if length is not None and len(seq) != length:
            if len(seq) < length:
                raise ValueError(
                    f"unroll(length={length}) got only {len(seq)} input "
                    "steps")
            seq = seq[:length]
        states = _get_begin_state(self, F, begin_state, seq, batch_size)
        outputs = []
        for step_input in seq:
            step_out, states = self(step_input, states)
            outputs.append(step_out)
        if merge_outputs:
            outputs = F.Concat(*[F.expand_dims(o, axis=axis)
                                 for o in outputs], dim=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell):
    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _declare_gate_params(self, hidden_size, input_size, n_gates,
                             i2h_weight_initializer,
                             h2h_weight_initializer,
                             i2h_bias_initializer, h2h_bias_initializer):
        """Declare the i2h/h2h weight+bias quartet every gated cell
        carries; ``n_gates`` stacks the per-gate blocks row-wise
        (1 = Elman, 3 = GRU, 4 = LSTM — the fused-kernel layout)."""
        rows = n_gates * hidden_size
        for name, shape, init in (
                ("i2h_weight", (rows, input_size), i2h_weight_initializer),
                ("h2h_weight", (rows, hidden_size), h2h_weight_initializer),
                ("i2h_bias", (rows,), i2h_bias_initializer),
                ("h2h_bias", (rows,), h2h_bias_initializer)):
            setattr(self, name, self.params.get(
                name, shape=shape, init=init, allow_deferred_init=True))


class RNNCell(HybridRecurrentCell):
    """Elman cell (reference gluon/rnn/rnn_cell.py:RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self._declare_gate_params(hidden_size, input_size, 1,
                                  i2h_weight_initializer,
                                  h2h_weight_initializer,
                                  i2h_bias_initializer,
                                  h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gates i,f,g,o (reference gluon/rnn/rnn_cell.py:LSTMCell)."""

    def __init__(self, hidden_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._declare_gate_params(hidden_size, input_size, 4,
                                  i2h_weight_initializer,
                                  h2h_weight_initializer,
                                  i2h_bias_initializer,
                                  h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4)
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = F.Activation(slice_gates[2], act_type="tanh")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell, gates r,z,n (reference gluon/rnn/rnn_cell.py:GRUCell)."""

    def __init__(self, hidden_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._declare_gate_params(hidden_size, input_size, 3,
                                  i2h_weight_initializer,
                                  h2h_weight_initializer,
                                  i2h_bias_initializer,
                                  h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3)
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack cells (reference gluon/rnn/rnn_cell.py:SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def _per_cell_states(self, states):
        """Carve the flat state list into per-child slices."""
        cursor = 0
        for cell in self._children:
            width = len(cell.state_info())
            yield cell, (None if states is None
                         else states[cursor:cursor + width])
            cursor += width

    def __call__(self, inputs, states):
        self._counter += 1
        carried = []
        for cell, state in self._per_cell_states(states):
            assert not isinstance(cell, BidirectionalCell)
            inputs, state = cell(inputs, state)
            carried.extend(state)
        return inputs, carried

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        last = len(self._children) - 1
        carried = []
        for k, (cell, cell_begin) in enumerate(
                self._per_cell_states(begin_state)):
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=cell_begin,
                layout=layout,
                merge_outputs=merge_outputs if k == last else None)
            carried.extend(states)
        return inputs, carried

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout on the input sequence (reference rnn_cell.py:DropoutCell)."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float))
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if isinstance(inputs, (NDArray, _symbol.Symbol)) and \
                not isinstance(inputs, list):
            return self.hybrid_forward(F, inputs, begin_state or [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(HybridRecurrentCell):
    """Base for wrapper cells (reference rnn_cell.py:ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified "\
            "twice" % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=ndarray.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout (reference rnn_cell.py:ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: F.Dropout(F.ones_like(like), p=p)  # noqa:E731
        prev_output = self._prev_output if self._prev_output is not None \
            else F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0.0 else next_output
        new_states = [F.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """output = base(input) + input (reference rnn_cell.py:ResidualCell)."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=False)
        self.base_cell._modified = True
        inputs, axis, F, _ = _format_sequence(length, inputs, layout, False)
        outputs = [o + i for o, i in zip(outputs, inputs)]
        if merge_outputs:
            outputs = [F.expand_dims(o, axis=axis) for o in outputs]
            outputs = F.Concat(*outputs, dim=axis)
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Two directions concatenated (reference
    rnn_cell.py:BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        states = begin_state
        l_cell, r_cell = self._children
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info(batch_size))],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info(batch_size)):],
            layout=layout, merge_outputs=False)
        outputs = [F.Concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = [F.expand_dims(o, axis=axis) for o in outputs]
            outputs = F.Concat(*outputs, dim=axis)
        return outputs, l_states + r_states

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError

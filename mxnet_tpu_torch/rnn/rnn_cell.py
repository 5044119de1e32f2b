"""Symbolic RNN cells.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (reference
python/mxnet/rnn/rnn_cell.py: ``BaseRNNCell.unroll`` :295, the RNN, LSTM
and GRU cells :362-535, ``FusedRNNCell`` :536, the Sequential,
Bidirectional, Residual, Zoneout and Dropout cells). Cells compose
Symbols. ``FusedRNNCell.unroll`` emits the one-op ``RNN`` symbol, whose
LSTM runs the Hopper sequence kernels (B1) on the card; the unfused cells
unroll into FullyConnected and elementwise ops a step (cuBLAS and torch
kernels, no hand kernel). Parameter names are the JAX package's letter for
letter, so ``unpack_weights``/``pack_weights`` carry one set of weights
between a fused stack and its ``unfuse()``d twin. The per-step i2h/h2h
projection, step naming and state info shared by the three dense cells
live in ``BaseRNNCell`` helpers (``_step_tag``, ``_affine_pair``,
``_nc_state``).
"""
from __future__ import annotations

import numpy as np

from .. import ndarray, symbol
from ..base import MXNetError
from ..ops.rnn_ops import _unpack, rnn_param_size

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]


class RNNParams:
    """Container for cell weights (reference rnn_cell.py:RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = symbol.Variable(full, **kwargs)
        return self._params[full]


class BaseRNNCell:
    """Abstract cell: ``output, states = cell(input, states)``
    (reference rnn_cell.py:BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        self._own_params = params is None
        self._prefix = prefix
        self._params = RNNParams(prefix) if params is None else params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    # -- shared naming / projection helpers ---------------------------------
    def _fresh_state_name(self):
        self._init_counter += 1
        return f"{self._prefix}begin_state_{self._init_counter}"

    def _step_tag(self):
        self._counter += 1
        return f"{self._prefix}t{self._counter}_"

    def _nc_state(self):
        return {"shape": (0, self._num_hidden), "__layout__": "NC"}

    def _bind_dense_params(self, bias_init=None):
        """Fetch the four i2h/h2h weight/bias Variables onto the cell."""
        bias_kw = {} if bias_init is None else {"init": bias_init}
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias", **bias_kw)
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    def _affine_pair(self, x, h_prev, gates, tag):
        """The two projections every dense cell starts with."""
        width = self._num_hidden * gates
        i2h = symbol.FullyConnected(x, self._iW, self._iB,
                                    num_hidden=width, name=f"{tag}i2h")
        h2h = symbol.FullyConnected(h_prev, self._hW, self._hB,
                                    num_hidden=width, name=f"{tag}h2h")
        return i2h, h2h

    def begin_state(self, func=None, **kwargs):
        """Initial state symbols, made by ``func`` (default ``sym.zeros``)
        from each state's info (reference rnn_cell.py:begin_state)."""
        if self._modified:
            raise MXNetError("this cell is wrapped by a modifier; step the "
                             "modifier instead")
        func = func or symbol.zeros
        fresh = []
        for info in self.state_info:
            merged = {**(info or {}), **kwargs}
            merged = {k: v for k, v in merged.items()
                      if not k.startswith("__")}  # drop __layout__ etc.
            fresh.append(func(name=self._fresh_state_name(), **merged))
        return fresh

    def _auto_begin_state(self, ref, batch_axis=0):
        """Zero begin states whose batch dim is read off the input symbol
        (the forward-only replacement for the reference's backward shape
        inference of ``zeros(shape=(0, H))`` states)."""
        return [symbol._begin_state_zeros(ref, shape=info["shape"],
                                          batch_axis=batch_axis,
                                          name=self._fresh_state_name())
                for info in self.state_info]

    def unpack_weights(self, args):
        """Split fused parameter blobs into per-gate arrays
        (reference rnn_cell.py:unpack_weights)."""
        out = dict(args)
        for group in ("i2h", "h2h") if self._gate_names else ():
            blob_w = out.pop(f"{self._prefix}{group}_weight")
            blob_b = out.pop(f"{self._prefix}{group}_bias")
            h = self._num_hidden
            for j, gate in enumerate(self._gate_names):
                rows = slice(j * h, (j + 1) * h)
                out[f"{self._prefix}{group}{gate}_weight"] = \
                    blob_w[rows].copy()
                out[f"{self._prefix}{group}{gate}_bias"] = blob_b[rows].copy()
        return out

    def pack_weights(self, args):
        out = dict(args)
        for group in ("i2h", "h2h") if self._gate_names else ():
            ws, bs = zip(*((out.pop(f"{self._prefix}{group}{g}_weight"),
                            out.pop(f"{self._prefix}{group}{g}_bias"))
                           for g in self._gate_names))
            out[f"{self._prefix}{group}_weight"] = \
                ndarray.concatenate(list(ws))
            out[f"{self._prefix}{group}_bias"] = ndarray.concatenate(list(bs))
        return out

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell for ``length`` steps (reference :295)."""
        self.reset()
        steps, _ = _normalize_sequence(length, inputs, layout, False)
        carry = begin_state if begin_state is not None \
            else self._auto_begin_state(steps[0])
        outs = []
        for x in steps:
            y, carry = self(x, carry)
            outs.append(y)
        outs, _ = _format_sequence(length, outs, layout, merge_outputs)
        return outs, carry

    def _get_activation(self, inputs, activation, **kwargs):
        if callable(activation):
            return activation(inputs, **kwargs)
        return symbol.Activation(inputs, act_type=activation, **kwargs)


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """inputs → list of per-step symbols (reference rnn_cell.py helpers)."""
    axis = layout.find("T")
    if isinstance(inputs, symbol.Symbol):
        if len(inputs.list_outputs()) == 1:
            # one symbol carrying the whole sequence: split on time axis
            t_axis = (in_layout or layout).find("T")
            inputs = symbol.split(inputs, axis=t_axis, num_outputs=length,
                                  squeeze_axis=1)
            inputs = list(inputs) if length > 1 else [inputs]
        else:
            inputs = list(inputs)
    if len(inputs) != length:
        raise MXNetError(
            f"got a sequence of length {len(inputs)}, expected {length}")
    return inputs, axis


def _format_sequence(length, outputs, layout, merge):
    axis = layout.find("T")
    if merge:
        expanded = [symbol.expand_dims(o, axis=axis) for o in outputs]
        outputs = symbol.Concat(*expanded, dim=axis)
    return outputs, axis


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (reference rnn_cell.py:362)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._bind_dense_params()

    @property
    def state_info(self):
        return [self._nc_state()]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        tag = self._step_tag()
        i2h, h2h = self._affine_pair(inputs, states[0], 1, tag)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name=f"{tag}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order i,f,g,o (reference rnn_cell.py:410)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        from ..initializer import LSTMBias
        self._bind_dense_params(LSTMBias(forget_bias=forget_bias))

    @property
    def state_info(self):
        return [self._nc_state(), self._nc_state()]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        tag = self._step_tag()
        i2h, h2h = self._affine_pair(inputs, states[0], 4, tag)
        lanes = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                    name=f"{tag}slice")
        sig = lambda s: symbol.Activation(s, act_type="sigmoid")  # noqa: E731
        tanh = lambda s: symbol.Activation(s, act_type="tanh")  # noqa: E731
        keep, forget, cand, emit = \
            sig(lanes[0]), sig(lanes[1]), tanh(lanes[2]), sig(lanes[3])
        next_c = forget * states[1] + keep * cand
        next_h = emit * tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order r,z,n (reference rnn_cell.py:478)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._bind_dense_params()

    @property
    def state_info(self):
        return [self._nc_state()]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        tag = self._step_tag()
        prev_h = states[0]
        i2h, h2h = self._affine_pair(inputs, prev_h, 3, tag)
        i_r, i_z, i_n = symbol.SliceChannel(i2h, num_outputs=3,
                                            name=f"{tag}i2h_slice")
        h_r, h_z, h_n = symbol.SliceChannel(h2h, num_outputs=3,
                                            name=f"{tag}h2h_slice")
        reset = symbol.Activation(i_r + h_r, act_type="sigmoid")
        update = symbol.Activation(i_z + h_z, act_type="sigmoid")
        cand = symbol.Activation(i_n + reset * h_n, act_type="tanh")
        next_h = update * prev_h + (1.0 - update) * cand
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Multi-layer fused cell emitting the one-op RNN symbol
    (reference rnn_cell.py:536)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        super().__init__(prefix=f"{mode}_" if prefix is None else prefix,
                         params=params)
        self._num_hidden, self._num_layers = num_hidden, num_layers
        self._mode, self._bidirectional = mode, bidirectional
        self._dropout, self._get_next_state = dropout, get_next_state
        self._parameter = self.params.get("parameters")
        self._directions = ["l", "r"] if bidirectional else ["l"]

    @property
    def state_info(self):
        depth = len(self._directions) * self._num_layers
        block = {"shape": (depth, 0, self._num_hidden), "__layout__": "LNC"}
        return [block] * (2 if self._mode == "lstm" else 1)

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    def _slice_weights(self, arr, li, lh):
        """Split a packed array into the reference's per-layer names
        (l0_i2h_weight, r0_h2h_bias, ...)."""
        pieces = _unpack(arr._data, self._num_layers, li, lh, self._mode,
                         self._bidirectional)
        named = {}
        for layer in range(self._num_layers):
            for d, dname in enumerate(self._directions):
                base = f"{self._prefix}{dname}{layer}_"
                names = ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")
                for suffix, piece in zip(names, pieces[layer][d]):
                    named[base + suffix] = ndarray.NDArray(piece.clone())
        return named

    def unpack_weights(self, args):
        out = dict(args)
        blob = out.pop(self._parameter.name)
        input_size = self._infer_input_size(blob.size)
        out.update(self._slice_weights(blob, input_size, self._num_hidden))
        return out

    def _infer_input_size(self, total):
        H, L = self._num_hidden, self._num_layers
        # the closed form is messy; scan plausible sizes
        for candidate in range(1, 65536):
            if rnn_param_size(L, candidate, H, self._mode,
                              self._bidirectional) == total:
                return candidate
        raise MXNetError("cannot infer input size from parameter length")

    def pack_weights(self, args):
        out = dict(args)
        mats, vecs, ctx = [], [], None
        for layer in range(self._num_layers):
            for dname in self._directions:
                base = f"{self._prefix}{dname}{layer}_"
                w_i2h = out.pop(f"{base}i2h_weight")
                ctx = ctx or w_i2h.context
                mats.append(w_i2h.asnumpy().ravel())
                mats.append(out.pop(f"{base}h2h_weight").asnumpy().ravel())
                vecs.append(out.pop(f"{base}i2h_bias").asnumpy().ravel())
                vecs.append(out.pop(f"{base}h2h_bias").asnumpy().ravel())
        out[self._parameter.name] = ndarray.array(np.concatenate(mats + vecs),
                                                  ctx=ctx)
        return out

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, axis = _normalize_sequence(length, inputs, layout, True)
        # the fused op consumes TNC: stack per-step inputs on a leading T axis
        stacked = symbol.Concat(
            *[symbol.expand_dims(x, axis=0) for x in steps], dim=0)
        if begin_state is None:
            begin_state = self._auto_begin_state(stacked, batch_axis=1)
        carry = list(begin_state)
        rnn = symbol.RNN(stacked, self._parameter, *carry,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers, mode=self._mode,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         name=f"{self._prefix}rnn")
        if not self._get_next_state:
            outputs, carry = rnn, []
        elif self._mode == "lstm":
            outputs, carry = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, carry = rnn[0], [rnn[1]]
        if merge_outputs is False:
            outputs = list(symbol.split(outputs, axis=0, num_outputs=length,
                                        squeeze_axis=1))
        elif layout == "NTC":
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, carry

    def unfuse(self):
        """Equivalent stack of unfused cells (reference :780)."""
        stack = SequentialRNNCell()
        make = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        last = self._num_layers - 1
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make(f"{self._prefix}l{i}_"),
                    make(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                stack.add(make(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != last:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack cells layer-over-layer (reference rnn_cell.py:698)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        carry_out = []
        cursor = 0
        for cell in self._cells:
            width = len(cell.state_info)
            inputs, piece = cell(inputs, states[cursor:cursor + width])
            cursor += width
            carry_out.extend(piece)
        return inputs, carry_out

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        cursor = 0
        flowing = inputs
        carry = []
        last = len(self._cells) - 1
        for i, cell in enumerate(self._cells):
            width = len(cell.state_info)
            sub_begin = None if begin_state is None \
                else begin_state[cursor:cursor + width]
            flowing, piece = cell.unroll(
                length, flowing, begin_state=sub_begin, layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            cursor += width
            carry.extend(piece)
        return flowing, carry


class DropoutCell(BaseRNNCell):
    """Apply dropout on input (reference rnn_cell.py:772)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference rnn_cell.py:800)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py:851)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell does not support zoneout; unfuse first"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    @staticmethod
    def _zone(p, fresh, stale):
        """Keep each unit of ``fresh`` with prob 1-p, else reuse ``stale``."""
        coin = symbol.Dropout(symbol.ones_like(fresh), p=p)
        return symbol.where(coin, fresh, stale)

    def __call__(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        stale_out = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = self._zone(self.zoneout_outputs, next_output, stale_out) \
            if self.zoneout_outputs > 0.0 else next_output
        if self.zoneout_states > 0.0:
            next_states = [self._zone(self.zoneout_states, new_s, old_s)
                           for new_s, old_s in zip(next_states, states)]
        self.prev_output = output
        return output, next_states


class ResidualCell(ModifierCell):
    """Adds the input to the output (reference rnn_cell.py:906)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs, begin_state=begin_state, layout=layout,
            merge_outputs=False)
        self.base_cell._modified = True
        steps, _ = _normalize_sequence(length, inputs, layout, False)
        summed = [o + i for o, i in zip(outputs, steps)]
        outputs, _ = _format_sequence(length, summed, layout, merge_outputs)
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Run two cells over opposite directions, concat outputs
    (reference rnn_cell.py:823)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = [s for c in self._cells
                           for s in c._auto_begin_state(steps[0])]
        fwd, bwd = self._cells
        split_at = len(fwd.state_info)
        fwd_out, fwd_states = fwd.unroll(
            length, inputs=steps, begin_state=begin_state[:split_at],
            layout=layout, merge_outputs=False)
        bwd_out, bwd_states = bwd.unroll(
            length, inputs=steps[::-1], begin_state=begin_state[split_at:],
            layout=layout, merge_outputs=False)
        joined = [symbol.Concat(f, b, dim=1,
                                name=f"{self._output_prefix}t{i}")
                  for i, (f, b) in enumerate(zip(fwd_out, bwd_out[::-1]))]
        outputs, _ = _format_sequence(length, joined, layout, merge_outputs)
        return outputs, fwd_states + bwd_states

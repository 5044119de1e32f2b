"""Symbolic RNN cells: the fused multi-layer cell of the LSTM LM.

Counterpart of ``RNNParams``, ``BaseRNNCell``, ``_normalize_sequence`` and
``FusedRNNCell`` in ``mxnet_tpu/rnn/rnn_cell.py``. ``FusedRNNCell.unroll``
emits the one-op ``RNN`` symbol; ``pack_weights``/``unpack_weights`` convert
between the packed cuDNN parameter vector and per-layer named arrays.
The unfused cells and the modifier cells come with a later slice.
"""
from __future__ import annotations

import numpy as np

from .. import ndarray, symbol
from ..base import MXNetError
from ..ops.rnn_ops import _unpack, rnn_param_size

__all__ = ["RNNParams", "BaseRNNCell", "FusedRNNCell"]


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

    def _fresh_state_name(self):
        self._init_counter += 1
        return f"{self._prefix}begin_state_{self._init_counter}"

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


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """inputs -> list of per-step symbols (reference rnn_cell.py helpers)."""
    axis = layout.find("T")
    if isinstance(inputs, symbol.Symbol):
        if len(inputs.list_outputs()) == 1:
            # one symbol carrying the whole sequence: split on the time axis
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

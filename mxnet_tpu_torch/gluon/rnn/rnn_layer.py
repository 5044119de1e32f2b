"""Gluon fused RNN layers: RNN, LSTM, GRU.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference
python/mxnet/gluon/rnn/rnn_layer.py): layers hold per-layer and direction
i2h/h2h weights (checkpoint-friendly names like ``l0_i2h_weight``) and run
the fused ``RNN`` op (``ops/rnn_ops.py``), whose LSTM runs the Hopper
sequence kernels (B1) forward and, under ``autograd.record()``, backward
on the card. Each forward packs the pieces into the op's one parameter
vector with ``Concat`` (cuDNN's order: every weight, then every bias), and
``Concat``'s backward splits the vector's gradient back into the pieces'.
"""
from __future__ import annotations

from ... import ndarray
from ...ops.rnn_ops import _GATES
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC', 'NTC']"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        self._gates = _GATES[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                name = f"{j}{i}_i2h_weight"
                setattr(self, name, self.params.get(
                    name, shape=(ng * nh, ni), init=i2h_weight_initializer,
                    allow_deferred_init=True))
                name = f"{j}{i}_h2h_weight"
                setattr(self, name, self.params.get(
                    name, shape=(ng * nh, nh), init=h2h_weight_initializer,
                    allow_deferred_init=True))
                name = f"{j}{i}_i2h_bias"
                setattr(self, name, self.params.get(
                    name, shape=(ng * nh,), init=i2h_bias_initializer,
                    allow_deferred_init=True))
                name = f"{j}{i}_h2h_bias"
                setattr(self, name, self.params.get(
                    name, shape=(ng * nh,), init=h2h_bias_initializer,
                    allow_deferred_init=True))
            ni = nh * self._dir

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        mapping = ("{_input_size} -> {_hidden_size}"
                   .format(**self.__dict__) if self._input_size
                   else str(self._hidden_size))
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_shape(self, *args):
        """Resolve input_size from the first input instead of tracing
        (the weight-packing concat has no per-param inverse shape rule)."""
        x = args[0]
        ni = x.shape[2] if self._layout == "TNC" else x.shape[2]
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                p = getattr(self, f"{j}{i}_i2h_weight")
                p.shape = (ng * nh, ni)
                p._finish_deferred_init()
            ni = nh * self._dir
        if not self._input_size:
            self._input_size = x.shape[2]
        for _, p in self.collect_params().items():
            p._finish_deferred_init()

    def begin_state(self, batch_size=0, func=ndarray.zeros, **kwargs):
        """Initial recurrent states (reference rnn_layer.py:begin_state)."""
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name=f"{self.prefix}h0_{i}",
                               **{k: v for k, v in info.items()
                                  if not k.startswith("__")}))
        return states

    def _collect_param_arrays(self, F, kwargs):
        """Order per-layer params into the fused packing: all weights
        (layer-major, direction-minor, i2h then h2h), then all biases."""
        weights, biases = [], []
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                weights.append(kwargs[f"{j}{i}_i2h_weight"])
                weights.append(kwargs[f"{j}{i}_h2h_weight"])
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                biases.append(kwargs[f"{j}{i}_i2h_bias"])
                biases.append(kwargs[f"{j}{i}_h2h_bias"])
        flat = [F.Reshape(w, shape=(-1,)) for w in weights] + list(biases)
        return F.Concat(*flat, dim=0)

    def hybrid_forward(self, F, inputs, states=None, **kwargs):
        if isinstance(states, dict):  # states omitted; params landed here
            kwargs, states = states, None
        batch_size = inputs.shape[self._layout.find("N")] \
            if hasattr(inputs, "shape") else 0
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size,
                                      func=_zeros_like_func(F, inputs,
                                                            self._layout))
        if not isinstance(states, (list, tuple)):
            states = [states]
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        params = self._collect_param_arrays(F, kwargs)
        rnn_args = [inputs, params] + list(states)
        rnn = F.RNN(*rnn_args, state_size=self._hidden_size,
                    num_layers=self._num_layers, bidirectional=self._dir == 2,
                    p=self._dropout, state_outputs=True, mode=self._mode)
        if self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        return outputs if skip_states else (outputs, states)


def _zeros_like_func(F, inputs, layout):
    """begin_state factory producing zeros sized from the live input (works
    under both nd and sym, concrete and traced shapes)."""
    batch_axis = 1  # RNN op consumes TNC; state batch dim is axis 1

    def func(name=None, shape=None, **kwargs):
        if F.__name__.endswith("symbol"):
            return getattr(F, "_begin_state_zeros")(
                inputs, shape=shape, batch_axis=layout.find("N"), name=name)
        out_shape = tuple(inputs.shape[layout.find("N")] if s == 0 else s
                          for s in shape)
        return F.zeros(shape=out_shape, ctx=inputs.context)

    return func


class RNN(_RNNLayer):
    """Vanilla multi-layer RNN with tanh/relu (reference rnn_layer.py:RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference rnn_layer.py:LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference rnn_layer.py:GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]

"""Gluon recurrent layers (counterpart of ``mxnet_tpu/gluon/rnn``): the
fused ``RNN``, ``LSTM`` and ``GRU`` layers. The recurrent cells
(``rnn_cell.py``) are queue A8's second half."""
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401

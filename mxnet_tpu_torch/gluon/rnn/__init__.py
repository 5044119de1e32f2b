"""Gluon recurrent layers and cells (counterpart of
``mxnet_tpu/gluon/rnn``; reference python/mxnet/gluon/rnn/): the fused
``RNN``, ``LSTM`` and ``GRU`` layers and the stepwise cells."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401

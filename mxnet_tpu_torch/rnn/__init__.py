"""Symbolic RNN toolkit (reference: python/mxnet/rnn/)."""
from .rnn_cell import BaseRNNCell, FusedRNNCell, RNNParams  # noqa: F401

"""Symbolic RNN toolkit (reference: python/mxnet/rnn/)."""
from .io import BucketSentenceIter, encode_sentences  # noqa: F401
from .rnn_cell import (  # noqa: F401
    BaseRNNCell,
    BidirectionalCell,
    DropoutCell,
    FusedRNNCell,
    GRUCell,
    LSTMCell,
    ModifierCell,
    ResidualCell,
    RNNCell,
    RNNParams,
    SequentialRNNCell,
    ZoneoutCell,
)

"""The port's op table. Importing this package registers every op."""
from . import nn_ops, rnn_ops, tensor_ops  # noqa: F401
from .registry import OP_TABLE, OpDef, get_op, list_ops, register  # noqa: F401

"""The port's op table. Importing this package registers every op."""
from . import (attention_ops, math_ops, nn_ops, optimizer_ops,  # noqa: F401
               rnn_ops, tensor_ops)
from .registry import OP_TABLE, OpDef, get_op, list_ops, register  # noqa: F401

"""Gluon Switch mixture-of-experts layer: queue A9.

The JAX package's ``SwitchFFN`` (``mxnet_tpu/gluon/nn/moe.py``) runs the
``moe`` op, which the port does not have yet: building the layer raises.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["SwitchFFN"]


class SwitchFFN(HybridBlock):
    """Switch/GShard feed-forward layer; raises until the ``moe`` op of
    queue A9 is ported."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("nn.SwitchFFN needs the moe op of queue A9, not "
                         "ported yet")

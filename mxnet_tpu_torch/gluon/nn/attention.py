"""Gluon multi-head attention layer.

Counterpart of ``mxnet_tpu/gluon/nn/attention.py``: query, key and value
projections, the ``MultiHeadAttention`` op and the output projection. The
op's core runs the flash-attention kernels (B2, forward and backward) on
the card. Sequence parallelism (``seq_axis``, a mesh axis to shard the
sequence over) needs the mesh of queues A7/A11 and raises.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(HybridBlock):
    """Self/cross multi-head attention over (batch, seq, d_model) inputs.

    Projects query/key/value with learned weights, applies (optionally
    causal) scaled-dot-product attention via the ``MultiHeadAttention``
    op, and projects the output. Call with one input (self-attention) or
    three (query, key, value).
    """

    def __init__(self, d_model, num_heads, causal=False, seq_axis="",
                 seq_mode="auto", use_bias=True, dtype="float32",
                 weight_initializer=None, **kwargs):
        if seq_axis:
            raise MXNetError(
                f"MultiHeadAttention(seq_axis={seq_axis!r}): sequence-"
                "parallel attention needs the mesh of queues A7/A11, not "
                "ported yet")
        super().__init__(**kwargs)
        self._d_model = d_model
        self._num_heads = num_heads
        self._causal = causal
        self._seq_axis = seq_axis
        self._seq_mode = seq_mode
        self._use_bias = use_bias
        with self.name_scope():
            for proj in ("query", "key", "value", "out"):
                setattr(self, f"{proj}_weight", self.params.get(
                    f"{proj}_weight", shape=(d_model, d_model),
                    dtype=dtype, init=weight_initializer,
                    allow_deferred_init=True))
                if use_bias:
                    setattr(self, f"{proj}_bias", self.params.get(
                        f"{proj}_bias", shape=(d_model,), dtype=dtype,
                        init="zeros", allow_deferred_init=True))

    def hybrid_forward(self, F, query, key=None, value=None, **params):
        key = query if key is None else key
        value = key if value is None else value

        def proj(x, name):
            kw = dict(num_hidden=self._d_model, flatten=False)
            if self._use_bias:
                return F.FullyConnected(x, params[f"{name}_weight"],
                                        params[f"{name}_bias"], **kw)
            return F.FullyConnected(x, params[f"{name}_weight"],
                                    no_bias=True, **kw)

        out = F.MultiHeadAttention(
            proj(query, "query"), proj(key, "key"), proj(value, "value"),
            num_heads=self._num_heads, causal=self._causal,
            seq_mode=self._seq_mode)
        return proj(out, "out")

    def __repr__(self):
        return (f"MultiHeadAttention(d_model={self._d_model}, "
                f"num_heads={self._num_heads}, causal={self._causal})")

"""Carry weights between the JAX package and the port.

Both packages hold parameters as named arrays and write them as the same
``.params`` container: an npz file whose keys are ``arg:<name>`` and
``aux:<name>``. These helpers move numpy arrays (as either package's
``asnumpy()`` returns them) into the port and write the container bytes
that both ``Predictor``s read; the transformer's nested parameter dict
moves the same way. Gluon parameter names are the same in both packages
(:func:`gluon_params_from_numpy`), and a Gluon RNN layer's per-layer pieces
pack into the fused RNN op's one parameter vector, the ``Module`` LM's
(:func:`pack_rnn_pieces`).
"""
from __future__ import annotations

import io as _io
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .base import MXNetError
from .context import Context, current_context
from .ndarray import NDArray, array

__all__ = ["params_from_numpy", "params_to_bytes",
           "transformer_params_from_numpy", "gluon_params_from_numpy",
           "pack_rnn_pieces"]


def params_from_numpy(arg_params: Mapping[str, np.ndarray],
                      aux_params: Mapping[str, np.ndarray],
                      ctx: Optional[Context] = None
                      ) -> Tuple[Dict[str, NDArray], Dict[str, NDArray]]:
    """numpy parameters -> the port's NDArrays on ``ctx`` (default: the
    current context), keeping each array's dtype."""
    def convert(params):
        return {k: array(v, ctx=ctx, dtype=np.asarray(v).dtype)
                for k, v in params.items()}
    return convert(arg_params), convert(aux_params)


def params_to_bytes(arg_params: Mapping[str, object],
                    aux_params: Mapping[str, object]) -> bytes:
    """The ``.params`` bytes of named parameters, given as numpy arrays or
    NDArrays of either package."""
    def host(v):
        return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
    arrays = {f"arg:{k}": host(v) for k, v in arg_params.items()}
    arrays.update({f"aux:{k}": host(v) for k, v in aux_params.items()})
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def transformer_params_from_numpy(tree: Mapping[str, object],
                                  ctx: Optional[Context] = None) -> Dict:
    """The JAX package's transformer parameter pytree, after
    ``jax.tree.map(np.asarray, params)``, -> the port's dict of tensors on
    ``ctx`` (default: the current context), same keys, shapes and dtypes."""
    device = (ctx or current_context()).torch_device()

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node), device=device)
    return convert(tree)


def gluon_params_from_numpy(net, arrays: Mapping[str, object]):
    """Set every parameter of the port's Gluon block ``net`` from
    ``arrays`` ({parameter name: value}, numpy arrays or NDArrays of
    either package, e.g. ``{n: p.data().asnumpy() for n, p in
    jax_net.collect_params().items()}``), each onto its parameter's
    device. The block's parameters must be initialized, their deferred
    shapes fixed (one forward does it); a missing name or shape raises."""
    for name, param in net.collect_params().items():
        if name not in arrays:
            raise MXNetError(f"gluon_params_from_numpy: no value for {name}")
        value = arrays[name]
        host = value.asnumpy() if hasattr(value, "asnumpy") else value
        data = param.data()
        if tuple(np.shape(host)) != data.shape:
            raise MXNetError(f"gluon_params_from_numpy: {name} has shape "
                             f"{data.shape}, the value {np.shape(host)}")
        data[:] = np.asarray(host)


def pack_rnn_pieces(pieces: Mapping[str, object], num_layers: int,
                    bidirectional: bool = False) -> np.ndarray:
    """A Gluon RNN layer's pieces ({"l0_i2h_weight": value, ...; "r*" for
    the reverse direction}, values as numpy arrays or NDArrays) as the
    fused RNN op's one float32 parameter vector, in the op's order
    (``gluon/rnn/rnn_layer.py:_collect_param_arrays``): every weight,
    layer by layer and direction by direction, i2h then h2h, row-major;
    then every bias in the same order."""
    def host(v):
        return np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v,
                          dtype=np.float32)
    dirs = ["l", "r"] if bidirectional else ["l"]
    weights, biases = [], []
    for i in range(num_layers):
        for d in dirs:
            weights += [host(pieces[f"{d}{i}_i2h_weight"]).ravel(),
                        host(pieces[f"{d}{i}_h2h_weight"]).ravel()]
            biases += [host(pieces[f"{d}{i}_i2h_bias"]),
                       host(pieces[f"{d}{i}_h2h_bias"])]
    return np.concatenate(weights + biases)

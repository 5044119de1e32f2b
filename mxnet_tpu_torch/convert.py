"""Carry weights between the JAX package and the port.

Both packages hold parameters as named arrays and write them as the same
``.params`` container: an npz file whose keys are ``arg:<name>`` and
``aux:<name>``. These helpers move numpy arrays (as either package's
``asnumpy()`` returns them) into the port and write the container bytes
that both ``Predictor``s read.
"""
from __future__ import annotations

import io as _io
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from .context import Context
from .ndarray import NDArray, array

__all__ = ["params_from_numpy", "params_to_bytes"]


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

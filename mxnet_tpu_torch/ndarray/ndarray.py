"""NDArray over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``, cut to what the
Predictor, the Executor and Symbol use: creation (``array``, ``zeros``,
``empty``), ``asnumpy``, ``shape``, ``dtype``, ``context``, ``copyto`` and
``arr[:] = value`` as an in-place host-to-device copy. Where the JAX
package swaps in a new immutable array on mutation, this one writes into
the tensor it holds.
"""
from __future__ import annotations

from typing import Optional

import numpy as _np
import torch

from ..base import MXNetError, numeric_types
from ..context import Context, context_of, current_context

__all__ = ["NDArray", "array", "empty", "zeros", "torch_dtype",
           "numpy_dtype"]

_NP_TO_TORCH = {
    _np.dtype("float16"): torch.float16,
    _np.dtype("float32"): torch.float32,
    _np.dtype("float64"): torch.float64,
    _np.dtype("uint8"): torch.uint8,
    _np.dtype("int8"): torch.int8,
    _np.dtype("int32"): torch.int32,
    _np.dtype("int64"): torch.int64,
    _np.dtype("bool"): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or its name) -> torch dtype; None means float32."""
    if isinstance(dtype, torch.dtype):
        return dtype
    npd = _np.dtype(dtype or "float32")
    if npd not in _NP_TO_TORCH:
        raise MXNetError(f"dtype {npd} is not supported by NDArray")
    return _NP_TO_TORCH[npd]


def numpy_dtype(dtype: torch.dtype) -> _np.dtype:
    if dtype not in _TORCH_TO_NP:
        raise MXNetError(f"dtype {dtype} has no numpy counterpart")
    return _TORCH_TO_NP[dtype]


def _host_array(value, dtype=None) -> _np.ndarray:
    """numpy view of ``value`` with the JAX package's default narrowing:
    float64 -> float32 and int64 -> int32 unless a dtype is given."""
    npv = _np.asarray(value, dtype=dtype)
    if dtype is None and npv.dtype == _np.float64:
        npv = npv.astype(_np.float32)
    elif dtype is None and npv.dtype == _np.int64:
        npv = npv.astype(_np.int32)
    return npv


class NDArray:
    """Multi-dimensional array with MXNet semantics over a torch tensor."""

    __slots__ = ("_data", "__weakref__")

    __array_priority__ = 100.0

    def __init__(self, data: torch.Tensor):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got {type(data)}")
        self._data = data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self) -> _np.dtype:
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    ctx = context

    def asnumpy(self) -> _np.ndarray:
        """An owned host copy; waits for the device."""
        return self._data.detach().cpu().numpy().copy()

    def copyto(self, other):
        if isinstance(other, NDArray):
            if other is not self:
                other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device(), copy=True))
        raise MXNetError(f"cannot copy to {type(other)}")

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            src = value._data
        elif isinstance(value, numeric_types):
            src = value
        else:
            src = torch.from_numpy(
                _np.ascontiguousarray(_host_array(value, self.dtype)))
        if isinstance(key, slice) and key == slice(None):
            if isinstance(src, numeric_types):
                self._data.fill_(src)
            else:
                self._data.copy_(src.expand(self.shape))
            return
        self._data[key] = src

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray {self.shape} @{self.context}>"


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """Copy ``source_array`` onto ``ctx`` (default: the current context)."""
    ctx = ctx or current_context()
    if isinstance(source_array, NDArray):
        src = source_array._data
        if dtype is not None:
            src = src.to(torch_dtype(dtype))
        return NDArray(src.to(ctx.torch_device(), copy=True))
    npv = _np.ascontiguousarray(_host_array(source_array, dtype))
    return NDArray(torch.from_numpy(npv).to(ctx.torch_device(), copy=True))


def zeros(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx or current_context()
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=ctx.torch_device()))


def empty(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An uninitialized array (``torch.empty``)."""
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx or current_context()
    return NDArray(torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                               device=ctx.torch_device()))


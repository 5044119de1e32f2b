"""dtypes of the port: numpy names, torch dtypes, and bfloat16.

numpy has no bfloat16 of its own, so a bf16 array's dtype is
:data:`bfloat16`, which compares equal to the name ``"bfloat16"``, to
``torch.bfloat16`` and to any dtype object named bfloat16 (ml_dtypes').
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["bfloat16", "torch_dtype", "numpy_dtype", "dtype_name", "is_bf16"]


class _BFloat16Dtype:
    """The dtype of a bf16 array."""

    name = "bfloat16"
    itemsize = 2
    kind = "f"

    def __eq__(self, other):
        return (other is self or other is torch.bfloat16 or other == "bfloat16"
                if isinstance(other, (str, torch.dtype, _BFloat16Dtype))
                else getattr(other, "name", None) == "bfloat16")

    def __hash__(self):
        return hash("bfloat16")

    def __repr__(self):
        return "dtype('bfloat16')"

    def __str__(self):
        return "bfloat16"


bfloat16 = _BFloat16Dtype()

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


def is_bf16(dtype) -> bool:
    if isinstance(dtype, (str, torch.dtype, _BFloat16Dtype)):
        return dtype in ("bfloat16", torch.bfloat16) or dtype is bfloat16
    return getattr(dtype, "name", None) == "bfloat16"


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or its name, or :data:`bfloat16`) -> torch dtype; None
    means float32."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if is_bf16(dtype):
        return torch.bfloat16
    npd = _np.dtype(dtype or "float32")
    if npd not in _NP_TO_TORCH:
        raise MXNetError(f"dtype {npd} is not supported by NDArray")
    return _NP_TO_TORCH[npd]


def numpy_dtype(dtype: torch.dtype):
    if dtype is torch.bfloat16:
        return bfloat16
    if dtype not in _TORCH_TO_NP:
        raise MXNetError(f"dtype {dtype} has no numpy counterpart")
    return _TORCH_TO_NP[dtype]


def dtype_name(dtype) -> str:
    """The numpy-style name of a dtype given in any accepted spelling."""
    return "bfloat16" if is_bf16(dtype) else _np.dtype(dtype).name

"""Gluon utilities.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference
python/mxnet/gluon/utils.py): ``split_data``/``split_and_load`` (a batch
cut along an axis, one slice a context) and ``clip_global_norm``.
"""
from __future__ import annotations

import numpy as _np

from .. import ndarray
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split an array along ``batch_axis`` into ``num_slice`` pieces
    (reference gluon/utils.py:split_data). The final piece absorbs the
    remainder when ``even_split=False``."""
    count = data.shape[batch_axis]
    if count < num_slice:
        raise MXNetError(
            f"Too many slices ({num_slice}) for data with shape "
            f"{data.shape} along axis {batch_axis}")
    if count % num_slice and even_split:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}; set "
            "even_split=False to allow uneven partitioning")
    chunk = count // num_slice
    cuts = [i * chunk for i in range(num_slice)] + [count]
    return [data.slice_axis(batch_axis, lo, hi)
            for lo, hi in zip(cuts, cuts[1:])]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` into len(ctx_list) slices, one per context
    (reference gluon/utils.py:split_and_load)."""
    if not isinstance(data, NDArray):
        data = ndarray.array(data)
    if len(ctx_list) < 2:
        return [data.as_in_context(ctx_list[0])]
    parts = split_data(data, len(ctx_list), batch_axis, even_split)
    return [part.as_in_context(ctx) for part, ctx in zip(parts, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Rescale arrays so their joint L2 norm is at most ``max_norm``
    (reference gluon/utils.py:clip_global_norm)."""
    if not arrays:
        raise MXNetError("arrays must not be empty")
    sq_sum = sum((ndarray.norm(a) ** 2).asscalar() for a in arrays)
    joint_norm = float(_np.sqrt(sq_sum))
    ratio = max_norm / (joint_norm + 1e-8)
    if ratio < 1.0:
        for a in arrays:
            a *= ratio
    return joint_norm

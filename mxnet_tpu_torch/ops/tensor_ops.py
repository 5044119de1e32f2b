"""Shape-manipulation, indexing and creation ops of the LSTM LM graph.

Counterpart of the matching ops in ``mxnet_tpu/ops/tensor_ops.py``:
Reshape (with MXNet's 0/-1/-2/-3/-4 codes), expand_dims, SwapAxis, Concat,
SliceChannel, Embedding and ``_zeros``. Attr specs are the JAX package's,
so symbol JSON parses to the same values in both packages.
"""
from __future__ import annotations

import torch

from ..base import AttrSpec, MXNetError
from ..ndarray.ndarray import torch_dtype
from .registry import register


def _infer_reshape(data_shape, target):
    """MXNet's special reshape codes 0/-1/-2/-3/-4 (reference
    matrix_op-inl.h ReshapeParam)."""
    out = []
    src = list(data_shape)
    i = 0  # index into src
    j = 0  # index into target
    while j < len(target):
        t = target[j]
        if t == 0:
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            d1, d2 = target[j + 1], target[j + 2]
            cur = src[i]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(t)
            i += 1
        j += 1
    return tuple(out)


@register("Reshape", aliases=["reshape"],
          attrs=AttrSpec(shape=("tuple", ()), reverse=("bool", False),
                         target_shape=("tuple", ()), keep_highest=("bool", False)))
def _reshape(x, shape=(), reverse=False, target_shape=(), keep_highest=False):
    if not shape and target_shape:  # legacy args
        shape = target_shape
    if reverse:
        inferred = _infer_reshape(x.shape[::-1], tuple(shape)[::-1])[::-1]
    else:
        inferred = _infer_reshape(x.shape, tuple(shape))
    return torch.reshape(x, inferred)


@register("expand_dims", attrs=AttrSpec(axis=("int",)))
def _expand_dims(x, axis):
    return torch.unsqueeze(x, axis)


@register("SwapAxis", aliases=["swapaxes"],
          attrs=AttrSpec(dim1=("int", 0), dim2=("int", 0)))
def _swapaxes(x, dim1, dim2):
    return torch.transpose(x, dim1, dim2)


@register("Concat", aliases=["concat"], key_var_num_args="num_args",
          attrs=AttrSpec(num_args=("int", 0), dim=("int", 1)))
def _concat(*args, num_args=0, dim=1):
    return torch.cat(args, dim=dim)


def _slice_channel_nout(attrs):
    return int(attrs.get("num_outputs", 1))


@register("SliceChannel", aliases=["split"],
          num_outputs=_slice_channel_nout,
          attrs=AttrSpec(num_outputs=("int",), axis=("int", 1),
                         squeeze_axis=("bool", False)))
def _slice_channel(x, num_outputs, axis=1, squeeze_axis=False):
    if x.shape[axis] % num_outputs:
        raise MXNetError(f"SliceChannel: axis {axis} of {tuple(x.shape)} "
                         f"does not split into {num_outputs} equal parts")
    parts = torch.split(x, x.shape[axis] // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("Embedding",
          num_inputs=2, input_names=["data", "weight"],
          param_shapes=lambda attrs, shapes: [
              shapes[0], (int(attrs["input_dim"]), int(attrs["output_dim"]))],
          attrs=AttrSpec(input_dim=("int",), output_dim=("int",),
                         dtype=("str", "float32"),
                         sparse_grad=("bool", False)))
def _embedding(data, weight, input_dim, output_dim, dtype="float32",
               sparse_grad=False):
    """Table lookup. Token ids arrive as float32 (the predict ABI carries
    float32 only) and are cast to integers before the lookup. Ids outside
    [0, input_dim) raise, where a CUDA gather would assert on the device."""
    idx = data.to(torch.int64)
    if idx.device.type != "meta" and bool(
            ((idx < 0) | (idx >= weight.shape[0])).any()):
        raise MXNetError(f"Embedding: token id outside [0, {weight.shape[0]})")
    return torch.nn.functional.embedding(idx, weight)


_INIT_SPEC = AttrSpec(shape=("tuple", ()), ctx=("str", ""), dtype=("str", "float32"))


@register("_zeros", num_inputs=0, attrs=_INIT_SPEC)
def _zeros(shape=(), ctx="", dtype="float32"):
    """Zero-input creation op; the executor moves its output onto the
    bound device."""
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype))

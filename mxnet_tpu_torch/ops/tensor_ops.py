"""Shape-manipulation, indexing, creation, ordering and sequence ops.

Counterpart of ``mxnet_tpu/ops/tensor_ops.py``: reshape (with MXNet's
0/-1/-2/-3/-4 codes), transpose, slicing, take/pick/gather_nd/one_hot,
tile/repeat/pad/flip/stack, where, the creation ops, sort/argsort/topk
(stable on ties, as jnp) and the Sequence* ops. Attr specs are the JAX
package's, so symbol JSON parses to the same values in both packages.
``cast_storage`` to csr/row_sparse waits for the sparse arrays (queue A9).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..base import AttrSpec, MXNetError
from ..dtypes import torch_dtype
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


@register("Flatten", aliases=["flatten"])
def _flatten(x):
    return torch.reshape(x, (x.shape[0], -1))


@register("transpose", attrs=AttrSpec(axes=("tuple", ())))
def _transpose(x, axes=()):
    return x.permute(*(axes or reversed(range(x.dim()))))


@register("expand_dims", attrs=AttrSpec(axis=("int",)))
def _expand_dims(x, axis):
    return torch.unsqueeze(x, axis)


@register("SwapAxis", aliases=["swapaxes"],
          attrs=AttrSpec(dim1=("int", 0), dim2=("int", 0)))
def _swapaxes(x, dim1, dim2):
    return torch.transpose(x, dim1, dim2)


@register("slice", aliases=["crop"],
          attrs=AttrSpec(begin=("tuple",), end=("tuple",)))
def _slice(x, begin, end):
    idx = tuple(
        slice(b if b is not None else 0, e if e is not None else x.shape[i])
        for i, (b, e) in enumerate(zip(begin, end)))
    return x[idx]


@register("slice_axis",
          attrs=AttrSpec(axis=("int",), begin=("int", 0), end=("any", None)))
def _slice_axis(x, axis, begin, end):
    axis = axis % x.dim()
    n = x.shape[axis]
    end = n if end in (None, "None") else int(end)
    if end < 0:
        end += n
    if begin < 0:
        begin += n
    return x.narrow(axis, begin, max(0, end - begin))


@register("reverse", aliases=["flip"], attrs=AttrSpec(axis=("tuple",)))
def _reverse(x, axis):
    return torch.flip(x, tuple(axis))


@register("repeat", attrs=AttrSpec(repeats=("int",), axis=("any", None)))
def _repeat(x, repeats, axis=None):
    axis_i = None if axis in (None, "None") else int(axis)
    return torch.repeat_interleave(x, repeats, dim=axis_i)


@register("tile", attrs=AttrSpec(reps=("tuple",)))
def _tile(x, reps):
    return torch.tile(x, tuple(reps))


_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


@register("Pad", aliases=["pad"],
          attrs=AttrSpec(mode=("str",), pad_width=("tuple",),
                         constant_value=("float", 0.0)))
def _pad(x, mode, pad_width, constant_value):
    pw = [(pad_width[2 * i], pad_width[2 * i + 1]) for i in range(x.dim())]
    if mode not in ("constant", *_PAD_MODES):
        raise MXNetError(f"unknown pad mode {mode}")
    # F.pad lists (before, after) from the last axis backwards
    flat = [p for pair in reversed(pw) for p in pair]
    if mode == "constant":
        return F.pad(x, flat, mode="constant", value=constant_value)
    # edge and reflect pad the trailing axes of a (batch, channel, ...)
    # array, as MXNet's Pad does; leading axes take no padding
    lead = next((i for i, p in enumerate(pw) if p != (0, 0)), x.dim())
    if lead < 2 or x.dim() > 5:
        raise MXNetError(f"Pad mode {mode}: pads only the trailing (at most "
                         f"3) axes after batch and channel, got {pad_width}")
    return F.pad(x, flat[:2 * (x.dim() - 2)], mode=_PAD_MODES[mode])


@register("Concat", aliases=["concat"], key_var_num_args="num_args",
          attrs=AttrSpec(num_args=("int", 0), dim=("int", 1)))
def _concat(*args, num_args=0, dim=1):
    return torch.cat(args, dim=dim)


@register("stack", key_var_num_args="num_args",
          attrs=AttrSpec(num_args=("int", 0), axis=("int", 0)))
def _stack(*args, num_args=0, axis=0):
    return torch.stack(args, dim=axis)


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


@register("Crop", key_var_num_args="num_args",
          attrs=AttrSpec(num_args=("int", 1), offset=("tuple", (0, 0)),
                         h_w=("tuple", (0, 0)), center_crop=("bool", False)))
def _crop(*args, num_args=1, offset=(0, 0), h_w=(0, 0), center_crop=False):
    x = args[0]
    if len(args) == 2:
        h, w = args[1].shape[2], args[1].shape[3]
    else:
        h, w = h_w
    if center_crop:
        oy = (x.shape[2] - h) // 2
        ox = (x.shape[3] - w) // 2
    else:
        oy, ox = offset
    return x[:, :, oy:oy + h, ox:ox + w]


_ID_CHECKS = threading.local()


@contextlib.contextmanager
def deferred_id_checks(flags):
    """Inside, an Embedding reads nothing back to the host (as a captured
    CUDA graph must not): each call appends to ``flags`` (a list) a device
    bool, whether any of its ids lies outside the table, and gathers with
    its ids clamped into range; the caller decides what an out-of-range
    id does. With ``flags`` None, Embedding checks as it does outside."""
    prev = getattr(_ID_CHECKS, "flags", None)
    _ID_CHECKS.flags = flags
    try:
        yield flags
    finally:
        _ID_CHECKS.flags = prev


@register("Embedding",
          num_inputs=2, input_names=["data", "weight"],
          needs_is_train=True,
          param_shapes=lambda attrs, shapes: [
              shapes[0], (int(attrs["input_dim"]), int(attrs["output_dim"]))],
          attrs=AttrSpec(input_dim=("int",), output_dim=("int",),
                         dtype=("str", "float32"),
                         sparse_grad=("bool", False)))
def _embedding(data, weight, input_dim, output_dim, dtype="float32",
               sparse_grad=False, _is_train=False):
    """Table lookup. Token ids arrive as float32 (the predict ABI carries
    float32 only) and are cast to integers before the lookup. Ids outside
    [0, input_dim) raise, where a CUDA gather would assert on the device:
    the check reads one bool back to the host, once a call (inside
    :func:`deferred_id_checks` it is handed to the caller). The weight's
    gradient is autograd's, dense; ``sparse_grad`` in training raises until
    the row_sparse arrays of queue A9."""
    if sparse_grad and _is_train:
        raise MXNetError("Embedding(sparse_grad=True) in training needs the "
                         "row_sparse gradients of queue A9, not ported yet")
    idx = data.to(torch.int64)
    if idx.device.type != "meta":
        bad = ((idx < 0) | (idx >= weight.shape[0])).any()
        flags = getattr(_ID_CHECKS, "flags", None)
        if flags is not None:
            flags.append(bad)
            idx = idx.clamp(0, weight.shape[0] - 1)
        elif bool(bad):
            raise MXNetError(
                f"Embedding: token id outside [0, {weight.shape[0]})")
    return torch.nn.functional.embedding(idx, weight)


@register("cast_storage", attrs=AttrSpec(stype=("str",)))
def _cast_storage_op(data, stype):
    if stype != "default":
        raise MXNetError(f"cast_storage to {stype!r} needs the sparse "
                         "NDArrays of queue A9, not ported yet")
    return data


def _clip_or_wrap(idx, n, mode):
    return torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)


@register("take", num_inputs=2, input_names=["a", "indices"],
          attrs=AttrSpec(axis=("int", 0), mode=("str", "clip")))
def _take(a, indices, axis=0, mode="clip"):
    axis = axis % a.dim()
    idx = _clip_or_wrap(indices.to(torch.int64), a.shape[axis], mode)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("batch_take", num_inputs=2, input_names=["a", "indices"])
def _batch_take(a, indices):
    return torch.gather(a, 1, indices.to(torch.int64)[:, None]).squeeze(1)


@register("pick", num_inputs=2, input_names=["data", "index"],
          attrs=AttrSpec(axis=("int", -1), keepdims=("bool", False),
                         mode=("str", "clip")))
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """data[..., index, ...] along ``axis`` (reference
    broadcast_reduce_op_index.cc:pick)."""
    axis = axis % data.dim()
    idx = _clip_or_wrap(index.to(torch.int64), data.shape[axis], mode)
    idx = idx.reshape(data.shape[:axis] + data.shape[axis + 1:]).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register("one_hot",
          attrs=AttrSpec(depth=("int",), on_value=("float", 1.0),
                         off_value=("float", 0.0), dtype=("str", "float32")))
def _one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """Indices outside [0, depth) give a row of off_value, as
    jax.nn.one_hot's comparison does."""
    idx = indices.to(torch.int32)
    oh = (idx[..., None] == torch.arange(depth, dtype=torch.int32,
                                         device=idx.device))
    return oh.to(torch_dtype(dtype)) * (on_value - off_value) + off_value


@register("gather_nd", num_inputs=2, input_names=["data", "indices"])
def _gather_nd(data, indices):
    idx = indices.to(torch.int64)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("where", num_inputs=3, input_names=["condition", "x", "y"])
def _where(condition, x, y):
    if condition.dim() == 1 and x.dim() > 1:
        condition = condition.reshape((-1,) + (1,) * (x.dim() - 1))
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.where(condition != 0, x.to(dt), y.to(dt))


# ---------------------------------------------------------------------------
# creation (init_op.cc): zero-input ops build on the host; the executor and
# the imperative path move their output onto the asked device
# ---------------------------------------------------------------------------

_INIT_SPEC = AttrSpec(shape=("tuple", ()), ctx=("str", ""), dtype=("str", "float32"))


@register("_zeros", num_inputs=0, attrs=_INIT_SPEC)
def _zeros(shape=(), ctx="", dtype="float32"):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype))


@register("_ones", num_inputs=0, attrs=_INIT_SPEC)
def _ones(shape=(), ctx="", dtype="float32"):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype))


@register("_full", num_inputs=0,
          attrs=AttrSpec(shape=("tuple", ()), ctx=("str", ""),
                         dtype=("str", "float32"), value=("float",)))
def _full(shape=(), ctx="", dtype="float32", value=0.0):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype))


@register("_arange", num_inputs=0,
          attrs=AttrSpec(start=("float", 0.0), stop=("any", None),
                         step=("float", 1.0), repeat=("int", 1),
                         ctx=("str", ""), dtype=("str", "float32")))
def _arange(start=0.0, stop=None, step=1.0, repeat=1, ctx="", dtype="float32"):
    """np.arange's values, as jnp.arange computes them for concrete
    bounds."""
    if stop in (None, "None"):
        start, stop = 0.0, start
    tdt = torch_dtype(dtype)
    npdt = np.float32 if tdt is torch.bfloat16 else np.dtype(dtype)
    out = torch.from_numpy(np.arange(start, float(stop), step, dtype=npdt))
    out = out.to(tdt)
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register("zeros_like")
def _zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(x):
    return torch.ones_like(x)


# ---------------------------------------------------------------------------
# ordering (ordering_op.cc); stable on ties, as jnp.sort/argsort
# ---------------------------------------------------------------------------


def _flat_axis(x, axis):
    if axis in (None, "None"):
        return x.reshape(-1), -1
    return x, int(axis)


@register("sort", attrs=AttrSpec(axis=("any", -1), is_ascend=("bool", True)))
def _sort(x, axis=-1, is_ascend=True):
    x, axis = _flat_axis(x, axis)
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort",
          attrs=AttrSpec(axis=("any", -1), is_ascend=("bool", True),
                         dtype=("str", "float32")))
def _argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    x, axis = _flat_axis(x, axis)
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


def _topk_nout(attrs):
    rt = attrs.get("ret_typ", "indices")
    return 2 if rt == "both" else 1


@register("topk", num_outputs=_topk_nout,
          attrs=AttrSpec(axis=("any", -1), k=("int", 1),
                         ret_typ=("str", "indices"), is_ascend=("bool", False),
                         dtype=("str", "float32")))
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False, dtype="float32"):
    x, axis = _flat_axis(x, axis)
    axis = axis % x.dim()
    xs = torch.movedim(x, axis, -1)
    vals = xs if is_ascend else -xs
    sort_idx = torch.argsort(vals, dim=-1, stable=True)[..., :k]
    top_vals = torch.gather(xs, -1, sort_idx)
    idx_out = torch.movedim(sort_idx, -1, axis).to(torch_dtype(dtype))
    val_out = torch.movedim(top_vals, -1, axis)
    if ret_typ == "indices":
        return idx_out
    if ret_typ == "value":
        return val_out
    if ret_typ == "both":
        return (val_out, idx_out)
    if ret_typ == "mask":
        mask = torch.zeros_like(xs).scatter(-1, sort_idx, 1.0)
        return torch.movedim(mask, -1, axis)
    raise MXNetError(f"unknown topk ret_typ {ret_typ}")


# ---------------------------------------------------------------------------
# sequence ops (sequence_{last,mask,reverse}*.cc), time-major (T, N, ...)
# ---------------------------------------------------------------------------

_SEQ_SPEC = AttrSpec(use_sequence_length=("bool", False), axis=("int", 0))


def _seq_len_or_full(args, use_sequence_length, T, N):
    if use_sequence_length and len(args) > 1:
        return args[1].to(torch.int64)
    return torch.full((N,), T, dtype=torch.int64, device=args[0].device)


@register("SequenceLast", key_var_num_args=None, num_inputs=None,
          input_names=["data", "sequence_length"], attrs=_SEQ_SPEC)
def _sequence_last(*args, use_sequence_length=False, axis=0):
    data = args[0]
    T, N = data.shape[0], data.shape[1]
    lengths = _seq_len_or_full(args, use_sequence_length, T, N)
    idx = torch.clamp(lengths - 1, 0, T - 1)
    return data[idx, torch.arange(N, device=data.device)]


@register("SequenceMask", num_inputs=None,
          input_names=["data", "sequence_length"],
          attrs=AttrSpec(use_sequence_length=("bool", False),
                         value=("float", 0.0), axis=("int", 0)))
def _sequence_mask(*args, use_sequence_length=False, value=0.0, axis=0):
    data = args[0]
    T, N = data.shape[0], data.shape[1]
    lengths = _seq_len_or_full(args, use_sequence_length, T, N)
    mask = (torch.arange(T, device=data.device)[:, None] < lengths[None, :])
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("SequenceReverse", num_inputs=None,
          input_names=["data", "sequence_length"], attrs=_SEQ_SPEC)
def _sequence_reverse(*args, use_sequence_length=False, axis=0):
    data = args[0]
    T, N = data.shape[0], data.shape[1]
    lengths = _seq_len_or_full(args, use_sequence_length, T, N)
    t = torch.arange(T, device=data.device)[:, None]
    src = torch.where(t < lengths[None, :], lengths[None, :] - 1 - t, t)
    return data[src, torch.arange(N, device=data.device)[None, :]]

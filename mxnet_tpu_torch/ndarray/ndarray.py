"""NDArray over a ``torch.Tensor``, and the imperative op invocation.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. As there, an NDArray is a
handle with a write version: every write (``_set_data``, ``arr[...] = v``,
the in-place operators, ``out=``, ``copyto``, ``Rtc.push``) puts a new
tensor behind the handle and bumps ``version``. No tensor an NDArray holds
is written in place, so views and shared tensors (``reshape``, basic
slicing, ``copyto`` of equal types) are safe, and an array keeps the value
it had when another array was derived from it, as with the JAX package's
immutable arrays.

Autograd (``attach_grad``, ``backward``, ``grad``, ``detach``) runs over
torch autograd (:mod:`mxnet_tpu_torch.autograd`): inside ``record()`` an
op runs with grad mode on over each array's graph tensor, outside it under
``torch.no_grad()``. Left out, raising :class:`MXNetError`: sparse storage
(``tostype`` to csr/row_sparse; queue A9) and ``imdecode`` (queue A10).
numpy has no bfloat16, so a bf16 array's ``dtype`` is :data:`bfloat16` and
its ``asnumpy()`` is the exact float32 widening.
"""
from __future__ import annotations

import operator
import re
from typing import Optional

import numpy as _np
import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError, numeric_types
from ..context import Context, context_of, current_context
from ..dtypes import bfloat16, dtype_name, is_bf16, numpy_dtype, torch_dtype
from ..ops.registry import get_op

__all__ = ["NDArray", "imperative_invoke", "array", "empty", "zeros", "ones",
           "full", "arange", "concatenate", "moveaxis", "onehot_encode",
           "save", "load", "waitall", "zeros_like", "ones_like", "imdecode",
           "torch_dtype", "numpy_dtype", "dtype_name", "bfloat16"]


def _host_array(value, dtype=None) -> _np.ndarray:
    """numpy view of ``value`` with the JAX package's default narrowing:
    float64 -> float32 and int64 -> int32 unless a dtype is given."""
    npv = _np.asarray(value, dtype=dtype)
    if dtype is None and npv.dtype == _np.float64:
        npv = npv.astype(_np.float32)
    elif dtype is None and npv.dtype == _np.int64:
        npv = npv.astype(_np.int32)
    return npv


def _to_tensor(value, dtype=None, device=None) -> torch.Tensor:
    """A tensor of ``value`` (NDArray, tensor or host value) of ``dtype`` on
    ``device``. Host values are copied, never aliased."""
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        t = value
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return t if device is None else t.to(device)
    if dtype is not None and is_bf16(dtype):
        npv = _host_array(value, _np.float32)
    else:
        npv = _host_array(value, None if dtype is None
                          else numpy_dtype(torch_dtype(dtype)))
    t = torch.tensor(npv, device=device)  # copies
    return t.to(torch.bfloat16) if dtype is not None and is_bf16(dtype) else t


def _ndarray_from_numpy(npv, dtype=None):
    return NDArray(_to_tensor(npv, dtype, torch.device("cpu")))


def _torch_key(key):
    """An indexing key with NDArrays turned into index tensors."""
    if isinstance(key, tuple):
        return tuple(_torch_key(k) for k in key)
    if isinstance(key, NDArray):
        return key._data.long()
    return key


def _negative_step_index(t: torch.Tensor, key):
    """``t[key]``, where a slice of negative step (which torch lacks)
    becomes an index_select."""
    keys = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and (k.step or 1) < 0 for k in keys):
        return t[key]
    out, ax = t, 0
    for k in keys:
        if isinstance(k, slice) and (k.step or 1) < 0:
            idx = torch.arange(*k.indices(out.shape[ax]), device=t.device)
            out = out.index_select(ax, idx)
            ax += 1
        elif k is None:
            out = out.unsqueeze(ax)
            ax += 1
        elif isinstance(k, int):
            out = out.select(ax, k)
        else:
            out = out[(slice(None),) * ax + (k,)]
            ax += 1
    return out


def _autograd_is_training() -> bool:
    """Whether imperative ops run in train mode (``autograd.record()``,
    ``train_mode()``): Dropout draws, BatchNorm reads and moves its batch
    statistics, the RNN op's dropout draws."""
    return autograd.is_training()


class NDArray:
    """Multi-dimensional array with MXNet semantics over a torch tensor."""

    __slots__ = ("_data", "_version", "_grad_buf", "_grad_req", "_ag_leaf",
                 "__weakref__")

    # ensure ndarray <op> NDArray dispatches to us
    __array_priority__ = 100.0

    def __init__(self, data: torch.Tensor):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got {type(data)}")
        self._data = data
        self._version = 0
        self._grad_buf: Optional["NDArray"] = None
        self._grad_req = "null"
        # (tensor, leaf): the leaf autograd differentiates for that tensor
        self._ag_leaf = None

    # -- core properties ----------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def stype(self):
        return "default"

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    ctx = context

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    # -- engine bridge ------------------------------------------------------
    def wait_to_read(self):
        """Block until the value is computed (reference NDArray::WaitToRead):
        a synchronize of the array's card."""
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)
        return self

    wait_to_write = wait_to_read

    def _set_data(self, new_data: torch.Tensor):
        """Put ``new_data`` behind this handle and bump the write version
        (the python-level analogue of ThreadedVar's version list)."""
        self._data = new_data
        self._version += 1

    @property
    def version(self) -> int:
        return self._version

    # -- conversion ---------------------------------------------------------
    def asnumpy(self) -> _np.ndarray:
        """An owned host copy; waits for the device. bf16 comes back as its
        exact float32 widening."""
        t = self._data.detach()
        if t.dtype is torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def astype(self, dtype) -> "NDArray":
        return imperative_invoke("cast", [self], {"dtype": dtype_name(dtype)})[0]

    def copy(self) -> "NDArray":
        return NDArray(self._data.clone())

    def copyto(self, other):
        if isinstance(other, NDArray):
            if other is self:
                return other
            other._set_data(self._data.to(other._data.device,
                                          other._data.dtype))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device()))
        raise MXNetError(f"cannot copy to {type(other)}")

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    def tostype(self, stype):
        if stype == "default":
            return self
        raise MXNetError(f"storage type {stype!r} needs the sparse NDArrays "
                         "of queue A9, not ported yet")

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a gradient buffer and make this array a leaf of later
        recordings (its history, if any, is dropped)."""
        if self._data.requires_grad:
            self._data = self._data.detach()
        self._ag_leaf = None
        self._mark_variable(zeros_like(self), grad_req)

    def _mark_variable(self, grad_nd, grad_req):
        self._grad_buf = grad_nd
        self._grad_req = grad_req

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad_buf

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- mutation -----------------------------------------------------------
    def __setitem__(self, key, value):
        if isinstance(value, numeric_types):
            val = value
        else:
            val = _to_tensor(value, self._data.dtype, self._data.device)
        if isinstance(key, slice) and key == slice(None):
            if isinstance(val, numeric_types):
                self._set_data(torch.full_like(self._data, val))
            else:
                self._set_data(val.expand(self.shape).contiguous())
            return
        new = self._data.clone()
        new[_torch_key(key)] = val
        self._set_data(new)

    def __getitem__(self, key):
        if autograd.is_recording():
            return self._getitem_taped(key)
        if isinstance(key, NDArray):
            return NDArray(self._data[key._data.long()])
        return NDArray(_negative_step_index(self._data, _torch_key(key)))

    def _getitem_taped(self, key):
        """Indexing inside ``record()``: the same indexing of the array's
        graph tensor with grad mode on, so gradients flow through basic
        slices, integer and array keys alike (the JAX package routes them
        through its slice ops for the same end)."""
        t = autograd._graph_tensor(self)
        with torch.enable_grad():
            if isinstance(key, NDArray):
                return NDArray(t[key._data.long()])
            return NDArray(_negative_step_index(t, _torch_key(key)))

    # -- python protocol ----------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __repr__(self):
        return (f"{self.asnumpy()!r}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    def __hash__(self):
        return id(self)

    def __reduce__(self):
        # pickle via numpy (optimizer-state checkpointing)
        return (_ndarray_from_numpy, (self.asnumpy(), dtype_name(self.dtype)))

    # -- arithmetic, dispatched through the op table ------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            name = op if a.shape == b.shape else "broadcast_" + op.split("_")[-1]
            return imperative_invoke(name, [a, b], {})[0]
        if isinstance(other, numeric_types):
            return imperative_invoke(scalar_op, [self], {"scalar": other})[0]
        return NotImplemented

    def __add__(self, other):
        return self._binop(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        if isinstance(other, numeric_types):
            return imperative_invoke("_rminus_scalar", [self], {"scalar": other})[0]
        return self._binop(other, "elemwise_sub", "_minus_scalar", reverse=True)

    def __mul__(self, other):
        return self._binop(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "elemwise_div", "_div_scalar")

    __div__ = __truediv__

    def __rtruediv__(self, other):
        if isinstance(other, numeric_types):
            return imperative_invoke("_rdiv_scalar", [self], {"scalar": other})[0]
        return self._binop(other, "elemwise_div", "_div_scalar", reverse=True)

    __rdiv__ = __rtruediv__

    def __mod__(self, other):
        return self._binop(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        if isinstance(other, numeric_types):
            return imperative_invoke("_rmod_scalar", [self], {"scalar": other})[0]
        return self._binop(other, "broadcast_mod", "_mod_scalar", reverse=True)

    def __pow__(self, other):
        return self._binop(other, "_power", "_power_scalar")

    def __rpow__(self, other):
        if isinstance(other, numeric_types):
            return imperative_invoke("_rpower_scalar", [self], {"scalar": other})[0]
        return NotImplemented

    def __neg__(self):
        return imperative_invoke("negative", [self], {})[0]

    def __abs__(self):
        return imperative_invoke("abs", [self], {})[0]

    def _cmp(self, other, op):
        if isinstance(other, NDArray):
            return imperative_invoke("broadcast_" + op, [self, other], {})[0]
        return imperative_invoke(f"_{op}_scalar", [self], {"scalar": other})[0]

    def __eq__(self, other):
        if other is None:
            return False
        return self._cmp(other, "equal")

    def __ne__(self, other):
        if other is None:
            return True
        return self._cmp(other, "not_equal")

    def __gt__(self, other):
        return self._cmp(other, "greater")

    def __ge__(self, other):
        return self._cmp(other, "greater_equal")

    def __lt__(self, other):
        return self._cmp(other, "lesser")

    def __le__(self, other):
        return self._cmp(other, "lesser_equal")

    # in-place operators put the result behind this handle
    def __iadd__(self, other):
        self._set_data(self.__add__(other)._data)
        return self

    def __isub__(self, other):
        self._set_data(self.__sub__(other)._data)
        return self

    def __imul__(self, other):
        self._set_data(self.__mul__(other)._data)
        return self

    def __itruediv__(self, other):
        self._set_data(self.__truediv__(other)._data)
        return self

    __idiv__ = __itruediv__

    # -- method forms of common ops -----------------------------------------
    def reshape(self, shape=None, *args):
        if args:
            shape = (shape,) + args
        if isinstance(shape, int):
            shape = (shape,)
        return imperative_invoke("reshape", [self], {"shape": shape})[0]

    def broadcast_to(self, shape):
        return imperative_invoke("broadcast_to", [self], {"shape": shape})[0]

    def transpose(self, axes=None):
        return imperative_invoke("transpose", [self],
                                 {"axes": tuple(axes) if axes else ()})[0]

    def swapaxes(self, dim1, dim2):
        return imperative_invoke("swapaxes", [self],
                                 {"dim1": dim1, "dim2": dim2})[0]

    def flatten(self):
        return imperative_invoke("Flatten", [self], {})[0]

    def expand_dims(self, axis):
        return imperative_invoke("expand_dims", [self], {"axis": axis})[0]

    def slice_axis(self, axis, begin, end):
        return imperative_invoke("slice_axis", [self],
                                 {"axis": axis, "begin": begin, "end": end})[0]

    def _reduce(self, name, axis=None, keepdims=False):
        if isinstance(axis, int):
            axis = (axis,)
        return imperative_invoke(name, [self],
                                 {"axis": axis, "keepdims": keepdims})[0]

    def sum(self, axis=None, keepdims=False, **kw):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return self._reduce("mean", axis, keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return self._reduce("prod", axis, keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return self._reduce("min", axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return imperative_invoke("argmax", [self],
                                 {"axis": axis, "keepdims": keepdims})[0]

    def argmin(self, axis=None, keepdims=False):
        return imperative_invoke("argmin", [self],
                                 {"axis": axis, "keepdims": keepdims})[0]

    def clip(self, a_min, a_max):
        return imperative_invoke("clip", [self],
                                 {"a_min": a_min, "a_max": a_max})[0]

    def abs(self):
        return self.__abs__()

    def square(self):
        return imperative_invoke("square", [self], {})[0]

    def sqrt(self):
        return imperative_invoke("sqrt", [self], {})[0]

    def norm(self):
        return imperative_invoke("norm", [self], {})[0]

    def sign(self):
        return imperative_invoke("sign", [self], {})[0]

    def log(self):
        return imperative_invoke("log", [self], {})[0]

    def exp(self):
        return imperative_invoke("exp", [self], {})[0]

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        out = imperative_invoke("SliceChannel", [self],
                                {"num_outputs": num_outputs, "axis": axis,
                                 "squeeze_axis": squeeze_axis})
        return list(out) if len(out) > 1 else out[0]

    def take(self, indices, axis=0, mode="clip"):
        return imperative_invoke("take", [self, indices],
                                 {"axis": axis, "mode": mode})[0]

    def one_hot(self, depth, **kw):
        return imperative_invoke("one_hot", [self], dict(depth=depth, **kw))[0]

    def as_nd_ndarray(self):
        return self

    def tolist(self):
        return self.asnumpy().tolist()


# ---------------------------------------------------------------------------
# imperative invoke: parse attrs, run the op on the tensors, wrap outputs
# (reference MXImperativeInvoke, src/c_api/c_api_ndarray.cc:553)
# ---------------------------------------------------------------------------

_CTX_ATTR = re.compile(r"^\s*(cpu|gpu|tpu|cpu_pinned|cpu_shared)\((\d+)\)\s*$")


def _ctx_from_attr(ctx) -> Optional[Context]:
    if isinstance(ctx, Context):
        return ctx
    m = _CTX_ATTR.match(ctx or "")
    return Context(m.group(1), int(m.group(2))) if m else None


def imperative_invoke(op_name, inputs, attrs, out=None):
    """Run one op on NDArrays. Outputs are new NDArrays, or with ``out=``
    written (cast to each target's dtype) behind the given ones. A call
    that may draw randomness (``opdef.uses_rng``) gets the device's
    ``random.generator``; an op that takes one but does not draw with these
    attrs gets ``None``. Inside ``autograd.record()`` the op runs with grad
    mode on over the inputs' graph tensors (``autograd._graph_tensor``), so
    that torch autograd records it; outside, under ``torch.no_grad()``."""
    opdef = get_op(op_name) if isinstance(op_name, str) else op_name
    parsed = opdef.parse_attrs(attrs or {})
    first = next((x for x in inputs if isinstance(x, NDArray)), None)
    device = (first._data.device if first is not None
              else (_ctx_from_attr(parsed.get("ctx"))
                    or current_context()).torch_device())
    recording = autograd.is_recording()
    # auxiliary states (BatchNorm's moving statistics) take no gradient
    vals = [(autograd._graph_tensor(x)
             if recording and i not in opdef.aux_inputs else x._data)
            if isinstance(x, NDArray) else _to_tensor(x, device=device)
            for i, x in enumerate(inputs)]

    call_attrs = dict(parsed)
    if opdef.key_var_num_args and not call_attrs.get(opdef.key_var_num_args):
        call_attrs[opdef.key_var_num_args] = len(inputs)
    is_train = _autograd_is_training()
    if opdef.needs_is_train:
        call_attrs["_is_train"] = is_train
    if opdef.needs_rng:
        vals = [_random.generator(device) if opdef.uses_rng(parsed)
                else None] + vals
    with torch.enable_grad() if recording else torch.no_grad():
        outputs = opdef.fn(*vals, **call_attrs)
    if not isinstance(outputs, tuple):
        outputs = (outputs,)
    if not inputs:
        # creation ops build on the host; place them on the asked device
        outputs = tuple(o.to(device) for o in outputs)

    # write back auxiliary-state updates (BatchNorm moving statistics)
    if opdef.aux_update and is_train:
        for out_idx, in_idx in opdef.aux_update.items():
            tgt = inputs[in_idx]
            if isinstance(tgt, NDArray):
                tgt._set_data(outputs[out_idx])

    n_visible = opdef.num_outputs(parsed)
    visible = outputs[:n_visible] if len(outputs) > n_visible else outputs
    out_arrays = [NDArray(o) for o in visible]

    if out is not None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        for tgt, src in zip(outs, out_arrays):
            tgt._set_data(src._data.to(tgt._data.dtype))
        return list(outs)
    return out_arrays


# ---------------------------------------------------------------------------
# creation and io functions (reference python/mxnet/ndarray/ndarray.py
# module functions, MXNDArraySave/Load)
# ---------------------------------------------------------------------------


def _device(ctx: Optional[Context]) -> torch.device:
    return (ctx or current_context()).torch_device()


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """Copy ``source_array`` onto ``ctx`` (default: the current context)."""
    return NDArray(_to_tensor(source_array, dtype, _device(ctx)).clone()
                   if isinstance(source_array, (NDArray, torch.Tensor))
                   else _to_tensor(source_array, dtype, _device(ctx)))


def empty(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An uninitialized array (``torch.empty``)."""
    return NDArray(torch.empty(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def zeros(shape, ctx: Optional[Context] = None, dtype=None, **kw) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx: Optional[Context] = None, dtype=None, **kw) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def zeros_like(other: NDArray) -> NDArray:
    return NDArray(torch.zeros_like(other._data))


def ones_like(other: NDArray) -> NDArray:
    return NDArray(torch.ones_like(other._data))


def arange(start, stop=None, step=1.0, repeat=1, ctx: Optional[Context] = None,
           dtype=None) -> NDArray:
    return imperative_invoke("_arange", [], {
        "start": start, "stop": stop, "step": step, "repeat": repeat,
        "ctx": str(ctx or current_context()), "dtype": dtype or "float32"})[0]


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return NDArray(torch.cat([a._data for a in arrays], dim=axis))


def moveaxis(tensor, source, destination) -> NDArray:
    return NDArray(torch.movedim(tensor._data, source, destination))


def onehot_encode(indices, out):
    depth = out.shape[1]
    res = imperative_invoke("one_hot", [indices], {"depth": depth})[0]
    out._set_data(res._data.to(out._data.dtype))
    return out


def waitall():
    """Wait for all pending device work (reference MXNDArrayWaitAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0, channels=3,
             mean=None):
    raise MXNetError("imdecode comes with the image IO of queue A10, not "
                     "ported yet")


# -- serialization ----------------------------------------------------------


def _host_for_save(arr: NDArray) -> _np.ndarray:
    if arr._data.dtype is torch.bfloat16:
        raise MXNetError("save: numpy has no bfloat16, so a bf16 array has "
                         "no .npz form; save arr.astype('float32')")
    return arr.asnumpy()


def save(fname: str, data):
    """Save NDArrays in the JAX package's ``.npz`` container, so that a
    file written by either package loads in the other."""
    if isinstance(data, NDArray):
        arrays = {"0": _host_for_save(data)}
    elif isinstance(data, (list, tuple)):
        arrays = {str(i): _host_for_save(d) for i, d in enumerate(data)}
    elif isinstance(data, dict):
        arrays = {k: _host_for_save(v) for k, v in data.items()}
    else:
        raise MXNetError("save expects NDArray, list or dict")
    # a file object keeps the exact name (np.savez appends .npz to paths)
    with open(fname, "wb") as f:
        _np.savez(f, **arrays)


def load(fname: str, ctx: Optional[Context] = None):
    """Load what :func:`save` wrote: a list for integer keys, else a dict,
    onto ``ctx`` (default: the current context)."""
    with _np.load(fname) as f:
        keys = list(f.keys())
        if all(k.isdigit() for k in keys):
            return [array(f[k], ctx=ctx) for k in sorted(keys, key=int)]
        return {k: array(f[k], ctx=ctx) for k in keys}


# ---------------------------------------------------------------------------
# module-level arithmetic (reference ndarray.py _ufunc_helper: array·array
# goes to the broadcast op, array·scalar to the scalar op, scalar·scalar to
# the python operator)
# ---------------------------------------------------------------------------

def _table_op(name):
    opdef = get_op(name)

    def f(*args, **kw):
        res = imperative_invoke(opdef, list(args), kw)
        return res[0] if len(res) == 1 else res
    return f


def _ufunc_helper(lhs, rhs, fn_array, fn_scalar, lfn_scalar,
                  rfn_scalar=None):
    if isinstance(lhs, numeric_types):
        if isinstance(rhs, numeric_types):
            return fn_scalar(lhs, rhs)
        if rfn_scalar is None:
            # commutative
            return _table_op(lfn_scalar)(rhs, scalar=float(lhs))
        return _table_op(rfn_scalar)(rhs, scalar=float(lhs))
    if isinstance(rhs, numeric_types):
        return _table_op(lfn_scalar)(lhs, scalar=float(rhs))
    if isinstance(rhs, NDArray):
        return _table_op(fn_array)(lhs, rhs)
    raise TypeError(f"type {type(rhs)} not supported")


def add(lhs, rhs):
    """Element-wise sum with broadcasting."""
    return _ufunc_helper(lhs, rhs, "broadcast_add", operator.add,
                         "_plus_scalar")


def subtract(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_sub", operator.sub,
                         "_minus_scalar", "_rminus_scalar")


def multiply(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_mul", operator.mul,
                         "_mul_scalar")


def divide(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_div", operator.truediv,
                         "_div_scalar", "_rdiv_scalar")


true_divide = divide


def modulo(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_mod", operator.mod,
                         "_mod_scalar", "_rmod_scalar")


def power(base, exp):
    return _ufunc_helper(base, exp, "broadcast_power", operator.pow,
                         "_power_scalar", "_rpower_scalar")


def maximum(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_maximum",
                         lambda x, y: x if x > y else y, "_maximum_scalar")


def minimum(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_minimum",
                         lambda x, y: x if x < y else y, "_minimum_scalar")


def equal(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_equal",
                         lambda x, y: 1.0 if x == y else 0.0,
                         "_equal_scalar")


def not_equal(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_not_equal",
                         lambda x, y: 1.0 if x != y else 0.0,
                         "_not_equal_scalar")


def greater(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_greater",
                         lambda x, y: 1.0 if x > y else 0.0,
                         "_greater_scalar", "_lesser_scalar")


def greater_equal(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_greater_equal",
                         lambda x, y: 1.0 if x >= y else 0.0,
                         "_greater_equal_scalar", "_lesser_equal_scalar")


def lesser(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_lesser",
                         lambda x, y: 1.0 if x < y else 0.0,
                         "_lesser_scalar", "_greater_scalar")


def lesser_equal(lhs, rhs):
    return _ufunc_helper(lhs, rhs, "broadcast_lesser_equal",
                         lambda x, y: 1.0 if x <= y else 0.0,
                         "_lesser_equal_scalar", "_greater_equal_scalar")

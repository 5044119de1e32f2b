"""Imperative autograd: record scopes and backward over torch autograd.

Counterpart of ``mxnet_tpu/autograd.py`` (reference python/mxnet/autograd.py
and src/ndarray/autograd.cc). The JAX package tapes one node an op and runs
``jax.vjp`` a node in backward; here torch autograd is the tape. Inside
``record()`` every op of :func:`~mxnet_tpu_torch.ndarray.imperative_invoke`
runs with grad mode on, and each floating-point NDArray that enters an op
without a history enters as a leaf tensor that needs a gradient (one leaf
an NDArray and tensor, kept on the array); outside it ops run under
``torch.no_grad()``, so nothing builds a graph and a parameter's tensor
can be updated in place. :func:`backward` asks ``torch.autograd.grad``
for the leaves of every array with a gradient buffer (each leaf is kept
in a weak registry while it lives); the heads reach some of them, and the
gradients land on each array's ``_grad_buf`` (written, added, or not at
all by its ``grad_req``), never on ``tensor.grad``. Every write bumps the
buffer's version, which the Gluon Trainer's stale-gradient check reads.

As in the JAX package, whose tape lives as long as the heads, the graph
is kept after a backward: a second ``backward()`` on the same heads gives
the same gradients. It is freed with the heads.
"""
from __future__ import annotations

import itertools
import threading
import weakref

import torch

from .base import MXNetError

__all__ = [
    "record",
    "pause",
    "train_mode",
    "predict_mode",
    "is_recording",
    "is_training",
    "set_recording",
    "set_training",
    "mark_variables",
    "backward",
    "grad",
    "Function",
]

_scope = threading.local()


def _st():
    if not hasattr(_scope, "recording"):
        _scope.recording = False
        _scope.training = False
    return _scope


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


def set_recording(is_record: bool) -> bool:
    st = _st()
    prev, st.recording = st.recording, is_record
    return prev


def set_training(train: bool) -> bool:
    st = _st()
    prev, st.training = st.training, train
    return prev


class _Scope:
    def __init__(self, recording=None, training=None):
        self._recording = recording
        self._training = training

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._recording is not None:
            st.recording = self._recording
        if self._training is not None:
            st.training = self._training
        return self

    def __exit__(self, *args):
        st = _st()
        st.recording, st.training = self._prev
        return False


def record(train_mode: bool = True):
    """``with autograd.record():`` records the ops run inside it."""
    return _Scope(recording=True, training=train_mode)


def pause(train_mode: bool = False):
    return _Scope(recording=False, training=train_mode)


def train_mode():
    return _Scope(training=True)


def predict_mode():
    return _Scope(training=False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to arrays (reference
    MXAutogradMarkVariables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var._mark_variable(g, req)


def _graph_tensor(arr) -> torch.Tensor:
    """The tensor an op recorded now reads for NDArray ``arr``: its own
    when it has a history (the output of a recorded op) or is not
    floating point, else a leaf that needs a gradient, made once for the
    array's current tensor and kept on the array (``_ag_leaf``), so that
    every use of the array within a recording reaches the same leaf."""
    t = arr._data
    if t.requires_grad or not t.is_floating_point():
        return t
    cached = arr._ag_leaf
    if cached is not None and cached[0] is t:
        return cached[1]
    leaf = t.detach().requires_grad_()
    leaf._mx_array = weakref.ref(arr)
    arr._ag_leaf = (t, leaf)
    _LEAVES[next(_leaf_ids)] = leaf
    return leaf


# every leaf that _graph_tensor made and a graph or its array still holds:
# backward asks torch for the gradients of those whose array has a
# gradient buffer, and torch gives None for those its heads do not reach
_LEAVES = weakref.WeakValueDictionary()
_leaf_ids = itertools.count()


def _marked_leaves():
    """(NDArray, leaf tensor) of each live leaf whose array has a
    gradient buffer."""
    flat = []
    for leaf in list(_LEAVES.values()):
        arr = leaf._mx_array()
        if arr is not None and arr._grad_buf is not None:
            flat.append((arr, leaf))
    return flat


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (each with its head gradient, ones where
    None) with respect to the marked arrays their recorded graph reaches,
    into the arrays' gradient buffers. ``retain_graph`` and
    ``train_mode`` are accepted for the reference's signature: the graph
    is always kept (see the module docstring)."""
    from .ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    outs, cots = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            if h._grad_buf is None:
                raise MXNetError(
                    "cannot differentiate a head that is neither recorded "
                    "nor a marked variable")
            t = _graph_tensor(h)
        outs.append(t)
        cots.append(torch.ones_like(t) if hg is None
                    else hg._data.to(t.device, t.dtype))
    flat = _marked_leaves()
    if not flat:
        return
    with torch.enable_grad():
        grads = torch.autograd.grad(outs, [leaf for _, leaf in flat], cots,
                                    retain_graph=True, allow_unused=True)
    summed = {}
    for (arr, _), g in zip(flat, grads):
        if g is not None:
            prev = summed.get(id(arr))
            summed[id(arr)] = (arr, g if prev is None else prev[1] + g)
    for arr, g in summed.values():
        buf, req = arr._grad_buf, arr._grad_req
        if req == "null" or buf is None:
            continue
        g = g.to(buf._data.dtype)
        buf._set_data(buf._data + g if req == "add" else g)


class _FunctionNode(torch.autograd.Function):
    """A user :class:`Function` as one node of torch's graph: its forward
    runs the user's ``forward`` on NDArrays of the inputs, its backward
    the user's ``backward`` on NDArrays of the cotangents."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray import NDArray
        ctx.func = func
        outputs = func.forward(*[NDArray(t) for t in tensors])
        ctx.single = isinstance(outputs, NDArray)
        outs = (outputs,) if ctx.single else tuple(outputs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cots):
        from .ndarray import NDArray
        func = ctx.func
        with pause():
            rets = func.backward(*[NDArray(c) for c in cots])
        if isinstance(rets, NDArray):
            rets = (rets,)
        n_in = len(ctx.needs_input_grad) - 1
        if len(rets) != n_in:
            raise MXNetError(
                f"{type(func).__name__}.backward must return exactly as "
                f"many NDArrays as forward's arguments (expected {n_in}, "
                f"got {len(rets)})")
        return (None,) + tuple(r._data if need else None for r, need in
                               zip(rets, ctx.needs_input_grad[1:]))


class Function:
    """A user-defined differentiable function (reference
    autograd.py:291): ``forward`` and ``backward`` on NDArrays, the
    latter replacing the chain rule through the former. For example,
    a numerically stable sigmoid::

        class sigmoid(mx.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + mx.nd.exp(-x))
                self.save_for_backward(y)
                return y
            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

    Outside ``record()`` a call is ``forward``; inside it the call is one
    node of the graph, a ``torch.autograd.Function`` whose forward runs
    ``forward`` with recording paused."""

    def __init__(self):
        self._used = False
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        """Takes as many inputs as forward's outputs; returns as many
        NDArrays as forward's arguments."""
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray

        if self._used:
            raise MXNetError(
                "Each Function instance can only be called once. "
                "Please create another instance.")
        self._used = True
        if not is_recording():
            return self.forward(*inputs)
        tensors = [_graph_tensor(x) for x in inputs]
        with pause(train_mode=is_training()), torch.enable_grad():
            outs = _FunctionNode.apply(self, *tensors)
        outs = outs if isinstance(outs, tuple) else (outs,)
        arrays = tuple(NDArray(o) for o in outs)
        return arrays[0] if len(arrays) == 1 else arrays


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, as new
    arrays; the variables' own gradient buffers are left as they were.
    As in the JAX package the results are values: ``create_graph`` is
    accepted and no graph of the gradient is recorded."""
    from .ndarray import NDArray, zeros_like

    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    saved = [(v._grad_buf, v._grad_req) for v in variables]
    try:
        for v in variables:
            v._mark_variable(zeros_like(v), "write")
        backward(heads, head_grads, retain_graph=bool(retain_graph),
                 train_mode=train_mode)
        outs = [v.grad.copy() for v in variables]
    finally:
        for v, (buf, req) in zip(variables, saved):
            v._grad_buf, v._grad_req = buf, req
    return outs[0] if single else outs

"""Gluon parameters: named, lazily-shaped weights with attached gradients.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference
python/mxnet/gluon/parameter.py: ``Parameter`` :41, ``ParameterDict``
:394). A parameter is one NDArray on one device (the card unless
``initialize(ctx=cpu())``), marked for autograd with a gradient buffer of
its shape; ``list_data``/``list_grad`` return that one array, as the JAX
package's do. ``ParameterDict.save``/``load`` use the ``.npz`` container
of ``nd.save``, so a file written by either package loads in the other.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as _np

from .. import autograd, initializer, ndarray
from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray
from ..symbol import Symbol

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Raised when a parameter's value is read before its shape is known
    (reference: gluon/parameter.py DeferredInitializationError)."""


def _shape_complete(shape):
    return shape is not None and all(s > 0 for s in shape)


class Parameter:
    """A weight of a Block (reference gluon/parameter.py:41).

    Supports deferred initialization: when ``shape`` contains 0s, the real
    shape is fixed at the first forward pass (``_finish_deferred_init``).
    """

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        if not differentiable:
            grad_req = "null"
        self._grad_req = grad_req
        self._data = None           # NDArray
        self._grad = None           # NDArray
        self._deferred_init = None  # (init, ctx) while waiting for shape
        self._var = None

    # -- properties ---------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req}")
        self._grad_req = req
        if self._data is not None:
            if req == "null":
                self._grad = None
                self._data._mark_variable(None, "null")
            else:
                self._init_grad()

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    # -- initialization -----------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Materialize the value (reference gluon/parameter.py:initialize)."""
        if self._data is not None and not force_reinit:
            return
        if default_init is None:
            default_init = initializer.Uniform()
        if ctx is None:
            ctx = current_context()
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else current_context()
        init = init or self.init or default_init
        if not _shape_complete(self.shape):
            if not self.allow_deferred_init:
                raise MXNetError(
                    f"Cannot initialize Parameter {self.name} because it has "
                    f"invalid shape {self.shape}; set allow_deferred_init=True "
                    "or provide a complete shape")
            self._deferred_init = (init, ctx)
            return
        self._finish_init(init, ctx)

    def _finish_init(self, init, ctx):
        data = ndarray.empty(self.shape, dtype=self.dtype, ctx=ctx)
        if isinstance(init, str):
            init = initializer.create(init)
        init(initializer.InitDesc(self.name), data)
        self._data = data
        self._deferred_init = None
        if self._grad_req != "null":
            self._init_grad()

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not _shape_complete(self.shape):
            raise DeferredInitializationError(
                f"Parameter {self.name} has unknown shape {self.shape}")
        init, ctx = self._deferred_init
        self._finish_init(init, ctx)

    def _init_grad(self):
        self._grad = ndarray.zeros_like(self._data)
        self._data._mark_variable(self._grad, self._grad_req)

    def _check_and_get(self):
        if self._data is not None:
            return self._data
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"Parameter {self.name} has not been initialized yet because "
                "its shape is still unknown (deferred initialization)")
        raise MXNetError(
            f"Parameter {self.name} has not been initialized. You should "
            "call initialize() first")

    # -- accessors ----------------------------------------------------------
    def data(self, ctx=None):
        return self._check_and_get()

    def list_data(self):
        return [self._check_and_get()]

    def grad(self, ctx=None):
        if self._grad is None:
            raise MXNetError(
                f"Cannot get gradient of Parameter {self.name} because "
                f"grad_req='{self._grad_req}'")
        self._check_and_get()
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self._check_and_get().context]

    def set_data(self, data):
        if self._data is None:
            # setting data before init fixes the shape and materializes
            self.shape = tuple(data.shape)
            if self._deferred_init is not None:
                self._finish_deferred_init()
            else:
                self._data = data if isinstance(data, NDArray) \
                    else ndarray.array(data)
                if self._grad_req != "null":
                    self._init_grad()
                return
        if tuple(data.shape) != tuple(self._data.shape):
            raise MXNetError(
                f"shape mismatch setting {self.name}: "
                f"{data.shape} vs {self._data.shape}")
        self._data[:] = data

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0

    def reset_ctx(self, ctx):
        """Move the value and its gradient buffer to ``ctx``."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        if self._data is not None and self._data.context != ctx:
            self._data = self._data.copyto(ctx)
            if self._grad_req != "null":
                self._init_grad()
        elif self._deferred_init is not None:
            self._deferred_init = (self._deferred_init[0], ctx)

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is not None:
            with autograd.pause():
                self._data = self._data.astype(dtype)
            if self._grad is not None:
                self._grad = self._grad.astype(dtype)
                self._data._mark_variable(self._grad, self._grad_req)

    def var(self) -> Symbol:
        if self._var is None:
            from ..symbol import Variable
            self._var = Variable(self.name, shape=self.shape,
                                 dtype=self.dtype,
                                 lr_mult=self.lr_mult, wd_mult=self.wd_mult,
                                 init=self.init)
        return self._var


class Constant(Parameter):
    """Non-learnable constant parameter (reference gluon later-versions; kept
    for model-zoo layers needing fixed tensors)."""

    def __init__(self, name, value):
        if not isinstance(value, _np.ndarray):
            value = _np.asarray(value, dtype=_np.float32)
        self.value = value

        class _CInit(initializer.Initializer):
            def _init_weight(_self, desc, arr):
                arr[:] = value

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_CInit())


class ParameterDict:
    """A prefix-scoped dictionary of Parameters (gluon/parameter.py:394)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        names = ", ".join(sorted(self._params))
        return f"ParameterDict '{self._prefix}' ({names})"

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """Get or create the parameter ``prefix+name`` (reference :475)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        # merge/verify attributes against an existing (possibly shared) param
        for k, v in kwargs.items():
            if k == "shape" and v is not None:
                v = tuple(v)
                if param.shape is not None and _shape_complete(param.shape):
                    if any(a and b and a != b for a, b in
                           zip(param.shape, v)):
                        raise MXNetError(
                            f"shape mismatch for shared Parameter {name}: "
                            f"{param.shape} vs {v}")
                elif _shape_complete(v):
                    param.shape = v
            elif getattr(param, k, None) is None and v is not None:
                setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError(f"no constant named {name} and no value")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"cannot update self with other: duplicate "
                                 f"parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self.values():
            p.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Save to the reference's NDArray-map checkpoint format
        (gluon/parameter.py:550)."""
        arg_dict = {}
        for p in self.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = p.data()
        ndarray.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        loaded = ndarray.load(filename, ctx=ctx)
        loaded = {restore_prefix + k.split(":", 1)[-1]: v
                  for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise MXNetError(f"Parameter {name} missing in {filename}")
        for name, value in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter {name} in file {filename} is not in this "
                        "ParameterDict")
                continue
            self._params[name].set_data(value)

"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (reference
python/mxnet/initializer.py): an Initializer base dispatching on the
parameter-name suffix (weight/bias/gamma/beta/moving_*) through a routing
table, the ``__init__`` attribute override, a string registry, and the
Uniform/Normal/Xavier/MSRAPrelu/Orthogonal/Bilinear/Constant/Mixed/One/
Zero/LSTMBias/Load family. Every draw is numpy on the host from
``random.host_rng()``, the stream the JAX package's initializers draw
from, funnelled through ``Initializer._store``: after the same
``random.seed`` both packages fill the same parameters with the same
bits.
"""
from __future__ import annotations

import json
import re

import numpy as _np

from .base import Registry
from .ndarray import NDArray
from .random import host_rng as _host_rng

__all__ = ["Initializer", "InitDesc", "register", "create", "Uniform",
           "Normal", "Xavier", "MSRAPrelu", "Zero", "One", "Constant",
           "Orthogonal", "Bilinear", "Mixed", "Load", "LSTMBias"]

_REG = Registry("initializer")
register = _REG.register


class InitDesc(str):
    """Parameter name + attrs hint (reference: initializer.py InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = str.__new__(cls, name)
        obj.attrs = dict(attrs) if attrs else {}
        obj.global_init = global_init
        return obj


# parameter-name suffix -> handler method name, checked in order
_SUFFIX_ROUTES = (
    ("weight", "_init_weight"),
    ("bias", "_init_bias"),
    ("gamma", "_init_gamma"),
    ("beta", "_init_beta"),
    ("moving_mean", "_init_zero"),
    ("running_mean", "_init_zero"),
    ("moving_var", "_init_one"),
    ("running_var", "_init_one"),
    ("moving_inv_var", "_init_zero"),
    ("moving_avg", "_init_zero"),
)


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr: NDArray):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        override = desc.attrs.get("__init__", "")
        if override:
            klass, kwargs = json.loads(override)
            create(klass, **kwargs)._init_weight(desc, arr)
            return
        for suffix, handler in _SUFFIX_ROUTES:
            if str(desc).endswith(suffix):
                getattr(self, handler)(desc, arr)
                return
        self._init_default(desc, arr)

    # -- shared fill helpers ------------------------------------------------
    @staticmethod
    def _store(arr, host):
        """Move a host numpy draw into the target array (on its device, in
        its dtype) as float32 values."""
        arr[:] = _np.asarray(host, dtype="float32")

    def _init_zero(self, desc, arr):
        arr[:] = 0.0

    def _init_one(self, desc, arr):
        arr[:] = 1.0

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, desc, arr):
        raise NotImplementedError()

    def _init_default(self, desc, arr):
        self._init_weight(desc, arr)

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Zero(Initializer):
    _init_weight = Initializer._init_zero


_REG._map["zeros"] = Zero


@register
class One(Initializer):
    _init_weight = Initializer._init_one


_REG._map["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = float(scale)

    def _init_weight(self, desc, arr):
        bound = self.scale
        self._store(arr, _host_rng().uniform(-bound, bound, arr.shape))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = float(sigma)

    def _init_weight(self, desc, arr):
        self._store(arr, _host_rng().normal(0, self.sigma, arr.shape))


@register
class Xavier(Initializer):
    """Xavier/Glorot (reference: initializer.py Xavier — rnd_type uniform/
    gaussian, factor_type avg/in/out, magnitude)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    @staticmethod
    def _fans(desc, shape):
        """(fan_in, fan_out) honouring an NHWC-style __layout__ hint."""
        layout = str(desc.attrs.get("__layout__", "")) \
            if isinstance(desc, InitDesc) else ""
        if layout.endswith("C") and not layout.startswith("NC") \
                and len(shape) > 2:
            # OHWI conv weight: fan_in = I*spatial, fan_out = O*spatial
            spatial = float(_np.prod(shape[1:-1]))
            return shape[-1] * spatial, shape[0] * spatial
        # OIHW (reference layout) / plain (out, in) matrices
        spatial = float(_np.prod(shape[2:])) if len(shape) > 2 else 1.0
        return shape[1] * spatial, shape[0] * spatial

    def _init_weight(self, desc, arr):
        shape = arr.shape
        if len(shape) < 2:
            self._store(arr, _host_rng().uniform(-0.07, 0.07, shape))
            return
        fan_in, fan_out = self._fans(desc, shape)
        denoms = {"avg": (fan_in + fan_out) / 2.0,
                  "in": fan_in,
                  "out": fan_out}
        if self.factor_type not in denoms:
            raise ValueError(
                f"unknown factor_type {self.factor_type!r}; "
                f"choose one of {sorted(denoms)}")
        denom = denoms[self.factor_type]
        scale = float(_np.sqrt(self.magnitude / denom))
        draw = (_host_rng().uniform(-scale, scale, shape)
                if self.rnd_type == "uniform"
                else _host_rng().normal(0, scale, shape))
        self._store(arr, draw)


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = float(scale)
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        rows = arr.shape[0]
        cols = int(_np.prod(arr.shape[1:]))
        seed = (_host_rng().uniform(-1.0, 1.0, (rows, cols))
                if self.rand_type == "uniform"
                else _host_rng().normal(0.0, 1.0, (rows, cols)))
        u, _, v = _np.linalg.svd(seed, full_matrices=False)
        basis = u if u.shape == seed.shape else v
        self._store(arr, self.scale * basis.reshape(arr.shape))


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernels (reference: used with Deconvolution
    UpSampling weights). Built as an outer product of 1-D triangle
    filters, broadcast over the channel axes."""

    def _init_weight(self, desc, arr):
        width = arr.shape[3]
        f = _np.ceil(width / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        tri_x = 1 - _np.abs(_np.arange(width) / f - c)
        tri_y = 1 - _np.abs(_np.arange(arr.shape[2]) / f - c)
        kernel = _np.outer(tri_y, tri_x)
        self._store(arr, _np.broadcast_to(kernel, arr.shape))


@register
class LSTMBias(Initializer):
    """Forget-gate bias init (reference: initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        gates = _np.zeros(arr.shape, dtype="float32")
        h = arr.shape[0] // 4
        gates[h:2 * h] = self.forget_bias  # i, f, g, o order
        self._store(arr, gates)

    _init_bias = _init_weight


@register
class Mixed(Initializer):
    def __init__(self, patterns, initializers):
        super().__init__()
        self._routes = [(re.compile(p), init)
                        for p, init in zip(patterns, initializers)]

    def __call__(self, desc, arr):
        for matcher, init in self._routes:
            if matcher.match(str(desc)):
                init(desc, arr)
                return
        raise ValueError(f"parameter {desc} did not match any pattern")


@register
class Load:
    """Init from a saved param dict, fall back to default_init."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k.split(":", 1)[-1]: v for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        name = str(name)
        known = self.param.get(name)
        if known is not None:
            arr[:] = known
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise ValueError(f"no init pattern for {name}")


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _REG.get(name)(**kwargs)

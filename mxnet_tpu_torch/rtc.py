"""Runtime-compiled kernels: the port of ``mxnet_tpu/rtc.py``.

The reference MXNet's ``mxrtc`` compiled CUDA C strings with NVRTC. The JAX
package kept its API but takes a Python body over input/output Refs, run
in ``pl.pallas_call``. The port keeps the JAX package's body language and
compiles it with NVRTC again: on CUDA tensors ``push`` translates the body
to one CUDA C kernel (``ops/cuda/rtc_codegen.py``), compiles it at the
first push (cached by source) and launches it, or raises. On CPU tensors it
runs the plain version: the body itself, over Refs that wrap torch tensors,
with ``jnp`` and ``jax`` as small namespaces of torch functions carrying
jnp's dtype rules (weak Python numbers, per-operation rounding, floor
``//`` and ``%``). Both paths take the same elementwise subset, checked at
construction; see ``rtc_codegen`` for it.

    rtc = mx.rtc.Rtc('axpy', [('x', x), ('y', y)], [('out', out)], '''
    out[:] = x[:] * 2.0 + y[:]
    ''')
    rtc.push([x, y], [out])

``grid_dims``/``block_dims``, ignored by the JAX package, are the launch
shape on the card when given (the kernel's grid-stride loop makes the
result independent of them); both paths reject a zero dim or more than
1024 threads a block.
"""
from __future__ import annotations

import textwrap
import types
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError
from .dtypes import dtype_name, torch_dtype
from .ops.cuda import rtc_codegen as _cg
from .ops.cuda.rtc import check_launch_dims, rtc_launch

__all__ = ["Rtc"]


# -- the plain version: jnp's semantics over torch tensors -----------------


def _dt(v) -> str:
    """The subset dtype of a value: a Val's dtype or a weak Python number."""
    if isinstance(v, _Val):
        return v.dtype
    return _cg.WEAK_FLOAT if isinstance(v, float) else _cg.WEAK_INT


def _tt(dtype: str) -> torch.dtype:
    return torch.bool if dtype == "bool" else torch_dtype(dtype)


class _Val:
    """A value of the body: a tensor and its subset dtype."""

    def __init__(self, t: torch.Tensor, dtype: str):
        self.t, self.dtype = t, dtype

    def to(self, dtype: str) -> torch.Tensor:
        if dtype == self.dtype:
            return self.t
        if dtype == "int32" and self.dtype in _cg.FLOATS:
            # truncate toward zero, saturate, NaN -> 0 (the kernel's
            # __float2int_rz)
            t = self.t.float()
            hi, lo = t >= 2.0 ** 31, t < -2.0 ** 31
            out = torch.where(hi | lo | torch.isnan(t), 0.0, t).to(torch.int32)
            return torch.where(hi, _cg.INT_MAX, torch.where(lo, _cg.INT_MIN, out))
        if self.dtype == "int32" and dtype in ("bfloat16", "float16"):
            return self.t.float().to(_tt(dtype))  # as the kernel: via fp32
        return self.t.to(_tt(dtype))

    # arithmetic
    def __add__(self, o):
        return _binop("+", self, o)

    def __radd__(self, o):
        return _binop("+", o, self)

    def __sub__(self, o):
        return _binop("-", self, o)

    def __rsub__(self, o):
        return _binop("-", o, self)

    def __mul__(self, o):
        return _binop("*", self, o)

    def __rmul__(self, o):
        return _binop("*", o, self)

    def __truediv__(self, o):
        return _binop("/", self, o)

    def __rtruediv__(self, o):
        return _binop("/", o, self)

    def __floordiv__(self, o):
        return _binop("//", self, o)

    def __rfloordiv__(self, o):
        return _binop("//", o, self)

    def __mod__(self, o):
        return _binop("%", self, o)

    def __rmod__(self, o):
        return _binop("%", o, self)

    def __pow__(self, o):
        return _binop("**", self, o)

    def __rpow__(self, o):
        return _binop("**", o, self)

    def __neg__(self):
        return _Val(torch.neg(self.t), self.dtype)

    def __pos__(self):
        return self

    # comparisons
    def __lt__(self, o):
        return _cmp(torch.lt, self, o)

    def __le__(self, o):
        return _cmp(torch.le, self, o)

    def __gt__(self, o):
        return _cmp(torch.gt, self, o)

    def __ge__(self, o):
        return _cmp(torch.ge, self, o)

    def __eq__(self, o):
        return _cmp(torch.eq, self, o)

    def __ne__(self, o):
        return _cmp(torch.ne, self, o)

    def astype(self, dtype: str) -> "_Val":
        return _Val(self.to(dtype), dtype)


def _as(v, dtype: str, device) -> torch.Tensor:
    """``v`` as a tensor of ``dtype``: a Python number converts as torch
    converts it (double -> float -> bf16/f16), as the kernel's literals."""
    if isinstance(v, _Val):
        return v.to(dtype)
    return torch.tensor(v, dtype=_tt(dtype), device=device)


def _device(*vals):
    return next(v.t.device for v in vals if isinstance(v, _Val))


def _where_int_div(a, b):
    """XLA's integer division and remainder: x / 0 = -1, x % 0 = x,
    INT_MIN / -1 = INT_MIN (torch raises or traps on these)."""
    zero = b == 0
    ovf = (a == _cg.INT_MIN) & (b == -1)
    safe = torch.where(zero | ovf, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    r = torch.fmod(a, safe)
    q = torch.where(zero, torch.full_like(q, -1), torch.where(ovf, a, q))
    r = torch.where(zero, a, torch.where(ovf, torch.zeros_like(r), r))
    return q, r


def _round_away(x):
    """lax.round: half away from zero."""
    r = torch.round(x)
    tr = torch.trunc(x)
    tie = torch.abs(x - tr) == 0.5
    return torch.where(tie, tr + torch.sign(x), r)


def _binop(op: str, a, b) -> _Val:
    if not isinstance(a, _Val) and not isinstance(b, _Val):
        return _cg.PY_OPS[op](a, b)
    dev = _device(a, b)
    ta, tb = _dt(a), _dt(b)
    if op == "**":
        if not isinstance(b, _Val) and isinstance(b, int):
            return _ipow(a, b)
        t = _cg.promote(ta, tb)
        return _Val(torch.pow(_as(a, t, dev), _as(b, t, dev)), t)
    t = _cg.promote(ta, tb)
    if op == "/" and t in ("int32", "bool"):
        t = "float32"
    x, y = _as(a, t, dev), _as(b, t, dev)
    if op in "+-*/":
        fn = {"+": torch.add, "-": torch.sub, "*": torch.mul,
              "/": torch.div}[op]
        return _Val(fn(x, y), t)
    if t == "int32":
        if op == "%":  # jnp.remainder: a divisor of 0 counts as 1
            y = torch.where(y == 0, torch.ones_like(y), y)
            _, r = _where_int_div(x, y)
            plus = ((r < 0) != (y < 0)) & (r != 0)
            return _Val(torch.where(plus, r + y, r), t)
        q, r = _where_int_div(x, y)
        sel = (torch.sign(x) != torch.sign(y)) & (r != 0)
        return _Val(torch.where(sel, q - 1, q), t)
    mod = torch.fmod(x, y)
    if op == "%":
        plus = ((mod < 0) != (y < 0)) & (mod != 0)
        return _Val(torch.where(plus, mod + y, mod), t)
    div = (x - mod) / y  # _float_divmod, each op in the dtype
    ind = (mod != 0) & (_sign(y) != _sign(mod))
    div = torch.where(ind, div - 1, div)
    return _Val(_round_away(div), t)


def _sign(x):
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _ipow(a: _Val, k: int) -> _Val:
    """lax.integer_pow: binary exponentiation, each product rounded."""
    x = a.t
    if k == 0:
        return _Val(torch.ones_like(x), a.dtype)
    recip, k, acc = k < 0, abs(k), None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return _Val(1.0 / acc if recip else acc, a.dtype)


def _cmp(fn, a, b) -> _Val:
    t = _cg.promote(_dt(a), _dt(b))
    dev = _device(a, b)
    return _Val(fn(_as(a, t, dev), _as(b, t, dev)), "bool")


def _float_val(v: _Val) -> _Val:
    return v if v.dtype in _cg.FLOATS else v.astype("float32")


def _unary(fn):
    return lambda x: (lambda v: _Val(fn(v.t), v.dtype))(_float_val(x))


def _maximum(a, b):
    t = _cg.promote(_dt(a), _dt(b))
    dev = _device(a, b)
    return _Val(torch.maximum(_as(a, t, dev), _as(b, t, dev)), t)


def _minimum(a, b):
    t = _cg.promote(_dt(a), _dt(b))
    dev = _device(a, b)
    return _Val(torch.minimum(_as(a, t, dev), _as(b, t, dev)), t)


def _where(c, a, b):
    dev = _device(c, a, b)
    if not isinstance(c, _Val):
        cond = torch.tensor(c != 0, device=dev)
    else:
        cond = c.t if c.dtype == "bool" else c.t != 0
    t = _cg.promote(_dt(a), _dt(b))
    return _Val(torch.where(cond, _as(a, t, dev), _as(b, t, dev)), t)


def _clip(x, min=None, max=None, a_min=None, a_max=None):
    lo = min if min is not None else a_min
    hi = max if max is not None else a_max
    if lo is not None:
        x = _maximum(lo, x)
    if hi is not None:
        x = _minimum(hi, x)
    return x


def _sigmoid(x: _Val) -> _Val:
    """lax.logistic: 1 / (1 + exp(-x)), each op in x's dtype."""
    one = torch.ones((), dtype=x.t.dtype, device=x.t.device)
    return _Val(one / (one + torch.exp(-x.t)), x.dtype)


def _floor_like(fn):
    return lambda x: x if x.dtype == "int32" else _Val(fn(x.t), x.dtype)


_JNP = types.SimpleNamespace(
    exp=_unary(torch.exp), log=_unary(torch.log), log1p=_unary(torch.log1p),
    expm1=_unary(torch.expm1), sqrt=_unary(torch.sqrt),
    tanh=_unary(torch.tanh), sin=_unary(torch.sin), cos=_unary(torch.cos),
    abs=lambda x: _Val(torch.abs(x.t), x.dtype),
    square=lambda x: _Val(x.t * x.t, x.dtype),
    sign=lambda x: _Val(_sign(x.t), x.dtype),
    floor=_floor_like(torch.floor), ceil=_floor_like(torch.ceil),
    maximum=_maximum, minimum=_minimum, where=_where, clip=_clip,
    float32="float32", bfloat16="bfloat16", float16="float16",
    int32="int32")
_JAX = types.SimpleNamespace(nn=types.SimpleNamespace(
    sigmoid=_sigmoid, relu=lambda x: _maximum(x, 0)))


class _Ref:
    """A whole-array Ref over a torch tensor, read and written as x[:] or
    x[...]."""

    def __init__(self, t: torch.Tensor, dtype: str):
        self.t, self.dtype = t, dtype

    def __getitem__(self, key):
        return _Val(self.t, self.dtype)

    def __setitem__(self, key, value):
        # the subset check at construction holds shape and dtype already
        self.t = value.t


def _spec(arrays) -> List[Tuple[str, tuple, str]]:
    return [(n, tuple(a.shape), dtype_name(a.dtype)) for n, a in arrays]


class Rtc:
    def __init__(self, name: str, inputs: Sequence[Tuple[str, object]],
                 outputs: Sequence[Tuple[str, object]], kernel: str):
        """name: kernel name; inputs/outputs: (name, NDArray) pairs fixing
        the argument names, shapes and dtypes; kernel: python source whose
        statements read/write the named Refs (``x[:]``-style). A body
        outside the compiled subset raises MXNetError here."""
        self.name = name
        self.input_names = [n for n, _ in inputs]
        self.output_names = [n for n, _ in outputs]
        if not self.output_names:
            raise MXNetError("Rtc needs at least one output")
        self._in_templates = [(s, d) for _, s, d in _spec(inputs)]
        self._out_templates = [(s, d) for _, s, d in _spec(outputs)]
        body = textwrap.dedent(kernel)
        args = ", ".join(self.input_names + self.output_names)
        src = (f"def _rtc_kernel({args}):\n"
               + textwrap.indent(body.strip() + "\n", "    "))
        scope = {"jnp": _JNP, "jax": _JAX, "np": np}
        try:
            exec(compile(src, f"<rtc:{name}>", "exec"), scope)
        except SyntaxError as e:
            raise MXNetError(f"Rtc kernel {name!r} failed to parse: {e}")
        self._kernel = scope["_rtc_kernel"]
        self._program = _cg.analyze(name, _spec(inputs), _spec(outputs), body)

    def _run_plain(self, tensors: List[torch.Tensor], device):
        refs = [_Ref(t, d) for t, (_, d) in zip(tensors, self._in_templates)]
        outs = [_Ref(torch.full(s, _cg.nan_fill(d), dtype=torch_dtype(d),
                                device=device), d)
                for s, d in self._out_templates]
        self._kernel(*refs, *outs)
        return [o.t for o in outs]

    def push(self, inputs: List, outputs: List, grid_dims=None,
             block_dims=None):
        """Run the kernel: on the card the NVRTC-compiled kernel with the
        given launch shape, on the CPU the plain version. Each output gets a
        new tensor behind its handle (its version bumps)."""
        if len(inputs) != len(self.input_names) or \
                len(outputs) != len(self.output_names):
            raise MXNetError(
                f"Rtc {self.name!r} expects {len(self.input_names)} inputs "
                f"and {len(self.output_names)} outputs")
        inputs = [x if hasattr(x, "shape") else np.asarray(x)
                  for x in inputs]
        for name, x, (shape, dtype) in zip(self.input_names, inputs,
                                           self._in_templates):
            xs = tuple(x.shape)
            xd = dtype_name(x.dtype)
            if xs != shape or xd != dtype:
                raise MXNetError(
                    f"Rtc {self.name!r} input {name!r}: got {xs}/{xd}, "
                    f"compiled for {shape}/{dtype}")
        check_launch_dims(grid_dims, block_dims)
        devices = {x._data.device for x in inputs if hasattr(x, "_data")}
        if not devices:
            devices = {o._data.device for o in outputs if hasattr(o, "_data")}
        if len(devices) > 1:
            raise MXNetError(f"Rtc {self.name!r}: inputs on several devices "
                             f"{sorted(map(str, devices))}")
        device = devices.pop() if devices else torch.device("cpu")
        tensors = [x._data if hasattr(x, "_data")
                   else torch.tensor(x, dtype=torch_dtype(d), device=device)
                   for x, (_, d) in zip(inputs, self._in_templates)]
        if device.type == "cuda":
            res = rtc_launch(self._program, tensors, grid_dims, block_dims)
        elif device.type == "cpu":
            res = self._run_plain(tensors, device)
        else:
            raise MXNetError(f"Rtc {self.name!r}: no kernel for {device}")
        for o, r in zip(outputs, res):
            o._set_data(r)
        return outputs

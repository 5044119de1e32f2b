"""Runtime-compiled kernels: the port of ``mxnet_tpu/rtc.py``.

The reference MXNet's ``mxrtc`` compiled CUDA C strings with NVRTC. The JAX
package kept its API but takes a Python body over input/output Refs, run
in ``pl.pallas_call``. The port keeps the JAX package's body language and
compiles it with NVRTC again. ``Rtc(...)`` runs the body once over symbolic
Refs (``ops/cuda/rtc_analyze.py``): that checks it and gives its program,
each output's final value as a typed graph. On CUDA tensors ``push``
compiles the program into one NVRTC module of map, reduce and product
stages (``ops/cuda/rtc_codegen.py``) at the first push (cached by source)
and launches it, or raises. On CPU tensors it runs the plain version: the
same program evaluated with torch ops, with jnp's rules (weak Python
numbers, per-operation rounding, floor ``//`` and ``%``, integer
wrapping, 16-bit float reductions in fp32 rounded once).

The language, as in the JAX package's interpret mode with x64 off:

* **Refs**: float32, bfloat16, float16, int32, int8, uint8 and bool, each
  output of its own shape. ``ref.shape``, ``ref.ndim``, ``ref.dtype``,
  ``len(ref)`` are Python values; Python arithmetic on them folds.
  ``jnp.pi``, ``np.pi``, ``jnp.inf`` and ``jnp.nan`` are numbers.
* **Indexing** on Ref reads, values and stores: static ints (negative
  too), slices with static bounds and a positive step, ``...``, and
  ``None`` on values. A store writes its region, whose shape the value
  must have, and leaves the rest of the Ref as it was (an earlier store or
  the fill: NaN, the least integer, False); a read of an output after a
  store gives the stored value. ``o[:] += e`` and ``a *= 2.0`` work.
* **Views**: ``.T``, ``jnp.transpose``, ``.reshape``/``jnp.reshape``,
  ``jnp.expand_dims``, ``jnp.squeeze``, ``jnp.broadcast_to``.
* **Reductions**: ``jnp.{sum, mean, max, min, prod, argmax, argmin, any,
  all}`` and their methods, with ``axis`` (an int, negative, or a tuple)
  and ``keepdims``; ``jax.nn.softmax`` and ``jax.nn.log_softmax`` as JAX
  expands them. Sums of ints give int32 (wrapping), means of ints fp32,
  argmax/argmin int32 (the first index; NaN wins), max/min keep NaN.
* **Products**: ``jnp.dot``, ``jnp.matmul`` and ``@`` on 1-D and 2-D
  operands and ``matmul`` with one leading batch dim;
  ``jax.lax.dot_general`` in the contractions ``(((1,), (0,)), ((), ()))``
  and ``(((1,), (1,)), ((), ()))`` with ``preferred_element_type``. 16-bit
  floats accumulate in fp32 and round once; int32 wraps.
* **Static control flow**, unrolled at ``Rtc(...)``: ``for i in
  range(...)``, ``jax.lax.fori_loop`` with static bounds and a lambda or
  local ``def``, ``if``/``elif``/``else`` and ``a if c else b`` on Python
  values. The truth value of an array (``if`` on one, a chained
  comparison of arrays) raises, as in JAX; so does a body that unrolls
  past 4096 statements.
* **Elementwise**: ``+ - * / // % **`` (integer powers with array
  exponents too), comparisons, bitwise ``& | ^ ~ << >>``,
  ``jnp.{exp, log, log1p, expm1, sqrt, tanh, sin, cos, tan, arcsin,
  arccos, arctan, arctan2, sinh, cosh, log2, log10, exp2, abs, square,
  sign, floor, ceil, round, trunc, maximum, minimum, where, clip, power,
  reciprocal, negative, isnan, isinf, isfinite, logical_and, logical_or,
  logical_not, mod, floor_divide, zeros, ones, full and their _like}``,
  ``jax.lax.{rsqrt, erf}``, ``jax.nn.{sigmoid, relu, gelu (approximate),
  silu, softplus, log_sigmoid, leaky_relu, elu}``, ``.astype`` to any Ref
  dtype, int16 or a Ref's ``dtype``. Promotion is jnp's lattice with x64
  off (``uint8 + int8`` is int16).

Still refused, with :class:`MXNetError` naming the construct and
``ROADMAP.md``'s "B4 remaining body language": gathers and advanced
indexing, scans, ``lax.while_loop``/``cond``/``scan``, sorting, ``einsum``,
products of rank above 3, fp64 (``.astype(jnp.float64)`` too) and complex
types, random numbers, and ``np`` functions of array values.

    rtc = mx.rtc.Rtc('axpy', [('x', x), ('y', y)], [('out', out)], '''
    out[:] = x[:] * 2.0 + y[:]
    ''')
    rtc.push([x, y], [out])

``grid_dims``/``block_dims``, ignored by the JAX package, are the launch
shape of the map stages on the card when given (their grid-stride loops
make the result independent of them); reduce and product stages choose
their own. Both paths reject a zero dim or more than 1024 threads a block.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError
from .dtypes import dtype_name, torch_dtype
from .ops.cuda import rtc_codegen as _cg
from .ops.cuda.rtc_analyze import FLOATS, IINFO, INTS, WEAK_FLOAT, WEAK_INT
from .ops.cuda.rtc import check_launch_dims, rtc_launch

__all__ = ["Rtc"]


# -- the plain version: the program evaluated with torch --------------------

_TT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16, "int32": torch.int32, "int16": torch.int16,
       "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
       WEAK_INT: torch.int32, WEAK_FLOAT: torch.float32}
_CANON = {WEAK_INT: "int32", WEAK_FLOAT: "float32"}


def _conv(t: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """``t`` held for dtype ``src`` converted to ``dst`` as the kernel
    converts: float to integer truncates, saturates and takes NaN to 0;
    integers wrap; integers reach 16-bit floats through fp32."""
    src, dst = _CANON.get(src, src), _CANON.get(dst, dst)
    if src == dst:
        return t
    if dst == "bool":
        return t != 0
    if dst in INTS:
        if src in FLOATS:
            lo, hi = IINFO[dst]
            x = t.float()
            big, small = x >= float(hi) + 1.0, x < float(lo)
            out = torch.where(big | small | torch.isnan(x), 0.0,
                              torch.trunc(x)).to(torch.int64)
            out = torch.where(big, hi, torch.where(small, lo, out))
            return out.to(_TT[dst])
        return t.to(torch.int64).to(_TT[dst]) if src != "bool" else \
            t.to(_TT[dst])
    if src not in FLOATS and dst != "float32":
        return t.float().to(_TT[dst])
    return t.to(_TT[dst])


def _where_int_div(a, b, dtype):
    """XLA's integer division and remainder: x / 0 = -1, x % 0 = x,
    MIN / -1 = MIN (torch raises or traps on these)."""
    lo = IINFO[dtype][0]
    zero = b == 0
    ovf = (a == lo) & (b == -1)
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


def _sign(x):
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


_FN = {"exp": torch.exp, "log": torch.log, "log1p": torch.log1p,
       "expm1": torch.expm1, "sqrt": torch.sqrt, "tanh": torch.tanh,
       "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
       "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
       "sinh": torch.sinh, "cosh": torch.cosh, "exp2": torch.exp2,
       "rsqrt": torch.rsqrt, "erf": torch.erf, "abs": torch.abs,
       "floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
       "round": torch.round, "square": lambda x: x * x, "sign": _sign,
       "isnan": torch.isnan, "isinf": torch.isinf,
       "isfinite": torch.isfinite}


class _Plain:
    """Evaluates a program's values with torch on one device."""

    def __init__(self, inputs: Dict[str, torch.Tensor], device):
        self.inputs, self.device = inputs, device
        self.memo: Dict[int, torch.Tensor] = {}

    def val(self, e, dtype: str) -> torch.Tensor:
        """``e`` as a tensor of ``dtype``: a weak literal converts as torch
        converts a Python number."""
        if e.kind == "const" and e.dtype in (WEAK_INT, WEAK_FLOAT):
            return torch.tensor(e.info["value"], dtype=_TT[dtype],
                                device=self.device)
        return _conv(self.ev(e), e.dtype, dtype)

    def ev(self, e) -> torch.Tensor:
        r = self.memo.get(id(e))
        if r is None:
            r = self.memo[id(e)] = getattr(self, "_" + e.kind)(e)
        return r

    def _const(self, e):
        return torch.tensor(e.info["value"], dtype=_TT[e.dtype],
                            device=self.device)

    def _in(self, e):
        return self.inputs[e.info["name"]]

    def _fill(self, e):
        return torch.full(e.shape, _cg.nan_fill(e.dtype), dtype=_TT[e.dtype],
                          device=self.device)

    def _neg(self, e):
        return torch.neg(self.val(e.args[0], e.dtype))

    def _bin(self, e):
        t, op = _CANON.get(e.dtype, e.dtype), e.info["op"]
        x, y = (self.val(a, t) for a in e.args)
        if t == "bool":
            return {"&": torch.logical_and, "|": torch.logical_or,
                    "^": torch.logical_xor}[op](x, y)
        if op in ("&", "|", "^"):
            return {"&": torch.bitwise_and, "|": torch.bitwise_or,
                    "^": torch.bitwise_xor}[op](x, y)
        if op in ("<<", ">>"):
            bits = {"int32": 32, "int16": 16, "int8": 8, "uint8": 8}[t]
            out = (y < 0) | (y >= bits)
            s = torch.where(out, torch.zeros_like(y), y).to(torch.int64)
            x64 = x.to(torch.int64)
            if op == "<<":
                r = torch.where(out, torch.zeros_like(x64), x64 << s)
                return r.to(_TT[t])  # wraps
            fill = torch.where(x64 < 0, -1, 0)
            return torch.where(out, fill, x64 >> s).to(_TT[t])
        if op in "+-*/":
            return {"+": torch.add, "-": torch.sub, "*": torch.mul,
                    "/": torch.div}[op](x, y)
        if t == "uint8":
            zero = y == 0
            safe = torch.where(zero, torch.ones_like(y), y)
            if op == "//":
                return torch.where(zero, torch.full_like(x, 255),
                                   torch.div(x, safe, rounding_mode="trunc"))
            return torch.where(zero, torch.zeros_like(x), torch.remainder(x, safe))
        if t in INTS:
            if op == "%":  # jnp.remainder: a divisor of 0 counts as 1
                y = torch.where(y == 0, torch.ones_like(y), y)
                _, r = _where_int_div(x, y, t)
                plus = ((r < 0) != (y < 0)) & (r != 0)
                return torch.where(plus, r + y, r)
            q, r = _where_int_div(x, y, t)
            sel = (torch.sign(x) != torch.sign(y)) & (r != 0)
            return torch.where(sel, q - 1, q)
        mod = torch.fmod(x, y)
        if op == "%":
            plus = ((mod < 0) != (y < 0)) & (mod != 0)
            return torch.where(plus, mod + y, mod)
        div = (x - mod) / y  # _float_divmod, each op in the dtype
        ind = (mod != 0) & (_sign(y) != _sign(mod))
        div = torch.where(ind, div - 1, div)
        return _round_away(div)

    def _ipow(self, e):
        """lax.integer_pow: binary exponentiation, each product rounded."""
        x = self.val(e.args[0], e.dtype)
        k = e.info["k"]
        if k == 0:
            return torch.ones_like(x)
        recip, k, acc = k < 0, abs(k), None
        while k > 0:
            if k & 1:
                acc = x if acc is None else acc * x
            k >>= 1
            if k > 0:
                x = x * x
        return 1.0 / acc if recip else acc

    def _ipowa(self, e):
        """jnp's _pow_int_int: six bits of the exponent."""
        x, y = (self.val(a, e.dtype) for a in e.args)
        x, y = torch.broadcast_tensors(x, y)
        acc = torch.where((x == 0) & (y != 0), torch.zeros_like(x),
                          torch.ones_like(x))
        y64 = y.to(torch.int64)
        for k in range(6):
            acc = torch.where(((y64 >> k) & 1) != 0, acc * x, acc)
            x = x * x
        return acc

    def _pow(self, e):
        x, y = (self.val(a, e.dtype) for a in e.args)
        return torch.pow(x, y)

    def _cmp(self, e):
        ct = e.info["ctype"]
        ct = {WEAK_INT: "int32", WEAK_FLOAT: "float32"}.get(ct, ct)
        x, y = (self.val(a, ct) for a in e.args)
        return {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
                "==": torch.eq, "!=": torch.ne}[e.info["op"]](x, y)

    def _max(self, e):
        return torch.maximum(*(self.val(a, e.dtype) for a in e.args))

    def _min(self, e):
        return torch.minimum(*(self.val(a, e.dtype) for a in e.args))

    def _where(self, e):
        c = self.val(e.args[0], "bool")
        a, b = (self.val(x, e.dtype) for x in e.args[1:])
        return torch.where(c, a, b)

    def _cast(self, e):
        return self.val(e.args[0], e.dtype)

    def _sigmoid(self, e):
        """lax.logistic: 1 / (1 + exp(-x)), each op in x's dtype."""
        x = self.val(e.args[0], e.dtype)
        one = torch.ones((), dtype=x.dtype, device=x.device)
        return one / (one + torch.exp(-x))

    def _not(self, e):
        x = self.val(e.args[0], e.dtype)
        return torch.logical_not(x) if e.dtype == "bool" else \
            torch.bitwise_not(x)

    def _fn(self, e):
        a = e.args[0]
        dt = a.dtype if e.info["fn"] in ("isnan", "isinf", "isfinite") \
            else e.dtype
        return _FN[e.info["fn"]](self.val(a, dt))

    def _fn2(self, e):
        return torch.atan2(*(self.val(a, e.dtype) for a in e.args))

    def _view(self, e):
        src = self.ev(e.args[0])
        start, dims = e.info["start"], e.info["dims"]
        driven = {d: (k, step) for k, (d, step) in enumerate(dims)
                  if d is not None}
        index = []
        for d in range(src.dim()):
            if d in driven:
                k, step = driven[d]
                n = e.shape[k]
                index.append(slice(start[d], start[d] + step * (n - 1) + 1, step))
            else:
                index.append(start[d])
        t = src[tuple(index)] if index else src
        ks = [k for d, (k, _) in sorted(driven.items())]
        order = sorted(range(len(ks)), key=lambda i: ks[i])
        t = t.permute(order) if len(order) > 1 else t
        for k, (d, _) in enumerate(dims):
            if d is None:
                t = t.unsqueeze(k)
        return t.expand(e.shape)

    def _reshape(self, e):
        return self.ev(e.args[0]).reshape(e.shape)

    def _store(self, e):
        old, val = self.ev(e.args[0]), self.ev(e.args[1])
        out = old.clone()
        index = tuple(slice(s, s + step * (n - 1) + 1, step) if kept else s
                      for s, step, n, kept in e.info["region"])
        out[index] = val
        return out

    def _reduce(self, e):
        src = e.args[0]
        op, axes, acc = e.info["op"], e.info["axes"], e.info["acc"]
        R = int(np.prod([src.shape[d] for d in axes]))
        if op in ("sum", "mean", "prod"):
            if acc == "float32":
                s = self.val(src, "float32")
                r = torch.sum(s, axes) if op != "prod" else _prod(s, axes)
                if op == "mean":
                    r = r / torch.tensor(float(R), dtype=torch.float32)
                return _conv(r, "float32", e.dtype).reshape(e.shape)
            s = self.val(src, "int32").to(torch.int64)
            r = torch.sum(s, axes) if op == "sum" else _prod(s, axes)
            return r.to(torch.int32).reshape(e.shape)  # wraps
        s = self.val(src, acc)
        if op in ("max", "min"):
            f = torch.amax if op == "max" else torch.amin
            return f(s, axes).reshape(e.shape)
        if op in ("any", "all"):
            f = torch.any if op == "any" else torch.all
            r = s
            for d in sorted(axes, reverse=True):
                r = f(r, d)
            return r.reshape(e.shape)
        # argmax / argmin over one axis: NaN wins, then the first index
        (axis,) = axes
        x = s.to(torch.uint8) if acc == "bool" else s
        if x.is_floating_point():
            nan = torch.isnan(x)
            big = float("-inf") if op == "argmax" else float("inf")
            idx = (torch.argmax if op == "argmax" else torch.argmin)(
                torch.where(nan, big, x.float()), axis)
            first_nan = torch.argmax(nan.to(torch.uint8), axis)
            idx = torch.where(nan.any(axis), first_nan, idx)
        else:
            idx = (torch.argmax if op == "argmax" else torch.argmin)(x, axis)
        return idx.to(torch.int32).reshape(e.shape)

    def _dot(self, e):
        a, b = (self.val(x, e.args[0].dtype) for x in e.args)
        if e.info["acc"] == "float32":
            r = torch.matmul(a.float(), b.float())
            return _conv(r, "float32", e.dtype)
        r = (a.to(torch.int64).unsqueeze(-1) * b.to(torch.int64).unsqueeze(-3)
             ).sum(-2)
        return r.to(_TT[e.dtype])


def _prod(s: torch.Tensor, axes) -> torch.Tensor:
    r = s
    for d in sorted(axes, reverse=True):
        r = torch.prod(r, d)
    return r


def _spec(arrays) -> List[Tuple[str, tuple, str]]:
    return [(n, tuple(a.shape), dtype_name(a.dtype)) for n, a in arrays]


class Rtc:
    def __init__(self, name: str, inputs: Sequence[Tuple[str, object]],
                 outputs: Sequence[Tuple[str, object]], kernel: str):
        """name: kernel name; inputs/outputs: (name, NDArray) pairs fixing
        the argument names, shapes and dtypes; kernel: python source whose
        statements read/write the named Refs (``x[:]``-style). A body
        outside the language raises MXNetError here."""
        self.name = name
        self.input_names = [n for n, _ in inputs]
        self.output_names = [n for n, _ in outputs]
        if not self.output_names:
            raise MXNetError("Rtc needs at least one output")
        self._in_templates = [(s, d) for _, s, d in _spec(inputs)]
        self._out_templates = [(s, d) for _, s, d in _spec(outputs)]
        self._program = _cg.analyze(name, _spec(inputs), _spec(outputs),
                                    kernel)

    def _run_plain(self, tensors: List[torch.Tensor], device):
        """The plain version: the program over ``tensors`` with torch ops on
        ``device``, into new tensors."""
        prog = self._program
        plain = _Plain({n: t for (n, _, _), t in zip(prog.inputs, tensors)},
                       device)
        # outputs are new tensors, as the JAX interpreter's are: a value
        # that is (a view of) an input is copied
        storages = {t.untyped_storage().data_ptr() for t in tensors}
        outs = []
        for n, _, dt in prog.outputs:
            r = plain.val(prog.finals[n], dt)
            shared = r.untyped_storage().data_ptr() in storages
            outs.append(r.clone(memory_format=torch.contiguous_format)
                        if shared else r.contiguous())
        return outs

    def push(self, inputs: List, outputs: List, grid_dims=None,
             block_dims=None):
        """Run the kernel: on the card the NVRTC-compiled stages with the
        given launch shape for map stages, on the CPU the plain version.
        Each output gets a new tensor behind its handle (its version
        bumps)."""
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

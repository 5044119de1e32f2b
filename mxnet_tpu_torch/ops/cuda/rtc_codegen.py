"""Translator of ``Rtc`` programs into the CUDA C source of one NVRTC module.

The JAX package's ``Rtc`` (``mxnet_tpu/rtc.py``) runs a Python body over
whole-array Refs inside ``pl.pallas_call``. The port compiles the same body
at runtime with NVRTC. :func:`analyze` (``rtc_analyze.py``) runs the body
over symbolic Refs and returns its program: each output's final value as a
typed dataflow graph. This module writes the kernels. It needs neither a
card nor a compiler, so the tests run it here.

The language (``mxnet_tpu_torch/rtc.py`` states it in full): static values
and folding (``ref.shape``, ``len``, Python arithmetic, ``jnp.pi``),
basic indexing on reads, values and stores (static ints, slices with a
positive step, ``None`` on values, ``...``), views (``.T``, transpose,
reshape, expand_dims, squeeze, broadcast_to), reductions (sum, mean, max,
min, prod, argmax, argmin, any, all, softmax and log_softmax), products
(dot, matmul, ``@`` up to one batch dim, the two 2-D ``lax.dot_general``
forms), static control flow unrolled at analysis, elementwise functions
and bitwise operators, over float32, bfloat16, float16, int32, int8,
uint8 and bool Refs, each output with its own shape. Anything else raises
:class:`MXNetError` naming the construct and :data:`QUEUE_ENTRY`.

Two kinds of module:

* A program of the elementwise subset whose outputs share one shape
  (``Program.simple``) compiles as before: :func:`emit` writes one kernel
  over the layout-collapsed index space (:func:`layout`), sizes and strides
  as launch arguments, so one module serves every shape, and a 16-byte
  vector kernel where every read is contiguous or one broadcast element.
  It loads every Ref the body reads once, at the top, before any store,
  keeps each output's value in a register from the fill the JAX package's
  interpreter gives a Ref never written (NaN, the least integer, False),
  and stores all outputs at the end.
* Any other program compiles into stages (:func:`plan_stages`,
  :func:`emit_stages`), each one ``__global__`` function of the module:
  **map** (each output, or a value read through several views, over its
  own index space, reads folded into offsets), **reduce** (a block of 256
  threads a kept index walks the reduced extent, the producer fused into
  its loads, then a fixed warp-shuffle and shared-memory tree; a small
  kept extent splits the reduced one over blocks into partials that a
  second kernel folds; no atomics, so results repeat bit for bit) and
  **product** (shared-memory tiles, 128x128 or 64x64, fp32 FMA on CUDA
  cores, integers in wrapping 32-bit arithmetic, operands fused). Values
  that cross stages live in scratch; a stage whose value is an output's
  final value writes that output.

bf16 and fp16 values are held in fp32 and rounded to their type after
every operation, with PTX ``cvt.rn`` conversions (round to nearest even)
written here by hand: no ``cuda_bf16.h``, so NVRTC needs no include path.
Sums, means and products of 16-bit floats accumulate in fp32 and round
once. Integers narrower than 32 bits are held in ``int`` and wrapped to
their width after every operation. Compiled with ``--fmad=false`` and no
fast math, ``+ - * /`` and comparisons give the plain version's bits.
Integer ``//`` and ``%`` are floor operations, and division by zero gives
XLA's values.
"""
from __future__ import annotations

import hashlib
import math
import warnings
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from ...base import MXNetError
from .rtc_analyze import (CASTS, DTYPES, FLOATS, IINFO, INTS, QUEUE_ENTRY,
                          WEAK_FLOAT, WEAK_INT, Expr, Program, analyze,
                          nan_fill, promote, walk)

__all__ = ["Program", "analyze", "emit", "layout", "promote", "QUEUE_ENTRY",
           "DTYPES", "CASTS", "nan_fill",
           "vector_width", "vector_kernel_name", "vector_aligned",
           "plan_stages", "emit_stages", "Stage", "MAX_STAGES"]

INT_MIN = -2 ** 31
INT_MAX = 2 ** 31 - 1
# a program split into more stages than this raises
MAX_STAGES = 64
THREADS = 256

# -- launch layout ----------------------------------------------------------


def layout(shape: Sequence[int], operands: Sequence[Tuple[Sequence[int],
                                                           Sequence[int]]]):
    """Collapse the index space for a launch. ``operands`` are the (shape,
    strides in elements) of each Ref the body reads. Dims of size 1 drop
    out, and neighbouring dims merge wherever every operand and the
    contiguous output step through them as one. Returns (dims, strides per
    operand, kinds) where a kind is ``flat`` (offset = index), ``zero``
    (one element) or ``strided``."""
    R = len(shape)
    aligned = []
    for s, st in operands:
        pad = R - len(s)
        aligned.append([0 if d < pad or s[d - pad] == 1 else st[d - pad]
                        for d in range(R)])
    keep = [d for d in range(R) if shape[d] != 1]
    dims = [shape[d] for d in keep]
    strides = [[a[d] for d in keep] for a in aligned]
    d = len(dims) - 2
    while d >= 0:  # the output is contiguous, so only the operands decide
        if all(st[d] == st[d + 1] * dims[d + 1] for st in strides):
            dims[d:d + 2] = [dims[d] * dims[d + 1]]
            for st in strides:
                st[d:d + 2] = [st[d + 1]]
        d -= 1
    if not dims:
        dims, strides = [1], [[0] for _ in strides]
    contiguous = [math.prod(dims[d + 1:]) for d in range(len(dims))]
    kinds = ["zero" if not any(st) else "flat" if st == contiguous
             else "strided" for st in strides]
    return dims, strides, kinds


# -- CUDA C -----------------------------------------------------------------

_PRELUDE = r"""
typedef unsigned short u16;
__device__ __forceinline__ float bf16_to_f32(u16 h) {
  return __uint_as_float(((unsigned)h) << 16);
}
__device__ __forceinline__ u16 f32_to_bf16(float f) {
  u16 h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(f));
  return h;
}
__device__ __forceinline__ float f16_to_f32(u16 h) {
  float f;
  asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(h));
  return f;
}
__device__ __forceinline__ u16 f32_to_f16(float f) {
  u16 h;
  asm("cvt.rn.f16.f32 %0, %1;" : "=h"(h) : "f"(f));
  return h;
}
__device__ __forceinline__ float rnd_bf16(float x) { return bf16_to_f32(f32_to_bf16(x)); }
__device__ __forceinline__ float rnd_f16(float x) { return f16_to_f32(f32_to_f16(x)); }
// jnp.maximum / minimum: NaN wins
__device__ __forceinline__ float fmax_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float fmin_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}
// int32 arithmetic wraps, as XLA's does
__device__ __forceinline__ int add_i(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int sub_i(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int mul_i(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
// XLA's integer division: x / 0 = -1, x % 0 = x, INT_MIN / -1 = INT_MIN
__device__ __forceinline__ int div_i(int a, int b) {
  return b == 0 ? -1 : ((a == (-2147483647 - 1) && b == -1) ? a : a / b);
}
__device__ __forceinline__ int rem_i(int a, int b) {
  return b == 0 ? a : ((a == (-2147483647 - 1) && b == -1) ? 0 : a % b);
}
__device__ __forceinline__ int sgn_i(int x) { return (x > 0) - (x < 0); }
// jnp.floor_divide on integers
__device__ __forceinline__ int floordiv_i(int a, int b) {
  int q = div_i(a, b);
  return (sgn_i(a) != sgn_i(b) && rem_i(a, b) != 0) ? sub_i(q, 1) : q;
}
// jnp.remainder on integers: a divisor of 0 counts as 1
__device__ __forceinline__ int mod_i(int a, int b) {
  int d = b == 0 ? 1 : b;
  int t = rem_i(a, d);
  return ((t < 0) != (d < 0) && t != 0) ? add_i(t, d) : t;
}
__device__ __forceinline__ int max_i(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int min_i(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int abs_i(int a) { return a < 0 ? sub_i(0, a) : a; }
// narrower integers: held in int, wrapped to their width
__device__ __forceinline__ int wrap_i16(int x) { return (int)(short)x; }
__device__ __forceinline__ int wrap_i8(int x) { return (int)(signed char)x; }
__device__ __forceinline__ int wrap_u8(int x) { return (int)(unsigned char)x; }
// unsigned floor division and remainder: x / 0 is all ones, x % 0 is 0
__device__ __forceinline__ int div_u8(int a, int b) { return b == 0 ? 255 : a / b; }
__device__ __forceinline__ int mod_u8(int a, int b) { return b == 0 ? 0 : a % b; }
// shifts past the width: left 0, right the sign (arithmetic) or 0
__device__ __forceinline__ int shl_i(int a, int s, int bits) {
  return (s < 0 || s >= bits) ? 0 : (int)((unsigned)a << s);
}
__device__ __forceinline__ int sar_i(int a, int s, int bits) {
  return (s < 0 || s >= bits) ? (a < 0 ? -1 : 0) : (a >> s);
}
// the shared-memory address of a generic pointer (for ldmatrix)
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  unsigned a;
  asm("{ .reg .u64 t; cvta.to.shared.u64 t, %1; cvt.u32.u64 %0, t; }"
      : "=r"(a) : "l"(p));
  return a;
}
// float to integer: truncate, saturate, NaN -> 0
__device__ __forceinline__ int f2i_sat(float x, float lo, float hi) {
  return x != x ? 0 : (int)fminf(fmaxf(truncf(x), lo), hi);
}
"""


def _fmt_float(v: float) -> str:
    if math.isnan(v):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(v):
        return "__int_as_float(0x7f800000)" if v > 0 else "__int_as_float(0xff800000)"
    return f"((float){float(v).hex()})"


def _literal(v, dtype: str) -> str:
    """A literal converted to ``dtype`` the way torch converts a Python
    number (double -> float -> bf16/f16), exactly."""
    if dtype in INTS:
        if isinstance(v, float):
            v = int(v)
        return f"({int(v)})"
    if dtype == "bool":
        return "true" if v else "false"
    with warnings.catch_warnings():  # a literal past float32's range is inf
        warnings.simplefilter("ignore", RuntimeWarning)
        f32 = float(np.float32(v))
    if dtype == "float32":
        return _fmt_float(f32)
    return f"rnd_{'bf16' if dtype == 'bfloat16' else 'f16'}({_fmt_float(f32)})"


_C_TYPE = {"float32": "float", "bfloat16": "float", "float16": "float",
           "int32": "int", "int16": "int", "int8": "int", "uint8": "int",
           "bool": "bool"}
_ST_TYPE = {"float32": "float", "bfloat16": "u16", "float16": "u16",
            "int32": "int", "int16": "short", "int8": "signed char",
            "uint8": "unsigned char", "bool": "unsigned char"}
_RND = {"bfloat16": "rnd_bf16", "float16": "rnd_f16"}
_WRAP = {"int16": "wrap_i16", "int8": "wrap_i8", "uint8": "wrap_u8"}
_BITS = {"int32": 32, "int16": 16, "int8": 8, "uint8": 8}
_FLOAT_FN = {"exp": "expf", "log": "logf", "log1p": "log1pf",
             "expm1": "expm1f", "sqrt": "sqrtf", "tanh": "tanhf",
             "sin": "sinf", "cos": "cosf", "tan": "tanf", "arcsin": "asinf",
             "arccos": "acosf", "arctan": "atanf", "sinh": "sinhf",
             "cosh": "coshf", "exp2": "exp2f", "rsqrt": "rsqrtf",
             "erf": "erff", "abs": "fabsf", "floor": "floorf",
             "ceil": "ceilf", "trunc": "truncf", "round": "rintf"}


def _canon(t: str) -> str:
    """A weak-typed value (a jnp array of Python numbers) is held as its
    canonical type."""
    return {WEAK_INT: "int32", WEAK_FLOAT: "float32"}.get(t, t)


def _wrap(t: str, code: str) -> str:
    return f"{_WRAP[t]}({code})" if t in _WRAP else code


def _sub_index(shape, idx, full):
    """The index of an operand of ``shape`` broadcast into ``full`` at
    ``idx`` (numpy's rules: leading dims dropped, dims of 1 at 0)."""
    if idx is None:
        return None
    pad = len(full) - len(shape)
    return tuple("0" if s == 1 else idx[pad + d] for d, s in enumerate(shape))


class _Emitter:
    """Writes the C statements of a value. In the layout-collapsed kernel
    (``idx`` None) a Ref read is the value loaded at the top, ``v_<name>``;
    in a stage, ``idx`` holds a C expression per dim of the value and
    ``leaf`` writes the load of an input or a materialized value there."""

    def __init__(self, leaf=None, idx_type="int"):
        self.lines: List[str] = []
        self.n = 0
        self.memo: Dict[tuple, str] = {}
        self.leaf = leaf
        self.idx_type = idx_type

    def tmp(self, dtype: str, code: str) -> str:
        self.n += 1
        name = f"e{self.n}"
        self.lines.append(f"const {_C_TYPE[_canon(dtype)]} {name} = {code};")
        return name

    def itmp(self, code: str) -> str:
        if code.isidentifier() or code.lstrip("-").isdigit():
            return code
        self.n += 1
        name = f"q{self.n}"
        self.lines.append(f"const {self.idx_type} {name} = {code};")
        return name

    def conv(self, v: str, src: str, dst: str) -> str:
        """Convert a C value held for dtype ``src`` to dtype ``dst``."""
        src, dst = _canon(src), _canon(dst)
        if src == dst:
            return v
        if dst == "bool":
            return f"({v} != 0)"
        if dst in INTS:
            if src in FLOATS:
                if dst == "int32":  # truncates, saturates, NaN -> 0
                    return f"__float2int_rz({v})"
                lo, hi = IINFO[dst]
                return f"f2i_sat({v}, {float(lo)}f, {float(hi)}f)"
            return _wrap(dst, f"((int){v})")
        if src in FLOATS:  # float to float: held in fp32, round to dst
            return v if dst == "float32" else f"{_RND[dst]}({v})"
        return f"((float){v})" if dst == "float32" else f"{_RND[dst]}((float){v})"

    def value(self, e: Expr, dtype: str, idx=None) -> str:
        """The C code of ``e`` at ``idx`` converted to ``dtype``."""
        if e.kind == "const":
            return _literal(e.info["value"], _canon(dtype))
        return self.conv(self.eval(e, idx), e.dtype, dtype)

    def eval(self, e: Expr, idx=None) -> str:
        if e.kind == "in" and idx is None:
            return f"v_{e.info['name']}"
        key = (id(e), idx)
        if key in self.memo:
            return self.memo[key]
        if idx is not None and self.leaf is not None:
            load = self.leaf(self, e, idx)
            if load is not None:
                r = self.tmp(e.dtype, load)
                self.memo[key] = r
                return r
        r = self._eval(e, idx)
        self.memo[key] = r
        return r

    def arg(self, e: Expr, k: int, dtype: str, idx) -> str:
        """Operand ``k`` of ``e`` at ``e``'s index ``idx``, as ``dtype``."""
        a = e.args[k]
        return self.value(a, dtype, _sub_index(a.shape, idx, e.shape))

    def _eval(self, e: Expr, idx) -> str:
        t = _canon(e.dtype)
        # bf16 and fp16 results round after every operation
        rnd = (lambda c: f"{_RND[t]}({c})") if t in _RND else (lambda c: c)
        if e.kind == "const":
            return self.tmp(t, _literal(e.info["value"], t))
        if e.kind == "fill":
            fill = nan_fill(t)
            return self.tmp(t, "__int_as_float(0x7fc00000)" if t in FLOATS
                            else _literal(fill, t))
        if e.kind == "neg":
            a = self.arg(e, 0, t, idx)
            if t in INTS:
                return self.tmp(t, _wrap(t, f"sub_i(0, {a})"))
            return self.tmp(t, f"-{a}")
        if e.kind == "bin":
            return self._bin(e, idx, rnd)
        if e.kind == "ipow":
            k = e.info["k"]
            x = self.arg(e, 0, t, idx)
            mul = (lambda p, q: _wrap(t, f"mul_i({p}, {q})")) if t in INTS \
                else (lambda p, q: rnd(f"{p} * {q}"))
            if k == 0:
                return self.tmp(t, "1" if t in INTS else "1.0f")
            recip, k, acc = k < 0, abs(k), None
            while k > 0:  # lax.integer_pow's binary exponentiation
                if k & 1:
                    acc = x if acc is None else self.tmp(t, mul(acc, x))
                k >>= 1
                if k > 0:
                    x = self.tmp(t, mul(x, x))
            return self.tmp(t, rnd(f"1.0f / {acc}")) if recip else acc
        if e.kind == "ipowa":  # jnp's _pow_int_int: six bits of the exponent
            x = self.arg(e, 0, t, idx)
            y = self.arg(e, 1, t, idx)
            acc = self.tmp(t, f"({x} == 0 && {y} != 0) ? 0 : 1")
            for _ in range(6):
                acc = self.tmp(t, f"({y} & 1) ? {_wrap(t, f'mul_i({acc}, {x})')}"
                                  f" : {acc}")
                x = self.tmp(t, _wrap(t, f"mul_i({x}, {x})"))
                y = self.tmp(t, f"(int)((unsigned){y} >> 1)")
            return acc
        if e.kind == "pow":
            a, b = self.arg(e, 0, t, idx), self.arg(e, 1, t, idx)
            return self.tmp(t, rnd(f"powf({a}, {b})"))
        if e.kind == "cmp":
            ct = e.info["ctype"]
            ct = {WEAK_INT: "int32", WEAK_FLOAT: "float32"}.get(ct, ct)
            a, b = self.arg(e, 0, ct, idx), self.arg(e, 1, ct, idx)
            return self.tmp("bool", f"{a} {e.info['op']} {b}")
        if e.kind in ("max", "min"):
            a, b = self.arg(e, 0, t, idx), self.arg(e, 1, t, idx)
            f = f"{e.kind}_i" if t in INTS else f"f{e.kind}_nan"
            return self.tmp(t, f"{f}({a}, {b})")
        if e.kind == "where":
            c = self.arg(e, 0, "bool", idx)
            a, b = self.arg(e, 1, t, idx), self.arg(e, 2, t, idx)
            return self.tmp(t, f"{c} ? {a} : {b}")
        if e.kind == "cast":
            return self.tmp(t, self.arg(e, 0, t, idx))
        if e.kind == "sigmoid":  # lax.logistic: 1 / (1 + exp(-x))
            x = self.arg(e, 0, t, idx)
            ex = self.tmp(t, rnd(f"expf(-{x})"))
            den = self.tmp(t, rnd(f"1.0f + {ex}"))
            return self.tmp(t, rnd(f"1.0f / {den}"))
        if e.kind == "not":
            a = self.arg(e, 0, t, idx)
            return self.tmp(t, f"!{a}" if t == "bool" else _wrap(t, f"~{a}"))
        if e.kind == "fn":
            return self._fn(e, idx, rnd)
        if e.kind == "fn2":  # arctan2
            a, b = self.arg(e, 0, t, idx), self.arg(e, 1, t, idx)
            return self.tmp(t, rnd(f"atan2f({a}, {b})"))
        if e.kind == "view":
            return self.eval(e.args[0], self._view_index(e, idx))
        if e.kind == "reshape":
            return self.eval(e.args[0], self._reshape_index(e, idx))
        if e.kind == "store":
            return self._store(e, idx)
        raise AssertionError(e.kind)

    def _bin(self, e: Expr, idx, rnd) -> str:
        t, op = _canon(e.dtype), e.info["op"]
        a, b = self.arg(e, 0, t, idx), self.arg(e, 1, t, idx)
        if t == "bool":
            return self.tmp(t, {"&": f"({a} && {b})", "|": f"({a} || {b})",
                                "^": f"({a} != {b})"}[op])
        if t in INTS:
            if op in ("<<", ">>"):
                bits = _BITS[t]
                f = f"shl_i({a}, {b}, {bits})" if op == "<<" else \
                    f"sar_i({a}, {b}, {bits})"
                return self.tmp(t, _wrap(t, f))
            if op in ("&", "|", "^"):
                return self.tmp(t, f"({a} {op} {b})")
            if t == "uint8" and op in ("//", "%"):
                f = "div_u8" if op == "//" else "mod_u8"
                return self.tmp(t, f"{f}({a}, {b})")
            f = {"+": "add_i", "-": "sub_i", "*": "mul_i", "//": "floordiv_i",
                 "%": "mod_i"}[op]
            return self.tmp(t, _wrap(t, f"{f}({a}, {b})"))
        if op in "+-*/":
            return self.tmp(t, rnd(f"{a} {op} {b}"))
        # jnp float remainder / floor_divide (_float_divmod), each op
        # rounded to the result type
        mod = self.tmp(t, rnd(f"fmodf({a}, {b})"))
        if op == "%":
            return self.tmp(t, f"(((({mod}) < 0.0f) != (({b}) < 0.0f)) && "
                               f"({mod}) != 0.0f) ? {rnd(f'{mod} + {b}')} : {mod}")
        div = self.tmp(t, rnd(f"({rnd(f'{a} - {mod}')}) / {b}"))
        ind = self.tmp("bool", f"({mod}) != 0.0f && sign_f({b}) != sign_f({mod})")
        div = self.tmp(t, f"{ind} ? {rnd(f'{div} - 1.0f')} : {div}")
        return self.tmp(t, f"roundf({div})")

    def _fn(self, e: Expr, idx, rnd) -> str:
        fn, t = e.info["fn"], _canon(e.dtype)
        a0 = e.args[0]
        if fn in ("isnan", "isinf", "isfinite"):
            x = self.arg(e, 0, a0.dtype, idx)
            return self.tmp("bool", {"isnan": f"({x} != {x})",
                                     "isinf": f"(fabsf({x}) == __int_as_float(0x7f800000))",
                                     "isfinite": f"(fabsf({x}) < __int_as_float(0x7f800000))"}[fn])
        x = self.arg(e, 0, t, idx)
        if t in INTS:
            code = {"abs": _wrap(t, f"abs_i({x})"),
                    "square": _wrap(t, f"mul_i({x}, {x})"),
                    "sign": f"sgn_i({x})"}[fn]
            return self.tmp(t, code)
        if fn == "square":
            return self.tmp(t, rnd(f"{x} * {x}"))
        if fn == "sign":
            return self.tmp(t, f"sign_f({x})")
        return self.tmp(t, rnd(f"{_FLOAT_FN[fn]}({x})"))

    def _view_index(self, e: Expr, idx):
        src = e.args[0]
        start, dims = e.info["start"], e.info["dims"]
        terms = {d: [str(start[d])] if start[d] else [] for d in range(len(src.shape))}
        for k, (d, step) in enumerate(dims):
            if d is not None and e.shape[k] != 1:
                terms[d].append(idx[k] if step == 1 else f"{idx[k]} * {step}")
        out = []
        for d, s in enumerate(src.shape):
            code = " + ".join(terms[d]) or "0"
            out.append("0" if s == 1 else self.itmp(code))
        return tuple(out)

    def _reshape_index(self, e: Expr, idx):
        src = e.args[0]
        it = self.idx_type
        terms = []
        for k, s in enumerate(e.shape):
            if s != 1:
                stride = math.prod(e.shape[k + 1:])
                terms.append(idx[k] if stride == 1 else f"{idx[k]} * ({it}){stride}")
        flat = self.itmp(" + ".join(terms) or "0")
        out = []
        for d, s in enumerate(src.shape):
            if s == 1:
                out.append("0")
                continue
            stride = math.prod(src.shape[d + 1:])
            q = flat if stride == 1 else f"({flat} / ({it}){stride})"
            first = all(x == 1 for x in src.shape[:d])
            out.append(self.itmp(q if first else f"{q} % ({it}){s}"))
        return tuple(out)

    def _store(self, e: Expr, idx) -> str:
        old, val = e.args
        conds, vidx = [], []
        for d, (start, step, size, kept) in enumerate(e.info["region"]):
            c = idx[d]
            if not kept:
                conds.append(f"{c} == {start}")
                continue
            if start == 0 and step == 1 and size == e.shape[d]:
                vidx.append(c)
                continue
            hi = start + step * (size - 1)
            cond = f"{c} >= {start} && {c} <= {hi}"
            if step != 1:
                cond += f" && ({c} - {start}) % {step} == 0"
            conds.append(cond)
            off = f"({c} - {start})" if start else c
            vidx.append(off if step == 1 else f"{off} / {step}")
        inside = self.tmp("bool", " && ".join(f"({c})" for c in conds) or "true")
        # out of the region the value's index is clamped to 0, so that its
        # loads stay in bounds
        vidx = tuple("0" if s == 1 else self.itmp(f"{inside} ? ({v}) : 0")
                     for v, s in zip(vidx, val.shape))
        v = self.value(val, e.dtype, vidx)
        o = self.value(old, e.dtype, idx)
        return self.tmp(e.dtype, f"{inside} ? {v} : {o}")


def _load(dtype: str, ptr: str, off: str) -> str:
    if dtype in ("float32", "int32"):
        return f"{ptr}[{off}]"
    if dtype == "bfloat16":
        return f"bf16_to_f32({ptr}[{off}])"
    if dtype == "float16":
        return f"f16_to_f32({ptr}[{off}])"
    if dtype == "bool":
        return f"({ptr}[{off}] != 0)"
    return f"(int){ptr}[{off}]"


def _store(dtype: str, v: str) -> str:
    if dtype in ("float32", "int32"):
        return v
    if dtype == "bfloat16":
        return f"f32_to_bf16({v})"
    if dtype == "float16":
        return f"f32_to_f16({v})"
    if dtype == "bool":
        return f"(unsigned char)({v} ? 1 : 0)"
    return f"({_ST_TYPE[dtype]})({v})"


_SIZE = {"float32": 4, "int32": 4, "bfloat16": 2, "float16": 2}
_WORDS = {16: "uint4", 8: "uint2"}


def vector_width(prog: Program, kinds: Sequence[str]):
    """Elements a thread of the vector kernel loads per operand per vector:
    16 bytes of the widest type among the ``flat`` reads and the outputs
    (4 fp32/int32, 8 bf16/fp16). None when a read is ``strided``, where
    only the scalar kernel exists."""
    if any(k == "strided" for k in kinds):
        return None
    dtypes = {n: dt for n, _, dt in prog.inputs}
    sizes = [_SIZE[dtypes[n]] for n, k in zip(prog.reads, kinds) if k == "flat"]
    sizes += [_SIZE[dt] for _, _, dt in prog.outputs]
    return 16 // max(sizes)


def vector_kernel_name(kname: str) -> str:
    """The vector kernel's name in the module of scalar kernel ``kname``."""
    return "rtcv_" + kname[len("rtc_"):]


def vector_aligned(addresses: Sequence[int], access_bytes: Sequence[int]):
    """Whether every operand the vector kernel accesses in vectors (the
    ``flat`` reads and the outputs) starts on its vector's width: an
    address and the bytes of one vector of it, in pairs. A view that starts
    one element into a tensor fails, and takes the scalar kernel."""
    return all(a % b == 0 for a, b in zip(addresses, access_bytes))


def _lane(dtype: str, word: str, j: int, vec: int) -> str:
    """Element ``j`` of a vector of ``vec`` elements of ``dtype`` loaded
    as the words of ``word`` (a uint4 or uint2)."""
    size = _SIZE[dtype]
    comp = "xyzw"[j * size // 4]
    if dtype == "float32":
        return f"__uint_as_float({word}.{comp})"
    if dtype == "int32":
        return f"(int){word}.{comp}"
    half = f"(u16)({word}.{comp} >> {16 * (j % 2)})"
    return (f"bf16_to_f32({half})" if dtype == "bfloat16"
            else f"f16_to_f32({half})")


def _pack(dtype: str, vals: Sequence[str], nbytes: int) -> str:
    """The words of a vector of ``vals`` (each already in the stored
    type's C value) to store as a uint4 or uint2."""
    if dtype in ("float32", "int32"):
        words = [f"(unsigned)({v})" if dtype == "int32"
                 else f"__float_as_uint({v})" for v in vals]
    else:
        conv = "f32_to_bf16" if dtype == "bfloat16" else "f32_to_f16"
        words = [f"((unsigned){conv}({vals[2 * k]}) | "
                 f"((unsigned){conv}({vals[2 * k + 1]}) << 16))"
                 for k in range(len(vals) // 2)]
    return f"make_{_WORDS[nbytes]}({', '.join(words)})"


_HEAD = ("  const long long nthreads = (long long)gridDim.x * gridDim.y * "
         "gridDim.z * blockDim.x * blockDim.y * blockDim.z;\n"
         "  const long long tid = ((long long)(blockIdx.z * gridDim.y + "
         "blockIdx.y) * gridDim.x + blockIdx.x) * (blockDim.x * blockDim.y * "
         "blockDim.z) + (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x "
         "+ threadIdx.x;\n")


def emit(prog: Program, rank: int, kinds: Sequence[str],
         wide_index: bool) -> Tuple[str, str]:
    """The CUDA C source of a ``simple`` program's kernel for an index space
    of ``rank`` collapsed dims, each read Ref accessed as its ``kinds``
    entry says (see :func:`layout`), with 64-bit offsets if
    ``wide_index``. Returns (source, kernel name). The source is the
    compile cache's key: it holds the body, the dtypes, the rank and the
    access kinds, while sizes and strides are launch arguments.

    Where every read is ``flat`` or ``zero`` (:func:`vector_width`), the
    module holds a second kernel, :func:`vector_kernel_name`, before the
    scalar one: each thread takes a vector of VEC consecutive elements per
    iteration, with one 16-byte load (8 for a narrower type) of each
    ``flat`` read and one store of each output, ``zero`` reads loaded
    once; the body's text is repeated for each element, so the
    arithmetic is the scalar kernel's; and the scalar loop, started past
    the last whole vector, handles the ``n % VEC`` elements left. The
    caller launches it only when :func:`vector_aligned` holds for the
    push's pointers."""
    em = _Emitter()
    for _, name, value in prog.stmts:
        odt = dict((n, dt) for n, _, dt in prog.outputs)[name]
        v = em.value(value, odt)
        em.lines.append(f"o_{name} = {v};")
    idx = "long long" if wide_index else "int"
    nread = len(prog.reads)
    dtypes = {n: dt for n, _, dt in prog.inputs}
    params = [f"const {_ST_TYPE[dtypes[n]]}* __restrict__ in_{n}"
              for n, _, _ in prog.inputs]
    params += [f"{_ST_TYPE[dt]}* __restrict__ out_{n}" for n, _, dt in prog.outputs]
    fills = []
    for n, _, dt in prog.outputs:
        fill = ("__int_as_float(0x7fc00000)" if dt in FLOATS
                else "(-2147483647 - 1)")
        fills.append(f"{_C_TYPE[dt]} o_{n} = {fill};")
    body: List[str] = []
    if "strided" in kinds:
        body.append(f"{idx} rem = ({idx})i;")
        for d in reversed(range(rank)):
            if d:
                body.append(f"const {idx} c{d} = rem % ({idx})p.dim[{d}]; "
                            f"rem /= ({idx})p.dim[{d}];")
            else:
                body.append(f"const {idx} c0 = rem;")
    for k, n in enumerate(prog.reads):
        if kinds[k] == "flat":
            off = f"({idx})i"
        elif kinds[k] == "zero":
            off = "0"
        else:
            off = " + ".join(f"c{d} * ({idx})p.st[{k}][{d}]" for d in range(rank))
        body.append(f"const {_C_TYPE[dtypes[n]]} v_{n} = "
                    f"{_load(dtypes[n], f'in_{n}', off)};")
    body += fills
    body += em.lines
    for n, _, dt in prog.outputs:
        body.append(f"out_{n}[({idx})i] = {_store(dt, f'o_{n}')};")
    signature = (f"body: {prog.text!r}; inputs "
                 f"{[(n, dt) for n, _, dt in prog.inputs]}; outputs "
                 f"{[(n, dt) for n, _, dt in prog.outputs]}; rank {rank}; "
                 f"reads {list(zip(prog.reads, kinds))}; index {idx}")
    kname = "rtc_" + hashlib.sha256(signature.encode()).hexdigest()[:16]
    st = f"  long long st[{nread}][{rank}];\n" if nread else ""
    head = (f"(const RtcArgs p, " + ", ".join(params) + ") {\n" + _HEAD)

    def scalar_loop(start):
        return (f"  for (long long i = {start}; i < p.n; i += nthreads) {{\n"
                + "".join(f"    {line}\n" for line in body) + "  }\n")

    vec = vector_width(prog, kinds)
    vector = "" if vec is None else (
        f'extern "C" __global__ void {vector_kernel_name(kname)}' + head
        + _vector_loop(prog, kinds, vec, idx, fills, em.lines)
        + scalar_loop(f"nvec * {vec} + tid") + "}\n")
    src = (f"// Rtc kernel generated by mxnet_tpu_torch.ops.cuda.rtc_codegen\n"
           f"// {signature}\n" + _PRELUDE +
           f"struct RtcArgs {{\n  long long n;\n  long long dim[{rank}];\n{st}}};\n"
           + vector +
           f'extern "C" __global__ void {kname}' + head
           + scalar_loop("tid") + "}\n")
    return src, kname


def _vector_loop(prog: Program, kinds: Sequence[str], vec: int, idx: str,
                 fills: List[str], lines: List[str]) -> str:
    """The vector kernel's main loop (see :func:`emit`): vector ``v`` of
    every ``flat`` read loaded, then the body once per element in a block
    of its own, then vector ``v`` of every output stored."""
    dtypes = {n: dt for n, _, dt in prog.inputs}
    flat = [n for n, k in zip(prog.reads, kinds) if k == "flat"]
    out: List[str] = []
    for n, k in zip(prog.reads, kinds):
        if k == "zero":  # one element, loaded once
            out.append(f"const {_C_TYPE[dtypes[n]]} v_{n} = "
                       f"{_load(dtypes[n], f'in_{n}', '0')};")
    out.append(f"const long long nvec = p.n / {vec};")
    out.append("for (long long v = tid; v < nvec; v += nthreads) {")
    for n in flat:
        w = _WORDS[vec * _SIZE[dtypes[n]]]
        out.append(f"  const {w} w_{n} = "
                   f"reinterpret_cast<const {w}*>(in_{n})[({idx})v];")
    for n, _, dt in prog.outputs:
        out.append(f"  {_C_TYPE[dt]} r_{n}[{vec}];")
    for lane in range(vec):
        out.append("  {")
        for n in flat:
            out.append(f"    const {_C_TYPE[dtypes[n]]} v_{n} = "
                       f"{_lane(dtypes[n], f'w_{n}', lane, vec)};")
        out += [f"    {line}" for line in fills + lines]
        out += [f"    r_{n}[{lane}] = o_{n};" for n, _, _ in prog.outputs]
        out.append("  }")
    for n, _, dt in prog.outputs:
        nbytes = vec * _SIZE[dt]
        vals = [f"r_{n}[{lane}]" for lane in range(vec)]
        out.append(f"  reinterpret_cast<{_WORDS[nbytes]}*>(out_{n})[({idx})v] = "
                   f"{_pack(dt, vals, nbytes)};")
    out.append("}")
    return "".join(f"  {line}\n" for line in out)


# -- stages ---------------------------------------------------------------------


class Stage(NamedTuple):
    """One kernel of a staged module. ``kind`` is map, reduce or product;
    ``nodes`` the values it writes (a map stage's outputs share a shape);
    ``buffers`` the buffer index of each."""

    kind: str
    nodes: Tuple[Expr, ...]
    buffers: Tuple[int, ...]


class StagePlan(NamedTuple):
    """The stages of a program, in launch order, and the buffers they
    write: ``buffers[j]`` is ("out", output index) or ("scratch", shape,
    dtype)."""

    stages: Tuple[Stage, ...]
    buffers: Tuple[tuple, ...]
    materialized: Dict[int, int]  # id(node) -> buffer


def _same_layout(e: Expr):
    """The node under ``e`` whose row-major elements are ``e``'s: through
    reshapes and views that only add or drop dims of 1."""
    while True:
        if e.kind == "reshape":
            e = e.args[0]
        elif e.kind == "view" and not any(e.info["start"]) and [
                d for d, _ in e.info["dims"] if d is not None] == [
                d for d, s in enumerate(e.args[0].shape) if s != 1] and all(
                step == 1 for d, step in e.info["dims"] if d is not None):
            e = e.args[0]
        else:
            return e


def _users(order):
    users: Dict[int, List[Expr]] = {}
    for e in order:
        for a in e.args:
            users.setdefault(id(a), []).append(e)
    return users


_REINDEX = ("view", "reshape", "store")


def plan_stages(prog: Program) -> StagePlan:
    """Split ``prog`` into stages. Reductions and products are stages of
    their own; an elementwise value read through a view by one user and by
    at least one more user, with 4 or more operations under it, is
    materialized by a map stage of its own (so a value is not computed again
    at every index each view reads it at); every output the stages do not
    write is written by a map stage over its own index space, one stage for
    the outputs of one shape."""
    finals = [prog.finals[n] for n, _, _ in prog.outputs]
    order = walk(finals)
    users = _users(order)
    mat: Dict[int, Expr] = {}
    cost: Dict[int, int] = {}
    for e in order:
        if e.kind in ("reduce", "dot"):
            mat[id(e)] = e
            cost[id(e)] = 0
            continue
        c = 0 if e.kind in ("in", "const", "fill") else 1
        c += sum(cost[id(a)] for a in e.args)
        cost[id(e)] = c
        us = users.get(id(e), [])
        if c >= 4 and len(us) >= 2 and any(u.kind in _REINDEX for u in us):
            mat[id(e)] = e
            cost[id(e)] = 0
    buffers: List[tuple] = []
    stages: List[Stage] = []
    where: Dict[int, int] = {}
    direct: Dict[int, int] = {}  # id(materialized node) -> output index
    for k, (n, s, dt) in enumerate(prog.outputs):
        under = _same_layout(prog.finals[n])
        if id(under) in mat and under.dtype == dt and id(under) not in direct:
            direct[id(under)] = k
    for e in order:
        if id(e) not in mat:
            continue
        if id(e) in direct:
            buffers.append(("out", direct[id(e)]))
        else:
            buffers.append(("scratch", e.shape, e.dtype))
        where[id(e)] = len(buffers) - 1
        kind = {"reduce": "reduce", "dot": "product"}.get(e.kind, "map")
        stages.append(Stage(kind, (e,), (where[id(e)],)))
    written = {k for k in direct.values()}
    groups: Dict[tuple, List[int]] = {}
    for k, (n, s, dt) in enumerate(prog.outputs):
        if k not in written:
            groups.setdefault(tuple(s), []).append(k)
    out_buf: Dict[int, int] = {}
    for shape, ks in groups.items():
        for k in ks:
            buffers.append(("out", k))
            out_buf[k] = len(buffers) - 1
        stages.append(Stage("map", tuple(prog.finals[prog.outputs[k][0]]
                                         for k in ks),
                            tuple(out_buf[k] for k in ks)))
    if len(stages) > MAX_STAGES:
        raise MXNetError(f"Rtc {prog.name!r}: the body needs {len(stages)} "
                         f"stages, past {MAX_STAGES} (queued at "
                         f"{QUEUE_ENTRY})")
    return StagePlan(tuple(stages), tuple(buffers), where)


def buffer_spec(prog: Program, buf: tuple):
    """(shape, dtype) of a buffer of a stage plan."""
    if buf[0] == "out":
        _, s, dt = prog.outputs[buf[1]]
        return tuple(s), dt
    return tuple(buf[1]), buf[2]


def _row_strides(shape):
    return [math.prod(shape[d + 1:]) for d in range(len(shape))]


def _decompose(var: str, shape, names, it: str) -> List[str]:
    """C lines that split flat index ``var`` (row-major over ``shape``) into
    ``names``."""
    lines = [f"{it} rem_{names[0]} = ({it}){var};"] if shape else []
    for d in reversed(range(len(shape))):
        if d:
            lines.append(f"const {it} {names[d]} = rem_{names[0]} % ({it}){shape[d]}; "
                         f"rem_{names[0]} /= ({it}){shape[d]};")
        else:
            lines.append(f"const {it} {names[0]} = rem_{names[0]};")
    return lines


class _Module:
    """The leaves of a staged module: inputs by name, materialized values
    by buffer, and the index type."""

    def __init__(self, prog: Program, plan: StagePlan, wide: bool):
        self.prog, self.plan = prog, plan
        self.it = "long long" if wide else "int"
        self.inputs = {n: (k, s, dt) for k, (n, s, dt) in enumerate(prog.inputs)}

    def address(self, e: Expr, idx):
        """(pointer, offset) of leaf ``e``'s element at ``idx``: an input
        (strides are launch arguments) or a materialized value (row-major),
        or None for any other value."""
        if e.kind == "in":
            k, s, _ = self.inputs[e.info["name"]]
            terms = [f"{c} * ({self.it})p.st[{k}][{d}]"
                     for d, c in enumerate(idx) if s[d] != 1 and c != "0"]
            return f"in_{e.info['name']}", " + ".join(terms) or "0"
        j = self.plan.materialized.get(id(e))
        if j is None:
            return None
        strides = _row_strides(e.shape)
        terms = [c if st == 1 else f"{c} * ({self.it}){st}"
                 for c, st, s in zip(idx, strides, e.shape) if s != 1 and c != "0"]
        return f"buf{j}", " + ".join(terms) or "0"

    def unit_stride(self, e: Expr) -> str:
        """C condition that leaf ``e``'s last dim has stride 1."""
        if e.kind == "in":
            k, s, _ = self.inputs[e.info["name"]]
            return f"p.st[{k}][{len(s) - 1}] == 1" if s else "true"
        return "true"

    def leaf(self, em: _Emitter, e: Expr, idx):
        at = self.address(e, idx)
        return None if at is None else _load(e.dtype, *at)

    def emitter(self, skip=None):
        """An emitter whose leaves are this module's, but ``skip`` (the
        value a stage computes) evaluated in place."""
        def leaf(em, e, idx):
            if skip is not None and e is skip:
                return None
            return self.leaf(em, e, idx)
        return _Emitter(leaf, self.it)


def emit_stages(prog: Program, plan: StagePlan, wide: bool, sms: int):
    """The CUDA C source of a staged module, the launch of each stage and
    the partial-sum slots its reductions need: (source, [(kernel name,
    grid, block, kind)], slots), where grid is None for a map stage (the
    caller's launch shape or the default). Reduce stages that split their
    reduced extent add a second kernel, the fold."""
    mod = _Module(prog, plan, wide)
    it = mod.it
    params = [f"const {_ST_TYPE[dt]}* __restrict__ in_{n}"
              for n, _, dt in prog.inputs]
    for j, buf in enumerate(plan.buffers):
        _, dt = buffer_spec(prog, buf)
        params.append(f"{_ST_TYPE[dt]}* __restrict__ buf{j}")
    params.append("float* __restrict__ part_f")
    params.append("int* __restrict__ part_i")
    sig = ", ".join(params)
    maxr = max([len(s) for _, s, _ in prog.inputs] + [1])
    nin = max(len(prog.inputs), 1)
    kernels, launches = [], []
    body_key = (f"body: {prog.text!r}; inputs "
                f"{[(n, s, dt) for n, s, dt in prog.inputs]}; outputs "
                f"{[(n, s, dt) for n, s, dt in prog.outputs]}; index {it}; "
                f"sms {sms}")
    base = "rtc_" + hashlib.sha256(body_key.encode()).hexdigest()[:16]
    part_need = 0
    for j, st in enumerate(plan.stages):
        kname = f"{base}_s{j}"
        if st.kind == "map":
            kernels.append(_emit_map(mod, st, kname, sig))
            launches.append((kname, None, None, "map"))
        elif st.kind == "reduce":
            src, ls, need = _emit_reduce(mod, st, kname, sig, sms)
            part_need = max(part_need, need)
            kernels.append(src)
            launches += ls
        else:
            src, grid, block = _emit_product(mod, st, kname, sig, sms)
            kernels.append(src)
            launches.append((kname, grid, block, "product"))
    source = (f"// Rtc module generated by mxnet_tpu_torch.ops.cuda.rtc_codegen\n"
              f"// {body_key}\n" + _PRELUDE +
              f"struct RtcArgs {{\n  long long st[{nin}][{maxr}];\n}};\n"
              + "".join(kernels))
    return source, launches, part_need


def _emit_map(mod: _Module, st: Stage, kname: str, sig: str) -> str:
    it = mod.it
    shape = st.nodes[0].shape
    n = math.prod(shape)
    names = tuple(f"c{d}" for d in range(len(shape)))
    em = mod.emitter(skip=st.nodes[0] if len(st.nodes) == 1 and id(
        st.nodes[0]) in mod.plan.materialized else None)
    stores = []
    for e, j in zip(st.nodes, st.buffers):
        _, dt = buffer_spec(mod.prog, mod.plan.buffers[j])
        v = em.value(e, dt, tuple("0" if s == 1 else c
                                  for c, s in zip(names, shape)))
        stores.append(f"buf{j}[({it})i] = {_store(dt, v)};")
    lines = _decompose("i", shape, names, it) + em.lines + stores
    return (f'extern "C" __global__ void {kname}(const RtcArgs p, {sig}) {{\n'
            + _HEAD
            + f"  for (long long i = tid; i < {n}LL; i += nthreads) {{\n"
            + "".join(f"    {line}\n" for line in lines) + "  }\n}\n")


_ACC_C = {"float32": "float", "bfloat16": "float", "float16": "float",
          "int32": "int", "int16": "int", "int8": "int", "uint8": "int",
          "bool": "int"}


def _reduce_ops(op: str, acc: str):
    """(init, combine(a, ai, b, bi) -> lines, index used) of a reduction."""
    flt = acc in FLOATS
    if op in ("sum", "mean"):
        init = "0.0f" if flt else "0"
        comb = (lambda a, ai, b, bi: [f"{a} = {a} + {b};"]) if flt else \
            (lambda a, ai, b, bi: [f"{a} = add_i({a}, {b});"])
        return init, comb, False
    if op == "prod":
        init = "1.0f" if flt else "1"
        comb = (lambda a, ai, b, bi: [f"{a} = {a} * {b};"]) if flt else \
            (lambda a, ai, b, bi: [f"{a} = mul_i({a}, {b});"])
        return init, comb, False
    if op in ("max", "min"):
        lo, hi = IINFO.get(acc, (0, 1))
        if flt:
            init = "__int_as_float(0xff800000)" if op == "max" else \
                "__int_as_float(0x7f800000)"
            f = f"f{op}_nan"
        else:
            init = str(lo if op == "max" else hi)
            f = f"{op}_i"
        return init, (lambda a, ai, b, bi: [f"{a} = {f}({a}, {b});"]), False
    if op in ("any", "all"):
        init = "0" if op == "any" else "1"
        c = "||" if op == "any" else "&&"
        return init, (lambda a, ai, b, bi: [f"{a} = ({a} {c} {b}) ? 1 : 0;"]), False
    # argmax / argmin: NaN wins, then the first index
    gt = ">" if op == "argmax" else "<"
    if flt:
        init = "__int_as_float(0xff800000)" if op == "argmax" else \
            "__int_as_float(0x7f800000)"

        def comb(a, ai, b, bi):
            return [f"if (({b} != {b}) ? (!({a} != {a}) || {bi} < {ai}) : "
                    f"(!({a} != {a}) && ({b} {gt} {a} || ({b} == {a} && "
                    f"{bi} < {ai})))) {{ {a} = {b}; {ai} = {bi}; }}"]
    else:
        lo, hi = IINFO.get(acc, (0, 1))
        init = str(lo if op == "argmax" else hi)

        def comb(a, ai, b, bi):
            return [f"if ({b} {gt} {a} || ({b} == {a} && {bi} < {ai})) "
                    f"{{ {a} = {b}; {ai} = {bi}; }}"]
    return init, comb, True


def _emit_reduce(mod: _Module, st: Stage, kname: str, sig: str, sms: int):
    """A reduction: one block a kept index (row mode) or, where the innermost
    dim is kept and there are many kept indices, one thread a kept index
    walking the reduced extent in order (column mode). A small kept extent
    in row mode splits the reduced one into ``parts`` chunks whose partials a
    second kernel folds in order."""
    e = st.nodes[0]
    it = mod.it
    src = e.args[0]
    op, axes, acc = e.info["op"], e.info["axes"], e.info["acc"]
    kept = [d for d in range(len(src.shape)) if d not in axes]
    kshape = [src.shape[d] for d in kept]
    rshape = [src.shape[d] for d in axes]
    K, R = math.prod(kshape), math.prod(rshape)
    j = st.buffers[0]
    _, odt = buffer_spec(mod.prog, mod.plan.buffers[j])
    ctype = _ACC_C[acc]
    init, comb, indexed = _reduce_ops(op, acc)
    kn = tuple(f"k{d}" for d in range(len(kept)))
    rn = tuple(f"r{d}" for d in range(len(axes)))
    full = [None] * len(src.shape)
    for d, c in zip(kept, kn):
        full[d] = c
    for d, c in zip(axes, rn):
        full[d] = c
    full = tuple("0" if s == 1 else c for c, s in zip(full, src.shape))
    em = mod.emitter()
    v = em.value(src, acc, full)
    if acc == "bool":
        v = f"({v} ? 1 : 0)"

    def finalize(a, ai):
        if indexed:
            return ai
        if op == "mean":
            return _Emitter().conv(f"({a} / (float){R})", "float32", odt)
        if acc == "bool":
            return f"({a} != 0)"
        return _Emitter().conv(a, acc, odt)

    element = (["{"] + _decompose("r", rshape, rn, it) + em.lines
               + [f"const {ctype} val = {v};"] + comb("acc", "ai", "val", "(int)r")
               + ["}"])
    column = len(src.shape) - 1 not in axes and K >= 2048
    if column:
        lines = ([f"for (long long kk = tid; kk < {K}LL; kk += nthreads) {{"]
                 + [f"  {x}" for x in _decompose("kk", kshape, kn, it)]
                 + [f"  {ctype} acc = {init}; int ai = 2147483647;",
                    f"  for (long long r = 0; r < {R}LL; ++r) {{"]
                 + [f"    {x}" for x in element]
                 + ["  }", f"  buf{j}[kk] = {_store(odt, finalize('acc', 'ai'))};",
                    "}"])
        src_text = (f'extern "C" __global__ void {kname}(const RtcArgs p, {sig}) {{\n'
                    + _HEAD + "".join(f"  {x}\n" for x in lines) + "}\n")
        grid = (max(1, min(-(-K // THREADS), sms * 8)), 1, 1)
        return src_text, [(kname, grid, (THREADS, 1, 1), "reduce")], 0
    # row mode: parts per kept index so that the grid fills the card
    parts = 1
    if K < 2 * sms and R >= 8 * THREADS:
        parts = max(1, min(-(-R // (8 * THREADS)), -(-4 * sms // K), 1024))
    chunk = -(-R // parts)
    tree = _block_tree(ctype, comb, init)
    lines = ([f"for (long long kk = blockIdx.x; kk < {K}LL; kk += gridDim.x) {{"]
             + [f"  {x}" for x in _decompose("kk", kshape, kn, it)]
             + [f"  {ctype} acc = {init}; int ai = 2147483647;",
                f"  const long long lo = (long long)blockIdx.y * {chunk}LL;",
                f"  const long long hi = lo + {chunk}LL < {R}LL ? lo + {chunk}LL : {R}LL;",
                "  for (long long r = lo + threadIdx.x; r < hi; r += blockDim.x) {"]
             + [f"    {x}" for x in element] + ["  }"]
             + [f"  {x}" for x in tree]
             + ["  if (threadIdx.x == 0) {"])
    if parts == 1:
        lines.append(f"    buf{j}[kk] = {_store(odt, finalize('acc', 'ai'))};")
    else:
        slot = f"kk * {parts}LL + blockIdx.y"
        lines.append(f"    part_f[{slot}] = acc;" if ctype == "float"
                     else f"    ((int*)part_f)[{slot}] = acc;")
        lines.append(f"    part_i[{slot}] = ai;")
    lines += ["  }", "  __syncthreads();", "}"]
    out = [f'extern "C" __global__ void {kname}(const RtcArgs p, {sig}) {{\n'
           + "  __shared__ " + ctype + " s_v[32];\n  __shared__ int s_i[32];\n"
           + "".join(f"  {x}\n" for x in lines) + "}\n"]
    grid = (min(K, 2 ** 31 - 1), parts, 1)
    launches = [(kname, grid, (THREADS, 1, 1), "reduce")]
    if parts > 1:
        load = "part_f[kk * {P}LL + t]" if ctype == "float" else \
            "((int*)part_f)[kk * {P}LL + t]"
        fold = ([f"for (long long kk = blockIdx.x; kk < {K}LL; kk += gridDim.x) {{",
                 f"  {ctype} acc = {init}; int ai = 2147483647;",
                 f"  for (int t = threadIdx.x; t < {parts}; t += blockDim.x) {{",
                 f"    const {ctype} val = {load.format(P=parts)};",
                 f"    const int vi = part_i[kk * {parts}LL + t];"]
                + [f"    {x}" for x in comb("acc", "ai", "val", "vi")]
                + ["  }"] + [f"  {x}" for x in tree]
                + ["  if (threadIdx.x == 0) "
                   f"buf{j}[kk] = {_store(odt, finalize('acc', 'ai'))};",
                   "  __syncthreads();", "}"])
        out.append(f'extern "C" __global__ void {kname}f(const RtcArgs p, {sig}) {{\n'
                   + "  __shared__ " + ctype + " s_v[32];\n  __shared__ int s_i[32];\n"
                   + "".join(f"  {x}\n" for x in fold) + "}\n")
        launches.append((kname + "f", (min(K, 2 ** 31 - 1), 1, 1),
                         (THREADS, 1, 1), "reduce"))
    return "".join(out), launches, K * parts if parts > 1 else 0


def _block_tree(ctype: str, comb, init: str) -> List[str]:
    """A block's fixed reduction of (acc, ai): warp shuffles, then the
    warps' results through shared memory, then the first warp's shuffles;
    thread 0 ends with the result."""
    def warp():
        lines = ["for (int o = 16; o > 0; o >>= 1) {",
                 f"  const {ctype} ov = __shfl_down_sync(0xffffffffu, acc, o);",
                 "  const int oi = __shfl_down_sync(0xffffffffu, ai, o);"]
        lines += ["  " + x for x in comb("acc", "ai", "ov", "oi")]
        return lines + ["}"]
    return (warp()
            + ["const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;",
               "if (lane == 0) { s_v[wid] = acc; s_i[wid] = ai; }",
               "__syncthreads();",
               "if (wid == 0) {",
               "  const int nw = (blockDim.x + 31) >> 5;",
               f"  acc = lane < nw ? s_v[lane] : ({ctype})({init});",
               "  ai = lane < nw ? s_i[lane] : 2147483647;"]
            + ["  " + x for x in warp()] + ["}"])


def _innermost(e: Expr, d: int) -> bool:
    """Whether dim ``d`` of ``e`` steps through the innermost (contiguous)
    dim of the leaf under it, following views and unary elementwise
    operands; a leaf is row-major."""
    while True:
        if e.kind == "view":
            src, step = e.info["dims"][d]
            if src is None:
                return False
            e, d = e.args[0], src
        elif e.kind in ("cast", "neg", "fn", "sigmoid"):
            e = e.args[0]
        else:
            return d == len(e.shape) - 1


def _emit_product(mod: _Module, st: Stage, kname: str, sig: str, sms: int):
    """A tiled product: a block computes a BM x BN tile of (B, M, N) from
    BK-deep tiles of A (B, M, K) and B (B, K, N) in shared memory, each of
    its 256 threads a TM x TN sub-tile (rows ty + 16 i, columns tx + 16 j,
    so that a warp's shared-memory reads and global stores are contiguous).
    Operands are evaluated where they are loaded, so casts, transposes and
    elementwise producers fuse; a tile element past an edge is 0."""
    e = st.nodes[0]
    it = mod.it
    a3, b3 = e.args
    Bn, M, K = a3.shape
    N = b3.shape[2]
    acc = e.info["acc"]
    j = st.buffers[0]
    _, odt = buffer_spec(mod.prog, mod.plan.buffers[j])
    sixteen = _sixteen_bit(a3)
    if sixteen is not None and sixteen == _sixteen_bit(b3):
        return _emit_product_mma(mod, st, kname, sig, sixteen)
    big = M >= 128 and N >= 128 and -(-M // 128) * -(-N // 128) * Bn >= sms
    BM = BN = 128 if big else 64
    TM = TN = BM // 16
    BK = 8 if big else 16
    ctype = "float" if acc == "float32" else "unsigned"
    # each operand's tile is loaded with consecutive threads along its
    # contiguous dim: k for a row-major A, n (or k, transposed) for B
    a_kfast = not _innermost(a3, 1)
    b_nfast = not _innermost(b3, 1)

    def load(name, expr, rows, cols, r_is_k, fast_col, dst):
        # tile of rows x cols; element u of thread t
        em = mod.emitter()
        if name == "A":
            idx = ("gb", "gr", "gc")  # (b, m, k)
        else:
            idx = ("gb", "gr", "gc")  # (b, k, n)
        idx = tuple("0" if s == 1 else c for c, s in zip(idx, expr.shape))
        v = em.value(expr, "float32" if ctype == "float" else "int32", idx)
        per = rows * cols // THREADS
        lines = [f"#pragma unroll",
                 f"for (int u = 0; u < {per}; ++u) {{",
                 f"  const int el = threadIdx.x + u * {THREADS};"]
        if fast_col:
            lines += [f"  const int tr = el / {cols}, tc = el % {cols};"]
        else:
            lines += [f"  const int tc = el / {rows}, tr = el % {rows};"]
        r0, c0 = ("m0", "k0") if name == "A" else ("k0", "n0")
        lim_r, lim_c = (M, K) if name == "A" else (K, N)
        lines += [f"  const {it} gr = ({it}){r0} + tr, gc = ({it}){c0} + tc;",
                  f"  {ctype} val = 0;",
                  f"  if (gr < {lim_r} && gc < {lim_c}) {{"]
        lines += [f"    {x}" for x in em.lines]
        lines += [f"    val = ({ctype})({v});", "  }"]
        if name == "A":
            lines.append(f"  {dst}[tc][tr] = val;")   # As[k][m]
        else:
            lines.append(f"  {dst}[tr][tc] = val;")   # Bs[k][n]
        lines.append("}")
        return lines

    la = load("A", a3, BM, BK, False, a_kfast, "As")
    lb = load("B", b3, BK, BN, True, b_nfast, "Bs")
    fma = "fmaf(a[i], b[jj], c[i][jj])" if ctype == "float" else \
        "c[i][jj] + a[i] * b[jj]"
    body = [
        f"__shared__ {ctype} As[{BK}][{BM} + 1];",
        f"__shared__ {ctype} Bs[{BK}][{BN} + 1];",
        "const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;",
        f"const {it} gb = blockIdx.z;",
        f"const {it} m0 = ({it})blockIdx.y * {BM}, n0 = ({it})blockIdx.x * {BN};",
        f"{ctype} c[{TM}][{TN}];",
        "#pragma unroll", f"for (int i = 0; i < {TM}; ++i)",
        "#pragma unroll", f"  for (int jj = 0; jj < {TN}; ++jj) c[i][jj] = 0;",
        f"for ({it} k0 = 0; k0 < {K}; k0 += {BK}) {{"]
    body += [f"  {x}" for x in la + lb]
    body += ["  __syncthreads();",
             "  #pragma unroll",
             f"  for (int kk = 0; kk < {BK}; ++kk) {{",
             f"    {ctype} a[{TM}], b[{TN}];",
             "    #pragma unroll",
             f"    for (int i = 0; i < {TM}; ++i) a[i] = As[kk][ty + 16 * i];",
             "    #pragma unroll",
             f"    for (int jj = 0; jj < {TN}; ++jj) b[jj] = Bs[kk][tx + 16 * jj];",
             "    #pragma unroll",
             f"    for (int i = 0; i < {TM}; ++i)",
             "      #pragma unroll",
             f"      for (int jj = 0; jj < {TN}; ++jj) c[i][jj] = {fma};",
             "  }",
             "  __syncthreads();",
             "}"]
    if ctype == "float":
        outv = _Emitter().conv("c[i][jj]", "float32", odt)
    else:
        outv = _Emitter().conv("(int)c[i][jj]", "int32", odt)
    body += ["#pragma unroll",
             f"for (int i = 0; i < {TM}; ++i) {{",
             f"  const {it} m = m0 + ty + 16 * i;",
             "  #pragma unroll",
             f"  for (int jj = 0; jj < {TN}; ++jj) {{",
             f"    const {it} n = n0 + tx + 16 * jj;",
             f"    if (m < {M} && n < {N}) buf{j}[(gb * {M} + m) * ({it}){N} + n] = "
             f"{_store(odt, outv)};",
             "  }", "}"]
    src = (f'extern "C" __global__ void __launch_bounds__({THREADS}) {kname}'
           f'(const RtcArgs p, {sig}) {{\n'
           + "".join(f"  {x}\n" for x in body) + "}\n")
    grid = (-(-N // BN), -(-M // BM), Bn)
    return src, grid, (THREADS, 1, 1)


_MMA_TYPE = {"bfloat16": ("bf16", "f32_to_bf16"), "float16": ("f16", "f32_to_f16")}


def _sixteen_bit(e: Expr):
    """The 16-bit float type every value of ``e`` is exact in: its own, or
    the one it was widened from to fp32 (``preferred_element_type``),
    through views; None otherwise."""
    while e.kind in ("view", "reshape"):
        e = e.args[0]
    if e.dtype in _RND:
        return e.dtype
    if e.kind == "cast" and e.dtype == "float32" and e.args[0].dtype in _RND:
        return e.args[0].dtype
    return None


def _direct_leaf(mod: _Module, e: Expr, fast: int, sixteen: str):
    """The leaf under operand ``e`` when it can be loaded as stored, 8
    16-bit elements at a time along dim ``fast``: views of step 1 (and an
    exact widening to fp32) over an input or a materialized value of type
    ``sixteen`` whose last dim ``fast`` steps. None otherwise."""
    d = fast
    while True:
        if e.kind == "view":
            src, step = e.info["dims"][d]
            if src is None or step != 1:
                return None
            e, d = e.args[0], src
        elif e.kind == "cast" and e.dtype == "float32" and \
                e.args[0].dtype == sixteen:
            e = e.args[0]
        else:
            break
    if e.dtype != sixteen or d != len(e.shape) - 1:
        return None
    if e.kind != "in" and id(e) not in mod.plan.materialized:
        return None
    return e


def _leaf_index(e: Expr, idx):
    """The index, in the leaf under views and casts, of ``e``'s element at
    ``idx`` (C expressions)."""
    while e.kind in ("view", "cast"):
        if e.kind == "cast":
            e = e.args[0]
            continue
        src, start, dims = e.args[0], e.info["start"], e.info["dims"]
        out = []
        for d, n in enumerate(src.shape):
            terms = [str(start[d])] if start[d] else []
            terms += [idx[k] if step == 1 else f"{idx[k]} * {step}"
                      for k, (sd, step) in enumerate(dims)
                      if sd == d and e.shape[k] != 1]
            out.append("0" if n == 1 else f"({' + '.join(terms) or '0'})")
        e, idx = src, tuple(out)
    return idx


def _emit_product_mma(mod: _Module, st: Stage, kname: str, sig: str,
                      sixteen: str):
    """A tiled product of 16-bit operands on the tensor cores: a block of 8
    warps computes a 128 x 128 tile of (B, M, N) from 32-deep tiles of A
    and B, each warp a 64 x 32 tile by ``mma.sync.m16n8k16`` with fp32
    accumulators (inline PTX, like the prelude's ``cvt.rn``). Each thread
    holds 2 vectors of 8 consecutive elements of each operand's next tile
    in registers while the block multiplies the current one from shared
    memory. A vector is one 16-byte load where the operand is a view of a
    stored 16-bit value with unit stride along its contiguous dim and the
    address is aligned; else (an edge, a strided view, a fused producer)
    its 8 elements are evaluated one by one through the operand's
    expression. Shared tiles keep each operand's contiguous dim contiguous:
    A as [m][k], B as [n][k] (fragments by 32-bit reads) or [k][n]
    (fragments by ``ldmatrix.trans``); rows are padded so that a fragment
    read meets no bank twice. Values are exact in the 16-bit type; the
    result rounds once."""
    e = st.nodes[0]
    it = mod.it
    a3, b3 = e.args
    Bn, M, K = a3.shape
    N = b3.shape[2]
    j = st.buffers[0]
    _, odt = buffer_spec(mod.prog, mod.plan.buffers[j])
    ptx, to16 = _MMA_TYPE[sixteen]
    a_kfast = not _innermost(a3, 1)   # row-major A: k contiguous
    b_nfast = not _innermost(b3, 1)   # row-major B: n contiguous

    def operand(name, expr, fast_col, reg):
        """Lines that fill ``reg[2]`` (uint4) with this thread's 2 vectors
        of the operand's tile at k0 = ``kt``; and the smem store lines."""
        rows, cols = (128, 32) if name == "A" else (32, 128)
        lim_r, lim_c = (M, K) if name == "A" else (K, N)
        r0, c0 = ("m0", "kt") if name == "A" else ("kt", "n0")
        fast = 2 if fast_col else 1
        leaf = _direct_leaf(mod, expr, fast, sixteen)
        # the element-wise path: the operand's expression at (gb, gr, gc)
        em = mod.emitter()
        idx = tuple("0" if s_ == 1 else c for c, s_ in
                    zip(("gb", "gr", "gc"), expr.shape))
        v = em.value(expr, "float32", idx)
        vecs_per_line = (cols if fast_col else rows) // 8
        lines = ["#pragma unroll", "for (int u = 0; u < 2; ++u) {",
                 f"  const int vid = threadIdx.x + u * {THREADS};"]
        if fast_col:
            lines += [f"  const int tr = vid / {vecs_per_line}, "
                      f"tc = (vid % {vecs_per_line}) * 8;"]
        else:
            lines += [f"  const int tc = vid / {vecs_per_line}, "
                      f"tr = (vid % {vecs_per_line}) * 8;"]
        lines += [f"  const {it} gr0 = ({it}){r0} + tr, gc0 = ({it}){c0} + tc;",
                  "  bool done = false;"]
        if leaf is not None:
            ptr, off = mod.address(leaf, _leaf_index(expr, tuple(
                "0" if s_ == 1 else c for c, s_ in
                zip(("gb", "gr0", "gc0"), expr.shape))))
            far = "gc0 + 8 <= " if fast_col else "gr0 + 8 <= "
            near = f"gr0 < {lim_r}" if fast_col else f"gc0 < {lim_c}"
            lines += [f"  if ({mod.unit_stride(leaf)} && {near} && "
                      f"{far}{lim_c if fast_col else lim_r}) {{"]
            lines += [f"    const u16* src = (const u16*){ptr} + ({off});",
                      "    if ((((unsigned long long)src) & 15) == 0) {",
                      f"      {reg}[u] = *reinterpret_cast<const uint4*>(src);",
                      "      done = true;", "    }", "  }"]
        lines += ["  if (!done) {",
                  "    unsigned w[4];",
                  "    #pragma unroll",
                  "    for (int q = 0; q < 8; ++q) {",
                  f"      const {it} gr = gr0 + {'0' if fast_col else 'q'}, "
                  f"gc = gc0 + {'q' if fast_col else '0'};",
                  "      float val = 0.0f;",
                  f"      if (gr < {lim_r} && gc < {lim_c}) {{"]
        lines += [f"        {x}" for x in em.lines]
        lines += [f"        val = {v};", "      }",
                  f"      const unsigned h = {to16}(val);",
                  "      if (q & 1) w[q >> 1] |= h << 16; else w[q >> 1] = h;",
                  "    }",
                  f"    {reg}[u] = make_uint4(w[0], w[1], w[2], w[3]);",
                  "  }", "}"]
        # the vector's place in shared memory
        if name == "A":
            if fast_col:  # 8 consecutive k of one m
                store = ["*reinterpret_cast<uint4*>(&As[tr][tc]) = ra[u];"]
            else:  # 8 consecutive m of one k: scattered
                store = ["const unsigned* w = reinterpret_cast<const unsigned*>(&ra[u]);",
                         "#pragma unroll",
                         "for (int q = 0; q < 8; ++q) As[tr + q][tc] = "
                         "(u16)(w[q >> 1] >> (16 * (q & 1)));"]
        elif fast_col:  # 8 consecutive n of one k: B as [k][n]
            store = ["*reinterpret_cast<uint4*>(&Bk[tr][tc]) = rb[u];"]
        else:  # 8 consecutive k of one n: B as [n][k]
            store = ["*reinterpret_cast<uint4*>(&Bn[tc][tr]) = rb[u];"]
        mapping = ([f"const int vid = threadIdx.x + u * {THREADS};"]
                   + ([f"const int tr = vid / {vecs_per_line}, "
                       f"tc = (vid % {vecs_per_line}) * 8;"] if fast_col else
                      [f"const int tc = vid / {vecs_per_line}, "
                       f"tr = (vid % {vecs_per_line}) * 8;"]))
        store_lines = (["#pragma unroll", "for (int u = 0; u < 2; ++u) {"]
                       + [f"  {x}" for x in mapping + store] + ["}"])
        return lines, store_lines

    load_a, store_a = operand("A", a3, a_kfast, "ra")
    load_b, store_b = operand("B", b3, b_nfast, "rb")
    mma = (f'asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.{ptx}.{ptx}.f32 '
           '{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};" : '
           '"+f"(c[mi][ni][0]), "+f"(c[mi][ni][1]), "+f"(c[mi][ni][2]), '
           '"+f"(c[mi][ni][3]) : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), '
           '"r"(a[mi][3]), "r"(b[ni][0]), "r"(b[ni][1]));')
    frag = "*reinterpret_cast<const unsigned*>(&{}[{}][{}])"
    if b_nfast:
        b_frag = ["      const int krow = kk + (lane & 15);",
                  "      const unsigned addr = smem_u32(&Bk[krow][col0]);",
                  '      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 '
                  '{%0, %1}, [%2];" : "=r"(b[ni][0]), "=r"(b[ni][1]) : "r"(addr));']
        b_col = "      const int col0 = wn * 32 + ni * 8;"
        b_decl = "__shared__ __align__(16) u16 Bk[32][136];"
    else:
        b_frag = [f"      b[ni][0] = {frag.format('Bn', 'col', 'kk + tq * 2')};",
                  f"      b[ni][1] = {frag.format('Bn', 'col', 'kk + tq * 2 + 8')};"]
        b_col = "      const int col = wn * 32 + ni * 8 + g;"
        b_decl = "__shared__ __align__(16) u16 Bn[128][40];"
    body = ["__shared__ __align__(16) u16 As[128][40];", b_decl,
            "const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;",
            "const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tq = lane & 3;",
            f"const {it} gb = blockIdx.z;",
            f"const {it} m0 = ({it})blockIdx.y * 128, n0 = ({it})blockIdx.x * 128;",
            "float c[4][4][4];",
            "#pragma unroll", "for (int mi = 0; mi < 4; ++mi)",
            "  #pragma unroll", "  for (int ni = 0; ni < 4; ++ni)",
            "    #pragma unroll",
            "    for (int r = 0; r < 4; ++r) c[mi][ni][r] = 0.0f;",
            "uint4 ra[2], rb[2];",
            f"{it} kt = 0;"]
    body += load_a + load_b
    body += [f"for ({it} k0 = 0; k0 < {K}; k0 += 32) {{"]
    body += [f"  {x}" for x in store_a + store_b]
    body += ["  __syncthreads();",
             f"  kt = k0 + 32;",
             f"  if (kt < {K}) {{"]
    body += [f"    {x}" for x in load_a + load_b]
    body += ["  }",
             "  #pragma unroll",
             "  for (int kk = 0; kk < 32; kk += 16) {",
             "    unsigned a[4][4], b[4][2];",
             "    #pragma unroll",
             "    for (int mi = 0; mi < 4; ++mi) {",
             "      const int row = wm * 64 + mi * 16 + g;",
             f"      a[mi][0] = {frag.format('As', 'row', 'kk + tq * 2')};",
             f"      a[mi][1] = {frag.format('As', 'row + 8', 'kk + tq * 2')};",
             f"      a[mi][2] = {frag.format('As', 'row', 'kk + tq * 2 + 8')};",
             f"      a[mi][3] = {frag.format('As', 'row + 8', 'kk + tq * 2 + 8')};",
             "    }",
             "    #pragma unroll",
             "    for (int ni = 0; ni < 4; ++ni) {",
             b_col]
    body += b_frag
    body += ["    }",
             "    #pragma unroll",
             "    for (int mi = 0; mi < 4; ++mi)",
             "      #pragma unroll",
             f"      for (int ni = 0; ni < 4; ++ni) {mma}",
             "  }",
             "  __syncthreads();",
             "}"]
    outv = _Emitter().conv("c[mi][ni][r]", "float32", odt)
    body += ["#pragma unroll",
             "for (int mi = 0; mi < 4; ++mi)",
             "  #pragma unroll",
             "  for (int ni = 0; ni < 4; ++ni)",
             "    #pragma unroll",
             "    for (int r = 0; r < 4; ++r) {",
             f"      const {it} m = m0 + wm * 64 + mi * 16 + g + (r >> 1) * 8;",
             f"      const {it} n = n0 + wn * 32 + ni * 8 + tq * 2 + (r & 1);",
             f"      if (m < {M} && n < {N}) buf{j}[(gb * {M} + m) * ({it}){N} + n] = "
             f"{_store(odt, outv)};",
             "    }"]
    src = (f'extern "C" __global__ void __launch_bounds__({THREADS}) {kname}'
           f'(const RtcArgs p, {sig}) {{\n'
           + "".join(f"  {x}\n" for x in body) + "}\n")
    grid = (-(-N // 128), -(-M // 128), Bn)
    return src, grid, (THREADS, 1, 1)

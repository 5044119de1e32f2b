"""Translator of ``Rtc`` bodies into the CUDA C source of one kernel.

The JAX package's ``Rtc`` (``mxnet_tpu/rtc.py``) runs a Python body over
whole-array Refs inside ``pl.pallas_call``. The port compiles the same body
at runtime with NVRTC. This module is the pure half of that: it parses the
body, checks that it lies inside the elementwise subset both of the port's
paths accept, infers each value's dtype and shape as jnp does (x64 off,
Python numbers weak), and writes the kernel. It needs neither a card nor a
compiler, so the tests run it here.

The subset: statements ``out[:] = e`` / ``out[...] = e`` and ``name = e``;
expressions over Ref reads ``x[:]``/``x[...]``, locals, int and float
literals, ``+ - * / // % **``, unary ``-``, one comparison, the functions
``jnp.{exp, log, log1p, expm1, sqrt, tanh, sin, cos, abs, square, sign,
floor, ceil, maximum, minimum, where, clip}``, ``jax.nn.{sigmoid, relu}``
and ``.astype(jnp.float32 | jnp.bfloat16 | jnp.float16 | jnp.int32)``,
over float32, bfloat16, float16 and int32 Refs. All outputs share one
shape, which is the kernel's index space; every Ref read broadcasts into
it by numpy's rules. Anything else raises :class:`MXNetError` naming the
construct and the queue entry that holds the rest of the body language.

The kernel (``emit``) gives each thread one output index at a time in a
grid-stride loop, so its result does not depend on the launch shape.
Where every operand is contiguous or one broadcast element, the module
also holds a vector kernel with 16-byte loads and stores and the same
per-element text (see ``emit``). It
loads every Ref the body reads once, at the top, before any store (so an
output that is also an input reads as it was, as in JAX), keeps each
output's value in a register from a NaN (float) or INT_MIN (int32) fill,
the fill the JAX package's interpreter gives a Ref never written, and
stores all outputs at the end. bf16 and fp16 values are held in fp32 and
rounded to their type after every operation, with PTX ``cvt.rn``
conversions (round to nearest even) written here by hand: no
``cuda_bf16.h``, so NVRTC needs no include path. Compiled with
``--fmad=false`` and no fast math, ``+ - * /`` and comparisons give the
plain version's bits. Integer ``//`` and ``%`` are floor operations, and
division by zero gives XLA's values (``x // 0`` is -1 or -2 as jnp
computes it, ``x % 0`` is 0).
"""
from __future__ import annotations

import ast
import hashlib
import math
import operator
import textwrap
import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ...base import MXNetError

__all__ = ["Program", "analyze", "emit", "layout", "promote", "QUEUE_ENTRY",
           "DTYPES", "JNP_FUNCS", "NN_FUNCS", "CASTS", "nan_fill",
           "vector_width", "vector_kernel_name", "vector_aligned"]

# where the rest of the body language is queued
QUEUE_ENTRY = "ROADMAP.md:431"

DTYPES = ("float32", "bfloat16", "float16", "int32")
FLOATS = ("float32", "bfloat16", "float16")
# Python literals are weak, as in jnp
WEAK_INT, WEAK_FLOAT = "weak_int", "weak_float"

JNP_FUNCS = ("exp", "log", "log1p", "expm1", "sqrt", "tanh", "sin", "cos",
             "abs", "square", "sign", "floor", "ceil", "maximum", "minimum",
             "where", "clip")
NN_FUNCS = ("sigmoid", "relu")
CASTS = ("float32", "bfloat16", "float16", "int32")
_TRANSCENDENTAL = {"exp": "expf", "log": "logf", "log1p": "log1pf",
                   "expm1": "expm1f", "sqrt": "sqrtf", "tanh": "tanhf",
                   "sin": "sinf", "cos": "cosf"}
_BINOPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
           ast.FloorDiv: "//", ast.Mod: "%", ast.Pow: "**"}
PY_OPS = {"+": operator.add, "-": operator.sub, "*": operator.mul,
           "/": operator.truediv, "//": operator.floordiv, "%": operator.mod,
           "**": operator.pow}
_CMPOPS = {ast.Lt: "<", ast.LtE: "<=", ast.Gt: ">", ast.GtE: ">=",
           ast.Eq: "==", ast.NotEq: "!="}
INT_MIN = -2 ** 31
INT_MAX = 2 ** 31 - 1


def nan_fill(dtype: str):
    """What a Ref the body never writes holds (JAX's interpreter fill)."""
    return float("nan") if dtype in FLOATS else INT_MIN


def is_float(t: str) -> bool:
    return t in FLOATS or t == WEAK_FLOAT


def promote(a: str, b: str) -> str:
    """jnp's result type of a binary op with x64 off; a weak (Python)
    number takes the other operand's type unless it is a float meeting an
    integer or bool."""
    weak = (WEAK_INT, WEAK_FLOAT)
    if a in weak and b in weak:
        return WEAK_FLOAT if WEAK_FLOAT in (a, b) else WEAK_INT
    if a in weak or b in weak:
        w, s = (a, b) if a in weak else (b, a)
        if w == WEAK_FLOAT and s not in FLOATS:
            return "float32"
        return "int32" if s == "bool" else s
    if a == b:
        return a
    if "bool" in (a, b):
        return b if a == "bool" else a
    if a == "int32" or b == "int32":
        return b if a == "int32" else a
    return "float32"  # two different floats: f16 with bf16, or with f32


def broadcast(s1: Tuple[int, ...], s2: Tuple[int, ...], node) -> Tuple[int, ...]:
    out = []
    for i in range(1, max(len(s1), len(s2)) + 1):
        a = s1[-i] if i <= len(s1) else 1
        b = s2[-i] if i <= len(s2) else 1
        if a != b and 1 not in (a, b):
            _reject(node, f"shapes {s1} and {s2} do not broadcast")
        out.append(b if a == 1 else a)
    return tuple(reversed(out))


def _reject(node, why: str):
    where = f" (line {node.lineno})" if getattr(node, "lineno", None) else ""
    what = ast.unparse(node) if isinstance(node, ast.AST) else str(node)
    raise MXNetError(
        f"Rtc body: {why}: `{what}`{where} ({type(node).__name__}). The port "
        "compiles the elementwise subset of the body language; the rest is "
        f"queued at {QUEUE_ENTRY}")


# -- typed expression tree --------------------------------------------------


class Expr:
    """A value of the body: its dtype (one of DTYPES, ``bool`` or weak) and
    its shape."""

    kind = ""

    def __init__(self, dtype: str, shape: Tuple[int, ...], args=(), **info):
        self.dtype, self.shape, self.args, self.info = dtype, shape, args, info


def _const(value, node) -> Expr:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        _reject(node, "only int and float literals are numbers here")
    if isinstance(value, int) and not INT_MIN <= value <= INT_MAX:
        _reject(node, "integer literal outside int32")
    e = Expr(WEAK_FLOAT if isinstance(value, float) else WEAK_INT, ())
    e.kind, e.info["value"] = "const", value
    return e


def _node(kind, dtype, shape, *args, **info) -> Expr:
    e = Expr(dtype, shape, args, **info)
    e.kind = kind
    return e


class Program:
    """A checked body: its statements over typed expressions, the index
    shape (the outputs' shape) and the Refs it reads."""

    def __init__(self, name, inputs, outputs, stmts, shape, reads, text):
        self.name = name
        self.inputs = inputs      # [(name, shape, dtype)]
        self.outputs = outputs    # [(name, shape, dtype)]
        self.stmts = stmts        # [("local"|"out", name, Expr)]
        self.shape = shape
        self.reads = reads        # input names the body reads, in order
        self.text = text          # the body, normalized by ast.unparse
        # launch plans by device and input layout, kept by ops/cuda/rtc.py
        self.plans = {}


def analyze(name: str, inputs: Sequence[Tuple[str, tuple, str]],
            outputs: Sequence[Tuple[str, tuple, str]], body: str) -> Program:
    """Check ``body`` against the subset and type it. Raises MXNetError on
    a syntax error or any construct outside the subset."""
    try:
        tree = ast.parse(textwrap.dedent(body).strip() + "\n")
    except SyntaxError as e:
        raise MXNetError(f"Rtc kernel {name!r} failed to parse: {e}")
    for n, _, dt in list(inputs) + list(outputs):
        if dt not in DTYPES:
            raise MXNetError(f"Rtc {name!r}: Ref {n!r} has dtype {dt}; the "
                             f"compiled subset takes {DTYPES} (queued at "
                             f"{QUEUE_ENTRY})")
    shapes = {tuple(s) for _, s, _ in outputs}
    if len(shapes) != 1:
        raise MXNetError(f"Rtc {name!r}: outputs of shapes {sorted(shapes)}; "
                         "the compiled subset runs one index space, so all "
                         f"outputs share one shape (queued at {QUEUE_ENTRY})")
    shape = shapes.pop()
    ins = {n: (tuple(s), dt) for n, s, dt in inputs}
    outs = {n: (tuple(s), dt) for n, s, dt in outputs}
    if len(ins) + len(outs) != len(inputs) + len(outputs) or set(ins) & set(outs):
        raise MXNetError(f"Rtc {name!r}: Ref names must be distinct")
    reserved = {"jnp", "jax", "np"}
    env: Dict[str, Expr] = {}
    stmts: List[tuple] = []
    reads: List[str] = []

    def ref(node):
        if not (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and node.value.id in {**ins, **outs}):
            return None
        sl = node.slice
        whole = ((isinstance(sl, ast.Slice) and sl.lower is None
                  and sl.upper is None and sl.step is None)
                 or (isinstance(sl, ast.Constant) and sl.value is Ellipsis))
        if not whole:
            _reject(node, "a Ref is read or written whole, as x[:] or x[...]")
        rname = node.value.id
        rshape = (ins.get(rname) or outs[rname])[0]
        if isinstance(sl, ast.Slice) and not rshape:
            _reject(node, "a 0-d Ref is indexed as x[...]")
        return rname

    def expr(node) -> Expr:
        rname = ref(node)
        if rname is not None:
            if rname in outs:
                s, dt = outs[rname]
                return _node("out", dt, s, name=rname)
            s, dt = ins[rname]
            if broadcast(s, shape, node) != shape:
                _reject(node, f"Ref of shape {s} does not broadcast into the "
                              f"outputs' shape {shape}")
            if rname not in reads:
                reads.append(rname)
            return _node("in", dt, s, name=rname)
        if isinstance(node, ast.Constant):
            return _const(node.value, node)
        if isinstance(node, ast.Name):
            if node.id not in env:
                _reject(node, "unknown name (Refs are read as x[:])")
            return env[node.id]
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
            a = expr(node.operand)
            if isinstance(node.op, ast.UAdd):
                return a
            if a.kind == "const":
                return _const(-a.info["value"], node)
            if a.dtype == "bool":
                _reject(node, "negation of a bool")
            return _node("neg", a.dtype, a.shape, a)
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return binop(_BINOPS[type(node.op)], expr(node.left),
                         expr(node.right), node)
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1 or type(node.ops[0]) not in _CMPOPS:
                _reject(node, "one comparison at a time")
            a, b = expr(node.left), expr(node.comparators[0])
            if a.kind == "const" and b.kind == "const":
                _reject(node, "comparison of two literals")
            t = promote(a.dtype, b.dtype)
            return _node("cmp", "bool", broadcast(a.shape, b.shape, node),
                         a, b, op=_CMPOPS[type(node.ops[0])], ctype=t)
        if isinstance(node, ast.Call):
            return call(node)
        _reject(node, "construct outside the compiled subset")

    def binop(op, a, b, node) -> Expr:
        if a.kind == "const" and b.kind == "const":
            try:  # Python computes literal arithmetic before jnp sees it
                v = PY_OPS[op](a.info["value"], b.info["value"])
            except (ZeroDivisionError, OverflowError) as e:
                _reject(node, f"literal arithmetic fails in Python ({e})")
            return _const(v, node)
        if "bool" in (a.dtype, b.dtype) and op in ("//", "%", "**") or \
                a.dtype == b.dtype == "bool":
            _reject(node, f"`{op}` on a bool")
        shape = broadcast(a.shape, b.shape, node)
        if op == "**":
            if b.kind == "const" and isinstance(b.info["value"], int):
                k = b.info["value"]
                if k < 0 and not is_float(a.dtype):
                    _reject(node, "negative integer power of an integer")
                return _node("ipow", a.dtype, a.shape, a, k=k)
            t = promote(a.dtype, b.dtype)
            if not is_float(t) or (is_float(a.dtype) and not is_float(b.dtype)):
                _reject(node, "integer exponent array (only a literal "
                              "integer exponent or a float power is compiled)")
            return _node("pow", t, shape, a, b)
        t = promote(a.dtype, b.dtype)
        if op == "/" and t in ("int32", "bool"):
            t = "float32"
        return _node("bin", t, shape, a, b, op=op)

    def call(node) -> Expr:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "astype":
            if (len(node.args) != 1 or node.keywords
                    or not isinstance(node.args[0], ast.Attribute)
                    or not isinstance(node.args[0].value, ast.Name)
                    or node.args[0].value.id != "jnp"
                    or node.args[0].attr not in CASTS):
                _reject(node, "astype takes one of jnp."
                              + ", jnp.".join(CASTS))
            a = expr(f.value)
            if a.kind == "const":
                _reject(node, "astype of a literal")
            return _node("cast", node.args[0].attr, a.shape, a)
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "jnp" and f.attr in JNP_FUNCS:
            fname = f.attr
        elif (isinstance(f, ast.Attribute) and f.attr in NN_FUNCS
              and isinstance(f.value, ast.Attribute) and f.value.attr == "nn"
              and isinstance(f.value.value, ast.Name)
              and f.value.value.id == "jax"):
            fname = f.attr
        else:
            _reject(node, "function outside the compiled subset")
        kw = {k.arg: k.value for k in node.keywords}
        if fname == "clip":
            lo = node.args[1] if len(node.args) > 1 else kw.pop("min", kw.pop("a_min", None))
            hi = node.args[2] if len(node.args) > 2 else kw.pop("max", kw.pop("a_max", None))
            argn = [node.args[0]] + [n for n in (lo, hi)]
            if kw or len(node.args) > 3 or not node.args:
                _reject(node, "jnp.clip(x, min, max)")
        else:
            argn = list(node.args)
            if kw:
                _reject(node, "keyword arguments")
        nargs = {"maximum": 2, "minimum": 2, "where": 3, "clip": 3}.get(fname, 1)
        if len(argn) != nargs:
            _reject(node, f"{fname} takes {nargs} argument(s)")
        args = [None if a is None or (isinstance(a, ast.Constant) and a.value is None)
                else expr(a) for a in argn]
        if all(a is None or a.kind == "const" for a in args):
            _reject(node, "a function of literals only (write the number)")
        valued = args[1:] if fname == "where" else args
        if any(a is not None and a.dtype == "bool" for a in valued):
            _reject(node, f"{fname} of a bool")
        if fname == "clip":
            x, lo, hi = args
            if x is None:
                _reject(node, "jnp.clip needs an array")
            for bound, op in ((lo, "maximum"), (hi, "minimum")):
                if bound is not None:
                    x = _node("max" if op == "maximum" else "min",
                              promote(bound.dtype, x.dtype),
                              broadcast(bound.shape, x.shape, node), bound, x)
            return x
        if fname in ("maximum", "minimum"):
            a, b = args
            return _node("max" if fname == "maximum" else "min",
                         promote(a.dtype, b.dtype),
                         broadcast(a.shape, b.shape, node), a, b)
        if fname == "where":
            c, a, b = args
            s = broadcast(broadcast(c.shape, a.shape, node), b.shape, node)
            return _node("where", promote(a.dtype, b.dtype), s, c, a, b)
        (a,) = args
        if fname == "relu":
            return _node("max", a.dtype, a.shape, a, _const(0, node))
        if fname == "sigmoid":
            if not is_float(a.dtype):
                _reject(node, "jax.nn.sigmoid of an integer (JAX raises)")
            return _node("sigmoid", a.dtype, a.shape, a)
        if fname in _TRANSCENDENTAL:
            return _node("fn", a.dtype if is_float(a.dtype) else "float32",
                         a.shape, a, fn=fname)
        if fname in ("floor", "ceil") and not is_float(a.dtype):
            return a
        return _node("fn", a.dtype, a.shape, a, fn=fname)

    for st in tree.body:
        if not isinstance(st, ast.Assign) or len(st.targets) != 1:
            _reject(st, "statements are assignments `out[:] = ...` or "
                        "`name = ...`")
        tgt = st.targets[0]
        value = expr(st.value)
        if isinstance(tgt, ast.Name):
            if tgt.id in reserved or tgt.id in ins or tgt.id in outs:
                _reject(tgt, "this name is a Ref or a module")
            env[tgt.id] = value
            stmts.append(("local", tgt.id, value))
            continue
        rname = ref(tgt)
        if rname is None or rname in ins:
            _reject(tgt, "only output Refs are written")
        oshape, odt = outs[rname]
        if value.shape != oshape:
            _reject(st, f"value of shape {value.shape} stored into a Ref of "
                        f"shape {oshape} (JAX raises: Invalid shape for swap)")
        if value.dtype != odt:
            _reject(st, f"value of dtype {value.dtype} stored into a {odt} "
                        "Ref (JAX raises: Invalid dtype for swap); convert "
                        "with .astype(...)")
        stmts.append(("out", rname, value))
    return Program(name, [(n, tuple(s), dt) for n, s, dt in inputs],
                   [(n, tuple(s), dt) for n, s, dt in outputs], stmts, shape,
                   reads, ast.unparse(tree))


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
"""


def _fmt_float(v: float) -> str:
    if math.isnan(v):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(v):
        return "__int_as_float(0x7f800000)" if v > 0 else "__int_as_float(0xff800000)"
    return f"((float){float(v).hex()})"


def _literal(v, dtype: str) -> str:
    """A weak literal converted to ``dtype`` the way torch converts a
    Python number (double -> float -> bf16/f16), exactly."""
    if dtype == "int32":
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
           "int32": "int", "bool": "bool"}
_ST_TYPE = {"float32": "float", "bfloat16": "u16", "float16": "u16",
            "int32": "int"}
_RND = {"bfloat16": "rnd_bf16", "float16": "rnd_f16"}


class _Emitter:
    def __init__(self):
        self.lines: List[str] = []
        self.n = 0
        self.memo: Dict[int, str] = {}

    def tmp(self, dtype: str, code: str) -> str:
        self.n += 1
        name = f"e{self.n}"
        self.lines.append(f"const {_C_TYPE[dtype]} {name} = {code};")
        return name

    def conv(self, v: str, src: str, dst: str) -> str:
        """Convert a C value held for dtype ``src`` to dtype ``dst``."""
        if src == dst:
            return v
        if dst == "int32":  # float -> int truncates, saturates, NaN -> 0
            return f"__float2int_rz({v})" if src in FLOATS else f"((int){v})"
        if dst == "bool":
            return f"({v} != 0)"
        if src in FLOATS:  # float to float: held in fp32, round to dst
            return v if dst == "float32" else f"{_RND[dst]}({v})"
        return f"((float){v})" if dst == "float32" else f"{_RND[dst]}((float){v})"

    def value(self, e: Expr, dtype: str, outs: Dict[str, str]) -> str:
        """The C code of ``e`` converted to ``dtype``."""
        if e.kind == "const":
            return _literal(e.info["value"], dtype)
        return self.conv(self.eval(e, outs), e.dtype, dtype)

    def eval(self, e: Expr, outs: Dict[str, str]) -> str:
        if e.kind == "in":
            return f"v_{e.info['name']}"
        if id(e) in self.memo:
            return self.memo[id(e)]
        r = self._eval(e, outs)
        self.memo[id(e)] = r
        return r

    def _eval(self, e: Expr, outs) -> str:
        t = e.dtype
        # bf16 and fp16 results round after every operation
        rnd = (lambda c: f"{_RND[t]}({c})") if t in _RND else (lambda c: c)
        if e.kind == "out":  # the output's value at this point of the body
            return self.tmp(t, outs[e.info["name"]])
        if e.kind == "neg":
            a = self.value(e.args[0], t, outs)
            return self.tmp(t, f"sub_i(0, {a})" if t == "int32" else f"-{a}")
        if e.kind == "bin":
            op = e.info["op"]
            a, b = (self.value(x, t, outs) for x in e.args)
            if t == "int32":
                f = {"+": "add_i", "-": "sub_i", "*": "mul_i", "//": "floordiv_i",
                     "%": "mod_i"}[op]
                return self.tmp(t, f"{f}({a}, {b})")
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
        if e.kind == "ipow":
            k = e.info["k"]
            x = self.value(e.args[0], t, outs)
            mul = (lambda p, q: f"mul_i({p}, {q})") if t == "int32" else \
                (lambda p, q: rnd(f"{p} * {q}"))
            if k == 0:
                return self.tmp(t, "1" if t == "int32" else "1.0f")
            recip, k, acc = k < 0, abs(k), None
            while k > 0:  # lax.integer_pow's binary exponentiation
                if k & 1:
                    acc = x if acc is None else self.tmp(t, mul(acc, x))
                k >>= 1
                if k > 0:
                    x = self.tmp(t, mul(x, x))
            return self.tmp(t, rnd(f"1.0f / {acc}")) if recip else acc
        if e.kind == "pow":
            a, b = (self.value(x, t, outs) for x in e.args)
            return self.tmp(t, rnd(f"powf({a}, {b})"))
        if e.kind == "cmp":
            ct = e.info["ctype"]
            ct = {WEAK_INT: "int32", WEAK_FLOAT: "float32"}.get(ct, ct)
            a, b = (self.value(x, ct, outs) for x in e.args)
            return self.tmp("bool", f"{a} {e.info['op']} {b}")
        if e.kind in ("max", "min"):
            a, b = (self.value(x, t, outs) for x in e.args)
            f = f"{e.kind}_i" if t == "int32" else f"f{e.kind}_nan"
            return self.tmp(t, f"{f}({a}, {b})")
        if e.kind == "where":
            c = self.value(e.args[0], "bool", outs)
            a, b = (self.value(x, t, outs) for x in e.args[1:])
            return self.tmp(t, f"{c} ? {a} : {b}")
        if e.kind == "cast":
            return self.tmp(t, self.value(e.args[0], t, outs))
        if e.kind == "sigmoid":  # lax.logistic: 1 / (1 + exp(-x))
            x = self.value(e.args[0], t, outs)
            ex = self.tmp(t, rnd(f"expf(-{x})"))
            den = self.tmp(t, rnd(f"1.0f + {ex}"))
            return self.tmp(t, rnd(f"1.0f / {den}"))
        if e.kind == "fn":
            fn = e.info["fn"]
            x = self.value(e.args[0], t, outs)
            if fn in _TRANSCENDENTAL:
                return self.tmp(t, rnd(f"{_TRANSCENDENTAL[fn]}({x})"))
            if t == "int32":
                code = {"abs": f"abs_i({x})", "square": f"mul_i({x}, {x})",
                        "sign": f"sgn_i({x})"}[fn]
                return self.tmp(t, code)
            code = {"abs": f"fabsf({x})", "square": rnd(f"{x} * {x}"),
                    "sign": f"sign_f({x})", "floor": f"floorf({x})",
                    "ceil": f"ceilf({x})"}[fn]
            return self.tmp(t, code)
        raise AssertionError(e.kind)


def _load(dtype: str, ptr: str, off: str) -> str:
    return {"float32": f"{ptr}[{off}]", "int32": f"{ptr}[{off}]",
            "bfloat16": f"bf16_to_f32({ptr}[{off}])",
            "float16": f"f16_to_f32({ptr}[{off}])"}[dtype]


def _store(dtype: str, v: str) -> str:
    return {"float32": v, "int32": v, "bfloat16": f"f32_to_bf16({v})",
            "float16": f"f32_to_f16({v})"}[dtype]


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


def emit(prog: Program, rank: int, kinds: Sequence[str],
         wide_index: bool) -> Tuple[str, str]:
    """The CUDA C source of ``prog``'s kernel for an index space of
    ``rank`` collapsed dims, each read Ref accessed as its ``kinds`` entry
    says (see :func:`layout`), with 64-bit offsets if ``wide_index``.
    Returns (source, kernel name). The source is the compile cache's key:
    it holds the body, the dtypes, the rank and the access kinds, while
    sizes and strides are launch arguments.

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
    outs = {n: f"o_{n}" for n, _, _ in prog.outputs}
    for kind, name, value in prog.stmts:
        if kind == "local":
            em.eval(value, outs)  # evaluated where the body binds it
            continue
        odt = dict((n, dt) for n, _, dt in prog.outputs)[name]
        v = em.value(value, odt, outs)
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
    head = (f"(const RtcArgs p, " + ", ".join(params) + ") {\n"
            "  const long long nthreads = (long long)gridDim.x * gridDim.y * "
            "gridDim.z * blockDim.x * blockDim.y * blockDim.z;\n"
            "  const long long tid = ((long long)(blockIdx.z * gridDim.y + "
            "blockIdx.y) * gridDim.x + blockIdx.x) * (blockDim.x * blockDim.y * "
            "blockDim.z) + (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x "
            "+ threadIdx.x;\n")
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

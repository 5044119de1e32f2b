"""Analysis of ``Rtc`` bodies: the body language both of the port's paths take.

The JAX package's ``Rtc`` runs a Python body over whole-array Refs inside
``pl.pallas_call``, so any jnp program with static shapes is a body. The
port runs the body once, at ``Rtc(...)``, over symbolic Refs: Python itself
unrolls ``for`` loops over ``range``, ``jax.lax.fori_loop``, local ``def``\\ s
and lambdas and ``if``/``else`` whose condition is a Python value, and every
jnp call records one node of a typed dataflow graph (:class:`Expr`), with
jnp's dtype (x64 off, Python numbers weak) and shape. A store into an
output Ref makes the Ref's next version; reading it gives the version at
that point. What the body leaves in each output Ref is the program
(:class:`Program`): ``rtc_codegen`` compiles it for the card and
``mxnet_tpu_torch/rtc.py`` evaluates it with torch on the CPU.

Anything outside the language raises :class:`MXNetError` naming the
construct and :data:`QUEUE_ENTRY`: a truth value of an array (``if`` on
one, a chained comparison of arrays), gathers, scans, ``lax.while_loop``,
``lax.cond``, ``lax.scan``, sorting, ``einsum``, products of rank above 3,
fp64 and complex types, random numbers, a ``while`` statement, and a body
that unrolls past :data:`MAX_STATEMENTS` statements.
"""
from __future__ import annotations

import ast
import math
import operator
import sys
import textwrap
from typing import List, Sequence, Tuple

import numpy as np

from ...base import MXNetError

__all__ = ["Expr", "Program", "analyze", "promote", "walk", "QUEUE_ENTRY",
           "DTYPES", "FLOATS", "INTS", "WEAK_INT", "WEAK_FLOAT", "IINFO",
           "nan_fill", "MAX_STATEMENTS", "CASTS"]

# where the rest of the body language is queued: the file and the entry's
# heading text in it
QUEUE_ENTRY = "ROADMAP.md: B4 remaining body language"

# dtypes a Ref may have; int16 exists as an intermediate (uint8 + int8)
DTYPES = ("float32", "bfloat16", "float16", "int32", "int8", "uint8", "bool")
FLOATS = ("float32", "bfloat16", "float16")
INTS = ("int32", "int16", "int8", "uint8")
# Python literals are weak, as in jnp
WEAK_INT, WEAK_FLOAT = "weak_int", "weak_float"
IINFO = {"int32": (-2 ** 31, 2 ** 31 - 1), "int16": (-2 ** 15, 2 ** 15 - 1),
         "int8": (-128, 127), "uint8": (0, 255)}
CASTS = ("float32", "bfloat16", "float16", "int32", "int16", "int8", "uint8",
         "bool")
# the unrolled body's statement cap
MAX_STATEMENTS = 4096

# jnp's type lattice with x64 off (64-bit types canonicalize to 32-bit):
# each type and the types directly above it
_ABOVE = {"bool": (WEAK_INT,), WEAK_INT: ("uint8", "int8"),
          "uint8": ("int16",), "int8": ("int16",), "int16": ("int32",),
          "int32": (WEAK_FLOAT,), WEAK_FLOAT: ("bfloat16", "float16"),
          "bfloat16": ("float32",), "float16": ("float32",), "float32": ()}


def _up(t: str) -> set:
    seen, todo = {t}, [t]
    while todo:
        for p in _ABOVE[todo.pop()]:
            if p not in seen:
                seen.add(p)
                todo.append(p)
    return seen


_UP = {t: _up(t) for t in _ABOVE}


def promote(a: str, b: str) -> str:
    """jnp's result type of a binary op with x64 off: the least upper bound
    in jnp's lattice. It is weak only when both operands are weak: a weak
    int meeting a bool gives int32, a weak float meeting an integer or a
    bool float32."""
    common = _UP[a] & _UP[b]
    lub = next(c for c in common if common <= _UP[c])
    if lub in (WEAK_INT, WEAK_FLOAT) and not (
            a in (WEAK_INT, WEAK_FLOAT) and b in (WEAK_INT, WEAK_FLOAT)):
        return "int32" if lub == WEAK_INT else "float32"
    return lub


def is_float(t: str) -> bool:
    return t in FLOATS or t == WEAK_FLOAT


def is_int(t: str) -> bool:
    return t in INTS or t == WEAK_INT


def nan_fill(dtype: str):
    """What a Ref the body never writes holds (JAX's interpreter fill):
    NaN, the type's least integer, or False."""
    if dtype in FLOATS:
        return float("nan")
    if dtype == "bool":
        return False
    return IINFO[dtype][0]


def wrap_int(v: int, dtype: str) -> int:
    lo, hi = IINFO[dtype]
    return (v - lo) % (hi - lo + 1) + lo


class _Reject(Exception):
    pass


def _reject(why: str):
    raise _Reject(why)


def broadcast(s1: Tuple[int, ...], s2: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for i in range(1, max(len(s1), len(s2)) + 1):
        a = s1[-i] if i <= len(s1) else 1
        b = s2[-i] if i <= len(s2) else 1
        if a != b and 1 not in (a, b):
            _reject(f"shapes {s1} and {s2} do not broadcast")
        out.append(b if a == 1 else a)
    return tuple(reversed(out))


# -- the graph ----------------------------------------------------------------


class Expr:
    """A value of the body: its kind, dtype (one of DTYPES, int16 or weak)
    and shape, its operands and the kind's details.

    Kinds: ``const`` (``value``), ``in`` (an input Ref, ``name``), ``fill``
    (an output Ref never written), the elementwise kinds (``neg``, ``bin``
    with ``op``, ``ipow`` with ``k``, ``pow``, ``ipowa``, ``cmp`` with
    ``op``/``ctype``, ``max``, ``min``, ``where``, ``cast``, ``sigmoid``,
    ``fn`` with ``fn``, ``not``), ``view`` (``start`` per operand dim,
    ``dims``: per result dim the operand dim it steps or None, and the
    step), ``reshape``, ``store`` (``region``: per Ref dim (start, step,
    size, kept)), ``reduce`` (``op``, ``axes``, ``acc``) and ``dot``
    (operands (B, M, K) and (B, K, N), ``acc``)."""

    __slots__ = ("kind", "dtype", "shape", "args", "info")

    def __init__(self, dtype: str, shape: Tuple[int, ...], args=(), **info):
        self.kind = ""
        self.dtype, self.shape, self.args, self.info = dtype, tuple(shape), \
            tuple(args), info


def node(kind, dtype, shape, *args, **info) -> Expr:
    e = Expr(dtype, shape, args, **info)
    e.kind = kind
    return e


def const(value, dtype=None) -> Expr:
    """A literal: weak for a Python number, else of ``dtype``."""
    if dtype is None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            _reject("only int and float literals are numbers here")
        if isinstance(value, int) and not IINFO["int32"][0] <= value <= \
                IINFO["int32"][1]:
            _reject("integer literal outside int32")
        dtype = WEAK_FLOAT if isinstance(value, float) else WEAK_INT
    return node("const", dtype, (), value=value)


_ELEMENTWISE = ("const", "in", "fill", "neg", "bin", "ipow", "pow", "ipowa",
                "cmp", "max", "min", "where", "cast", "sigmoid", "fn", "fn2",
                "not")


class Program:
    """A checked body: each output's final value, and for a body of the
    elementwise subset that every output shares one shape (``simple``) the
    statements, the index shape and the Refs read, in the form the
    layout-collapsed kernel takes (``rtc_codegen.emit``)."""

    def __init__(self, name, inputs, outputs, finals, text):
        self.name = name
        self.inputs = inputs      # [(name, shape, dtype)]
        self.outputs = outputs    # [(name, shape, dtype)]
        self.finals = finals      # {output name: Expr}
        self.text = text          # the body, normalized by ast.unparse
        # launch plans by device and input layout, kept by ops/cuda/rtc.py
        self.plans = {}
        self.simple = _is_simple(inputs, outputs, finals)
        self.shape = tuple(outputs[0][1]) if self.simple else None
        self.stmts = [("out", n, finals[n]) for n, _, _ in outputs
                      if finals[n].kind != "fill"] if self.simple else []
        self.reads = _reads(finals, [n for n, _, _ in outputs])


def walk(roots):
    """Every node under ``roots``, operands before users, each once."""
    seen, order = set(), []
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        e, done = stack.pop()
        if done:
            order.append(e)
            continue
        if id(e) in seen:
            continue
        seen.add(id(e))
        stack.append((e, True))
        stack.extend((a, False) for a in reversed(e.args))
    return order


def _reads(finals, names) -> List[str]:
    reads = []
    for e in walk([finals[n] for n in names]):
        if e.kind == "in" and e.info["name"] not in reads:
            reads.append(e.info["name"])
    return reads


_OLD_DTYPES = ("float32", "bfloat16", "float16", "int32")
_OLD_FNS = ("exp", "log", "log1p", "expm1", "sqrt", "tanh", "sin", "cos",
            "abs", "square", "sign", "floor", "ceil")


def _is_simple(inputs, outputs, finals) -> bool:
    if len({tuple(s) for _, s, _ in outputs}) != 1:
        return False
    if any(dt not in _OLD_DTYPES for _, _, dt in list(inputs) + list(outputs)):
        return False
    for e in walk(list(finals.values())):
        if e.kind not in _ELEMENTWISE or e.kind in ("ipowa", "not") or \
                e.dtype not in _OLD_DTYPES + ("bool", WEAK_INT, WEAK_FLOAT):
            return False
        if e.kind == "const" and e.dtype not in (WEAK_INT, WEAK_FLOAT):
            return False
        if e.kind == "bin" and e.info["op"] not in PY_OPS:
            return False
        if e.kind == "fn" and e.info["fn"] not in _OLD_FNS:
            return False
        if e.kind == "pow" and not is_float(e.dtype):
            return False
    return True


PY_OPS = {"+": operator.add, "-": operator.sub, "*": operator.mul,
          "/": operator.truediv, "//": operator.floordiv, "%": operator.mod,
          "**": operator.pow}


# -- dtypes as the body sees them ---------------------------------------------


class DType(str):
    """A dtype in the body: ``jnp.float32``, ``ref.dtype``, ``x.dtype``. It
    equals its name."""

    def __repr__(self):
        return f"dtype({str(self)!r})"


_DT = {n: DType(n) for n in CASTS + ("float64",)}


def _dtype_arg(d) -> str:
    if isinstance(d, DType):
        return str(d)
    if d is None:
        return None
    _reject("astype takes one of jnp." + ", jnp.".join(CASTS[:-1])
            + ", jnp.bool_ or a Ref's dtype")


# -- values of the body -----------------------------------------------------


def _numpy_scalar(v) -> Expr:
    """A numpy scalar is strongly typed in jnp: its dtype, 64-bit types
    canonical at 32."""
    name = {"float64": "float32", "int64": "int32", "uint32": None,
            "uint64": None}.get(v.dtype.name, v.dtype.name)
    if name not in CASTS or name is None:
        _reject(f"numpy scalar of dtype {v.dtype.name}")
    if name in INTS:
        return const(wrap_int(int(v), name), name)
    if name == "bool":
        return const(bool(v), "bool")
    return const(_round_to(float(v), name), name)


def _round_to(v: float, dtype: str) -> float:
    """``v`` rounded to ``dtype`` as torch converts a Python number."""
    import torch
    return float(torch.tensor(v, dtype=getattr(torch, dtype)).item())


def _e(v) -> Expr:
    """The node of an operand: a Val, a Python number (weak) or a numpy
    scalar."""
    if isinstance(v, Val):
        return v.e
    if isinstance(v, np.generic):
        return _numpy_scalar(v)
    if isinstance(v, Ref):
        _reject("a Ref is read as x[:] or x[...] before it is used")
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return const(v)
    if isinstance(v, bool):
        _reject("only int and float literals are numbers here")
    _reject(f"a {type(v).__name__} is not a value of the body")


def _static_int(v):
    """The value of a static integer index, or None."""
    if isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_)):
        return int(v)
    if isinstance(v, Val) and v.e.kind == "const" and is_int(v.e.dtype):
        return int(v.e.info["value"])
    return None


_UFUNC_OPS = {"add": "+", "subtract": "-", "multiply": "*",
              "true_divide": "/", "divide": "/"}


class Val:
    """An array value of the body (symbolic)."""

    __array_priority__ = 1000
    __hash__ = None

    def __init__(self, e: Expr):
        self.e = e

    # static attributes
    @property
    def shape(self):
        return self.e.shape

    @property
    def ndim(self):
        return len(self.e.shape)

    @property
    def size(self):
        return math.prod(self.e.shape)

    @property
    def dtype(self):
        d = self.e.dtype
        return _DT[{WEAK_INT: "int32", WEAK_FLOAT: "float32"}.get(d, d)]

    def __len__(self):
        if not self.e.shape:
            _reject("len() of a 0-d array")
        return self.e.shape[0]

    def __bool__(self):
        _reject("the truth value of an array: an `if` on an array value, "
                "or a chained comparison of arrays (`a < b < c` is `a < b "
                "and b < c`; one comparison at a time); JAX raises "
                "TracerBoolConversionError")

    def __index__(self):
        _reject("an array value used as a Python integer")

    __int__ = __float__ = __index__

    def __iter__(self):
        _reject("iteration over an array value")

    def __array__(self, *a, **k):
        _reject("numpy of an array value: the function outside the "
                "compiled language (use jnp)")

    def __array_ufunc__(self, ufunc, method, *a, **k):
        op = _UFUNC_OPS.get(ufunc.__name__)
        if op is not None and method == "__call__" and len(a) == 2 and not k:
            return Val(binop(op, *a))
        _reject(f"np.{ufunc.__name__} of an array value: the function "
                "outside the compiled language (use jnp)")

    def __array_function__(self, func, types_, args, kwargs):
        _reject(f"np.{func.__name__} of an array value: the function "
                "outside the compiled language (use jnp)")

    # arithmetic
    def __add__(self, o): return Val(binop("+", self, o))
    def __radd__(self, o): return Val(binop("+", o, self))
    def __sub__(self, o): return Val(binop("-", self, o))
    def __rsub__(self, o): return Val(binop("-", o, self))
    def __mul__(self, o): return Val(binop("*", self, o))
    def __rmul__(self, o): return Val(binop("*", o, self))
    def __truediv__(self, o): return Val(binop("/", self, o))
    def __rtruediv__(self, o): return Val(binop("/", o, self))
    def __floordiv__(self, o): return Val(binop("//", self, o))
    def __rfloordiv__(self, o): return Val(binop("//", o, self))
    def __mod__(self, o): return Val(binop("%", self, o))
    def __rmod__(self, o): return Val(binop("%", o, self))
    def __pow__(self, o): return Val(binop("**", self, o))
    def __rpow__(self, o): return Val(binop("**", o, self))
    def __and__(self, o): return Val(binop("&", self, o))
    def __rand__(self, o): return Val(binop("&", o, self))
    def __or__(self, o): return Val(binop("|", self, o))
    def __ror__(self, o): return Val(binop("|", o, self))
    def __xor__(self, o): return Val(binop("^", self, o))
    def __rxor__(self, o): return Val(binop("^", o, self))
    def __lshift__(self, o): return Val(binop("<<", self, o))
    def __rlshift__(self, o): return Val(binop("<<", o, self))
    def __rshift__(self, o): return Val(binop(">>", self, o))
    def __rrshift__(self, o): return Val(binop(">>", o, self))
    def __matmul__(self, o): return Val(matmul(self, o, "@"))
    def __rmatmul__(self, o): return Val(matmul(o, self, "@"))
    def __neg__(self): return Val(negate(self.e))
    def __pos__(self): return self
    def __abs__(self): return _JNP.abs(self)
    def __invert__(self): return Val(invert(self.e))

    def __lt__(self, o): return Val(compare("<", self, o))
    def __le__(self, o): return Val(compare("<=", self, o))
    def __gt__(self, o): return Val(compare(">", self, o))
    def __ge__(self, o): return Val(compare(">=", self, o))
    def __eq__(self, o): return Val(compare("==", self, o))
    def __ne__(self, o): return Val(compare("!=", self, o))

    # methods
    def astype(self, dtype):
        return Val(cast(self.e, _dtype_arg(dtype)))

    def __getitem__(self, key):
        return Val(index_value(self.e, key))

    @property
    def T(self):
        return Val(transpose(self.e, None))

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = axes[0]
        return Val(transpose(self.e, tuple(axes) if axes else None))

    def reshape(self, *shape, order="C"):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = shape[0]
        return Val(reshape(self.e, tuple(shape)))

    def squeeze(self, axis=None):
        return Val(squeeze(self.e, axis))

    def sum(self, axis=None, keepdims=False, dtype=None):
        return _JNP.sum(self, axis=axis, keepdims=keepdims, dtype=dtype)

    def mean(self, axis=None, keepdims=False, dtype=None):
        return _JNP.mean(self, axis=axis, keepdims=keepdims, dtype=dtype)

    def max(self, axis=None, keepdims=False):
        return _JNP.max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return _JNP.min(self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False, dtype=None):
        return _JNP.prod(self, axis=axis, keepdims=keepdims, dtype=dtype)

    def argmax(self, axis=None, keepdims=False):
        return _JNP.argmax(self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _JNP.argmin(self, axis=axis, keepdims=keepdims)

    def any(self, axis=None, keepdims=False):
        return _JNP.any(self, axis=axis, keepdims=keepdims)

    def all(self, axis=None, keepdims=False):
        return _JNP.all(self, axis=axis, keepdims=keepdims)

    def dot(self, o):
        return _JNP.dot(self, o)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        _reject(f"array method .{name} outside the compiled language")


# -- elementwise ------------------------------------------------------------


def _literals_only(*es):
    if all(e.kind == "const" and e.dtype in (WEAK_INT, WEAK_FLOAT)
           for e in es):
        _reject("a function of literals only (write the number)")


def _fold_int(op, a: Expr, b: Expr, t: str):
    """Two integer literals of which one is typed fold, wrapped to ``t``, so
    that a fori_loop index stays a static index."""
    x, y = a.info["value"], b.info["value"]
    if op in ("//", "%") and y == 0:
        return None
    v = {"+": x + y, "-": x - y, "*": x * y, "//": x // y if y else 0,
         "%": x % y if y else 0}.get(op)
    return None if v is None else const(wrap_int(v, t), t)


def _fits(t: str, *es: Expr):
    """A Python int meeting a narrow integer must fit it (JAX raises
    OverflowError)."""
    if t in ("int8", "uint8", "int16"):
        lo, hi = IINFO[t]
        for e in es:
            if e.kind == "const" and e.dtype == WEAK_INT and \
                    not lo <= e.info["value"] <= hi:
                _reject(f"Python int {e.info['value']} out of range for {t} "
                        "(JAX raises OverflowError)")


def binop(op: str, a, b) -> Expr:
    a, b = _e(a), _e(b)
    _fits(promote(a.dtype, b.dtype), a, b)
    if a.kind == b.kind == "const" and a.dtype in (WEAK_INT, WEAK_FLOAT) \
            and b.dtype in (WEAK_INT, WEAK_FLOAT):
        try:  # Python computes literal arithmetic before jnp sees it
            return const(PY_OPS[op](a.info["value"], b.info["value"]))
        except (ZeroDivisionError, OverflowError) as err:
            _reject(f"literal arithmetic fails in Python ({err})")
    shape = broadcast(a.shape, b.shape)
    if op in ("&", "|", "^", "<<", ">>"):
        t = promote(a.dtype, b.dtype)
        if is_float(t):
            _reject(f"`{op}` on a float")
        if op in ("<<", ">>") and t == "bool":
            _reject(f"`{op}` on a bool")
        t = "int32" if t == WEAK_INT else t
        return node("bin", t, shape, a, b, op=op)
    bools = (a.dtype == "bool") + (b.dtype == "bool")
    if bools and op in ("//", "%", "**") or bools == 2 and op == "-":
        _reject(f"`{op}` on a bool")
    if op == "**":
        if b.kind == "const" and isinstance(b.info["value"], int) and \
                b.dtype == WEAK_INT:
            k = b.info["value"]
            if k < 0 and not is_float(a.dtype):
                _reject("negative integer power of an integer")
            if a.kind == "const" and a.dtype not in (WEAK_INT, WEAK_FLOAT) \
                    and is_int(a.dtype):
                return const(wrap_int(a.info["value"] ** k, a.dtype), a.dtype)
            return node("ipow", a.dtype, a.shape, a, k=k)
        t = promote(a.dtype, b.dtype)
        if is_float(t):
            return node("pow", t, shape, a, b)
        return node("ipowa", t, shape, a, b)  # jnp's _pow_int_int
    t = promote(a.dtype, b.dtype)
    if op == "/" and not is_float(t):
        t = "float32"
    if a.kind == b.kind == "const" and t in INTS and op in "+-*//%":
        folded = _fold_int(op, a, b, t)
        if folded is not None:
            return folded
    if t == "bool":  # + and * on bools: logical or / and
        return node("bin", t, shape, a, b, op={"+": "|", "*": "&"}[op])
    return node("bin", t, shape, a, b, op=op)


def compare(op: str, a, b) -> Expr:
    a, b = _e(a), _e(b)
    t = promote(a.dtype, b.dtype)
    _fits(t, a, b)
    return node("cmp", "bool", broadcast(a.shape, b.shape), a, b, op=op,
                ctype=t)


def negate(a: Expr) -> Expr:
    if a.kind == "const" and a.dtype in (WEAK_INT, WEAK_FLOAT):
        return const(-a.info["value"])
    if a.dtype == "bool":
        _reject("negation of a bool")
    if a.kind == "const" and a.dtype in INTS:
        return const(wrap_int(-a.info["value"], a.dtype), a.dtype)
    return node("neg", a.dtype, a.shape, a)


def invert(a: Expr) -> Expr:
    if is_float(a.dtype):
        _reject("`~` on a float")
    t = "int32" if a.dtype == WEAK_INT else a.dtype
    return node("not", t, a.shape, a)


def cast(a: Expr, dtype: str) -> Expr:
    if dtype is None:
        return a
    if dtype not in CASTS:
        _reject(f"astype takes one of {', '.join(CASTS)}: {dtype} is not one "
                "(fp64 and complex types are queued)")
    if a.kind == "const" and a.dtype in (WEAK_INT, WEAK_FLOAT):
        _reject("astype of a literal")
    if a.dtype == dtype:
        return a
    return node("cast", dtype, a.shape, a)


def _float_operand(a: Expr) -> Expr:
    """jnp's promote_args_inexact: integers and bools become float32."""
    return a if is_float(a.dtype) else cast(a, "float32")


def _unary_float(fn):
    def f(x, /):
        a = _e(x)
        _literals_only(a)
        a = _float_operand(a)
        return Val(node("fn", a.dtype, a.shape, a, fn=fn))
    return f


def _typed_const(v: float, like: Expr) -> Expr:
    """A constant of ``like``'s float dtype (np.array(v, dtype))."""
    return const(_round_to(v, like.dtype), like.dtype)


def _maxmin(kind):
    def f(x, y):
        a, b = _e(x), _e(y)
        _literals_only(a, b)
        t = promote(a.dtype, b.dtype)
        if t == "bool":
            return Val(node("bin", "bool", broadcast(a.shape, b.shape), a, b,
                            op="|" if kind == "max" else "&"))
        return Val(node(kind, t, broadcast(a.shape, b.shape), a, b))
    return f


def _where(c, x, y):
    c, a, b = _e(c), _e(x), _e(y)
    _literals_only(c, a, b)
    s = broadcast(broadcast(c.shape, a.shape), b.shape)
    return Val(node("where", promote(a.dtype, b.dtype), s, c, a, b))


def _clip(x, min=None, max=None, a_min=None, a_max=None):
    lo = min if min is not None else a_min
    hi = max if max is not None else a_max
    a = _e(x)
    _literals_only(a)
    v = Val(a)
    if lo is not None:
        v = _maxmin("max")(lo, v)
    if hi is not None:
        v = _maxmin("min")(hi, v)
    return v


def _abs(x):
    a = _e(x)
    _literals_only(a)
    if a.dtype in ("bool", "uint8"):
        return Val(a)
    return Val(node("fn", a.dtype, a.shape, a, fn="abs"))


def _same_type_fn(fn, ints):
    """A function that keeps its operand's dtype; ``ints`` what it does to
    an integer: 'keep' (the identity) or the same function."""
    def f(x):
        a = _e(x)
        _literals_only(a)
        if a.dtype == "bool":
            _reject(f"jnp.{fn} of a bool")
        if not is_float(a.dtype) and ints == "keep":
            return Val(a)
        return Val(node("fn", a.dtype, a.shape, a, fn=fn))
    return f


def _square(x, /):
    a = _e(x)
    _literals_only(a)
    if a.dtype == "bool":
        _reject("jnp.square of a bool")
    return Val(node("fn", a.dtype, a.shape, a, fn="square"))


def _sign(x):
    a = _e(x)
    _literals_only(a)
    if a.dtype == "bool":
        _reject("jnp.sign of a bool")
    return Val(node("fn", a.dtype, a.shape, a, fn="sign"))


def _isfn(fn):
    def f(x):
        a = _e(x)
        _literals_only(a)
        if not is_float(a.dtype):
            return Val(broadcast_to(const(fn == "isfinite", "bool"), a.shape))
        return Val(node("fn", "bool", a.shape, a, fn=fn))
    return f


def _logical(op):
    def f(x, y=None):
        a = _e(x)
        a = a if a.dtype == "bool" else compare("!=", Val(a), 0)
        if op == "not":
            _literals_only(a)
            return Val(node("not", "bool", a.shape, a))
        b = _e(y)
        b = b if b.dtype == "bool" else compare("!=", Val(b), 0)
        return Val(node("bin", "bool", broadcast(a.shape, b.shape), a, b,
                        op=op))
    return f


def _sigmoid(x):
    a = _e(x)
    _literals_only(a)
    if not is_float(a.dtype):
        _reject("jax.nn.sigmoid of an integer (JAX raises)")
    return Val(node("sigmoid", a.dtype, a.shape, a))


def _relu(x):
    return _maxmin("max")(x, 0)


def _log2(x):
    a = _float_operand(_e(x))
    _literals_only(a)
    ln = _unary_float("log")(Val(a))
    ln2 = node("fn", a.dtype, (), _typed_const(2.0, a), fn="log")
    return Val(binop("/", ln, Val(ln2)))


def _log10(x):
    a = _float_operand(_e(x))
    _literals_only(a)
    return _unary_float("log")(Val(a)) * Val(_typed_const(0.4342944819032518,
                                                          a))


def _reciprocal(x):
    a = _float_operand(_e(x))
    _literals_only(a)
    return Val(node("ipow", a.dtype, a.shape, a, k=-1))


def _arctan2(y, x):
    a, b = _e(y), _e(x)
    _literals_only(a, b)
    t = promote(a.dtype, b.dtype)
    t = t if is_float(t) and t != WEAK_FLOAT else "float32"
    return Val(node("fn2", t, broadcast(a.shape, b.shape), cast_to(a, t),
                    cast_to(b, t), fn="arctan2"))


def cast_to(a: Expr, t: str) -> Expr:
    if a.kind == "const" and a.dtype in (WEAK_INT, WEAK_FLOAT):
        return const(_round_to(float(a.info["value"]), t), t) if t in FLOATS \
            else const(wrap_int(int(a.info["value"]), t), t)
    return cast(a, t)


def _gelu(x, approximate=True):
    if approximate is not True:
        _reject("jax.nn.gelu(approximate=False) (erfc) is outside the "
                "compiled language")
    a = _float_operand(_e(x))
    _literals_only(a)
    v = Val(a)
    c = Val(_typed_const(float(np.sqrt(2 / np.pi)), a))
    cdf = 0.5 * (1.0 + _unary_float("tanh")(c * (v + 0.044715 * (v ** 3))))
    return v * cdf


def _silu(x):
    a = _float_operand(_e(x))
    return Val(a) * _sigmoid(Val(a))


def _logaddexp0(a: Expr) -> Val:
    """lax's logaddexp(x, 0) as jax.nn.softplus computes it."""
    x = Val(a)
    zero = Val(_typed_const(0.0, a))
    amax = _maxmin("max")(x, zero)
    delta = x - zero
    tail = amax + _unary_float("log1p")(_unary_float("exp")(
        -Val(node("fn", a.dtype, a.shape, delta.e, fn="abs"))))
    return _where(Val(node("fn", "bool", a.shape, delta.e, fn="isnan")),
                  x + zero, tail)


def _softplus(x):
    a = _float_operand(_e(x))
    _literals_only(a)
    return _logaddexp0(a)


def _log_sigmoid(x):
    a = _float_operand(_e(x))
    _literals_only(a)
    return -_logaddexp0(negate(a))


def _leaky_relu(x, negative_slope=1e-2):
    v = Val(_e(x))
    _literals_only(v.e)
    return _where(v >= 0, v, negative_slope * v)


def _elu(x, alpha=1.0):
    v = Val(_e(x))
    _literals_only(v.e)
    return _where(v > 0, v, alpha * _unary_float("expm1")(
        _where(v > 0, 0.0, v)))


def _power(x, y):
    return Val(binop("**", x, y))


def _negative(x):
    return Val(negate(_e(x)))


def _round(x, decimals=0):
    if decimals != 0:
        _reject("jnp.round with decimals")
    return _same_type_fn("round", "keep")(x)


# -- indexing and views ---------------------------------------------------------


def _norm_key(key, ndim: int, allow_none: bool):
    """Basic indexing: a tuple of (kind, value) per item, ``...`` expanded;
    kinds 'int', 'slice', 'none'."""
    if not isinstance(key, tuple):
        key = (key,)
    items = []
    for k in key:
        if k is None:
            if not allow_none:
                _reject("None in a Ref's index (JAX raises); index the value")
            items.append(("none", None))
        elif k is Ellipsis:
            items.append(("ellipsis", None))
        elif isinstance(k, slice):
            for part in (k.start, k.stop, k.step):
                if part is not None and _static_int(part) is None:
                    _reject("a slice bound that is not a static integer "
                            "(dynamic slices are queued)")
            items.append(("slice", slice(*(None if p is None else
                                            _static_int(p) for p in
                                            (k.start, k.stop, k.step)))))
        else:
            i = _static_int(k)
            if i is None:
                _reject("an index that is not a static integer, slice, None "
                        "or ...: gathers and advanced indexing are queued")
            items.append(("int", i))
    if sum(1 for kind, _ in items if kind == "ellipsis") > 1:
        _reject("more than one ... in an index")
    used = sum(1 for kind, _ in items if kind in ("int", "slice"))
    if used > ndim:
        _reject(f"too many indices ({used}) for an array of rank {ndim}")
    out = []
    for kind, v in items:
        if kind == "ellipsis":
            out += [("slice", slice(None))] * (ndim - used)
        else:
            out.append((kind, v))
    if not any(kind == "ellipsis" for kind, _ in items):
        out += [("slice", slice(None))] * (ndim - used)
    return out


def _index_spec(shape, key, allow_none):
    """(start per dim, dims of the result: (operand dim or None, step),
    result shape) of basic indexing."""
    items = _norm_key(key, len(shape), allow_none)
    start, dims, out = [0] * len(shape), [], []
    d = 0
    for kind, v in items:
        if kind == "none":
            dims.append((None, 0))
            out.append(1)
            continue
        n = shape[d]
        if kind == "int":
            i = v + n if v < 0 else v
            if not 0 <= i < n:
                _reject(f"index {v} out of range for a dim of {n}")
            start[d] = i
        else:
            if v.step is not None and v.step <= 0:
                _reject("a slice step that is not positive")
            lo, hi, step = v.indices(n)
            size = len(range(lo, hi, step))
            start[d] = lo if size else 0
            dims.append((d, step))
            out.append(size)
        d += 1
    return start, dims, tuple(out)


def view(e: Expr, start, dims, shape) -> Expr:
    """A strided view of ``e`` (see :class:`Expr`), folded into ``e``'s own
    view where ``e`` is one; the identity returns ``e``."""
    shape = tuple(shape)
    if any(s == 0 for s in shape):
        _reject("an empty array")
    if shape == e.shape and not any(start) and list(dims) == [
            (k, 1) for k in range(len(shape))]:
        return e
    if e.kind == "view":
        istart, idims = e.info["start"], e.info["dims"]
        src = e.args[0]
        nstart = list(istart)
        for k1, (d, s1) in enumerate(idims):
            if d is not None:
                nstart[d] += s1 * start[k1]
        ndims = []
        for k1, s2 in dims:
            if k1 is None or idims[k1][0] is None:
                ndims.append((None, 0))
            else:
                ndims.append((idims[k1][0], idims[k1][1] * s2))
        return view(src, nstart, ndims, shape)
    return node("view", e.dtype, shape, e, start=list(start), dims=list(dims))


def index_value(e: Expr, key) -> Expr:
    start, dims, shape = _index_spec(e.shape, key, allow_none=True)
    return view(e, start, dims, shape)


def transpose(e: Expr, axes) -> Expr:
    n = len(e.shape)
    axes = tuple(reversed(range(n))) if axes is None else tuple(
        _axis(a, n) for a in axes)
    if sorted(axes) != list(range(n)):
        _reject(f"transpose axes {axes} for rank {n}")
    return view(e, [0] * n, [(a, 1) for a in axes],
                tuple(e.shape[a] for a in axes))


def _axis(a, n: int) -> int:
    a = _static_int(a)
    if a is None or not -n <= a < max(n, 1):
        _reject(f"axis {a} for rank {n}")
    return a + n if a < 0 else a


def reshape(e: Expr, shape) -> Expr:
    shape = tuple(_static_int(s) for s in shape)
    if any(s is None for s in shape):
        _reject("reshape to a shape that is not static")
    n = math.prod(e.shape)
    if shape.count(-1) > 1:
        _reject("reshape with more than one -1")
    if -1 in shape:
        rest = math.prod(s for s in shape if s != -1)
        shape = tuple(n // rest if s == -1 else s for s in shape)
    if math.prod(shape) != n:
        _reject(f"reshape of {e.shape} to {shape}")
    if shape == e.shape:
        return e
    if [s for s in shape if s != 1] == [s for s in e.shape if s != 1]:
        # only dims of 1 in or out: a view
        big = [d for d, s in enumerate(e.shape) if s != 1]
        dims, j = [], 0
        for s in shape:
            if s == 1:
                dims.append((None, 0))
            else:
                dims.append((big[j], 1))
                j += 1
        return view(e, [0] * len(e.shape), dims, shape)
    if e.kind == "reshape":
        e = e.args[0]
    return node("reshape", e.dtype, shape, e)


def squeeze(e: Expr, axis) -> Expr:
    n = len(e.shape)
    if axis is None:
        axes = [d for d, s in enumerate(e.shape) if s == 1]
    else:
        axes = [_axis(a, n) for a in (axis if isinstance(axis, (tuple, list))
                                      else (axis,))]
        if any(e.shape[a] != 1 for a in axes):
            _reject(f"squeeze of a dim that is not 1 ({e.shape}, {axis})")
    keep = [d for d in range(n) if d not in axes]
    return view(e, [0] * n, [(d, 1) for d in keep],
                tuple(e.shape[d] for d in keep))


def expand_dims(e: Expr, axis) -> Expr:
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    n = len(e.shape) + len(axes)
    axes = sorted(_axis(a, n) for a in axes)
    dims, shape, j = [], [], 0
    for k in range(n):
        if k in axes:
            dims.append((None, 0))
            shape.append(1)
        else:
            dims.append((j, 1))
            shape.append(e.shape[j])
            j += 1
    return view(e, [0] * len(e.shape), dims, tuple(shape))


def broadcast_to(e: Expr, shape) -> Expr:
    shape = tuple(_static_int(s) for s in shape)
    if broadcast(e.shape, shape) != shape:
        _reject(f"broadcast_to of {e.shape} to {shape}")
    pad = len(shape) - len(e.shape)
    dims = [(None, 0) if k < pad or e.shape[k - pad] == 1 else (k - pad, 1)
            for k in range(len(shape))]
    return view(e, [0] * len(e.shape), dims, shape)


# -- reductions ---------------------------------------------------------------


def _axes(axis, n: int):
    if axis is None:
        return tuple(range(n))
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    out = tuple(sorted(_axis(a, n) for a in axes))
    if len(set(out)) != len(out):
        _reject(f"repeated axis in {axis}")
    return out


def reduce(op: str, x, axis=None, keepdims=False, dtype=None) -> Val:
    a = _e(x)
    _literals_only(a)
    if dtype is not None:
        _reject(f"jnp.{op}(dtype=...)")
    if op in ("argmax", "argmin") and isinstance(axis, (tuple, list)):
        _reject(f"jnp.{op} takes one axis")
    n = len(a.shape)
    axes = _axes(axis, n)
    if op in ("argmax", "argmin") and axis is None and n > 1:
        a, axes = reshape(a, (math.prod(a.shape),)), (0,)
        n = 1
    if not axes:
        axes = ()
    kept = tuple(1 if d in axes else s for d, s in enumerate(a.shape)) \
        if keepdims else tuple(s for d, s in enumerate(a.shape)
                               if d not in axes)
    t = {WEAK_INT: "int32", WEAK_FLOAT: "float32"}.get(a.dtype, a.dtype)
    if op in ("sum", "prod"):
        if t == "uint8":
            _reject(f"jnp.{op} of uint8 (a uint32 result)")
        out = t if t in FLOATS else "int32"
        acc = "float32" if t in FLOATS else "int32"
    elif op == "mean":
        out = t if t in FLOATS else "float32"
        acc = "float32"
    elif op in ("max", "min"):
        out = acc = t
        if t == "bool":  # max of bools is any, min all
            op = "any" if op == "max" else "all"
    elif op in ("argmax", "argmin"):
        out, acc = "int32", t
    else:  # any, all
        out = acc = "bool"
    if not axes:  # nothing reduced: jnp still converts
        if op in ("argmax", "argmin"):
            return Val(broadcast_to(const(0, "int32"), kept))
        if op in ("any", "all"):
            return Val(compare("!=", Val(a), 0) if t != "bool" else a)
        return Val(cast(a, out))
    return Val(node("reduce", out, kept, a, op=op, axes=axes, acc=acc,
                    keepdims=bool(keepdims)))


def _softmax(x, axis=-1, where=None, log=False):
    if where is not None:
        _reject("softmax with where=")
    v = Val(_e(x))
    _literals_only(v.e)
    x_max = _JNP.max(v, axis=axis, keepdims=True)
    if log:
        shifted = v - x_max
        return shifted - _JNP.log(_JNP.sum(_JNP.exp(shifted), axis=axis,
                                           keepdims=True))
    unnormalized = _JNP.exp(v - x_max)
    return unnormalized / _JNP.sum(unnormalized, axis=axis, keepdims=True)


# -- products -----------------------------------------------------------------


def _dot_node(a: Expr, b: Expr, shape, out: str) -> Expr:
    """The product of a (B, M, K) and b (B, K, N), viewed as ``shape``
    (the (B, M, N) result with dims of 1 dropped as jnp drops them)."""
    if out == "bool" or "bool" in (a.dtype, b.dtype):
        _reject("a product of bools")
    acc = "float32" if out in FLOATS else "int32"
    d = node("dot", out, (a.shape[0], a.shape[1], b.shape[2]), a, b, acc=acc)
    return reshape(d, shape)


def _product(a: Expr, b: Expr, what: str, out=None) -> Expr:
    _literals_only(a, b)
    t = out or promote(a.dtype, b.dtype)
    if t in (WEAK_INT, WEAK_FLOAT):
        t = "int32" if t == WEAK_INT else "float32"
    ra, rb = len(a.shape), len(b.shape)
    if ra == 0 or rb == 0:
        if what == "@":
            _reject("matmul of a 0-d operand")
        return cast_to(binop("*", Val(a), Val(b)), t)
    if max(ra, rb) > 3 or (what == "dot" and max(ra, rb) > 2):
        _reject(f"{what} of operands of rank {ra} and {rb} (products of "
                "rank above 3 are queued)")
    if a.shape[-1] != (b.shape[0] if rb == 1 else b.shape[-2]):
        _reject(f"{what} of shapes {a.shape} and {b.shape}")
    a, b = cast_to(a, t), cast_to(b, t)
    a3 = expand_dims(a, 0) if ra == 2 else a if ra == 3 else \
        expand_dims(a, (0, 1))
    b3 = expand_dims(b, 0) if rb == 2 else b if rb == 3 else \
        expand_dims(b, (0, 2))
    B = max(a3.shape[0], b3.shape[0])
    if a3.shape[0] != b3.shape[0] and 1 not in (a3.shape[0], b3.shape[0]):
        _reject(f"{what} batch dims {a.shape} and {b.shape}")
    a3 = broadcast_to(a3, (B,) + a3.shape[1:])
    b3 = broadcast_to(b3, (B,) + b3.shape[1:])
    shape = ((B,) if max(ra, rb) == 3 else ()) + \
        ((a.shape[-2],) if ra >= 2 else ()) + ((b.shape[-1],) if rb >= 2
                                               else ())
    return _dot_node(a3, b3, shape, t)


def matmul(x, y, what="matmul") -> Expr:
    return _product(_e(x), _e(y), what)


def _dot(x, y, precision=None, preferred_element_type=None):
    return Val(_product(_e(x), _e(y), "dot",
                        _dtype_arg(preferred_element_type)))


def _dot_general(x, y, dimension_numbers, precision=None,
                 preferred_element_type=None):
    a, b = _e(x), _e(y)
    try:
        (ca, cb), (ba, bb) = dimension_numbers
        form = (tuple(ca), tuple(cb), tuple(ba), tuple(bb))
    except (TypeError, ValueError):
        _reject("dot_general's dimension_numbers")
    if len(a.shape) != 2 or len(b.shape) != 2 or form not in (
            ((1,), (0,), (), ()), ((1,), (1,), (), ())):
        _reject(f"jax.lax.dot_general with {dimension_numbers} on ranks "
                f"{len(a.shape)} and {len(b.shape)} (the 2-D contractions "
                "(((1,), (0,)), ((), ())) and (((1,), (1,)), ((), ())) are "
                "compiled)")
    if form[1] == (1,):
        b = transpose(b, None)
    out = _dtype_arg(preferred_element_type)
    if out is None:
        out = promote(a.dtype, b.dtype)
    return Val(_product(a, b, "dot_general", out))


# -- constructors and loops ---------------------------------------------------


def _full(shape, fill_value, dtype=None):
    if isinstance(shape, int):
        shape = (shape,)
    f = _e(fill_value)
    if f.kind != "const":
        return Val(broadcast_to(cast(f, _dtype_arg(dtype)) if dtype else f,
                                tuple(shape)))
    t = _dtype_arg(dtype) or {WEAK_INT: "int32", WEAK_FLOAT: "float32"}.get(
        f.dtype, f.dtype)
    return Val(broadcast_to(cast_to(f, t), tuple(shape)))


def _fori_loop(lower, upper, body_fun, init_val, unroll=None):
    lo, hi = _static_int(lower), _static_int(upper)
    if lo is None or hi is None:
        _reject("jax.lax.fori_loop bounds that are not static")
    v = init_val
    for i in range(lo, hi):
        v = body_fun(Val(const(i, "int32")), v)
    return v


class _Namespace:
    """A module of the body (``jnp``, ``jax``, ``jax.nn``, ``jax.lax``):
    its functions, and MXNetError for any other name."""

    def __init__(self, path, queued=None, **members):
        self._path, self._queued = path, queued or {}
        self.__dict__.update(members)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        why = self._queued.get(name, "outside the compiled language")
        _reject(f"{self._path}.{name}: function {why}")


_QUEUED = {n: "queued (gathers and advanced indexing)" for n in
           ("take", "take_along_axis")}
_QUEUED.update({n: "queued (scans)" for n in ("cumsum", "cumprod")})
_QUEUED.update({n: "queued (sorting)" for n in ("sort", "argsort")})
_QUEUED["einsum"] = "queued (einsum)"
_QUEUED.update({n: "queued (fp64 and complex types)" for n in
                ("complex64", "complex128", "int64")})
_LAX_QUEUED = {n: "queued (lax control flow)" for n in
               ("while_loop", "cond", "scan", "switch")}
_LAX_QUEUED.update({"cumsum": "queued (scans)"})

def _reduction(op):
    return lambda x, axis=None, keepdims=False, dtype=None, **kw: (
        _no_kw(kw, op), reduce(op, x, axis, keepdims, dtype))[1]


def _no_kw(kw, what):
    if kw:
        _reject(f"{what} with {sorted(kw)}")


_JNP = _Namespace(
    "jnp", _QUEUED,
    exp=_unary_float("exp"), log=_unary_float("log"),
    log1p=_unary_float("log1p"), expm1=_unary_float("expm1"),
    sqrt=_unary_float("sqrt"), tanh=_unary_float("tanh"),
    sin=_unary_float("sin"), cos=_unary_float("cos"),
    tan=_unary_float("tan"), arcsin=_unary_float("arcsin"),
    arccos=_unary_float("arccos"), arctan=_unary_float("arctan"),
    sinh=_unary_float("sinh"), cosh=_unary_float("cosh"),
    exp2=_unary_float("exp2"), log2=_log2, log10=_log10,
    arctan2=_arctan2, abs=_abs, square=_square, sign=_sign,
    floor=_same_type_fn("floor", "keep"), ceil=_same_type_fn("ceil", "keep"),
    trunc=_same_type_fn("trunc", "keep"), round=_round,
    maximum=_maxmin("max"), minimum=_maxmin("min"), where=_where,
    clip=_clip, power=_power, reciprocal=_reciprocal, negative=_negative,
    isnan=_isfn("isnan"), isinf=_isfn("isinf"), isfinite=_isfn("isfinite"),
    logical_and=_logical("&"), logical_or=_logical("|"),
    logical_not=_logical("not"),
    mod=lambda x, y: Val(binop("%", x, y)),
    floor_divide=lambda x, y: Val(binop("//", x, y)),
    sum=_reduction("sum"), mean=_reduction("mean"), max=_reduction("max"),
    min=_reduction("min"), prod=_reduction("prod"),
    argmax=_reduction("argmax"), argmin=_reduction("argmin"),
    any=_reduction("any"), all=_reduction("all"),
    dot=_dot, matmul=lambda x, y: Val(matmul(x, y)),
    transpose=lambda x, axes=None: Val(transpose(_e(x), axes)),
    reshape=lambda x, shape: Val(reshape(_e(x), tuple(shape) if isinstance(
        shape, (tuple, list)) else (shape,))),
    expand_dims=lambda x, axis: Val(expand_dims(_e(x), axis)),
    squeeze=lambda x, axis=None: Val(squeeze(_e(x), axis)),
    broadcast_to=lambda x, shape: Val(broadcast_to(_e(x), shape)),
    zeros=lambda shape, dtype=None: _full(shape, 0.0 if dtype is None else 0,
                                          dtype),
    ones=lambda shape, dtype=None: _full(shape, 1.0 if dtype is None else 1,
                                         dtype),
    full=_full,
    zeros_like=lambda x, dtype=None: _full(_e(x).shape, 0, dtype or
                                           Val(_e(x)).dtype),
    ones_like=lambda x, dtype=None: _full(_e(x).shape, 1, dtype or
                                          Val(_e(x)).dtype),
    full_like=lambda x, fill_value, dtype=None: _full(
        _e(x).shape, fill_value, dtype or Val(_e(x)).dtype),
    pi=math.pi, e=math.e, inf=math.inf, nan=math.nan,
    float32=_DT["float32"], bfloat16=_DT["bfloat16"],
    float16=_DT["float16"], int32=_DT["int32"], int16=_DT["int16"],
    int8=_DT["int8"], uint8=_DT["uint8"], bool_=_DT["bool"],
    float64=_DT["float64"])

_NN = _Namespace(
    "jax.nn", {"one_hot": "queued (gathers and advanced indexing)"},
    sigmoid=_sigmoid, relu=_relu, gelu=_gelu, silu=_silu, swish=_silu,
    softplus=_softplus, log_sigmoid=_log_sigmoid, leaky_relu=_leaky_relu,
    elu=_elu, softmax=lambda x, axis=-1, where=None: _softmax(x, axis, where),
    log_softmax=lambda x, axis=-1, where=None: _softmax(x, axis, where,
                                                        log=True))
_LAX = _Namespace(
    "jax.lax", _LAX_QUEUED, fori_loop=_fori_loop, dot_general=_dot_general,
    rsqrt=_unary_float("rsqrt"), erf=_unary_float("erf"),
    exp=_unary_float("exp"), tanh=_unary_float("tanh"),
    logistic=_sigmoid, max=_maxmin("max"), min=_maxmin("min"))
_JAX = _Namespace("jax", {"random": "queued (random numbers)"}, nn=_NN,
                  lax=_LAX, numpy=_JNP)


class Ref:
    """A Ref of the body: an input (read only) or an output, whose value
    moves on with each store."""

    def __init__(self, name, shape, dtype, value: Expr, writable: bool):
        self._name, self._shape, self._dtype = name, tuple(shape), dtype
        self._value, self._writable = value, writable

    shape = property(lambda self: self._shape)
    ndim = property(lambda self: len(self._shape))
    dtype = property(lambda self: _DT[self._dtype])
    size = property(lambda self: math.prod(self._shape))

    def __len__(self):
        if not self._shape:
            _reject("len() of a 0-d Ref")
        return self._shape[0]

    def _key(self, key):
        if isinstance(key, slice) and not self._shape:
            _reject("a 0-d Ref is indexed as x[...]")
        return _index_spec(self._shape, key, allow_none=False)

    def __getitem__(self, key):
        start, dims, shape = self._key(key)
        return Val(view(self._value, start, dims, shape))

    def __setitem__(self, key, value):
        if not self._writable:
            _reject("only output Refs are written")
        start, dims, shape = self._key(key)
        v = _e(value)
        if v.shape != shape:
            _reject(f"value of shape {v.shape} stored into a region of shape "
                    f"{shape} (JAX raises: Invalid shape for swap)")
        if v.dtype in (WEAK_INT, WEAK_FLOAT) and \
                promote(v.dtype, self._dtype) == self._dtype:
            v = cast_to(v, self._dtype)
        if v.dtype != self._dtype:
            _reject(f"value of dtype {Val(v).dtype} stored into a "
                    f"{self._dtype} Ref (JAX raises: Invalid dtype for swap);"
                    " convert with .astype(...)")
        full = shape == self._shape and not any(start) and dims == [
            (k, 1) for k in range(len(shape))]
        if full:
            self._value = v
            return
        region = []
        steps = {d: (k, s) for k, (d, s) in enumerate(dims)}
        for d, n in enumerate(self._shape):
            if d in steps:
                k, s = steps[d]
                region.append((start[d], s, shape[k], True))
            else:
                region.append((start[d], 1, 1, False))
        self._value = node("store", self._dtype, self._shape, self._value, v,
                           region=tuple(region))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        _reject(f"Ref attribute .{name} outside the compiled language")


# -- the body as a whole ----------------------------------------------------------

# statements of the body: Python runs them, so these are all checked here
_STATEMENTS = (ast.Assign, ast.AugAssign, ast.For, ast.If, ast.FunctionDef,
               ast.Return, ast.Pass, ast.Break, ast.Continue)
_BUILTINS = {"range": range, "len": len, "int": int, "float": float,
             "abs": abs, "min": min, "max": max, "tuple": tuple,
             "list": list, "enumerate": enumerate, "zip": zip,
             "True": True, "False": False, "None": None}


def _check_statements(tree):
    for st in ast.walk(tree):
        if isinstance(st, ast.stmt) and st is not tree:
            if isinstance(st, ast.Expr) and (
                    isinstance(st.value, ast.Constant)
                    or isinstance(st.value, ast.Call)
                    and isinstance(st.value.func, ast.Attribute)
                    and st.value.func.attr == "fori_loop"):
                continue  # a docstring, or a loop run for its stores
            if isinstance(st, ast.While):
                raise _Located("a `while` statement: static `for` loops over "
                               "range(...) only (lax.while_loop is queued)",
                               st)
            if not isinstance(st, _STATEMENTS):
                raise _Located("statements are assignments `out[:] = ...` or "
                               "`name = ...`, `for` over range(...), `if`, "
                               "`def` and `return`", st)
            if isinstance(st, ast.For) and not (
                    isinstance(st.iter, ast.Call)
                    and isinstance(st.iter.func, ast.Name)
                    and st.iter.func.id == "range"):
                raise _Located("a `for` loop over something else than "
                               "range(...)", st)
            if isinstance(st, ast.FunctionDef) and st.decorator_list:
                raise _Located("a decorated function", st)
            for t in getattr(st, "targets", [getattr(st, "target", None)]):
                if isinstance(t, ast.Name) and t.id in ("jnp", "jax", "np"):
                    raise _Located("this name is a Ref or a module", st)


class _Located(Exception):
    def __init__(self, why, st):
        super().__init__(why)
        self.why, self.lineno = why, st.lineno


def _message(why: str, lineno, lines) -> str:
    where = ""
    if lineno is not None and 1 <= lineno <= len(lines):
        where = f": `{lines[lineno - 1].strip()}` (line {lineno})"
    return (f"Rtc body: {why}{where}. The port compiles the body language "
            f"stated in mxnet_tpu_torch/rtc.py; the rest is queued at "
            f"{QUEUE_ENTRY}")


def _trace(fn, args, filename: str):
    """``fn(*args)`` with every statement of the body counted: past
    MAX_STATEMENTS it raises."""
    count = [0]

    def local(frame, event, arg):
        if event == "line":
            count[0] += 1
            if count[0] > MAX_STATEMENTS:
                raise _Reject(f"the body unrolls past {MAX_STATEMENTS} "
                              "statements")
        return local

    def calls(frame, event, arg):
        return local if frame.f_code.co_filename == filename else None

    old = sys.gettrace()
    sys.settrace(calls)
    try:
        return fn(*args)
    finally:
        sys.settrace(old)


def analyze(name: str, inputs: Sequence[Tuple[str, tuple, str]],
            outputs: Sequence[Tuple[str, tuple, str]], body: str) -> Program:
    """Run ``body`` over symbolic Refs and return its program. Raises
    MXNetError on a syntax error or any construct outside the language."""
    text = textwrap.dedent(body).strip() + "\n"
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        raise MXNetError(f"Rtc kernel {name!r} failed to parse: {e}")
    lines = text.splitlines()
    for n, _, dt in list(inputs) + list(outputs):
        if dt not in DTYPES:
            raise MXNetError(f"Rtc {name!r}: Ref {n!r} has dtype {dt}; the "
                             f"compiled language takes {DTYPES} (fp64 and "
                             f"complex types are queued at {QUEUE_ENTRY})")
    names = [n for n, _, _ in list(inputs) + list(outputs)]
    if len(set(names)) != len(names):
        raise MXNetError(f"Rtc {name!r}: Ref names must be distinct")
    for n, s, _ in list(inputs) + list(outputs):
        if any(d == 0 for d in s):
            raise MXNetError(f"Rtc {name!r}: Ref {n!r} of shape {tuple(s)} "
                             "is empty")
    try:
        _check_statements(tree)
    except _Located as e:
        raise MXNetError(_message(e.why, e.lineno, lines))
    filename = f"<rtc-analysis:{name}>"
    src = (f"def _rtc_kernel({', '.join(names)}):\n"
           + textwrap.indent(text, "    "))
    scope = {"jnp": _JNP, "jax": _JAX, "np": np,
             "__builtins__": dict(_BUILTINS)}
    exec(compile(src, filename, "exec"), scope)
    refs = [Ref(n, s, dt, node("in", dt, tuple(s), name=n), False)
            for n, s, dt in inputs]
    outs = [Ref(n, s, dt, node("fill", dt, tuple(s)), True)
            for n, s, dt in outputs]
    try:
        _trace(scope["_rtc_kernel"], refs + outs, filename)
    except MXNetError:
        raise
    except (_Reject, Exception) as e:
        why = str(e) if isinstance(e, _Reject) else \
            f"unknown name {e.name!r} (Refs are read as x[:])" if \
            isinstance(e, NameError) else f"{type(e).__name__}: {e}"
        lineno = None
        tb = e.__traceback__
        while tb is not None:
            if tb.tb_frame.f_code.co_filename == filename:
                lineno = tb.tb_lineno - 1
            tb = tb.tb_next
        raise MXNetError(_message(why, lineno, lines)) from None
    finals = {r._name: r._value for r in outs}
    return Program(name, [(n, tuple(s), dt) for n, s, dt in inputs],
                   [(n, tuple(s), dt) for n, s, dt in outputs], finals,
                   ast.unparse(tree))

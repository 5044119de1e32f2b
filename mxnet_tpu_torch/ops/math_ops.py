"""Elementwise, scalar, broadcast, reduction and dot operators.

Counterpart of ``mxnet_tpu/ops/math_ops.py``: the same names, aliases,
attr specs and input names, each op a torch composition with the JAX
package's numerics where torch's defaults differ:

* a ``*_scalar`` op casts its scalar to the array's dtype first, so an
  int32 ``x + 1.5`` is ``x + 1`` in int32 and a bf16 ``x * 0.1`` multiplies
  by bf16(0.1);
* two arrays promote as jnp does (``torch.promote_types``), whatever their
  rank: a 0-d fp32 array does not give way to a bf16 one;
* ``round`` rounds half to even, ``fix`` truncates, ``sign`` keeps NaN and
  -0, ``gamma`` is ``exp(gammaln(x))``, ``mod`` is floor-mod and an integer
  ``x % 0`` is 0, as in jnp;
* integer sums and products stay int32; ``argmax``/``argmin``/
  ``argmax_channel`` return float32; ``norm`` accumulates in fp32;
* ``dot``/``batch_dot`` run fp32 in fp32 (TF32 is off on the card, see
  ``context.py``).
"""
from __future__ import annotations

import torch

from ..base import AttrSpec
from ..dtypes import torch_dtype
from .registry import alias, register


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


def _float(t: torch.Tensor) -> torch.Tensor:
    """jnp's promote_args_inexact: integers and bools become float32."""
    return t if _is_float(t) else t.to(torch.float32)


def _promote(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _sign(x):
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _cbrt(x):
    x = _float(x)
    return torch.copysign(torch.abs(x) ** (1.0 / 3.0), x)


def _logical_not(x):
    return (x == 0).to(x.dtype)


# ---------------------------------------------------------------------------
# unary elementwise (reference elemwise_unary_op.cc, mshadow_op.h functors)
# ---------------------------------------------------------------------------

_UNARY = {
    "relu": lambda x: torch.maximum(x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)),
    "sigmoid": lambda x: torch.sigmoid(_float(x)),
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "exp": lambda x: torch.exp(_float(x)),
    "log": lambda x: torch.log(_float(x)),
    "log2": lambda x: torch.log2(_float(x)),
    "log10": lambda x: torch.log10(_float(x)),
    "log1p": lambda x: torch.log1p(_float(x)),
    "expm1": lambda x: torch.expm1(_float(x)),
    "sqrt": lambda x: torch.sqrt(_float(x)),
    "rsqrt": lambda x: torch.rsqrt(_float(x)),
    "square": torch.square,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "abs": torch.abs,
    "sign": _sign,
    "round": torch.round,  # half to even, as jnp.round
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    # exp(gammaln(x)) as the JAX package has it: |gamma|, sign lost for x < 0
    "gamma": lambda x: torch.exp(torch.lgamma(_float(x))),
    "gammaln": lambda x: torch.lgamma(_float(x)),
    "erf": lambda x: torch.erf(_float(x)),
    "sin": lambda x: torch.sin(_float(x)),
    "cos": lambda x: torch.cos(_float(x)),
    "tan": lambda x: torch.tan(_float(x)),
    "arcsin": lambda x: torch.asin(_float(x)),
    "arccos": lambda x: torch.acos(_float(x)),
    "arctan": lambda x: torch.atan(_float(x)),
    "sinh": lambda x: torch.sinh(_float(x)),
    "cosh": lambda x: torch.cosh(_float(x)),
    "tanh": lambda x: torch.tanh(_float(x)),
    "arcsinh": lambda x: torch.asinh(_float(x)),
    "arccosh": lambda x: torch.acosh(_float(x)),
    "arctanh": lambda x: torch.atanh(_float(x)),
    "degrees": lambda x: torch.rad2deg(_float(x)),
    "radians": lambda x: torch.deg2rad(_float(x)),
    "reciprocal": lambda x: 1.0 / x,
    "negative": torch.neg,
    "logical_not": _logical_not,
}

for _name, _impl in _UNARY.items():
    register(_name)((lambda impl: (lambda x: impl(x)))(_impl))

register("identity", aliases=["_copy"])(lambda x: x)

# stop_gradient: reference BlockGrad / make_loss
register("BlockGrad", aliases=["stop_gradient"])(lambda x: x.detach())
register("make_loss", aliases=["MakeLoss"])(lambda x: x)


@register("Cast", aliases=["cast"], attrs=AttrSpec(dtype=("str",)))
def _cast(x, dtype):
    return x.to(torch_dtype(dtype))


@register("clip", attrs=AttrSpec(a_min=("float",), a_max=("float",)))
def _clip(x, a_min, a_max):
    """jnp.clip: maximum(a_min, x), then minimum(a_max, .); float bounds
    make an integer array float32."""
    dt = x.dtype if _is_float(x) else torch.float32
    lo = torch.tensor(a_min, dtype=dt, device=x.device)
    hi = torch.tensor(a_max, dtype=dt, device=x.device)
    return torch.minimum(hi, torch.maximum(lo, x.to(dt)))


# ---------------------------------------------------------------------------
# binary elementwise and broadcast (torch broadcasts natively, so the
# same-shape and broadcast families share one implementation)
# ---------------------------------------------------------------------------

def _mod(a, b):
    """jnp.mod (floor remainder); an integer divisor of 0 gives 0."""
    a, b = _promote(a, b)
    if not _is_float(b):
        b = torch.where(b == 0, torch.ones_like(b), b)
    return torch.remainder(a, b)


def _power(a, b):
    if _is_float(a) and not _is_float(b):
        return torch.pow(a, b)  # float base, integer power: base dtype
    return torch.pow(*_promote(a, b))


def _hypot(a, b):
    a, b = _promote(a, b)
    return torch.hypot(_float(a), _float(b))


def _binary(fn):
    return lambda a, b: fn(*_promote(a, b))


_BINARY = {
    "add": _binary(torch.add),
    "sub": _binary(torch.sub),
    "mul": _binary(torch.mul),
    "div": _binary(torch.true_divide),
    "mod": _mod,
    "power": _power,
    "maximum": _binary(torch.maximum),
    "minimum": _binary(torch.minimum),
    "hypot": _hypot,
}
_BINARY_CMP = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
}

for _name, _impl in _BINARY.items():
    register("elemwise_" + _name if _name in ("add", "sub", "mul", "div") else "_" + _name,
             num_inputs=2, input_names=["lhs", "rhs"])(
        (lambda impl: (lambda a, b: impl(a, b)))(_impl))
    register("broadcast_" + _name, num_inputs=2, input_names=["lhs", "rhs"])(
        (lambda impl: (lambda a, b: impl(a, b)))(_impl))
for _name, _impl in _BINARY_CMP.items():
    register("_" + _name, num_inputs=2, input_names=["lhs", "rhs"])(
        (lambda impl: (lambda a, b: impl(*_promote(a, b)).to(a.dtype)))(_impl))
    register("broadcast_" + _name, num_inputs=2, input_names=["lhs", "rhs"])(
        (lambda impl: (lambda a, b: impl(*_promote(a, b)).to(a.dtype)))(_impl))

for _a, _b in [("_plus", "elemwise_add"), ("_add", "elemwise_add"),
               ("_minus", "elemwise_sub"), ("_sub", "elemwise_sub"),
               ("_mul", "elemwise_mul"), ("_div", "elemwise_div"),
               ("_grad_add", "elemwise_add"), ("_mod", "broadcast_mod"),
               ("_Power", "_power"), ("_Maximum", "_maximum"),
               ("_Minimum", "_minimum"),
               ("broadcast_plus", "broadcast_add"),
               ("broadcast_minus", "broadcast_sub")]:
    alias(_a, _b)


def _scalar_op(impl, reverse=False):
    """The scalar is cast to the array's dtype first (jnp.asarray(scalar,
    dtype=x.dtype)), then the op runs on two arrays of that dtype."""
    def f(x, scalar):
        s = torch.tensor(scalar, dtype=x.dtype, device=x.device)
        return impl(s, x) if reverse else impl(x, s)
    return f


_SCALAR_SPEC = AttrSpec(scalar=("float",))
for _name, _impl, _rev in [
    ("_plus_scalar", _BINARY["add"], False),
    ("_minus_scalar", _BINARY["sub"], False),
    ("_rminus_scalar", _BINARY["sub"], True),
    ("_mul_scalar", _BINARY["mul"], False),
    ("_div_scalar", _BINARY["div"], False),
    ("_rdiv_scalar", _BINARY["div"], True),
    ("_mod_scalar", _mod, False),
    ("_rmod_scalar", _mod, True),
    ("_power_scalar", lambda a, b: torch.pow(a, b), False),
    ("_rpower_scalar", lambda a, b: torch.pow(a, b), True),
    ("_maximum_scalar", _BINARY["maximum"], False),
    ("_minimum_scalar", _BINARY["minimum"], False),
    ("_hypot_scalar", _hypot, False),
]:
    register(_name, attrs=_SCALAR_SPEC)(_scalar_op(_impl, _rev))
for _name, _impl in [
    ("_equal_scalar", torch.eq),
    ("_not_equal_scalar", torch.ne),
    ("_greater_scalar", torch.gt),
    ("_greater_equal_scalar", torch.ge),
    ("_lesser_scalar", torch.lt),
    ("_lesser_equal_scalar", torch.le),
]:
    register(_name, attrs=_SCALAR_SPEC)(
        (lambda impl: (lambda x, scalar: impl(x, scalar).to(x.dtype)))(_impl))


@register("smooth_l1", attrs=AttrSpec(scalar=("float", 1.0)))
def _smooth_l1(x, scalar):
    s2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


# n-ary sum (reference elemwise_sum.cc ElementWiseSum / add_n)
@register("add_n", aliases=["ElementWiseSum", "_sum"], key_var_num_args="num_args",
          attrs=AttrSpec(num_args=("int", 0)))
def _add_n(*args, num_args=0):
    out = args[0]
    for a in args[1:]:
        out = _BINARY["add"](out, a)
    return out


# ---------------------------------------------------------------------------
# reductions (broadcast_reduce_op_*.cc)
# ---------------------------------------------------------------------------

_REDUCE_SPEC = AttrSpec(axis=("tuple", None), keepdims=("bool", False),
                        exclude=("bool", False))


def _norm_axes(axis, ndim, exclude):
    if axis is None:
        return None
    axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(i for i in range(ndim) if i not in axes)
    return axes


def _sum_dtype(x):
    """jnp.sum/prod keep int32 (torch widens to int64); bool sums to int32."""
    return torch.int32 if x.dtype in (torch.bool, torch.int32) else x.dtype


def _sum(x, axes, keepdims):
    return torch.sum(x, dim=axes, keepdim=keepdims).to(_sum_dtype(x))


def _mean(x, axes, keepdims):
    return torch.mean(_float(x), dim=axes, keepdim=keepdims)


def _prod(x, axes, keepdims):
    if axes is None:
        out = torch.prod(x)
        out = out.reshape((1,) * x.dim()) if keepdims else out
    else:  # torch.prod takes one dim at a time
        out = x
        for a in sorted(axes, reverse=True):
            out = torch.prod(out, dim=a, keepdim=keepdims)
    return out.to(_sum_dtype(x))


def _nansum(x, axes, keepdims):
    return torch.nansum(x, dim=axes, keepdim=keepdims).to(_sum_dtype(x))


def _nanprod(x, axes, keepdims):
    if _is_float(x):
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, axes, keepdims)


def _amax(x, axes, keepdims):
    return torch.amax(x, dim=() if axes is None else axes, keepdim=keepdims)


def _amin(x, axes, keepdims):
    return torch.amin(x, dim=() if axes is None else axes, keepdim=keepdims)


def _reduce_op(impl):
    def f(x, axis=None, keepdims=False, exclude=False):
        axes = _norm_axes(axis, x.dim(), exclude)
        if axes == ():
            # jnp reduces over no axis: the array itself, in the result dtype
            return impl(x.unsqueeze(0), (0,), False)
        return impl(x, axes, keepdims)
    return f


for _name, _impl in [("sum", _sum), ("mean", _mean), ("prod", _prod),
                     ("nansum", _nansum), ("nanprod", _nanprod),
                     ("max", _amax), ("min", _amin)]:
    register(_name, attrs=_REDUCE_SPEC)(_reduce_op(_impl))
alias("sum_axis", "sum")
alias("max_axis", "max")
alias("min_axis", "min")


@register("_square_sum", attrs=_REDUCE_SPEC)
def _square_sum_op(data, axis=None, keepdims=False, exclude=False):
    """sum(data**2) over axes (reference square_sum-inl.h)."""
    return _reduce_op(_sum)(data * data, axis, keepdims, exclude)


@register("norm")
def _norm(x):
    # the L2 norm of the flattened array, accumulated in fp32
    return torch.sqrt(torch.sum(torch.square(x.to(torch.float32)))).to(x.dtype)


_ARG_SPEC = AttrSpec(axis=("any", None), keepdims=("bool", False))


def _arg_reduce(impl):
    def f(x, axis=None, keepdims=False):
        if axis is None:
            out = impl(x.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * x.dim())
            return out.to(torch.float32)
        axis_i = int(axis)
        return impl(x, dim=axis_i, keepdim=keepdims).to(torch.float32)
    return f


register("argmax", attrs=_ARG_SPEC)(_arg_reduce(torch.argmax))
register("argmin", attrs=_ARG_SPEC)(_arg_reduce(torch.argmin))


@register("argmax_channel")
def _argmax_channel(x):
    return torch.argmax(x, dim=-1).to(torch.float32)


@register("broadcast_to", attrs=AttrSpec(shape=("tuple",)))
def _broadcast_to(x, shape):
    target = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
    return x.expand(target)


@register("broadcast_axis", aliases=["broadcast_axes"],
          attrs=AttrSpec(axis=("tuple", ()), size=("tuple", ())))
def _broadcast_axis(x, axis, size):
    target = list(x.shape)
    for a, s in zip(axis, size):
        target[a % x.dim()] = s
    return x.expand(tuple(target))


# ---------------------------------------------------------------------------
# dot / batch_dot (dot-inl.h); torch.matmul, fp32 without TF32
# ---------------------------------------------------------------------------

_DOT_SPEC = AttrSpec(transpose_a=("bool", False), transpose_b=("bool", False))


@register("dot", num_inputs=2, input_names=["lhs", "rhs"], attrs=_DOT_SPEC)
def _dot(a, b, transpose_a=False, transpose_b=False):
    a, b = _promote(a, b)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    if transpose_a and a.dim() > 1:
        a = torch.movedim(a, 0, -1)
    if transpose_b and b.dim() > 1:
        b = torch.movedim(b, -1, 0)
    # contract the last axis of a with the first axis of b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot", num_inputs=2, input_names=["lhs", "rhs"], attrs=_DOT_SPEC)
def _batch_dot(a, b, transpose_a=False, transpose_b=False):
    a, b = _promote(a, b)
    if transpose_a:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b:
        b = torch.swapaxes(b, -1, -2)
    return torch.matmul(a, b)


@register("L2Normalization",
          attrs=AttrSpec(eps=("float", 1e-10), mode=("str", "instance")))
def _l2_normalization(x, eps, mode):
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, x.dim()))
    else:
        raise ValueError(f"unknown L2Normalization mode {mode}")
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True) + eps)
    return x / norm


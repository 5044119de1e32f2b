"""Parity of the PyTorch port's imperative ``nd`` path with the JAX package.

The same numpy inputs, made from a seed, go through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd`` on the CPU: every op of the math and tensor tables
in one table-driven test per family, the traps where torch's defaults
differ from jnp's as their own cases, the op table's contract, the NDArray
semantics (write versions, views, ``out=``), ``save``/``load`` across the
two packages, and the TF32 switch in ``context.py``.

The JAX package is run as its users run it, with x64 off
(``jax.enable_x64(False)`` around each reference call: the suite's
conftest turns x64 on for the JAX package's own float64 checks).

Tolerances: arithmetic, comparisons, rounding, indexing and ordering are
exact (``assert_array_equal``); functions computed by a library's
approximation (exp, log, tanh, erf, gamma, ...) differ between XLA's and
torch's CPU implementations by a few fp32 ulps, so they are held to
rtol 1e-5; reductions and products, summed in another order, to rtol
1e-5 / atol 1e-6.
"""
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import context as port_context
from mxnet_tpu_torch import nd as pnd
from mxnet_tpu_torch.base import MXNetError

EXACT = dict(rtol=0, atol=0)
LIBM = dict(rtol=1e-5, atol=1e-6)
SUM = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def ref():
    import jax
    import mxnet_tpu
    from mxnet_tpu.ops.registry import OP_TABLE
    return types.SimpleNamespace(mx=mxnet_tpu, nd=mxnet_tpu.nd,
                                 table=OP_TABLE,
                                 x32=lambda: jax.enable_x64(False))


def _arrays(seed, *specs):
    rng = np.random.RandomState(seed)
    out = []
    for shape, kind in specs:
        if kind == "normal":
            out.append(rng.normal(0, 2, shape).astype(np.float32))
        elif kind == "pos":
            out.append(rng.uniform(0.1, 4, shape).astype(np.float32))
        elif kind == "unit":
            out.append(rng.uniform(-0.95, 0.95, shape).astype(np.float32))
        elif kind == "ge1":
            out.append(rng.uniform(1.05, 4, shape).astype(np.float32))
        elif kind == "int":
            out.append(rng.randint(-9, 10, shape).astype(np.int32))
        elif kind == "idx":
            out.append(rng.randint(-2, 7, shape).astype(np.float32))
        elif kind == "half":  # exact halves: the rounding traps
            out.append((rng.randint(-8, 9, shape) + 0.5).astype(np.float32))
        else:
            raise ValueError(kind)
    return out


CASES = []  # (family, label, op name, input arrays, attrs, tolerance)


def _add(family, name, arrays, attrs=None, tol=EXACT, label=None):
    CASES.append((family, label or name, name, arrays, dict(attrs or {}), tol))


def _ids(family):
    return [i for i, c in enumerate(CASES) if c[0] == family]


def _label(i):
    return f"{CASES[i][1]}-{i}"


# -- unary ------------------------------------------------------------------

UNARY = {
    "relu": "normal", "sigmoid": "normal", "softsign": "normal",
    "exp": "normal", "log": "pos", "log2": "pos", "log10": "pos",
    "log1p": "pos", "expm1": "normal", "sqrt": "pos", "rsqrt": "pos",
    "square": "normal", "cbrt": "normal", "rcbrt": "pos", "abs": "normal",
    "sign": "normal", "round": "half", "rint": "half", "ceil": "normal",
    "floor": "normal", "trunc": "normal", "fix": "half", "gamma": "normal",
    "gammaln": "pos", "erf": "normal", "sin": "normal", "cos": "normal",
    "tan": "unit", "arcsin": "unit", "arccos": "unit", "arctan": "normal",
    "sinh": "unit", "cosh": "unit", "tanh": "normal", "arcsinh": "normal",
    "arccosh": "ge1", "arctanh": "unit", "degrees": "normal",
    "radians": "normal", "reciprocal": "pos", "negative": "normal",
    "logical_not": "int", "identity": "normal", "_copy": "normal",
    "BlockGrad": "normal", "stop_gradient": "normal", "make_loss": "normal",
    "MakeLoss": "normal",
}
_EXACT_UNARY = {"relu", "abs", "sign", "round", "rint", "ceil", "floor",
                "trunc", "fix", "negative", "logical_not", "identity",
                "_copy", "BlockGrad", "stop_gradient", "make_loss",
                "MakeLoss", "square", "softsign", "reciprocal"}
for _n in sorted(UNARY):
    _add("unary", _n, _arrays(len(_n), ((3, 5), UNARY[_n])),
         tol=EXACT if _n in _EXACT_UNARY else LIBM)
# round half to even, fix truncates, gamma loses the sign, int stays int
for _n, _v, _dt in [
        ("round", [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32),
        ("fix", [-2.7, -0.5, 0.5, 2.7], np.float32),
        ("gamma", [-2.5, -1.5, -0.5, 0.5, 3.0], np.float32),
        ("sign", [-3, 0, 4], np.int32), ("square", [-3, 7], np.int32),
        ("sqrt", [4, 9], np.int32), ("floor", [-3, 7], np.int32)]:
    _add("unary_trap", _n, [np.array(_v, _dt)], tol=LIBM if _n == "gamma" else EXACT)

# -- binary, broadcast and scalar -------------------------------------------

BINARY = ["add", "sub", "mul", "div", "mod", "power", "maximum", "minimum",
          "hypot"]
CMP = ["equal", "not_equal", "greater", "greater_equal", "lesser",
       "lesser_equal"]
_SAME_SHAPE = ([f"elemwise_{n}" for n in ("add", "sub", "mul", "div")]
               + ["_" + n for n in BINARY if n not in ("add", "sub", "mul", "div")]
               + ["_" + n for n in CMP])
_BROADCAST = ["broadcast_" + n for n in BINARY + CMP]
for _n in sorted(_SAME_SHAPE + _BROADCAST):
    _kind = "pos" if "power" in _n else "normal"
    _shapes = ((3, 4), (1, 4)) if _n in _BROADCAST else ((3, 4), (3, 4))
    _a, _b = _arrays(len(_n), (_shapes[0], _kind), (_shapes[1], _kind))
    _b[0, :2] = _a[0, :2]  # equal pairs for the comparisons
    _add("binary", _n, [_a, _b],
         tol=LIBM if any(k in _n for k in ("power", "hypot", "mod")) else EXACT)
# floor-mod and int32 division by zero; int32 promotion; 0-d operands
for _n, _a, _b in [
        ("broadcast_mod", np.array([-3, -1, 2, 5], np.int32),
         np.array([2, -2, 0, 3], np.int32)),
        ("broadcast_mod", np.array([-3.5, -1.0, 2.0, 5.5], np.float32),
         np.array([2.0, -2.0, 0.75, 3.0], np.float32)),
        ("broadcast_div", np.array([-3, -1, 2, 5], np.int32),
         np.array([2, -2, 4, 3], np.int32)),
        ("broadcast_add", np.array([1.5, 2.5], np.float32), np.array(2, np.int32)),
        ("broadcast_mul", np.array(3.0, np.float32), np.array([1, 2], np.int32))]:
    _add("binary_trap", _n, [_a, _b], tol=LIBM if "div" in _n else EXACT)

SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
          "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
          "_power_scalar", "_rpower_scalar", "_maximum_scalar",
          "_minimum_scalar", "_hypot_scalar", "_equal_scalar",
          "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
          "_lesser_scalar", "_lesser_equal_scalar"]
for _n in SCALAR:
    for _dt in ("float32", "int32"):
        if _dt == "int32" and _n in ("_hypot_scalar", "_rpower_scalar"):
            continue  # float-only ops
        (_x,) = _arrays(len(_n), ((3, 4), "pos" if "pow" in _n else "normal"))
        # 1.5 casts to the array's dtype first: int32 x + 1.5 is x + 1
        _add("scalar", _n, [_x.astype(_dt)], {"scalar": 1.5}, label=f"{_n}-{_dt}",
             tol=LIBM if any(k in _n for k in ("pow", "hypot", "div", "mod"))
             else EXACT)

_a, _b, _c = _arrays(5, ((3, 4), "normal"), ((3, 4), "normal"), ((3, 4), "normal"))
_add("misc", "smooth_l1", [_a], {"scalar": 1.3})
for _n in ("add_n", "ElementWiseSum", "_sum"):
    _add("misc", _n, [_a, _b, _c])
_add("misc", "clip", [_a], {"a_min": -1.0, "a_max": 0.5})
_add("misc", "clip", [_a.astype(np.int32)], {"a_min": -1.0, "a_max": 1.0},
     label="clip-int32")
for _dt in ("int32", "float16", "bfloat16", "float32"):
    _add("misc", "Cast", [_a], {"dtype": _dt}, label=f"Cast-{_dt}")

# -- reductions, arg reductions, norm, broadcast_to, dot --------------------

REDUCE = ["sum", "mean", "prod", "nansum", "nanprod", "max", "min",
          "sum_axis", "max_axis", "min_axis", "_square_sum"]
for _n in REDUCE:
    (_x,) = _arrays(len(_n), ((2, 3, 4), "unit" if "prod" in _n else "normal"))
    for _attrs in ({}, {"axis": (0, 2), "keepdims": True},
                   {"axis": 1, "exclude": True}, {"axis": ()}):
        _add("reduce", _n, [_x], _attrs, SUM)
for _n in ("sum", "prod", "max"):  # int32 stays int32
    _add("reduce", _n, _arrays(3, ((2, 3), "int")), {"axis": 1},
         label=f"{_n}-int32")
_x = np.array([[1, 5, 5, 2], [7, 7, 0, 7], [3, 1, 1, 9]], np.float32)
for _n, _attrs in [("argmax", {}), ("argmax", {"axis": 1}),
                   ("argmax", {"axis": 0, "keepdims": True}),
                   ("argmin", {"axis": 1}), ("argmin", {}),
                   ("argmax_channel", {})]:
    _add("arg", _n, [_x], _attrs)  # ties: the first index, as float32
(_x,) = _arrays(9, ((64, 33), "normal"))
_add("norm", "norm", [_x], tol=SUM)  # accumulates in fp32
_add("norm", "norm", [_x.astype(np.float16)], label="norm-float16")
(_x,) = _arrays(4, ((3, 1), "normal"))
_add("bcast", "broadcast_to", [_x], {"shape": (3, 5)})
_add("bcast", "broadcast_to", [_x], {"shape": (0, 5)})
for _n in ("broadcast_axis", "broadcast_axes"):
    _add("bcast", _n, [_x], {"axis": 1, "size": 4})
_a, _b = _arrays(1, ((4, 3), "normal"), ((3, 5), "normal"))
_x, _y = _arrays(2, ((2, 3, 4), "normal"), ((2, 4, 5), "normal"))
for _ta in (False, True):
    for _tb in (False, True):
        _t = {"transpose_a": _ta, "transpose_b": _tb}
        _add("dot", "dot", [_a.T.copy() if _ta else _a, _b.T.copy() if _tb else _b],
             _t, SUM)
        _add("dot", "batch_dot", [np.swapaxes(_x, 1, 2).copy() if _ta else _x,
                                  np.swapaxes(_y, 1, 2).copy() if _tb else _y],
             _t, SUM)
_a, _b, _m = _arrays(3, ((5,), "normal"), ((5,), "normal"), ((2, 3, 4), "normal"))
_add("dot", "dot", [_a, _b], tol=SUM, label="dot-vectors")
for _mode in ("instance", "channel", "spatial"):
    _add("dot", "L2Normalization", [_m], {"mode": _mode}, SUM)

# -- tensor ops -------------------------------------------------------------

_X = ((2, 3, 4), "normal")
_P = ((1, 2, 3, 4), "normal")
for _i, (_n, _specs, _attrs) in enumerate([
        ("Reshape", [_X], {"shape": (0, -1)}), ("reshape", [_X], {"shape": (-3, 4)}),
        ("Flatten", [_X], {}), ("transpose", [_X], {}),
        ("transpose", [_X], {"axes": (1, 0, 2)}),
        ("expand_dims", [_X], {"axis": 1}), ("SwapAxis", [_X], {"dim1": 0, "dim2": 2}),
        ("slice", [_X], {"begin": (0, 1), "end": (2, 3)}),
        ("crop", [_X], {"begin": (1, 0, 1), "end": (2, 2, -1)}),
        ("slice_axis", [_X], {"axis": 2, "begin": 1, "end": -1}),
        ("slice_axis", [_X], {"axis": -1, "begin": -3, "end": None}),
        ("reverse", [_X], {"axis": (0, 2)}), ("flip", [_X], {"axis": 1}),
        ("repeat", [_X], {"repeats": 2, "axis": 1}), ("repeat", [_X], {"repeats": 2}),
        ("tile", [_X], {"reps": (2, 1)}), ("tile", [_X], {"reps": (1, 2, 1, 2)}),
        ("Concat", [_X, _X], {"dim": 1}), ("stack", [_X, _X], {"axis": 1}),
        ("SliceChannel", [_X], {"num_outputs": 3, "axis": 1}),
        ("split", [_X], {"num_outputs": 4, "axis": 2, "squeeze_axis": True}),
        ("zeros_like", [_X], {}), ("ones_like", [_X], {}),
        ("sort", [_X], {}), ("sort", [_X], {"axis": 1, "is_ascend": False}),
        ("sort", [_X], {"axis": None}),
        ("argsort", [_X], {}), ("argsort", [_X], {"axis": 0, "is_ascend": False}),
        ("topk", [_X], {"k": 2}), ("topk", [_X], {"k": 2, "ret_typ": "value", "axis": 1}),
        ("topk", [_X], {"k": 2, "ret_typ": "both", "is_ascend": True}),
        ("topk", [_X], {"k": 1, "ret_typ": "mask"}),
        ("Pad", [_P], {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                       "constant_value": 1.5}),
        ("pad", [_P], {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
        ("pad", [_P], {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
        ("Crop", [((1, 2, 5, 6), "normal")], {"h_w": (3, 2), "offset": (1, 2)}),
        ("Crop", [((1, 2, 5, 6), "normal")], {"h_w": (3, 2), "center_crop": True}),
        ("cast_storage", [_X], {"stype": "default"})]):
    _arrs = _arrays(_i, *_specs)
    if _n in ("sort", "argsort", "topk"):
        _arrs[0][0, 0, :2] = 1.25  # a tie: both orders keep it stable
    _add("tensor", _n, _arrs, _attrs)

_d, _idx = _arrays(4, ((5, 4), "normal"), ((2, 3), "idx"))
_idx[0, 0] = 9.0  # past the end: clipped or wrapped
_pidx = np.array([0, 3, 9, -1, 2], np.float32)
for _mode in ("clip", "wrap"):
    _add("index", "take", [_d, _idx], {"mode": _mode})
    _add("index", "take", [_d, _idx], {"axis": 1, "mode": _mode})
    _add("index", "pick", [_d, _pidx], {"axis": 1, "mode": _mode})
    _add("index", "pick", [_d, _pidx[:4]], {"axis": 0, "mode": _mode, "keepdims": True})
_d, _c, _y = _arrays(6, ((3, 4), "normal"), ((3, 4), "normal"), ((3, 4), "normal"))
_add("index", "gather_nd", [_d, np.array([[0, 2, -1], [1, 3, 0]], np.float32)])
_add("index", "where", [(_c > 0).astype(np.float32), _d, _y])
_add("index", "where", [np.array([1, 0, 1], np.float32), _d, _y], label="where-rows")
_ind = np.array([0, 2, 5, -1], np.float32)  # 5 and -1: a row of off_value
_add("index", "one_hot", [_ind], {"depth": 4})
_add("index", "one_hot", [_ind], {"depth": 3, "on_value": 2.0, "off_value": -1.0,
                                  "dtype": "int32"})
_add("index", "batch_take", [_d, np.array([0, 3, 1], np.float32)])
(_d,) = _arrays(7, ((5, 3, 2), "normal"))
_lens = np.array([5, 2, 3], np.float32)
for _n in ("SequenceLast", "SequenceMask", "SequenceReverse"):
    _add("sequence", _n, [_d])
    _add("sequence", _n, [_d, _lens], {"use_sequence_length": True,
                                       **({"value": -1.0} if _n == "SequenceMask" else {})})
for _n, _attrs in [("_zeros", {"shape": (2, 3)}),
                   ("_ones", {"shape": (2, 3), "dtype": "int32"}),
                   ("_full", {"shape": (2, 2), "value": 2.5}),
                   ("_arange", {"start": 1.0, "stop": 4.0, "step": 0.5}),
                   ("_arange", {"start": 5.0, "repeat": 2})]:
    _add("creation", _n, [], _attrs)


@pytest.fixture(scope="module")
def jax_out(ref):
    """Every case's JAX reference, computed in one jit (x64 off): the JAX
    table's op functions, called as ``imperative_invoke`` calls them."""
    import jax
    import jax.numpy as jnp

    def run(args):
        outs = []
        for (_, _, name, _, attrs, _), vals in zip(CASES, args):
            op = ref.table[name]
            parsed = op.parse_attrs(attrs)
            if op.key_var_num_args and not parsed.get(op.key_var_num_args):
                parsed[op.key_var_num_args] = len(vals)
            res = op.fn(*vals, **parsed)
            res = res if isinstance(res, tuple) else (res,)
            outs.append(res[:op.num_outputs(parsed)])
        return outs

    with jax.enable_x64(False):
        args = [[jnp.asarray(a) for a in c[3]] for c in CASES]
        res = jax.jit(run)(args)
        return [[(np.asarray(o.astype(jnp.float32)) if o.dtype == jnp.bfloat16
                  else np.asarray(o), str(o.dtype)) for o in r] for r in res]


def _check(jax_out, i):
    _, label, name, arrays, attrs, tol = CASES[i]
    with mxt.cpu():
        out = getattr(pnd, name)(*[pnd.array(a, dtype=a.dtype) for a in arrays],
                                 **attrs)
    got = [(o.asnumpy(), str(o.dtype))
           for o in (out if isinstance(out, (list, tuple)) else [out])]
    want = jax_out[i]
    assert len(got) == len(want), label
    for (g, gd), (w, wd) in zip(got, want):
        assert gd == wd, f"{label}: dtype {gd} != {wd}"
        assert g.shape == w.shape, f"{label}: shape {g.shape} != {w.shape}"
        if tol == EXACT:
            np.testing.assert_array_equal(g, w, err_msg=label)
        else:
            np.testing.assert_allclose(g, w, err_msg=label, **tol)


@pytest.mark.parametrize("case", _ids("unary") + _ids("unary_trap"), ids=_label)
def test_unary(jax_out, case):
    _check(jax_out, case)


@pytest.mark.parametrize("case", _ids("binary") + _ids("binary_trap"), ids=_label)
def test_binary(jax_out, case):
    _check(jax_out, case)


@pytest.mark.parametrize("case", _ids("scalar") + _ids("misc"), ids=_label)
def test_scalar_and_misc(jax_out, case):
    _check(jax_out, case)


@pytest.mark.parametrize("case", _ids("reduce") + _ids("arg") + _ids("norm")
                         + _ids("bcast") + _ids("dot"), ids=_label)
def test_reduce_dot(jax_out, case):
    _check(jax_out, case)


@pytest.mark.parametrize("case", _ids("tensor") + _ids("index") + _ids("sequence")
                         + _ids("creation"), ids=_label)
def test_tensor_op(jax_out, case):
    _check(jax_out, case)


def test_scalar_keeps_the_array_dtype():
    with mxt.cpu():
        x = pnd.array([1, 2, 3], dtype="int32")
        y = x + 1.5
        z = x.astype("bfloat16") * 0.1
    assert y.dtype == np.int32 and y.asnumpy().tolist() == [2, 3, 4]
    # bf16(0.1) = 0.10009765625, so 1 * bf16(0.1) is that value exactly
    assert z.dtype == "bfloat16" and z.asnumpy()[0] == np.float32(0.10009765625)


def test_module_functions(ref):
    a, b = _arrays(8, ((2, 3), "normal"), ((1, 3), "normal"))
    for fn in ("add", "subtract", "multiply", "divide", "modulo", "maximum",
               "minimum", "equal", "not_equal", "greater", "greater_equal",
               "lesser", "lesser_equal", "true_divide"):
        for lhs, rhs in ((a, b), (a, 0.5), (0.5, a))[:3 if fn in (
                "subtract", "divide", "greater", "lesser") else 1]:
            def call(nd, port):
                cv = lambda v: v if isinstance(v, float) else nd.array(v)
                with (mxt.cpu() if port else ref.x32()):
                    return getattr(nd, fn)(cv(lhs), cv(rhs)).asnumpy()
            got, want = call(pnd, True), call(ref.nd, False)
            tol = LIBM if fn in ("divide", "true_divide", "modulo") else EXACT
            np.testing.assert_allclose(got, want, err_msg=fn, **tol) \
                if tol is LIBM else np.testing.assert_array_equal(got, want, fn)
    with mxt.cpu(), ref.x32():
        x = pnd.array(a)
        np.testing.assert_array_equal(pnd.power(pnd.abs(x), 2.0).asnumpy(),
                                      ref.nd.power(ref.nd.abs(ref.nd.array(a)), 2.0).asnumpy())
        np.testing.assert_array_equal(pnd.concatenate([x, x], axis=1).asnumpy(),
                                      np.concatenate([a, a], axis=1))
        np.testing.assert_array_equal(pnd.moveaxis(x, 0, 1).asnumpy(), a.T)
        assert pnd.full((2, 2), 3, dtype="int32").asnumpy().tolist() == [[3, 3], [3, 3]]
        assert pnd.ones((2,)).dtype == np.float32
        np.testing.assert_array_equal(pnd.arange(2, 8, 2).asnumpy(),
                                      ref.nd.arange(2, 8, 2).asnumpy())
        out = pnd.zeros((3, 4))
        pnd.onehot_encode(pnd.array([1, 3, 0]), out)
        np.testing.assert_array_equal(out.asnumpy(), np.eye(4, dtype=np.float32)[[1, 3, 0]])
        pnd.waitall()


# -- the op table -----------------------------------------------------------

def _jax_ops(ref, module):
    """The names a JAX op module registers (compat_ops' alias of identity,
    ``_CrossDeviceCopy``, belongs to compat_ops)."""
    return sorted(n for n, op in ref.table.items()
                  if n != "_CrossDeviceCopy" and (
                      getattr(op.fn, "__module__", "") == f"mxnet_tpu.ops.{module}"
                      or (module == "math_ops" and n in ("BlockGrad", "stop_gradient"))))


@pytest.mark.parametrize("module", ["math_ops", "tensor_ops", "optimizer_ops"])
def test_op_table_matches_jax(ref, module):
    names = _jax_ops(ref, module)
    assert len(names) == {"math_ops": 137, "tensor_ops": 43, "optimizer_ops": 7}[module]
    for name in names:
        j, p = ref.table[name], mxt.OP_TABLE.get(name)
        assert p is not None, f"{name} is not ported"
        assert p.input_names == j.input_names, name
        assert p.num_inputs == j.num_inputs, name
        assert p.key_var_num_args == j.key_var_num_args, name
        assert sorted(p.attr_spec.fields) == sorted(j.attr_spec.fields), name
        for field, (typ, default) in j.attr_spec.fields.items():
            ptyp, pdefault = p.attr_spec.fields[field]
            assert ptyp == typ, (name, field)
            assert (pdefault is p.attr_spec._REQUIRED) == (default is j.attr_spec._REQUIRED)
            if default is not j.attr_spec._REQUIRED:
                assert pdefault == default, (name, field)
        sample = {"num_outputs": 3, "ret_typ": "both"}
        attrs = {k: v for k, v in sample.items() if k in j.attr_spec.fields}
        assert p.num_outputs(attrs) == j.num_outputs(attrs), name
    # aliases point at one record, as in the JAX table
    for name in names:
        twins = [n for n in names if ref.table[n] is ref.table[name]]
        assert all(mxt.OP_TABLE[n] is mxt.OP_TABLE[name] for n in twins), name


def test_nd_namespace_generated_with_collision_rule():
    assert pnd.ones.__module__.endswith("ndarray.ndarray")  # not the _ones op
    for name in ("sgd_mom_update", "topk", "broadcast_add", "relu", "norm"):
        assert callable(getattr(pnd, name)) and getattr(pnd, name).__name__ == name
    with mxt.cpu():
        a = pnd.array([[1.0, -2.0]])
        assert pnd.relu(data=a).asnumpy().tolist() == [[1.0, 0.0]]
        assert pnd.clip(a, -1.0, 0.5).asnumpy().tolist() == [[0.5, -1.0]]


# -- NDArray semantics ------------------------------------------------------

def test_version_bumps_on_every_write():
    with mxt.cpu():
        a = pnd.zeros((2, 3))
        v = a.version
        a[:] = 1.0
        a[0, 1] = 5.0
        a += 1
        a *= 2
        pnd.elemwise_add(a, a, out=a)
        pnd.ones((2, 3)).copyto(a)
        a._set_data(a._data)
        assert a.version == v + 7


def test_writes_leave_derived_arrays_alone():
    with mxt.cpu():
        a = pnd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        view, row, t = a.reshape((3, 2)), a[1], a.T
        a[:] = 0.0
        a += 5
        assert view.asnumpy().ravel().tolist() == list(range(6))
        assert row.asnumpy().tolist() == [3, 4, 5]
        assert t.shape == (3, 2) and t.asnumpy()[2, 1] == 5


def test_out_casts_to_the_target_dtype(ref):
    a = np.array([1.7, -2.2], np.float32)
    with mxt.cpu():
        tgt = pnd.zeros((2,), dtype="int32")
        res = pnd.elemwise_add(pnd.array(a), pnd.array(a), out=tgt)
    with ref.x32():
        jt = ref.nd.zeros((2,), dtype="int32")
        ref.nd.elemwise_add(ref.nd.array(a), ref.nd.array(a), out=jt)
    assert res is tgt and tgt.dtype == np.int32
    np.testing.assert_array_equal(tgt.asnumpy(), jt.asnumpy())


def test_indexing_and_setitem(ref):
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    with mxt.cpu():
        p = pnd.array(x)
        for key in ((1,), (slice(1, 3),), (slice(None, None, -1),),
                    (slice(None), slice(1, None, 2)), (-1, slice(None, None, -2))):
            key = key if len(key) > 1 else key[0]
            np.testing.assert_array_equal(p[key].asnumpy(), x[key])
        np.testing.assert_array_equal(p[pnd.array([2, 0], dtype="int32")].asnumpy(), x[[2, 0]])
        p[1:3, 2] = -1.0
        p[0] = pnd.array(np.ones(6, np.float32))
        p[3] = np.full(6, 7.0)
    with ref.x32():
        j = ref.nd.array(x)
        j[1:3, 2] = -1.0
        j[0] = ref.nd.array(np.ones(6, np.float32))
        j[3] = np.full(6, 7.0)
        np.testing.assert_array_equal(p.asnumpy(), j.asnumpy())


def test_ndarray_methods(ref):
    (x,) = _arrays(11, ((2, 3, 4), "normal"))
    with mxt.cpu(), ref.x32():
        p, j = pnd.array(x), ref.nd.array(x)
    for call in (lambda a: a.reshape(6, 4), lambda a: a.reshape((-1,)),
                 lambda a: a.transpose((2, 0, 1)), lambda a: a.T,
                 lambda a: a.swapaxes(0, 1), lambda a: a.flatten(),
                 lambda a: a.expand_dims(0), lambda a: a.slice_axis(1, 0, 2),
                 lambda a: a.sum(axis=1), lambda a: a.mean(keepdims=True),
                 lambda a: a.max(axis=(0, 2)), lambda a: a.min(), lambda a: a.prod(axis=2),
                 lambda a: a.argmax(axis=1), lambda a: a.argmin(), lambda a: a.clip(-1, 1),
                 lambda a: abs(a), lambda a: a.square(), lambda a: a.abs().sqrt(),
                 lambda a: a.sign(), lambda a: a.abs().log(), lambda a: a.exp(),
                 lambda a: a.split(2, axis=2)[1], lambda a: a.broadcast_to((2, 2, 3, 4)),
                 lambda a: a.take(pnd.array([1, 0]) if isinstance(a, pnd.NDArray)
                                  else ref.nd.array([1, 0]), axis=1),
                 lambda a: (a > 0) + (a <= 0.5) * 2 - (a == a) / 4 + (a != 1),
                 lambda a: 2 - a, lambda a: 1 / (a + 10), lambda a: a % 1.5, lambda a: 1.5 % (a + 5),
                 lambda a: (a + 5) ** 2, lambda a: 2 ** a, lambda a: -a,
                 lambda a: a.astype("int32"), lambda a: a[0, 0]):
        with mxt.cpu(), ref.x32():
            got, want = call(p).asnumpy(), call(j).asnumpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, **SUM)
    assert p[0, 0, 0].asscalar() == x[0, 0, 0] and float(p[1, 1, 1]) == x[1, 1, 1]
    assert len(p) == 2 and [r.shape for r in p] == [(3, 4), (3, 4)]
    assert p.tolist() == x.tolist() and p.size == 24 and p.ndim == 3
    assert p.context == mxt.cpu() and p.stype == "default"
    with pytest.raises(MXNetError):
        p.asscalar()


def test_bf16_arrays():
    with mxt.cpu():
        a = pnd.array([1.0, 2.5, 3.0], dtype="bfloat16")
        assert a.dtype == "bfloat16" and a.dtype == pnd.bfloat16
        assert a.dtype == torch.bfloat16 and a.dtype != np.float32
        assert a.asnumpy().dtype == np.float32
        assert (a * 2.0).astype("float32").asnumpy().tolist() == [2.0, 5.0, 6.0]
        assert pnd.zeros((2,), dtype=pnd.bfloat16)._data.dtype == torch.bfloat16
        with pytest.raises(MXNetError, match="bfloat16"):
            pnd.save("unused.npz", a)


def test_left_out_parts_raise():
    with mxt.cpu():
        a = pnd.ones((2,))
        # backward of an array neither recorded nor marked raises, as in
        # the JAX package (autograd itself is tests/test_torch_port_autograd)
        for call in (a.backward, lambda: a.tostype("csr"),
                     lambda: pnd.cast_storage(a, stype="row_sparse"),
                     lambda: pnd.imdecode(b"")):
            with pytest.raises(MXNetError):
                call()
        assert a.tostype("default") is a and a.detach().shape == (2,)
        assert a.grad is None
        a.attach_grad()
        np.testing.assert_array_equal(a.grad.asnumpy(), [0.0, 0.0])
    # a call that may draw random numbers (RNN's dropout at p > 0) gets
    # the device's generator; imperative calls outside autograd's train
    # mode run in eval mode, where dropout draws nothing
    rng = np.random.RandomState(0)
    ins = [rng.normal(0, 1, (3, 2, 4)), rng.uniform(-0.3, 0.3, (460,)),
           np.zeros((2, 2, 5)), np.zeros((2, 2, 5))]
    attrs = {"state_size": 5, "num_layers": 2, "mode": "lstm"}
    with mxt.cpu():
        arrays = [pnd.array(a) for a in ins]
        want = mxt.nd.imperative_invoke("RNN", arrays, attrs)[0]
        got = mxt.nd.imperative_invoke("RNN", arrays, dict(attrs, p=0.5))[0]
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_default_context_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only behaviour")
    with pytest.raises(MXNetError):
        pnd.zeros((2,))
    with pytest.raises(MXNetError):
        pnd.arange(3)


# -- save / load across the packages ----------------------------------------

@pytest.mark.parametrize("layout", ["list", "dict", "single"])
def test_npz_interchange(ref, tmp_path, layout):
    arrays = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "i": np.array([1, -2], np.int32),
              "h": np.array([0.5, 1.5], np.float16)}
    def pack(nd):
        with mxt.cpu():
            made = {k: nd.array(v, dtype=v.dtype) for k, v in arrays.items()}
        return {"list": list(made.values()), "dict": made,
                "single": made["w"]}[layout]
    def unpack(obj):
        if isinstance(obj, dict):
            return {k: (v.asnumpy(), str(v.dtype)) for k, v in obj.items()}
        return [(v.asnumpy(), str(v.dtype)) for v in obj]
    for writer, reader in ((pnd, ref.nd), (ref.nd, pnd)):
        path = str(tmp_path / f"{layout}-{writer is pnd}.params")
        with ref.x32():
            writer.save(path, pack(writer))
            with mxt.cpu():
                got = unpack(reader.load(path))
            want = unpack(ref.nd.load(path))
        assert type(got) is type(want)
        items = got.items() if isinstance(got, dict) else enumerate(got)
        for k, (g, gd) in items:
            w, wd = want[k]
            assert gd == wd and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_pickle_round_trip():
    import pickle
    with mxt.cpu():
        a = pnd.array(np.arange(4, dtype=np.float32))
        b = pickle.loads(pickle.dumps(a.astype("bfloat16")))
    assert b.dtype == "bfloat16" and b.asnumpy().tolist() == [0, 1, 2, 3]


# -- TF32 is off wherever the card is handed out ----------------------------

def test_tf32_turned_off_when_the_card_is_handed_out(monkeypatch):
    monkeypatch.setattr(port_context, "num_gpus", lambda: 1)
    monkeypatch.setattr(port_context, "_TF32_OFF", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert mxt.cpu().torch_device().type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32  # the CPU leaves it alone
    assert mxt.gpu(0).torch_device() == torch.device("cuda", 0)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    with pytest.raises(MXNetError):
        mxt.gpu(1).torch_device()

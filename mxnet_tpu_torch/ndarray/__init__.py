"""The ``nd`` namespace: NDArray plus op functions generated from the table.

Counterpart of ``mxnet_tpu/ndarray/__init__.py`` (reference
python/mxnet/ndarray/op.py:51 ``_make_ndarray_function``): every op of
OP_TABLE becomes ``nd.<name>``, unless a module function of that name is
already here (``nd.ones`` stays the creation function). Sparse arrays
(``cast_storage``, ``sparse_retain``) wait for queue A9.
"""
from __future__ import annotations

import sys as _sys

from .. import ops as _ops  # noqa: F401  (fills OP_TABLE first)
from ..ops.registry import OP_TABLE, OpDef, resolve_inputs
from .ndarray import (  # noqa: F401
    NDArray,
    add,
    arange,
    array,
    bfloat16,
    concatenate,
    divide,
    empty,
    equal,
    full,
    greater,
    greater_equal,
    imdecode,
    imperative_invoke,
    lesser,
    lesser_equal,
    load,
    maximum,
    minimum,
    modulo,
    moveaxis,
    multiply,
    not_equal,
    ones,
    ones_like,
    onehot_encode,
    power,
    save,
    subtract,
    true_divide,
    waitall,
    zeros,
    zeros_like,
)


def _make_op_func(opdef: OpDef, name: str):
    def op_func(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        inputs = resolve_inputs(opdef, args, kwargs, name)
        res = imperative_invoke(opdef, inputs, kwargs, out=out)
        if out is not None:
            return out if not isinstance(out, (list, tuple)) else res
        return res[0] if len(res) == 1 else res

    op_func.__name__ = name
    op_func.__doc__ = (opdef.fn.__doc__ or "") + (
        f"\n\nParameters: {sorted(opdef.attr_spec.fields)}"
        f"\nInputs: {opdef.input_names or ['data']}"
    )
    return op_func


_this_module = _sys.modules[__name__]
for _name, _opdef in OP_TABLE.items():
    if not hasattr(_this_module, _name):
        setattr(_this_module, _name, _make_op_func(_opdef, _name))

del _this_module, _name, _opdef

"""The ``sym`` namespace: Symbol plus op constructors generated from the
op table (reference: python/mxnet/symbol/op.py import-time codegen)."""
from __future__ import annotations

import sys as _sys

from ..base import MXNetError
from ..ops.registry import OP_TABLE, OpDef, resolve_inputs
from .symbol import (  # noqa: F401
    AttrScope,
    Group,
    NameManager,
    Prefix,
    Symbol,
    SymbolNode,
    Variable,
    load_json,
    symbol_invoke,
    var,
)


def _make_sym_func(opdef: OpDef, name: str):
    def sym_func(*args, **kwargs):
        sym_name = kwargs.pop("name", None)
        kwargs.pop("attr", None)
        inputs = resolve_inputs(opdef, args, kwargs, name,
                                is_input=lambda v: isinstance(v, Symbol))
        if any(not isinstance(x, Symbol) for x in inputs):
            raise MXNetError(f"{name}: symbolic inputs must be Symbols")
        return symbol_invoke(opdef, inputs, kwargs, sym_name)

    sym_func.__name__ = name
    sym_func.__doc__ = (opdef.fn.__doc__ or "") + (
        f"\n\nParameters: {sorted(opdef.attr_spec.fields)}"
        f"\nInputs: {opdef.input_names or ['data']}")
    return sym_func


_this_module = _sys.modules[__name__]
for _name, _opdef in OP_TABLE.items():
    if not hasattr(_this_module, _name):
        setattr(_this_module, _name, _make_sym_func(_opdef, _name))

del _this_module, _name, _opdef


def zeros(shape, dtype="float32", **kwargs):
    return _zeros(shape=shape, dtype=dtype, **kwargs)  # noqa: F821

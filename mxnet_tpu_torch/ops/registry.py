"""Declarative operator registry: the single op table of the port.

Counterpart of ``mxnet_tpu/ops/registry.py``. Each op is one record whose
``fn`` computes on torch tensors. Shape inference runs ``fn`` on tensors
of the ``meta`` device (where the JAX package used ``jax.eval_shape``), so
an op's ``fn`` must work on meta tensors: it may read shapes but not
values.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

from ..base import AttrSpec, MXNetError

__all__ = ["OpDef", "register", "get_op", "list_ops", "OP_TABLE",
           "resolve_inputs"]

OP_TABLE: Dict[str, "OpDef"] = {}


class OpDef:
    """One operator.

    fn(*inputs, **attrs) -> tensor or tuple of tensors. Ops whose signature
    takes a leading ``rng`` argument set ``needs_rng``; ops whose semantics
    differ between train and eval read the ``_is_train`` attr injected by
    the caller and set ``needs_is_train``.
    """

    def __init__(
        self,
        name: str,
        fn: Callable,
        attrs: Optional[AttrSpec] = None,
        num_inputs: Optional[int] = None,
        num_outputs: Union[int, Callable] = 1,
        input_names: Optional[Sequence[str]] = None,
        output_names: Optional[Sequence[str]] = None,
        needs_rng: bool = False,
        needs_is_train: bool = False,
        key_var_num_args: Optional[str] = None,
        aux_inputs: Sequence[int] = (),
        param_shapes: Optional[Callable] = None,
    ):
        self.name = name
        self.fn = fn
        self.attr_spec = attrs or AttrSpec()
        self.num_inputs = num_inputs
        self._num_outputs = num_outputs
        self.input_names = list(input_names) if input_names else None
        self.output_names = list(output_names) if output_names else ["output"]
        self.needs_rng = needs_rng
        self.needs_is_train = needs_is_train
        # name of the attr holding the variadic input count (Concat)
        self.key_var_num_args = key_var_num_args
        # input indices that are auxiliary states, not gradient-bearing args
        self.aux_inputs = tuple(aux_inputs)
        # param_shapes(attrs, input_shapes) -> full input-shape list with
        # unknown parameter shapes filled in from the data shape + attrs
        self.param_shapes = param_shapes

    def num_outputs(self, attrs) -> int:
        if callable(self._num_outputs):
            return self._num_outputs(attrs)
        return self._num_outputs

    def parse_attrs(self, raw_attrs: Dict) -> Dict:
        return self.attr_spec.parse(raw_attrs, self.name)

    def __repr__(self):
        return f"<OpDef {self.name}>"


def register(name: str, aliases: Sequence[str] = (), **kwargs):
    """Register an operator. Usable as a decorator over its fn."""

    def deco(fn):
        op = OpDef(name, fn, **kwargs)
        if name in OP_TABLE:
            raise MXNetError(f"operator {name} registered twice")
        OP_TABLE[name] = op
        for a in aliases:
            OP_TABLE[a] = op
        return fn

    return deco


def resolve_inputs(opdef: OpDef, args, kwargs, name: str, is_input=None):
    """Merge positional and keyword-passed op inputs into one ordered list.

    Used by the generated sym.* wrappers (they accept inputs positionally
    or by their declared names). Mutates ``kwargs`` (consumed input names
    are popped). Non-tensor trailing positional args fill the declared
    attr fields in order (``clip(data, a_min, a_max)``).
    """
    inputs = list(args)
    if opdef.attr_spec.fields:
        def _tensorish(v):
            if is_input is not None:
                return is_input(v)
            return (hasattr(v, "shape") and hasattr(v, "dtype")
                    and not isinstance(v, (tuple, list)))

        n_peel = 0
        while (n_peel < len(inputs)
               and not _tensorish(inputs[-1 - n_peel])):
            n_peel += 1
        if n_peel:
            # the variadic-count field is auto-filled, never positional
            fields = [k for k in opdef.attr_spec.fields
                      if k not in kwargs and k != opdef.key_var_num_args]
            if n_peel > len(fields):
                raise MXNetError(
                    f"{name}: {n_peel} positional parameters given but "
                    f"only {len(fields)} declared parameters "
                    f"remain ({fields}); valid: "
                    f"{sorted(opdef.attr_spec.fields)}")
            extra = inputs[len(inputs) - n_peel:]
            inputs = inputs[:len(inputs) - n_peel]
            kwargs.update(zip(fields, extra))
    # ops registered without explicit input_names still accept ``data=``
    input_names = opdef.input_names or ["data"]
    kw_inputs = {}
    for i, n in enumerate(input_names):
        if n in kwargs and (is_input is None or is_input(kwargs[n])):
            kw_inputs[i] = kwargs.pop(n)
    if kw_inputs:
        hi = max(kw_inputs)
        slots = inputs + [None] * max(0, hi + 1 - len(inputs))
        for i, v in kw_inputs.items():
            if slots[i] is not None:
                raise MXNetError(
                    f"input {input_names[i]} of {name} given "
                    "both positionally and by keyword")
            slots[i] = v
        inputs = [x for x in slots if x is not None]
    return inputs


def get_op(name: str) -> OpDef:
    if name not in OP_TABLE:
        raise MXNetError(f"Unknown operator {name}")
    return OP_TABLE[name]


def list_ops():
    return sorted(OP_TABLE)

"""Symbol: the declarative graph API.

Counterpart of ``mxnet_tpu/symbol/symbol.py``. A Symbol is a DAG of op
applications over the port's op table. Shape inference runs each op on
``meta`` tensors, where the JAX package used ``jax.eval_shape``. The JSON
format is the JAX package's, so a graph saved by either package loads in
the other.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import random as _random
from ..base import MXNetError, __version__, _parse_tuple
from ..ndarray.ndarray import torch_dtype
from ..ops.registry import OpDef, get_op

__all__ = ["Symbol", "SymbolNode", "Variable", "var", "Group", "load_json",
           "load", "symbol_invoke", "NameManager", "Prefix", "AttrScope"]


class _NameManagerMeta(type):
    """Makes ``NameManager.current`` thread-local while keeping the
    reference's class-attribute spelling."""

    _tls = threading.local()

    @property
    def current(cls):
        cur = getattr(cls._tls, "current", None)
        if cur is None:
            cur = cls._tls.current = NameManager()
        return cur

    @current.setter
    def current(cls, value):
        cls._tls.current = value


class NameManager(metaclass=_NameManagerMeta):
    """Auto-naming for anonymous symbols (reference: python/mxnet/name.py).
    ``with NameManager():`` / ``with Prefix('net_'):`` installs a new one
    for the block."""

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        hint = hint.lower().lstrip("_")
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"

    def __enter__(self):
        self._old_manager = NameManager.current
        NameManager.current = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager.current = self._old_manager
        return False


class Prefix(NameManager):
    """Name manager that prepends a prefix to every name (reference
    name.py:74)."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name: Optional[str], hint: str) -> str:
        return self._prefix + super().get(name, hint)


class AttrScope:
    """``with AttrScope(ctx_group='dev1'):`` attaches attrs to the symbols
    created in scope (reference: python/mxnet/attribute.py)."""

    _local = threading.local()

    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}

    @classmethod
    def current_attrs(cls) -> Dict[str, str]:
        return dict(getattr(cls._local, "attrs", {}) or {})

    def __enter__(self):
        self._old = getattr(AttrScope._local, "attrs", {})
        merged = dict(self._old)
        merged.update(self._attrs)
        AttrScope._local.attrs = merged
        return self

    def __exit__(self, *args):
        AttrScope._local.attrs = self._old
        return False


class SymbolNode:
    """One graph node: a variable (op=None) or an op application."""

    __slots__ = ("op", "name", "attrs", "inputs", "scope_attrs")

    def __init__(self, op: Optional[OpDef], name: str, attrs: Dict,
                 inputs: List[Tuple["SymbolNode", int]]):
        self.op = op
        self.name = name
        self.attrs = attrs          # parsed python values
        self.inputs = inputs
        self.scope_attrs = AttrScope.current_attrs()

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        return 1 if self.op is None else self.op.num_outputs(self.attrs)


class Symbol:
    """A list of output entries over the node DAG."""

    def __init__(self, outputs: List[Tuple[SymbolNode, int]]):
        self._outputs = outputs

    # -- graph traversal ----------------------------------------------------
    def _topo_nodes(self) -> List[SymbolNode]:
        order, seen = [], set()
        stack = [(n, False) for n, _ in reversed(self._outputs)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for parent, _ in reversed(node.inputs):
                if id(parent) not in seen:
                    stack.append((parent, False))
        return order

    def _aux_node_ids(self) -> set:
        aux = set()
        for node in self._topo_nodes():
            if node.op is not None and node.op.aux_inputs:
                for i in node.op.aux_inputs:
                    if i < len(node.inputs):
                        parent, _ = node.inputs[i]
                        if parent.is_variable:
                            aux.add(id(parent))
        return aux

    def list_arguments(self) -> List[str]:
        aux = self._aux_node_ids()
        return [n.name for n in self._topo_nodes()
                if n.is_variable and id(n) not in aux]

    def list_auxiliary_states(self) -> List[str]:
        aux = self._aux_node_ids()
        return [n.name for n in self._topo_nodes()
                if n.is_variable and id(n) in aux]

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._outputs:
            if node.num_outputs() == 1:
                names.append(f"{node.name}_output" if node.op else node.name)
            else:
                out_name = (node.op.output_names[idx]
                            if node.op and idx < len(node.op.output_names)
                            else str(idx))
                names.append(f"{node.name}_{out_name}")
        return names

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    # -- composition --------------------------------------------------------
    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError(f"no output named {index}; have {names}")
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    def get_internals(self) -> "Symbol":
        outs = []
        for node in self._topo_nodes():
            for i in range(node.num_outputs()):
                outs.append((node, i))
        return Symbol(outs)

    def __repr__(self):
        name = self.name
        return f"<Symbol {name if name else 'group [' + ', '.join(self.list_outputs()) + ']'}>"

    # -- shape inference -----------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the shapes given
        positionally (in list_arguments order) or by name."""
        arg_names = self.list_arguments()
        known: Dict[str, tuple] = {}
        for name, shape in zip(arg_names, args):
            if shape is not None:
                known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})
        var_shapes, out_shapes = self._infer_shapes(known)
        arg_shapes = [var_shapes[n] for n in arg_names]
        aux_shapes = [var_shapes[n] for n in self.list_auxiliary_states()]
        return arg_shapes, out_shapes, aux_shapes

    def _infer_shapes(self, known_shapes: Dict[str, tuple]):
        """Forward shape propagation with param-shape completion: variables
        get shapes from ``known_shapes``, their declared ``__shape__`` or
        the consuming op's ``param_shapes`` hook; op outputs come from
        running the op on meta tensors."""
        vals: Dict[Tuple[int, int], torch.Tensor] = {}
        var_shapes: Dict[str, tuple] = {}

        def meta(shape, node_attrs):
            dt = torch_dtype(node_attrs.get("__dtype__", "float32"))
            return torch.empty(tuple(shape), dtype=dt, device="meta")

        for node in self._topo_nodes():
            if node.is_variable:
                shape = known_shapes.get(node.name, var_shapes.get(node.name))
                if shape is None and "__shape__" in node.attrs:
                    # dim 0 in a declared shape means "unknown, infer me"
                    declared = tuple(int(x) for x in
                                     _parse_tuple(node.attrs["__shape__"]))
                    if declared and all(d > 0 for d in declared):
                        shape = declared
                if shape is not None:
                    vals[(id(node), 0)] = meta(shape, node.attrs)
                    var_shapes[node.name] = tuple(shape)
                continue
            ins = [vals.get((id(p), i)) for p, i in node.inputs]
            if node.op.param_shapes and any(t is None for t in ins):
                shapes = [tuple(t.shape) if t is not None else None for t in ins]
                try:
                    filled = node.op.param_shapes(node.attrs, shapes)
                except (TypeError, KeyError, IndexError):
                    filled = shapes
                for i, ((p, pidx), s) in enumerate(zip(node.inputs, filled)):
                    if ins[i] is None and s is not None and p.is_variable:
                        ins[i] = vals[(id(p), pidx)] = meta(s, p.attrs)
                        var_shapes[p.name] = tuple(s)
            if any(t is None for t in ins):
                missing = [p.name for (p, _), t in zip(node.inputs, ins)
                           if t is None]
                raise MXNetError(
                    f"cannot infer shape: inputs {missing} of node "
                    f"{node.name} ({node.op.name}) unknown")
            try:
                outs = _call_op(node, ins, is_train=False, device="meta")
            except MXNetError:
                raise
            except Exception as e:
                raise MXNetError(f"shape inference failed at node {node.name} "
                                 f"({node.op.name}): {e}") from e
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
        out_shapes = [tuple(vals[(id(n), i)].shape) for n, i in self._outputs]
        return var_shapes, out_shapes

    def attr_dict(self):
        """{node name: its attributes as strings}, op attributes and user
        attributes together (reference symbol.py attr_dict)."""
        out = {}
        for node in self._topo_nodes():
            d = dict(node.scope_attrs)
            if node.op is not None:
                d.update(node.op.attr_spec.serialize(node.attrs))
            else:
                d.update({k: str(v) for k, v in node.attrs.items()})
            if d:
                out[node.name] = d
        return out

    def _arg_layouts(self):
        """{weight variable name: its consumer op's ``layout`` attr}, which
        initializers read for the fan-in and fan-out of channel-last
        weights."""
        out = {}
        for node in self._topo_nodes():
            layout = None if node.op is None else node.attrs.get("layout")
            if not layout or str(layout) == "None":
                continue
            for p, _ in node.inputs:
                if p.is_variable and p.name.endswith("weight"):
                    out[p.name] = str(layout)
        return out

    # -- binding -------------------------------------------------------------
    def _grad_req_dict(self, grad_req):
        names = self.list_arguments()
        if isinstance(grad_req, str):
            return {n: grad_req for n in names}
        if isinstance(grad_req, (list, tuple)):
            return dict(zip(names, grad_req))
        return {n: grad_req.get(n, "null") for n in names}

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """Infer shapes, allocate zero arrays on ``ctx`` (default: the
        current context), a gradient array for each argument whose
        ``grad_req`` (one string, a list in argument order, or a dict) is
        ``write`` or ``add``, and return the bound Executor (reference:
        symbol.py:1250)."""
        from ..context import current_context
        from ..executor import Executor
        from ..ndarray import zeros as nd_zeros

        ctx = ctx or current_context()
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        type_dict = type_dict or {}
        args = {name: nd_zeros(shape, ctx=ctx,
                               dtype=type_dict.get(name, "float32"))
                for name, shape in zip(self.list_arguments(), arg_shapes)}
        aux = {name: nd_zeros(shape, ctx=ctx,
                              dtype=type_dict.get(name, "float32"))
               for name, shape in zip(self.list_auxiliary_states(),
                                      aux_shapes)}
        reqs = self._grad_req_dict(grad_req)
        grads = {name: nd_zeros(args[name].shape, ctx=ctx,
                                dtype=args[name].dtype)
                 for name, req in reqs.items() if req != "null"}
        return Executor(self, ctx, args, grads, reqs, aux)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind the caller's arrays (lists in argument order, or dicts):
        gradients land in ``args_grad``, allocated as zeros where it is
        None (reference: symbol.py:1514)."""
        from ..context import current_context
        from ..executor import Executor
        from ..ndarray import zeros as nd_zeros

        ctx = ctx or current_context()
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        args = dict(args or {})
        missing = set(arg_names) - set(args)
        if missing:
            raise MXNetError(f"bind missing arguments: {sorted(missing)}")
        reqs = self._grad_req_dict(grad_req)
        if args_grad is None:
            args_grad = {n: nd_zeros(args[n].shape, ctx=ctx,
                                     dtype=args[n].dtype)
                         for n, r in reqs.items() if r != "null"}
        aux_states = dict(aux_states or {})
        for n in aux_names:
            if n not in aux_states:
                raise MXNetError(f"bind missing auxiliary state {n}")
        return Executor(self, ctx, args, dict(args_grad), reqs, aux_states)

    # -- serialization (MXNet graph-JSON structure) ---------------------------
    def tojson(self) -> str:
        nodes = self._topo_nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for node in nodes:
            entry = {
                "op": "null" if node.is_variable else node.op.name,
                "name": node.name,
                "inputs": [[nid[id(p)], i, 0] for p, i in node.inputs],
            }
            if node.op is not None:
                attrs = node.op.attr_spec.serialize(node.attrs)
            else:
                attrs = {k: str(v) for k, v in node.attrs.items()}
            if node.scope_attrs:
                attrs.update(node.scope_attrs)
            if attrs:
                entry["attrs"] = attrs
            out_nodes.append(entry)
        graph = {
            "nodes": out_nodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[nid[id(n)], i, 0] for n, i in self._outputs],
            "attrs": {"mxnet_version": ["int", 1100],
                      "mxnet_tpu_version": ["str", __version__]},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())


def _call_op(node: SymbolNode, ins, is_train: bool, device):
    """Run one op node on its input tensors; returns a tuple of outputs.
    Outputs of input-less ops are moved onto ``device``."""
    attrs = dict(node.attrs)
    if node.op.needs_is_train:
        attrs["_is_train"] = is_train
    if node.op.key_var_num_args and not attrs.get(node.op.key_var_num_args):
        attrs[node.op.key_var_num_args] = len(ins)
    # the op's randomness (RNN dropout) runs only in training, from the
    # device's generator
    if node.op.needs_rng:
        gen = (_random.generator(device)
               if is_train and node.op.uses_rng(node.attrs) else None)
        args = (gen,) + tuple(ins)
    else:
        args = ins
    out = node.op.fn(*args, **attrs)
    out = out if isinstance(out, tuple) else (out,)
    if not ins:
        out = tuple(o.to(device) for o in out)
    return out


def Variable(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs) -> Symbol:
    """Create a symbolic variable (reference: symbol.py var/Variable)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = {}
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    if stype is not None:
        attrs["__storage_type__"] = str(stype)
    node = SymbolNode(None, name, attrs, [])
    if attr:
        node.scope_attrs.update({k: str(v) for k, v in attr.items()})
    node.scope_attrs.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(node, 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    outputs = []
    for s in symbols:
        outputs.extend(s._outputs)
    return Symbol(outputs)


def symbol_invoke(opdef: OpDef, inputs: Sequence[Symbol], attrs: Dict,
                  name: Optional[str]) -> Symbol:
    """Compose a new symbol node; missing parameter inputs become variables
    named '{node}_{input}', e.g. 'fc1_weight'."""
    parsed = opdef.parse_attrs(attrs or {})
    name = NameManager.current.get(name, opdef.name)
    entries: List[Tuple[SymbolNode, int]] = []
    for s in inputs:
        if len(s._outputs) != 1:
            raise MXNetError(
                f"cannot compose {opdef.name} with a grouped symbol input")
        entries.append(s._outputs[0])
    input_names = opdef.input_names
    if input_names and not opdef.key_var_num_args:
        n_expected = len(input_names)
        if opdef.num_inputs is None:
            # variadic by attrs (no_bias drops bias)
            n_expected = _expected_inputs(opdef, parsed)
        while len(entries) < n_expected:
            v = Variable(f"{name}_{input_names[len(entries)]}")
            entries.append(v._outputs[0])
    if opdef.key_var_num_args and not parsed.get(opdef.key_var_num_args):
        parsed[opdef.key_var_num_args] = len(entries)
    node = SymbolNode(opdef, name, parsed, entries)
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _expected_inputs(opdef: OpDef, attrs: Dict) -> int:
    if opdef.name == "FullyConnected":
        return 2 if attrs.get("no_bias") else 3
    return len(opdef.input_names or ["data"])


def load_json(json_str: str) -> Symbol:
    """Parse a symbol JSON string: this package's output, the JAX
    package's, or the reference's formats (post-NNVM "attrs", and the
    pre-NNVM legacy "param" for op params plus "attr" for user attrs)."""
    graph = json.loads(json_str)
    nodes: List[SymbolNode] = []
    for entry in graph["nodes"]:
        attrs = dict(entry.get("attrs") or entry.get("param") or {})
        attrs.update(entry.get("attr") or {})
        if entry["op"] == "null":
            # dunder keys (__dtype__ etc.) are structural attrs; the rest
            # (ctx_group, lr_mult) are user attrs
            node_attrs = {k: v for k, v in attrs.items()
                          if k.startswith("__")}
            node = SymbolNode(None, entry["name"], node_attrs, [])
            node.scope_attrs.update(
                {k: v for k, v in attrs.items() if not k.startswith("__")})
        else:
            opdef = get_op(entry["op"])
            known = {k: v for k, v in attrs.items()
                     if k in opdef.attr_spec.fields}
            scope = {k: v for k, v in attrs.items()
                     if k not in opdef.attr_spec.fields}
            inputs = [(nodes[nid], out_idx)
                      for nid, out_idx, *_ in entry["inputs"]]
            node = SymbolNode(opdef, entry["name"], opdef.parse_attrs(known),
                              inputs)
            node.scope_attrs.update(scope)
        nodes.append(node)
    heads = [(nodes[nid], idx) for nid, idx, *_ in graph["heads"]]
    return Symbol(heads)


def load(fname: str) -> Symbol:
    """Load a symbol JSON file (``Symbol.save``'s, or the JAX package's)."""
    with open(fname) as f:
        return load_json(f.read())

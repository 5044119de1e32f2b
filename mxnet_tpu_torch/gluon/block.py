"""Gluon Blocks: imperative-first modules, hybridized into cached ops.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference
python/mxnet/gluon/block.py: ``Block`` :115, ``HybridBlock`` :283,
``hybridize`` :254, ``_build_cache`` :361, ``SymbolBlock`` :493). The JAX
package compiles a hybridized block into one ``jax.jit`` program a
(shapes, dtypes, is_train) key. PyTorch has no such compiler here: a
hybridized block keeps the same cache, one cached op a key, each recording
the parameters its call writes back (BatchNorm's moving statistics) and
its calls, and runs the same ``hybrid_forward`` body eagerly on the
tensors, as the imperative path does. Inside
``autograd.record()`` torch autograd records that body as it records
every op. ``SymbolBlock`` runs its symbol through
``executor.build_graph_eval``.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd, ndarray
from .. import symbol as _symbol
from ..base import MXNetError
from ..executor import build_graph_eval
from ..ndarray import NDArray
from ..symbol import Symbol
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name manager for automatic prefixes (reference block.py:34)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """Create prefix and params for a new Block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _global_count(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, shared=params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            # param names follow the params-dict prefix (which tracks the
            # SHARED dict when one was passed), and the shared link flows
            # down so descendants resolve shared weights by name
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *args):
        _BlockScope._current.value = self._old_scope
        return False


_GLOBAL_NAME_COUNTS = {}


def _global_count(hint):
    count = _GLOBAL_NAME_COUNTS.get(hint, 0)
    _GLOBAL_NAME_COUNTS[hint] = count + 1
    return f"{hint}{count}"


def _flatten_nd(args):
    """Flatten nested lists/tuples of arrays into a flat list + structure."""
    if isinstance(args, (NDArray, Symbol)):
        return [args], 0
    if isinstance(args, (list, tuple)):
        flat, fmts = [], []
        for a in args:
            f, fmt = _flatten_nd(a)
            flat.extend(f)
            fmts.append(fmt)
        return flat, fmts
    return [args], -1


def _regroup_nd(flat, fmt):
    if fmt == 0 or fmt == -1:
        return flat[0], flat[1:]
    out = []
    for f in fmt:
        res, flat = _regroup_nd(flat, f)
        out.append(res)
    return out, flat


class Block:
    """Base class for all neural-network layers and models
    (reference gluon/block.py:115)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        s = "{name}(\n{modstr}\n)" if self._children else "{name}()"
        modstr = "\n".join(
            f"  ({i}): " + repr(c).replace("\n", "\n  ")
            for i, c in enumerate(self._children))
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __setattr__(self, name, value):
        if hasattr(self, "_children") and isinstance(value, Block):
            old = getattr(self, name, None)
            if isinstance(old, Block) and old in self._children:
                # re-assignment replaces the old child in place, otherwise
                # the orphan's params would linger in collect_params()
                self._children[self._children.index(old)] = value
            else:
                self.register_child(value)
        elif hasattr(self, "_reg_params") and isinstance(value, Parameter):
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        """``with self.name_scope():`` children get prefixed names."""
        return self._scope

    def collect_params(self, select=None):
        """Gather this block's and all descendants' parameters
        (reference block.py:186); ``select`` is a regex on names."""
        ret = ParameterDict(self._params.prefix)
        # both the scoped dict (params.get) and directly-assigned Parameter
        # attributes (__setattr__ → _reg_params)
        own = dict(self.params.items())
        own.update({p.name: p for p in self._reg_params.values()})
        if select is None:
            ret.update(own)
        else:
            pat = re.compile(select)
            ret.update({k: v for k, v in own.items() if pat.match(k)})
        for child in self._children:
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block):
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True):
        for child in self._children:
            child.hybridize(active)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def save_params(self, filename):
        """reference gluon/block.py:216"""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, restore_prefix=self.prefix)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block whose forward can be hybridized into cached ops
    (reference gluon/block.py:283)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_ops = {}  # (shapes, dtypes, is_train) -> _CachedOp

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise MXNetError(
                "Children of HybridBlock must also be HybridBlock, but "
                f"{block} is a {type(block).__name__}. Use Block instead if "
                "you need non-hybridizable children")
        super().register_child(block)
        self._cached_ops = {}

    def hybridize(self, active=True):
        self._active = active
        self._cached_ops = {}
        super().hybridize(active)

    def cast(self, dtype):
        self._cached_ops = {}
        super().cast(dtype)

    # -- deferred shape inference ------------------------------------------
    def infer_shape(self, *args):
        """Fix deferred parameter shapes by symbolic shape inference over
        the block's graph (reference block.py _deferred_infer_shape)."""
        flat_args, fmt = _flatten_nd(args)
        inputs = [_symbol.Variable(f"data{i}" if i else "data")
                  for i in range(len(flat_args))]
        params = {name: p.var() for name, p in self._reg_params.items()}
        regrouped, _ = _regroup_nd(list(inputs), fmt)
        with self.name_scope():
            out = self.hybrid_forward(_symbol, *regrouped, **params)
        flat_out, _ = _flatten_nd(out)
        grouped = _symbol.Group(flat_out) if len(flat_out) > 1 else flat_out[0]
        shape_kwargs = {}
        for s, a in zip(inputs, flat_args):
            if isinstance(a, NDArray):
                shape_kwargs[s.name] = a.shape
        arg_shapes, _, aux_shapes = grouped.infer_shape(**shape_kwargs)
        shapes = dict(zip(grouped.list_arguments(), arg_shapes))
        shapes.update(zip(grouped.list_auxiliary_states(), aux_shapes))
        for _, param in self.collect_params().items():
            if param.name in shapes:
                param.shape = tuple(shapes[param.name])
                param._finish_deferred_init()

    # -- hybridized path ----------------------------------------------------
    def _call_cached_op(self, *args):
        """Run the body as the imperative path does, under the cached op
        of the call's key: its first call records which parameters the
        body wrote back (BatchNorm's moving statistics in training)."""
        flat_args, _ = _flatten_nd(args)
        is_train = autograd.is_training()
        key = (tuple((a.shape, str(a.dtype)) if isinstance(a, NDArray)
                     else repr(a) for a in flat_args), is_train)
        entry = self._cached_ops.get(key)
        if entry is None:
            entry = self._cached_ops[key] = _CachedOp(f"_cached_{self.name}",
                                                      key)
        first = entry.calls == 0
        params = list(self.collect_params().values()) if first else []
        before = [p.data()._data for p in params]
        out = self.hybrid_forward(ndarray, *args, **{
            n: p.data() for n, p in self._reg_params.items()})
        if first:
            entry.aux_update = sorted(p.name for p, t in zip(params, before)
                                      if p.data()._data is not t)
        entry.calls += 1
        return out

    def forward(self, x, *args):
        """Dispatch: Symbol input -> symbolic compose; hybridized -> its
        cached op; otherwise op by op."""
        if isinstance(x, Symbol):
            params = {name: p.var()
                      for name, p in self._reg_params.items()}
            with self.name_scope():
                return self.hybrid_forward(_symbol, x, *args, **params)
        try:
            if self._active:
                return self._call_cached_op(x, *args)
            kwargs = {n: p.data() for n, p in self._reg_params.items()}
            return self.hybrid_forward(ndarray, x, *args, **kwargs)
        except DeferredInitializationError:
            self.infer_shape(x, *args)  # finalizes every inferable param
            for name, p in self.collect_params().items():
                if p._deferred_init is not None:
                    raise MXNetError(
                        f"shape of Parameter {name} could not be inferred "
                        f"from the inputs (still {p.shape}); pass explicit "
                        "in_units/in_channels or a complete shape")
            return self.forward(x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _CachedOp:
    """One hybridized call signature of a block (the JAX package's cached
    ``OpDef``): its key, the parameters its first call wrote back
    (``aux_update``: BatchNorm's moving statistics in training) and the
    number of calls. A hybridized child inside it keeps its own."""

    def __init__(self, name, key):
        self.name = name
        self.key = key
        self.calls = 0
        self.aux_update = None


class SymbolBlock(HybridBlock):
    """Wrap a Symbol graph as a callable Block (reference block.py:493).
    Its forward runs the graph through ``executor.build_graph_eval`` on
    the inputs' device; inside ``autograd.record()`` torch autograd
    records it, and in training the graph's auxiliary updates are written
    back into the parameters."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            outputs = _symbol.Group(list(outputs))
        self._in_names = [i.name for i in inputs]
        self._out_sym = outputs
        self._eval = build_graph_eval(outputs)
        arg_names = set(outputs.list_arguments())
        self._aux_names = set(outputs.list_auxiliary_states())
        # the graph's name of each parameter (a parameter's own name
        # carries the block's prefix)
        self._sym_params = {
            name: self.params.get(name, shape=None, allow_deferred_init=True,
                                  grad_req="null" if name in self._aux_names
                                  else "write")
            for name in sorted(arg_names | self._aux_names)
            if name not in self._in_names}

    def forward(self, x, *args):
        if isinstance(x, Symbol):
            return self._out_sym
        recording = autograd.is_recording()
        is_train = autograd.is_training()
        arrays = {name: p.data() for name, p in self._sym_params.items()}
        arrays.update(zip(self._in_names, (x,) + args))
        vals = {name: autograd._graph_tensor(a) if recording else a._data
                for name, a in arrays.items()}
        arg_vals = {n: v for n, v in vals.items() if n not in self._aux_names}
        aux_vals = {n: v for n, v in vals.items() if n in self._aux_names}
        with torch.enable_grad() if recording else torch.no_grad():
            outs, aux_up = self._eval(arg_vals, aux_vals, x._data.device,
                                      is_train)
        for name, val in aux_up.items():
            arrays[name]._set_data(val.detach())
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

"""Executor: a bound symbol graph, run eagerly, with its gradients.

Counterpart of ``mxnet_tpu/executor.py`` (``build_graph_eval`` and
``Executor``, reference graph_executor.h:57-66). PyTorch runs eagerly, so a
forward walks the graph in topological order and calls each op on the
bound tensors. An inference forward runs under ``torch.inference_mode()``.
A training forward records the graph with autograd: every argument whose
``grad_req`` is not ``null`` enters as a leaf that needs a gradient, and
:meth:`Executor.backward` asks autograd for their gradients. The JAX
package recomputes the forward inside its vjp; here the graph runs once a
forward, and a second ``backward`` after one forward reuses it. Graph
passes, program caches and device-placed evaluation are queue A12.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .base import MXNetError
from .ndarray import NDArray
from .symbol.symbol import _call_op

__all__ = ["Executor", "build_graph_eval"]


def build_graph_eval(symbol):
    """Build eval_fn(arg_vals: dict, aux_vals: dict, device, is_train)
    -> (the symbol's outputs (list of tensors), aux updates {name: tensor}
    of ops that write auxiliary states back in training)."""
    nodes = symbol._topo_nodes()
    aux_ids = symbol._aux_node_ids()
    out_entries = list(symbol._outputs)

    def eval_fn(arg_vals: Dict, aux_vals: Dict, device, is_train: bool):
        values, aux_updates = {}, {}
        for node in nodes:
            if node.is_variable:
                src = aux_vals if id(node) in aux_ids else arg_vals
                values[(id(node), 0)] = src[node.name]
                continue
            ins = [values[(id(p), i)] for p, i in node.inputs]
            outs = _call_op(node, ins, is_train, device)
            for i, o in enumerate(outs):
                values[(id(node), i)] = o
            if is_train:
                for out_idx, in_idx in node.op.aux_update.items():
                    parent, _ = node.inputs[in_idx]
                    if parent.is_variable and id(parent) in aux_ids:
                        aux_updates[parent.name] = outs[out_idx]
        return [values[(id(n), i)] for n, i in out_entries], aux_updates

    return eval_fn


class Executor:
    """A bound executor over one symbol: ``arg_dict``, ``grad_dict`` (an
    array for each argument whose ``grad_req`` is ``write`` or ``add``) and
    ``aux_dict`` (reference: graph_executor.h:57-66)."""

    def __init__(self, symbol, ctx, args: Dict[str, NDArray],
                 grads: Dict[str, NDArray], grad_req: Dict[str, str],
                 aux: Dict[str, NDArray]):
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device()
        self.arg_dict = args
        self.grad_dict = grads
        self.aux_dict = aux
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        for name, req in grad_req.items():
            if req not in ("null", "write", "add"):
                raise MXNetError(f"grad_req {req!r} of {name}: one of null, "
                                 "write, add")
        self._grad_req = {n: grad_req.get(n, "null") for n in self._arg_names}
        self._diff_args = [n for n in self._arg_names
                           if self._grad_req[n] != "null"]
        self.outputs: List[NDArray] = []
        self._eval = build_graph_eval(symbol)
        self._graph = None  # (leaves, outputs) of the last training forward

    # -- API ----------------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._output_names, self.outputs))

    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays; ``kwargs`` first copy new
        values into named arguments. With ``is_train`` the graph is
        recorded for :meth:`backward` and ops write their auxiliary states
        back."""
        for name, val in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError(f"unknown argument {name}")
            self.arg_dict[name][:] = val
        self._graph = None
        args = {n: self.arg_dict[n]._data for n in self._arg_names}
        aux = {n: self.aux_dict[n]._data for n in self._aux_names}
        if not is_train:
            with torch.inference_mode():
                outs, _ = self._eval(args, aux, self._device, False)
            self.outputs = [NDArray(o) for o in outs]
            return self.outputs
        leaves = {}
        for name in self._diff_args:
            t = args[name]
            # an inference-mode tensor cannot be saved for backward
            t = t.clone() if t.is_inference() else t.detach()
            args[name] = leaves[name] = t.requires_grad_()
        with torch.enable_grad():
            outs, aux_up = self._eval(args, aux, self._device, True)
        for name, val in aux_up.items():
            self.aux_dict[name]._set_data(val.detach())
        self._graph = (leaves, outs)
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the last training forward's outputs, each with its
        head gradient (``out_grads``; a missing one is ``ones_like`` the
        output, as in the JAX package's ``_run_fwd_bwd``), into
        ``grad_dict``: written for ``grad_req='write'``, added for
        ``'add'``. An argument the outputs do not depend on gets zeros."""
        if self._graph is None:
            raise MXNetError("backward needs a forward(is_train=True) first")
        leaves, outs = self._graph
        if out_grads is None:
            heads = [None] * len(outs)
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [None if g is None else g._data for g in out_grads]
        pairs = [(o, torch.ones_like(o) if h is None else h.to(o.dtype))
                 for o, h in zip(outs, heads) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs and names:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                [h for _, h in pairs], retain_graph=True, allow_unused=True)
        for name, g in zip(names, grads):
            buf = self.grad_dict.get(name)
            if buf is None:
                continue
            if g is None:
                g = torch.zeros_like(leaves[name])
            g = g.to(buf._data.dtype)
            if self._grad_req[name] == "add":
                buf._set_data(buf._data + g)
            else:
                buf._set_data(g)

    def forward_backward(self, out_grads=None, **kwargs):
        """A training forward and its backward, in one call."""
        self.forward(is_train=True, **kwargs)
        self.backward(out_grads)
        return self.outputs

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arguments and auxiliary states."""
        for name, val in (arg_params or {}).items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = val
            elif not allow_extra_params:
                raise MXNetError(f"unknown argument {name}")
        for name, val in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name][:] = val
            elif not allow_extra_params:
                raise MXNetError(f"unknown aux state {name}")

"""Executor: a bound symbol graph, run eagerly.

Counterpart of the forward half of ``mxnet_tpu/executor.py``
(``build_graph_eval`` and ``Executor``). PyTorch runs eagerly, so a forward
walks the graph in topological order and calls each op on the bound
tensors under ``torch.inference_mode()``. Graph passes, program caches,
device-placed evaluation and backward come with later slices.
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
    -> the symbol's outputs (list of tensors)."""
    nodes = symbol._topo_nodes()
    aux_ids = symbol._aux_node_ids()
    out_entries = list(symbol._outputs)

    def eval_fn(arg_vals: Dict, aux_vals: Dict, device, is_train: bool):
        values = {}
        for node in nodes:
            if node.is_variable:
                src = aux_vals if id(node) in aux_ids else arg_vals
                values[(id(node), 0)] = src[node.name]
                continue
            ins = [values[(id(p), i)] for p, i in node.inputs]
            for i, o in enumerate(_call_op(node, ins, is_train, device)):
                values[(id(node), i)] = o
        return [values[(id(n), i)] for n, i in out_entries]

    return eval_fn


class Executor:
    """A bound, forward-only executor over one symbol (reference:
    graph_executor.h:57-66)."""

    def __init__(self, symbol, ctx, args: Dict[str, NDArray],
                 aux: Dict[str, NDArray]):
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device()
        self.arg_dict = args
        self.aux_dict = aux
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.outputs: List[NDArray] = []
        self._eval = build_graph_eval(symbol)

    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays; ``kwargs`` first copy new
        values into named arguments."""
        if is_train:
            raise MXNetError("this executor runs inference only; training "
                             "comes with the training slice")
        for name, val in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError(f"unknown argument {name}")
            self.arg_dict[name][:] = val
        with torch.inference_mode():
            outs = self._eval(
                {n: self.arg_dict[n]._data for n in self._arg_names},
                {n: self.aux_dict[n]._data for n in self._aux_names},
                self._device, False)
        self.outputs = [NDArray(o) for o in outs]
        return self.outputs

"""PythonModule / PythonLossModule: modules implemented in Python.

Counterpart of ``mxnet_tpu/module/python_module.py`` (reference
python/mxnet/module/python_module.py): a BaseModule with no parameters
whose forward and backward the user writes (the reference's example is a
custom loss on top of a network, chained through SequentialModule).
Introspection is generated from the stored fields; only the compute hooks
are written out. A loss module's gradient lies on its scores' device.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from ..io import DataDesc
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


def _stored(attr):
    return property(lambda self: getattr(self, attr),
                    doc=f"The module's {attr.lstrip('_')}.")


def _as_descs(shapes):
    if shapes is None:
        return None
    return [d if isinstance(d, DataDesc) else DataDesc(*d) for d in shapes]


class PythonModule(BaseModule):
    """Parameterless module; subclasses implement forward/backward."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = self._label_shapes = self._output_shapes = None

    data_names = _stored("_data_names")
    output_names = _stored("_output_names")
    data_shapes = _stored("_data_shapes")
    label_shapes = _stored("_label_shapes")
    output_shapes = _stored("_output_shapes")

    # -- parameters: a python module has none --------------------------------
    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = _as_descs(data_shapes)
        if label_shapes is not None:
            self._label_shapes = _as_descs(label_shapes)
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        raise NotImplementedError


class PythonLossModule(PythonModule):
    """Scalar-ish loss in python: forward stores data, backward emits the
    gradient from ``grad_func`` (reference python_module.py:PythonLossModule
    — default grad is for softmax CE fused heads)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._name = name
        self._grad_func = grad_func
        self._scores = self._labels = self._scores_grad = None

    def _compute_output_shapes(self):
        return [DataDesc(self._name + "_output", self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "pyloss is a head; no out_grads expected"
        assert self.for_training
        from ..ndarray import array as nd_array

        ctx = self._scores.context
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not hasattr(grad, "asnumpy"):
                grad = nd_array(np.asarray(grad), ctx=ctx)
        else:
            # default: d(softmax CE)/d(prob) with prob inputs = p - onehot
            grad = self._scores.asnumpy().copy()
            rows = np.arange(grad.shape[0])
            grad[rows, self._labels.asnumpy().astype(int).ravel()] -= 1.0
            grad = nd_array(grad, ctx=ctx)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError

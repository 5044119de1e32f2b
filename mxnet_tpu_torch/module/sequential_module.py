"""SequentialModule: chain modules, each consuming the previous outputs.

Counterpart of ``mxnet_tpu/module/sequential_module.py`` (reference
python/mxnet/module/sequential_module.py): ``add`` with
``take_labels``/``auto_wiring`` metadata, binding each submodule on the
previous one's output shapes, forward and backward chained through the
list. The chain is held as ``_Link`` records (module and routing flags).
"""
from __future__ import annotations

import logging
from typing import NamedTuple

from ..base import MXNetError
from ..initializer import Uniform
from ..io import DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class _Link(NamedTuple):
    """One chained submodule and how data/labels route into it."""
    module: object
    wants_labels: bool   # bind-time labels are forwarded to this link
    auto_wire: bool      # rename upstream outputs to this link's data names


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger)
        self._chain: list[_Link] = []
        self._label_shapes = None
        self._data_shapes = None

    def add(self, module, **kwargs):
        """Append a module. kwargs: take_labels=True routes the bind-time
        labels to this submodule; auto_wiring=True renames the previous
        module's outputs to this module's data names."""
        known = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}
        unknown = set(kwargs) - known
        if unknown:
            raise MXNetError(f"unknown meta {sorted(unknown)}; "
                             f"valid: {sorted(known)}")
        self._chain.append(_Link(module,
                                 bool(kwargs.get(self.META_TAKE_LABELS)),
                                 bool(kwargs.get(self.META_AUTO_WIRING))))
        self.binded = self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _each(self):
        return (link.module for link in self._chain)

    @property
    def _head(self):
        return self._chain[0].module

    @property
    def _tail(self):
        return self._chain[-1].module

    # -- introspection ------------------------------------------------------
    @property
    def data_names(self):
        return self._head.data_names if self._chain else []

    @property
    def output_names(self):
        return self._tail.output_names if self._chain else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._head.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._tail.output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        args, auxs = {}, {}
        for mod in self._each():
            a, x = mod.get_params()
            args |= a
            auxs |= x
        return args, auxs

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for mod in self._each():
            mod.init_params(initializer=initializer, arg_params=arg_params,
                            aux_params=aux_params, allow_missing=True,
                            force_init=force_init)
        # duplicate parameter names across submodules are a wiring bug
        owner: dict = {}
        for i, mod in enumerate(self._each()):
            for name in mod.get_params()[0]:
                if name in owner:
                    raise MXNetError(
                        f"duplicate parameter {name} in modules "
                        f"{owner[name]} and {i}")
                owner[name] = i
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("shared_module not supported by "
                             "SequentialModule")
        if not self._chain:
            raise MXNetError("add modules before binding")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        # labels survive only if some link consumes them
        self._label_shapes = (label_shapes if
                              any(l.wants_labels for l in self._chain)
                              else None)

        upstream = data_shapes
        for i, link in enumerate(self._chain):
            feed = upstream
            if link.auto_wire:
                names = link.module.data_names
                assert len(names) == len(feed)
                feed = [DataDesc(n, d.shape) for n, d in zip(names, feed)]
            link.module.bind(
                data_shapes=feed,
                label_shapes=label_shapes if link.wants_labels else None,
                for_training=for_training,
                inputs_need_grad=(inputs_need_grad if i == 0
                                  else bool(for_training)),
                force_rebind=force_rebind, grad_req=grad_req)
            upstream = link.module.output_shapes
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        for mod in self._each():
            mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                               optimizer_params=optimizer_params,
                               force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch

        batch = data_batch
        for pos, mod in enumerate(self._each(), start=1):
            mod.forward(batch, is_train=is_train)
            if pos == len(self._chain):
                break
            batch = DataBatch(data=mod.get_outputs(),
                              label=data_batch.label,
                              pad=getattr(data_batch, "pad", 0))

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for pos, link in enumerate(reversed(self._chain)):
            link.module.backward(out_grads=out_grads)
            if pos == len(self._chain) - 1:
                break
            out_grads = link.module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for mod in self._each():
            mod.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._tail.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._head.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for link in self._chain:
            if link.wants_labels:
                link.module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for mod in self._each():
            mod.install_monitor(mon)

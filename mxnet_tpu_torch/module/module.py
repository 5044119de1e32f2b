"""Module: an executor-backed trainer over one Symbol.

Counterpart of ``mxnet_tpu/module/module.py`` (reference
python/mxnet/module/module.py: bind:351, init_optimizer:460,
forward:556, backward:598, update:615). One context: the default is the
port's, ``gpu(0)``; several contexts (data parallelism) and ``group2ctxs``
are queue A11. The executor's gradients go through the optimizer's
updater, one parameter at a time (``model._update_params``); the fused
whole step (``_fused_train_step``) is queue A6 and gives None.
"""
from __future__ import annotations

import logging

from .. import optimizer as opt
from ..base import MXNetError
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import _create_kvstore, _update_params, save_checkpoint
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


def _namelist(value):
    return list(value) if value is not None else []


def _descs(shapes):
    return [x if isinstance(x, DataDesc) else DataDesc(*x)
            for x in (shapes or [])]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None):
        super().__init__(logger=logger)
        from ..context import current_context
        if context is None:
            context = current_context()
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError(f"Module over {len(context)} contexts needs "
                                 "the data parallelism of queue A11")
            context = context[0]
        if group2ctxs:
            raise MXNetError("Module(group2ctxs=...) needs the model "
                             "parallelism of queue A11")
        self._context = context
        self._symbol = symbol

        roles = {"data": (_namelist(data_names), True),
                 "label": (_namelist(label_names), False),
                 "state": (_namelist(state_names), True),
                 "fixed_param": (_namelist(fixed_param_names), True)}
        for role, (names, strict) in roles.items():
            _check_input_names(symbol, names, role, strict)
        self._data_names, self._label_names, self._state_names, \
            self._fixed_param_names = (roles[r][0] for r in
                                       ("data", "label", "state",
                                        "fixed_param"))
        non_param = set(self._data_names) | set(self._label_names) \
            | set(self._state_names)
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in non_param]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()

        self._arg_params = self._aux_params = None
        self._params_dirty = False
        self._optimizer = self._kvstore = self._updater = None
        self._preload_opt_states = None
        self._exec = None
        self._data_shapes = self._label_shapes = None

    @staticmethod
    def load(prefix, epoch=None, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol and params (the port's or
        the JAX package's); with ``load_optimizer_states`` the ``.states``
        file is loaded by ``init_optimizer``."""
        from ..model import _load_checkpoint_ex
        _, sym, args, auxs, states = _load_checkpoint_ex(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            if states is None:
                raise MXNetError(f"checkpoint at {prefix!r} has no optimizer "
                                 "states (.states) file")
            mod._preload_opt_states = states
        return mod

    def save_checkpoint(self, prefix, epoch=None,
                        save_optimizer_states=False):
        """reference: module.py:152 — the symbol, the params and, with
        ``save_optimizer_states``, the updater's state, under one
        manifest."""
        states = (self._updater.get_states(dump_optimizer=True)
                  if save_optimizer_states else None)
        save_checkpoint(prefix, epoch, self.symbol, *self.get_params(),
                        states=states)

    def save(self, prefix, save_optimizer_states=False):
        """The epoch-less checkpoint (``prefix.params``)."""
        self.save_checkpoint(prefix, None,
                             save_optimizer_states=save_optimizer_states)

    # -- shapes --------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        shape_kwargs = {d.name: d.shape
                        for d in self._data_shapes + self._label_shapes}
        _, out_shapes, _ = self._symbol.infer_shape(**shape_kwargs)
        return [DataDesc(n, tuple(s))
                for n, s in zip(self._output_names, out_shapes)]

    # -- params --------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def _sync_params_from_devices(self):
        if self._exec is None:
            return
        self._arg_params = {n: self._exec.arg_dict[n].copy()
                            for n in self._param_names}
        self._aux_params = {n: self._exec.aux_dict[n].copy()
                            for n in self._aux_names}
        self._params_dirty = False

    def _fused_train_step(self):
        """The fused whole step is queue A6: ``fit`` runs
        ``forward_backward`` and ``update``."""
        return None

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """reference: module.py:246 — given arrays are copied in, the rest
        drawn by ``initializer`` on the host and copied onto the device."""
        if self.params_initialized and not force_init:
            logging.warning("Parameters already initialized and "
                            "force_init=False. init_params call ignored.")
            return
        assert self.binded, "call bind before initializing the parameters"
        attrs = self._symbol.attr_dict()
        for pname, layout in self._symbol._arg_layouts().items():
            attrs.setdefault(pname, {})["__layout__"] = layout

        def fill(name, arr, supplied):
            given = supplied.get(name) if supplied else None
            if given is not None:
                if given is not arr:
                    arr[:] = given
                return
            if initializer is None and not allow_missing:
                raise RuntimeError(f"init failed: no initializer and "
                                   f"param {name} missing")
            if initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)

        for name in self._param_names:
            fill(name, self._exec.arg_dict[name], arg_params)
        for name in self._aux_names:
            fill(name, self._exec.aux_dict[name], aux_params)
        self.params_initialized = True
        self._params_dirty = False

    # -- bind ----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """reference: module.py:351 — one executor on the module's
        context, a gradient for each parameter (``grad_req``) when
        ``for_training``, for the data when ``inputs_need_grad``."""
        if force_rebind:
            if self._exec is not None and self._params_dirty:
                self._sync_params_from_devices()
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes)

        shape_kwargs = {d.name: d.shape
                        for d in self._data_shapes + self._label_shapes}
        req = {}
        for name in self._symbol.list_arguments():
            if name in self._data_names:
                req[name] = "write" if inputs_need_grad else "null"
            elif name in self._label_names or name in self._state_names:
                req[name] = "null"
            elif name in self._fixed_param_names or not for_training:
                req[name] = "null"
            else:
                req[name] = grad_req
        self._exec = self._symbol.simple_bind(ctx=self._context,
                                              grad_req=req, **shape_kwargs)
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())
        elif self.params_initialized:
            # params loaded before bind (Module.load), or kept across a
            # force_rebind: the fresh executor starts zeroed
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)

    # -- optimizer ------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """reference: module.py:460 — ``rescale_grad`` is 1/batch_size
        unless given."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        arg_dict = {n: self._exec.arg_dict[n] for n in self._param_names}
        self._kvstore, _ = _create_kvstore(kvstore, 1, arg_dict)
        rescale_grad = 1.0 / self._data_shapes[0].shape[0]
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size "
                    f"({optimizer.rescale_grad} vs. {rescale_grad}). Is this "
                    "intended?")
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share another Module's optimizer and updater."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -- compute -------------------------------------------------------------
    def _input_dict(self, data_batch):
        inputs = {}
        data = data_batch.data
        if not isinstance(data, (list, tuple)):
            data = [data]
        for name, arr in zip(self._data_names, data):
            inputs[name] = arr
        label = data_batch.label
        if label is not None and self._label_names:
            if not isinstance(label, (list, tuple)):
                label = [label]
            for name, arr in zip(self._label_names, label):
                inputs[name] = arr
        return inputs

    def forward(self, data_batch, is_train=None):
        """reference: module.py:556 — the batch is copied onto the
        module's device."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._exec.forward(is_train=is_train, **self._input_dict(data_batch))

    def backward(self, out_grads=None):
        """reference: module.py:598"""
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self._exec.forward_backward(**self._input_dict(data_batch))

    def update(self):
        """reference: module.py:615 — one updater call a parameter."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        _update_params([self._exec.arg_dict[n] for n in self._param_names],
                       [self._exec.grad_dict.get(n)
                        for n in self._param_names],
                       updater=self._updater, num_device=1,
                       kvstore=self._kvstore, param_names=self._param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return [self._exec.arg_dict[n] for n in self._state_names]

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        if states is not None:
            for name, s in zip(self._state_names, states):
                self._exec.arg_dict[name][:] = s
        else:
            for name in self._state_names:
                self._exec.arg_dict[name][:] = value

    def update_metric(self, eval_metric, labels):
        """The metric reads the outputs where they are (sync-free)."""
        eval_metric.update([] if labels is None else labels,
                           self.get_outputs())

    def install_monitor(self, mon):
        raise MXNetError("Monitor is queue A15, not ported yet")

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_optimizer_states(self, fname):
        """The updater's state from a ``.states`` file this package
        wrote."""
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

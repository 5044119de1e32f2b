"""Optimizers + Updater: the port of ``mxnet_tpu/optimizer.py``.

Reference: python/mxnet/optimizer.py — Optimizer base with registry
(register:93), SGD:334, NAG, SGLD, DCASGD, Adam:539, AdaGrad:594,
RMSProp:631, AdaDelta, Ftrl, Test, plus the ``Updater`` closure used by
kvstore ``set_updater``. Updates run through the update ops
(ops/optimizer_ops.py — reference src/operator/optimizer_op.cc) and put the
new value behind the weight's NDArray handle, as the JAX package does.

Not yet here: SGLD draws its noise from ``random`` and raises until queue
A9 ports it; sparse (row_sparse) gradients wait for the sparse arrays of
A9, so every gradient is dense.
"""
from __future__ import annotations

import math
import pickle
from typing import Dict

import numpy as _np

from .base import MXNetError, Registry
from .ndarray import ndarray as _ndmod
from .ndarray import zeros_like

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "DCASGD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Test", "Updater", "get_updater",
           "register", "create"]

_REG = Registry("optimizer")


def register(klass):
    _REG.register(klass)
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return _REG.get(name)(**kwargs)


def _invoke(name, inputs, attrs):
    return _ndmod.imperative_invoke(name, inputs, attrs)


class Optimizer:
    """Base optimizer (reference: optimizer.py Optimizer)."""

    opt_registry = _REG._map  # reference-compat alias

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        self.idx2name = dict(param_idx2name)
        self.sym_info = None
        if sym is not None:
            self.sym_info = (sym.attr_dict(), sym.list_arguments())
        self.param_dict = param_dict or {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def register(klass):  # decorator parity
        return register(klass)

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined. Set lr on the scheduler instead.")
        self.lr = lr

    def _sym_declared_mults(self, key):
        """Multipliers declared on symbol attributes (__lr_mult__ /
        __wd_mult__, reference: Symbol attr plumbing)."""
        declared = {}
        if self.sym_info:
            attrs, arg_names = self.sym_info
            for name in arg_names:
                value = attrs.get(name, {}).get(key)
                if value is not None:
                    declared[name] = float(value)
        return declared

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_declared_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # biases/BN params take no weight decay unless told otherwise
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._sym_declared_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count
        count[index] = count.get(index, self.begin_num_update) + 1
        self.num_update = max(count[index], self.num_update)

    def _multiplier(self, index, table, field):
        """Per-param multiplier: Parameter object wins, then the index
        table, then the name table (reference _get_lr/_get_wd lookup
        order)."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], field)
        if index in table:
            return table[index]
        return table.get(self.idx2name.get(index), 1.0)

    def _get_lr(self, index):
        base = (self.lr if self.lr_scheduler is None
                else self.lr_scheduler(self.num_update))
        return base * self._multiplier(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._multiplier(index, self.wd_mult, "wd_mult")

    def _prepare(self, index, grad):
        """Common update preamble: bump the counter, resolve lr/wd, and
        rescale+clip the gradient (python-math optimizers share this;
        op-backed ones pass the raw grad to their fused update op)."""
        self._update_count(index)
        scaled = grad * self.rescale_grad
        if self.clip_gradient is not None:
            scaled = scaled.clip(-self.clip_gradient, self.clip_gradient)
        return self._get_lr(index), self._get_wd(index), scaled

    def _common_attrs(self, lr, wd):
        return {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad,
                "clip_gradient": (self.clip_gradient
                                  if self.clip_gradient is not None else -1.0)}


@register
class SGD(Optimizer):
    """SGD with momentum and optional fp16 multi-precision
    (reference: optimizer.py:334; sgd_update/sgd_mom_update ops)."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        weight32 = None
        if self.multi_precision and weight.dtype == _np.float16:
            weight32 = weight.astype("float32")
        mom = (zeros_like(weight32 if weight32 is not None else weight)
               if self.momentum != 0.0 else None)
        if weight32 is not None:
            return (mom, weight32)
        return mom

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        attrs = self._common_attrs(lr, wd)
        if isinstance(state, tuple):  # multi-precision
            mom, weight32 = state
            if mom is None:
                new_w, new_w32 = _invoke("mp_sgd_update",
                                         [weight, grad, weight32], attrs)
                weight._set_data(new_w._data)
                weight32._set_data(new_w32._data)
            else:
                attrs["momentum"] = self.momentum
                new_w, new_mom, new_w32 = _invoke(
                    "mp_sgd_mom_update", [weight, grad, mom, weight32], attrs)
                weight._set_data(new_w._data)
                mom._set_data(new_mom._data)
                weight32._set_data(new_w32._data)
            return
        if state is None:
            (new_w,) = _invoke("sgd_update", [weight, grad], attrs)
            weight._set_data(new_w._data)
        else:
            attrs["momentum"] = self.momentum
            new_w, new_mom = _invoke("sgd_mom_update", [weight, grad, state],
                                     attrs)
            weight._set_data(new_w._data)
            state._set_data(new_mom._data)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference: optimizer.py NAG)."""

    def update(self, index, weight, grad, state):
        lr, wd, grad = self._prepare(index, grad)
        if state is not None:
            state *= self.momentum
            grad += wd * weight
            state += grad
            grad += self.momentum * state
            weight += -lr * grad
        else:
            weight += -lr * (grad + wd * weight)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.py SGLD)."""

    def update(self, index, weight, grad, state):
        raise MXNetError("SGLD draws Gaussian noise from `random`, which "
                         "the port does not have yet (ROADMAP queue A9)")


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference: optimizer.py DCASGD)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (zeros_like(weight), weight.copy())

    def update(self, index, weight, grad, state):
        lr, wd, grad = self._prepare(index, grad)
        mom, previous_weight = state
        comp = grad + self.lamda * grad * grad * (weight - previous_weight)
        if mom is not None:
            mom *= self.momentum
            mom += -lr * (comp + wd * weight)
            delta = mom
            weight += delta
        else:
            weight += -lr * (comp + wd * weight)
        previous_weight._set_data(weight._data)


@register
class Adam(Optimizer):
    """Adam (reference: optimizer.py:539; adam_update op)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros_like(weight), zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        mean, var = state
        attrs = self._common_attrs(lr, wd)
        attrs.update({"beta1": self.beta1, "beta2": self.beta2,
                      "epsilon": self.epsilon})
        new_w, new_mean, new_var = _invoke("adam_update",
                                           [weight, grad, mean, var], attrs)
        weight._set_data(new_w._data)
        mean._set_data(new_mean._data)
        var._set_data(new_var._data)


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference: optimizer.py:594)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = grad.clip(-self.clip_gradient, self.clip_gradient)
        history = state
        history += grad * grad
        weight += -lr * (grad / (history + self.float_stable_eps).sqrt()
                         + wd * weight)


@register
class RMSProp(Optimizer):
    """RMSProp, plain (Hinton) and centered (Alex Graves) variants
    (reference: optimizer.py:631; rmsprop_update/rmspropalex_update ops)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (zeros_like(weight), zeros_like(weight), zeros_like(weight))
        return (zeros_like(weight),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        attrs = self._common_attrs(lr, wd)
        attrs.update({"gamma1": self.gamma1, "epsilon": self.epsilon,
                      "clip_weights": self.clip_weights or -1.0})
        if not self.centered:
            (n,) = state
            new_w, new_n = _invoke("rmsprop_update", [weight, grad, n], attrs)
            weight._set_data(new_w._data)
            n._set_data(new_n._data)
        else:
            n, g, delta = state
            attrs["gamma2"] = self.gamma2
            new_w, new_n, new_g, new_delta = _invoke(
                "rmspropalex_update", [weight, grad, n, g, delta], attrs)
            weight._set_data(new_w._data)
            n._set_data(new_n._data)
            g._set_data(new_g._data)
            delta._set_data(new_delta._data)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.py AdaDelta)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros_like(weight), zeros_like(weight))

    def update(self, index, weight, grad, state):
        _, wd, grad = self._prepare(index, grad)
        acc_g, acc_delta = state
        acc_g._set_data((self.rho * acc_g + (1 - self.rho) * grad * grad)._data)
        current_delta = ((acc_delta + self.epsilon).sqrt()
                         / (acc_g + self.epsilon).sqrt()) * grad
        acc_delta._set_data(
            (self.rho * acc_delta + (1 - self.rho) * current_delta
             * current_delta)._data)
        weight._set_data((weight - current_delta - wd * weight)._data)


@register
class Ftrl(Optimizer):
    """FTRL (reference: optimizer.py Ftrl)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (zeros_like(weight), zeros_like(weight))  # z, n

    def update(self, index, weight, grad, state):
        lr, wd, grad = self._prepare(index, grad)
        z, n = state
        sigma = -n.sqrt()
        n += grad * grad
        denom = n.sqrt()
        sigma += denom
        sigma /= lr
        z += grad - sigma * weight
        new_w = ((z.abs() > self.lamda1) *
                 ((z.sign() * self.lamda1 - z) /
                  ((self.beta + denom) / lr + wd)))
        weight._set_data(new_w._data)


@register
class Test(Optimizer):
    """No-frills test optimizer (reference: optimizer.py Test — used by
    kvstore tests)."""

    def create_state(self, index, weight):
        return zeros_like(weight)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state._set_data(weight._data)


class Updater:
    """Per-key state closure applied on grad push (reference: optimizer.py
    Updater; runs server-side in dist kvstore)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict = {}
        self.states_synced: Dict = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
            self.states_synced[index] = True
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        """Restore states. A (states, optimizer) tuple (written by
        ``get_states(dump_optimizer=True)``) additionally restores the
        *update counters* (Adam/rmsprop bias correction) onto the LIVE
        optimizer — the live object keeps its freshly configured
        hyperparameters (lr, rescale_grad, scheduler), so resuming with a
        new batch size or lr behaves as configured."""
        obj = pickle.loads(states) if isinstance(states, bytes) else states
        if isinstance(obj, tuple) and len(obj) == 2 \
                and isinstance(obj[1], Optimizer):
            self.states, saved_opt = obj
            self.optimizer._index_update_count = dict(
                saved_opt._index_update_count)
            self.optimizer.num_update = saved_opt.num_update
        else:
            self.states = obj
        self.states_synced = {k: False for k in self.states}

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer)
                            if dump_optimizer else self.states)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)

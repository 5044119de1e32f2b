"""Gluon Trainer: applies an Optimizer to a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference
python/mxnet/gluon/trainer.py: ``step`` :116). ``step`` updates every
parameter whose gradient a backward wrote since the last step (a stale one
raises unless ``ignore_stale_grad``) through
``perf.step_runtime.apply_fused_triples`` and ``FusedOptimizerApply``: one
CUDA graph for the parameter set, captured at the first step and replayed
after it, with the step's ``rescale_grad`` (1 / batch_size) a device input.
``MXTPU_FUSED_STEP=0``, or an optimizer without a functional rule, takes the
per-parameter loop instead. ``loss_scale=`` arms the dynamic loss scale: the
caller multiplies its loss by ``trainer.loss_scale.scale``, the update
divides it out, skips a step with a non-finite gradient inside the captured
graph, and the host-side schedule advances from the step's finite flag.
``mesh``/``shard_optimizer_state`` (queue A11) and
``save_states(checkpointer=...)`` (queue A13) raise.
"""
from __future__ import annotations

import os
import pickle
import tempfile

from .. import ndarray
from .. import optimizer as opt
from ..base import MXNetError, getenv
from ..perf.step_runtime import (FusedOptimizerApply, apply_fused_triples,
                                 has_functional_update)
from ..quant.loss_scale import DynamicLossScale, LossScaleConfig
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _atomic_write_bytes(path, data):
    """Write ``data`` to ``path`` through a temporary file in the same
    directory, fsynced and renamed over it: a reader sees the old file or
    the new one, never a torn one (``resilience/checkpoint.py:
    atomic_write_bytes`` of the JAX package)."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 mesh=None, shard_optimizer_state=None, loss_scale=None):
        if mesh is not None or shard_optimizer_state:
            raise MXNetError(
                "Trainer(mesh=, shard_optimizer_state=) needs the "
                "ShardingPlan of queue A11, not ported yet")
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}")
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise MXNetError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}")
            self._params.append(param)
        self._scale = 1.0
        self._init_optimizer(optimizer, optimizer_params or {})
        # last-seen grad-buffer versions, for stale-grad detection
        self._grad_versions = [None] * len(self._params)
        # the fused update (None: not built; False: no functional rule)
        self._fused_apply = None
        self._loss_scale = None
        if loss_scale:
            if not has_functional_update(self._optimizer):
                raise MXNetError(
                    "Trainer(loss_scale=...) needs an optimizer with a "
                    "functional update rule (sgd/nag/adam/rmsprop): the "
                    "finite check runs inside the fused update")
            cfg = LossScaleConfig() if loss_scale is True else loss_scale
            self._loss_scale = DynamicLossScale(cfg)

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError(
                    "optimizer_params must be empty if optimizer is an "
                    "Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer,
                                         param_idx2name={
                                             i: p.name for i, p in
                                             enumerate(self._params)},
                                         **optimizer_params)
        self._states = [None] * len(self._params)
        self._states_created = [False] * len(self._params)

    @property
    def loss_scale(self):
        """The host-side :class:`~mxnet_tpu_torch.quant.DynamicLossScale`
        (None unless ``Trainer(loss_scale=...)``): multiply the loss by
        ``trainer.loss_scale.scale`` before ``backward()``."""
        return self._loss_scale

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer update from each parameter's current gradient,
        rescaled by ``1 / batch_size`` (reference trainer.py:step). A
        parameter whose gradient buffer no backward has written since the
        previous step is stale and raises, unless ``ignore_stale_grad``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._loss_scale is not None:
            self._optimizer.rescale_grad /= self._loss_scale.scale
        live = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            grad = param.grad()
            if not ignore_stale_grad:
                if self._grad_versions[i] == grad.version:
                    raise MXNetError(
                        f"Gradient of Parameter `{param.name}` has not been "
                        "updated by backward since last `step`. This could "
                        "mean a bug in your model that made it only use a "
                        "subset of the Parameters for this iteration. If you "
                        "are intentionally only using a subset, call step "
                        "with ignore_stale_grad=True")
                self._grad_versions[i] = grad.version
            if not self._states_created[i]:
                self._states[i] = self._optimizer.create_state(
                    i, param.data())
                self._states_created[i] = True
            live.append((i, param, grad))
        if self._fused_step(live):
            if self._loss_scale is not None and live:
                self._loss_scale.update(self._fused_apply.last_finite)
            return
        if self._loss_scale is not None and live:
            raise MXNetError(
                "Trainer(loss_scale=...): this step fell back to the "
                "per-parameter update (MXTPU_FUSED_STEP=0), which cannot "
                "run the finite guard of the fused update; disable loss "
                "scaling or keep the fused path")
        for i, param, grad in live:
            self._optimizer.update(i, param.data(), grad, self._states[i])

    def _fused_step(self, live):
        """The whole update as one fused apply; False when this step runs
        the per-parameter loop."""
        if self._fused_apply is False or not live \
                or not getenv("MXTPU_FUSED_STEP", 1, int):
            return False
        optimizer = self._optimizer
        apply = self._fused_apply
        if apply is None or apply._opt is not optimizer:
            if not has_functional_update(optimizer):
                self._fused_apply = False
                return False
            self._fused_apply = FusedOptimizerApply(
                optimizer, name="gluon-trainer",
                loss_scale=(self._loss_scale.config
                            if self._loss_scale is not None else None))
        triples = [(i, param.data(), grad) for i, param, grad in live]
        return apply_fused_triples(self._fused_apply, optimizer, triples,
                                   lambda i: self._states[i])

    def save_states(self, fname, checkpointer=None):
        """Write the optimizer states as a pickle of host arrays, atomically
        (reference trainer.py:save_states)."""
        if checkpointer is not None:
            raise MXNetError("save_states(checkpointer=...) needs the "
                             "asynchronous checkpointer of queue A13, not "
                             "ported yet")
        states = [
            None if s is None else
            (s.asnumpy() if hasattr(s, "asnumpy") else
             [x.asnumpy() if hasattr(x, "asnumpy") else x for x in s]
             if isinstance(s, (list, tuple)) else s)
            for s in self._states]
        blob = {"states": states,
                "optimizer": self._optimizer.__class__.__name__}
        _atomic_write_bytes(fname, pickle.dumps(blob))

    def load_states(self, fname):
        """Read what :meth:`save_states` wrote (by either package), each
        state onto its parameter's device."""
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        states = []
        for i, s in enumerate(blob["states"]):
            ctx = (self._params[i].list_ctx()[0]
                   if self._params[i]._data is not None else None)
            if s is None:
                states.append(None)
            elif isinstance(s, list):
                states.append([ndarray.array(x, ctx=ctx)
                               if hasattr(x, "shape") else x for x in s])
            elif hasattr(s, "shape"):
                states.append(ndarray.array(s, ctx=ctx))
            else:
                states.append(s)
        self._states = states
        self._states_created = [s is not None for s in states]

"""BaseModule: the high-level train/score/predict interface.

Counterpart of ``mxnet_tpu/module/base_module.py`` (reference
python/mxnet/module/base_module.py: fit:376 with its epoch loop :476-492,
forward_backward:189, score, predict, iter_predict). The loops walk a
lookahead batch generator, so that ``prepare`` sees the upcoming batch,
and ``predict`` is a fold over ``iter_predict``. ``fit`` runs
``forward_backward`` and ``update`` a batch: the fused whole step is queue
A6. Its resilience arguments (``checkpoint_batch_period``, ``resume``,
``supervisor``, ``async_checkpoint``) raise until queue A13, and
``monitor`` until A15.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import ndarray as nd
from ..base import MXNetError
from ..callback import BatchEndParam
from ..initializer import Uniform

__all__ = ["BaseModule"]

_END = object()


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, list):
        return obj
    return [obj]


def _fire(callbacks, param):
    """Invoke one callback or a list of them with the same param."""
    for cb in _as_list(callbacks):
        cb(param)


def _lookahead(iterable):
    """Yield (batch, upcoming) pairs; ``upcoming`` is None on the last."""
    it = iter(iterable)
    here = next(it, _END)
    while here is not _END:
        nxt = next(it, _END)
        yield here, (None if nxt is _END else nxt)
        here = nxt


def _resolve_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


def _check_input_names(symbol, names, typename, throw):
    known = set(symbol.list_arguments())
    bad = [n for n in names if n not in known]
    if not bad:
        return
    param_suffixes = ("_weight", "_bias", "_gamma", "_beta")
    data_like = [a for a in symbol.list_arguments()
                 if not a.endswith(param_suffixes)]
    msg = (f"You created Module with Module(..., {typename}_names={names}) "
           f"but input with name '{bad[0]}' is not found in "
           f"symbol.list_arguments(). Did you mean one of: \n"
           + "\n".join(data_like))
    if throw:
        raise ValueError(msg)
    logging.warning(msg)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- properties subclasses provide ---------------------------------------
    @property
    def data_names(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement data_names")

    @property
    def output_names(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement output_names")

    @property
    def data_shapes(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement data_shapes")

    @property
    def label_shapes(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement label_shapes")

    @property
    def output_shapes(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement output_shapes")

    @property
    def symbol(self):
        return self._symbol

    # -- abstract ops --------------------------------------------------------
    def bind(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} must implement bind")

    def init_params(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} must implement init_params")

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} must implement init_optimizer")

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError(
            f"{type(self).__name__} must implement forward")

    def backward(self, out_grads=None):
        raise NotImplementedError(
            f"{type(self).__name__} must implement backward")

    def update(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement update")

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError(
            f"{type(self).__name__} must implement get_outputs")

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError(
            f"{type(self).__name__} must implement get_input_grads")

    def get_params(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement get_params")

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError(
            f"{type(self).__name__} must implement update_metric")

    # -- composite ops -------------------------------------------------------
    def forward_backward(self, data_batch):
        """reference: base_module.py:189"""
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        tagged = {f"arg:{k}": v for k, v in arg_params.items()}
        tagged.update((f"aux:{k}", v) for k, v in aux_params.items())
        nd.save(fname, tagged)

    def load_params(self, fname):
        groups = {"arg": {}, "aux": {}}
        for tagged_name, value in nd.load(fname).items():
            tag, _, name = tagged_name.partition(":")
            if tag not in groups or not name:
                raise ValueError(f"Invalid param file {fname}")
            groups[tag][name] = value
        self.set_params(groups["arg"], groups["aux"])

    # -- scoring / prediction ------------------------------------------------
    def _trimmed_outputs(self, batch):
        """Forward outputs with the batch's pad rows dropped."""
        keep = None if not batch.pad else -batch.pad
        return [out[:keep] if keep else out for out in self.get_outputs()]

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """reference: base_module.py score"""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        eval_metric = _resolve_metric(eval_metric)
        eval_metric.reset()
        seen = 0
        for eval_batch in eval_data:
            if num_batch is not None and seen == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            _fire(batch_end_callback,
                  BatchEndParam(epoch=epoch, nbatch=seen,
                                eval_metric=eval_metric, locals=locals()))
            seen += 1
        _fire(score_end_callback,
              BatchEndParam(epoch=epoch, nbatch=seen,
                            eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            yield (self._trimmed_outputs(eval_batch), nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """reference: base_module.py predict — a fold over iter_predict."""
        per_batch = [[o.copy() for o in outs] for outs, _, _ in
                     self.iter_predict(eval_data, num_batch=num_batch,
                                       reset=reset)]
        if not per_batch:
            return per_batch
        if not merge_batches:
            return per_batch
        widths = {len(outs) for outs in per_batch}
        assert len(widths) == 1, \
            "Cannot merge batches, as num of outputs is not the same " \
            "in mini-batches. Maybe bucketing is used?"
        merged = [nd.concatenate(column) for column in zip(*per_batch)]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    # -- the main training loop ----------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint_prefix=None, checkpoint_period=1,
            checkpoint_batch_period=None, resume=None,
            save_optimizer_states=True, supervisor=None,
            async_checkpoint=None):
        """reference: base_module.py:376 — bind, init params and optimizer,
        then per epoch a training pass (``forward_backward`` and
        ``update`` a batch, the metric updated from the outputs), the
        epoch-end callbacks, a checkpoint at ``checkpoint_prefix`` every
        ``checkpoint_period`` epochs (labelled with the epochs done, with
        the optimizer state when ``save_optimizer_states``), and the
        optional validation pass."""
        assert num_epoch is not None, "please specify number of epochs"
        for name, value in (("checkpoint_batch_period",
                             checkpoint_batch_period), ("resume", resume),
                            ("supervisor", supervisor),
                            ("async_checkpoint", async_checkpoint)):
            if value not in (None, False):
                raise MXNetError(f"fit({name}=...) needs the resilience layer "
                                 "of queue A13, not ported yet")
        if monitor is not None:
            raise MXNetError("fit(monitor=...) needs the Monitor of queue "
                             "A15, not ported yet")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        train_metric = _resolve_metric(eval_metric)
        validation_metric = validation_metric or train_metric
        for epoch in range(begin_epoch, num_epoch):
            started = time.time()
            train_metric.reset()
            for nbatch, (batch, upcoming) in enumerate(
                    _lookahead(train_data)):
                self.forward_backward(batch)
                self.update()
                if upcoming is not None:
                    self.prepare(upcoming)
                self.update_metric(train_metric, batch.label)
                _fire(batch_end_callback,
                      BatchEndParam(epoch=epoch, nbatch=nbatch,
                                    eval_metric=train_metric,
                                    locals=locals()))
            for name, val in train_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - started)

            # one copy of the params for the callbacks and the next epoch
            snapshot = self.get_params()
            self.set_params(*snapshot)
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, *snapshot)
            # eval sharing the train iterator consumes it first
            shared_iter = eval_data is train_data
            if not shared_iter:
                train_data.reset()
            if checkpoint_prefix and (epoch + 1) % max(
                    1, int(checkpoint_period)) == 0:
                self.save_checkpoint(
                    checkpoint_prefix, epoch + 1,
                    save_optimizer_states=save_optimizer_states)
            if eval_data:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            if shared_iter:
                train_data.reset()

    def save_checkpoint(self, prefix, epoch=None,
                        save_optimizer_states=False):
        """The params-only checkpoint; ``Module`` adds optimizer state."""
        from ..model import save_checkpoint as _save_ckpt
        _save_ckpt(prefix, epoch, self.symbol, *self.get_params())

    def prepare(self, data_batch):
        pass

    def install_monitor(self, mon):
        raise NotImplementedError(
            f"{type(self).__name__} must implement install_monitor")

"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py`` (reference python/mxnet/
callback.py: Speedometer, do_checkpoint, module_checkpoint,
log_train_metric, ProgressBar, LogValidationMetricsCallback). Epoch-end
callbacks receive ``(iter_no, sym, arg, aux)``, batch-end callbacks a
``BatchEndParam``. A metric is read (a device sync) only at a report
boundary. ``ResilienceMonitor`` is queue A13.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "module_checkpoint", "ProgressBar", "BatchEndParam",
           "LogValidationMetricsCallback"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _every_n_epochs(period, action):
    """Epoch-end gate: run ``action(epoch_1based, sym, arg, aux)`` every
    ``period`` epochs (both checkpoint callbacks share this)."""
    period = max(1, int(period))

    def callback(iter_no, sym=None, arg=None, aux=None):
        epoch = iter_no + 1
        if epoch % period == 0:
            action(epoch, sym, arg, aux)

    return callback


def do_checkpoint(prefix, period=1):
    """Save sym/params every ``period`` epochs (model.save_checkpoint)."""
    from .model import save_checkpoint

    return _every_n_epochs(
        period, lambda epoch, sym, arg, aux:
            save_checkpoint(prefix, epoch, sym, arg, aux))


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Save a Module (and optionally its optimizer state) periodically."""
    return _every_n_epochs(
        period, lambda epoch, *_:
            mod.save_checkpoint(prefix, epoch, save_optimizer_states))


def _metric_line(prefix_parts, metric, reset):
    """One log line: prefix parts + every (name, value) pair of ``metric``."""
    parts = list(prefix_parts)
    if metric is not None:
        # a report boundary: the callers gate this on `frequent`/`period`
        parts += [f"{name}={value:f}"
                  for name, value in metric.get_name_value()]
        if reset:
            metric.reset()
    logging.info("\t".join(parts))


def log_train_metric(period, auto_reset=False):
    """Log training metrics every ``period`` batches."""

    def callback(param):
        if param.eval_metric is None or param.nbatch % period:
            return
        # a report boundary: gated on `period` just above
        for name, value in param.eval_metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            param.eval_metric.reset()

    return callback


class Speedometer:
    """Log throughput (and metrics) every ``frequent`` batches.

    The clock restarts whenever the batch counter goes backwards (a new
    epoch) so the first report of each epoch measures only its own
    batches.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._tick = None       # wall time at the last report boundary
        self._prev_batch = -1

    def __call__(self, param):
        if param.nbatch < self._prev_batch:
            self._tick = None
        self._prev_batch = param.nbatch
        if self._tick is None:          # first batch seen: start the clock
            self._tick = time.time()
            return
        if param.nbatch % self.frequent:
            return
        now = time.time()
        rate = self.frequent * self.batch_size / max(now - self._tick, 1e-12)
        self._tick = now
        head = ("Epoch[%d] Batch [%d]" % (param.epoch, param.nbatch)
                if param.eval_metric is not None
                else "Iter[%d] Batch [%d]" % (param.epoch, param.nbatch))
        _metric_line([head, "Speed: %.2f samples/sec" % rate],
                     param.eval_metric, self.auto_reset)


class ProgressBar:
    """Render training progress as a fixed-width bar."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        fill = int(round(self.bar_len * frac))
        bar = "=" * fill + "-" * (self.bar_len - fill)
        logging.info("[%s] %d%%\r", bar, -(-100 * param.nbatch // self.total))


class LogValidationMetricsCallback:
    """Log eval metrics at epoch end."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)

"""Learning-rate schedulers: the port of ``mxnet_tpu/lr_scheduler.py``.

API parity: python/mxnet/lr_scheduler.py (FactorScheduler,
MultiFactorScheduler, PolyScheduler), consumed by
:class:`mxnet_tpu_torch.optimizer.Optimizer` via ``lr_scheduler(num_update)``.

Unlike the reference's stateful while-loop schedulers, every curve here
is a pure function of ``num_update`` — the decay count is computed in
closed form, so a scheduler can be called out of order (e.g. after a
checkpoint resume) and still return the right lr.
"""
from __future__ import annotations

import logging
from bisect import bisect_left

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler"]

_log = logging.getLogger("mxnet_tpu_torch.lr_scheduler")


class LRScheduler:
    """Maps an update counter to a learning rate; ``base_lr`` is
    overwritten by the optimizer's ``learning_rate`` at attach time."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._last_logged = None

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError()

    def _announce(self, num_update, lr):
        """Log once per lr change (reference logs inside its update loop)."""
        if self._last_logged not in (None, lr):
            _log.info("update %d: learning rate is now %0.5e", num_update, lr)
        self._last_logged = lr
        return lr


class FactorScheduler(LRScheduler):
    """Multiply the lr by ``factor`` once per ``step`` updates, floored
    at ``stop_factor_lr``. The reference advances a counter while
    ``num_update > count + step``; the closed form of that recurrence is
    ``decays = (num_update - 1) // step``.
    """

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("step must be a positive update count")
        if not factor <= 1.0:
            raise ValueError("factor above 1 would grow the lr; use <= 1")
        self.step = int(step)
        self.factor = float(factor)
        self.stop_factor_lr = float(stop_factor_lr)

    def __call__(self, num_update):
        decays = max(0, (int(num_update) - 1) // self.step)
        lr = max(self.base_lr * self.factor ** decays, self.stop_factor_lr)
        return self._announce(num_update, lr)


class MultiFactorScheduler(LRScheduler):
    """Multiply the lr by ``factor`` as ``num_update`` passes each entry
    of the increasing ``step`` list (strictly: once ``num_update > s``)."""

    def __init__(self, step, factor=1.0, base_lr=0.01):
        super().__init__(base_lr)
        if not (isinstance(step, list) and step):
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError("milestones must be positive update counts")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("milestones must be strictly increasing")
        self.step = list(step)
        self.factor = float(factor)

    def __call__(self, num_update):
        passed = bisect_left(self.step, int(num_update))
        lr = self.base_lr * self.factor ** passed
        return self._announce(num_update, lr)


class PolyScheduler(LRScheduler):
    """Polynomial ramp to zero: ``base_lr * (1 - t/T) ** pwr`` with the
    progress clamped at ``T = max_update``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if int(max_update) < 1:
            raise ValueError("max_update must be a positive update count")
        self.max_update = int(max_update)
        self.power = pwr

    def __call__(self, num_update):
        progress = min(int(num_update), self.max_update) / self.max_update
        return self.base_lr * (1.0 - progress) ** self.power

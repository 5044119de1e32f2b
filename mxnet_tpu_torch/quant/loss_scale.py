"""Dynamic loss scaling: the low-precision training guard of the fused step.

Counterpart of the part of ``mxnet_tpu/quant/loss_scale.py`` that
:class:`~mxnet_tpu_torch.perf.FusedStep` uses. The guard's state is two
device scalars, ``(scale float32, finite_streak int32)``, updated in
place by the step; the decision is taken on the device:

* every gradient finite  -> the update applies; a streak of
  ``growth_interval`` finite steps doubles the scale (up to ``max_scale``);
* any non-finite gradient -> the step is skipped: parameters, optimizer
  state and auxiliary states keep their values bit for bit, and the scale
  backs off by ``backoff_factor`` (down to ``min_scale``).

No value is read back to the host inside the step. Scales are powers of
two, so scaling is exact. :class:`DynamicLossScale` is the host-side
mirror the Gluon Trainer keeps, whose backward runs outside the fused
update: the caller multiplies its loss by ``scale``, the update skips a
non-finite step on the device, and the schedule advances from the step's
finite flag, one value read back at the update's end. The rest of
``quant/`` is queue A12.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaleConfig", "DynamicLossScale", "init_state",
           "tree_all_finite", "next_state", "guarded_select"]


class LossScaleConfig:
    """Hyperparameters of the dynamic schedule (all powers of two so
    scaling stays exact)."""

    def __init__(self, init_scale: float = 2.0 ** 15,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 200,
                 max_scale: float = 2.0 ** 24, min_scale: float = 1.0):
        self.init_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.max_scale = float(max_scale)
        self.min_scale = float(min_scale)


def init_state(config: LossScaleConfig, device=None):
    """The device-side ``(scale float32, finite_streak int32)`` state."""
    return (torch.tensor(config.init_scale, dtype=torch.float32,
                         device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def tree_all_finite(tensors):
    """A device bool: whether every floating-point tensor of ``tensors``
    (an iterable, None entries skipped) is finite everywhere."""
    flags = [torch.isfinite(t).all() for t in tensors
             if t is not None and t.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()


def next_state(state, finite, config: LossScaleConfig):
    """The schedule's next ``(scale, streak)``: grow on a full finite
    streak, back off on overflow, hold otherwise."""
    scale, streak = state
    grown_streak = streak + 1
    grow = grown_streak >= config.growth_interval
    finite_scale = torch.where(
        grow, torch.clamp(scale * config.growth_factor,
                          max=config.max_scale), scale)
    finite_streak = torch.where(grow, torch.zeros_like(grown_streak),
                                grown_streak)
    new_scale = torch.where(finite, finite_scale,
                            torch.clamp(scale * config.backoff_factor,
                                        min=config.min_scale))
    new_streak = torch.where(finite, finite_streak,
                             torch.zeros_like(finite_streak))
    return new_scale.to(torch.float32), new_streak.to(torch.int32)


def guarded_select(finite, updated, previous):
    """``updated`` where ``finite``, else ``previous`` unchanged."""
    return torch.where(finite, updated, previous)


class DynamicLossScale:
    """The host-side schedule of the Gluon Trainer
    (``mxnet_tpu/quant/loss_scale.py:107-130``): the float ``scale`` the
    caller multiplies its loss by, advanced by :meth:`update` from the
    step's finite flag."""

    def __init__(self, config: LossScaleConfig = None):
        self.config = config or LossScaleConfig()
        self.scale = self.config.init_scale
        self._streak = 0
        self.steps_skipped = 0

    def update(self, finite: bool) -> bool:
        """Advance the schedule; returns ``finite`` for chaining."""
        cfg = self.config
        if finite:
            self._streak += 1
            if self._streak >= cfg.growth_interval:
                self.scale = min(cfg.max_scale, self.scale
                                 * cfg.growth_factor)
                self._streak = 0
        else:
            self.scale = max(cfg.min_scale, self.scale
                             * cfg.backoff_factor)
            self._streak = 0
            self.steps_skipped += 1
        return finite

"""Gluon loss functions.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (reference
python/mxnet/gluon/loss.py: L1/L2, SigmoidBinaryCrossEntropy,
SoftmaxCrossEntropy, KLDiv, Huber, Hinge). Losses are HybridBlocks over
table ops, so autograd records them with the model. The weight and
sample-weight scaling and the mean over every axis but the batch axis
shared by every loss live in :meth:`Loss._finish`.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L1Loss", "L2Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss"]


class Loss(HybridBlock):
    """Base class: a Block computing a per-sample scalar loss
    (reference loss.py:Loss)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _finish(self, F, loss, sample_weight, scale=None):
        """Apply per-sample weights + the loss's global weight, then
        reduce to one scalar per batch element."""
        if sample_weight is not None:
            loss = F.broadcast_mul(loss, sample_weight)
        total_weight = self._weight if scale is None else scale
        if total_weight is not None:
            loss = loss * total_weight
        return F.mean(loss, axis=self._batch_axis, exclude=True)


def _match(F, label, pred):
    """Give ``label`` the shape of ``pred``."""
    return label.reshape(pred.shape)


class L2Loss(Loss):
    r"""0.5 * weight * (pred - label)^2 (reference loss.py:L2Loss)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        sq = F.square(pred - _match(F, label, pred))
        return self._finish(F, sq, sample_weight, scale=self._weight / 2)


class L1Loss(Loss):
    r"""weight * |pred - label| (reference loss.py:L1Loss)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        return self._finish(F, F.abs(pred - _match(F, label, pred)),
                            sample_weight)


class SigmoidBinaryCrossEntropyLoss(Loss):
    r"""BCE with optional pre-sigmoid inputs, computed stably from logits
    (reference loss.py:SigmoidBinaryCrossEntropyLoss)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._pre_activated = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _match(F, label, pred)
        if self._pre_activated:
            eps = 1e-12
            bce = -(F.log(pred + eps) * label +
                    F.log(1.0 - pred + eps) * (1.0 - label))
        else:
            # log(1+exp(-|x|)) + max(x,0) - x*label (stable logits form)
            bce = F.relu(pred) - pred * label + \
                F.Activation(-F.abs(pred), act_type="softrelu")
        return self._finish(F, bce, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    r"""Softmax + cross-entropy over logits; labels are class indices unless
    ``sparse_label=False`` (reference loss.py:SoftmaxCrossEntropyLoss)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._class_axis = axis
        self._index_labels = sparse_label
        self._pre_normalized = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._pre_normalized \
            else F.log_softmax(pred, axis=self._class_axis)
        if self._index_labels:
            ce = -F.pick(logp, label, axis=self._class_axis, keepdims=True)
        else:
            ce = -F.sum(logp * _match(F, label, logp),
                        axis=self._class_axis, keepdims=True)
        return self._finish(F, ce, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    r"""Kullback-Leibler divergence (reference loss.py:KLDivLoss)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._pre_normalized = from_logits
        self._class_axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logq = pred if self._pre_normalized \
            else F.log_softmax(pred, axis=self._class_axis)
        kl = label * (F.log(label + 1e-12) - logq)
        return self._finish(F, kl, sample_weight)


class HuberLoss(Loss):
    r"""Smooth L1: quadratic within ``rho`` of the target, linear outside."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        err = F.abs(pred - _match(F, label, pred))
        huber = F.where(err > self._rho,
                        err - 0.5 * self._rho,
                        (0.5 / self._rho) * F.square(err))
        return self._finish(F, huber, sample_weight)


class HingeLoss(Loss):
    r"""max(0, margin - pred*label) for labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        gap = F.relu(self._margin - pred * _match(F, label, pred))
        return self._finish(F, gap, sample_weight)

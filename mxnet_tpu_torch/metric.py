"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (reference python/mxnet/metric.py:
EvalMetric base and registry :44, :159, Accuracy :339, TopKAccuracy :404,
F1 :478, Perplexity :573, MAE/MSE/RMSE :678-795, CrossEntropy :854, Loss,
CustomMetric/np(), CompositeEvalMetric :209).

``update()`` is sync-free, as in the JAX package: the device metrics
(accuracy, top-k, perplexity, cross-entropy, the regression errors, loss)
compute their contribution with torch on the outputs' device and add it to
a device scalar, so the training step never waits for a readback; the
value is read once, at ``get()``. F1 and custom metrics, whose measure is
numpy, keep the batches they were given and fold them in at ``get()`` (or
after ``MAX_PENDING`` batches), as the JAX package keeps all of them.
"""
from __future__ import annotations


import numpy as _np
import torch

from .base import Registry

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy", "Loss",
           "Torch", "Caffe", "CustomMetric", "np", "create",
           "check_label_shapes"]

_REG = Registry("metric")

# the host metrics' bound on the batches they keep between folds
MAX_PENDING = 64


def check_label_shapes(labels, preds, shape=0):
    lhs = labels.shape if shape else len(labels)
    rhs = preds.shape if shape else len(preds)
    if lhs != rhs:
        raise ValueError(
            f"Shape of labels {lhs} does not match shape of "
            f"predictions {rhs}")


def _tensor(x):
    """The torch tensor behind an NDArray, tensor or host array."""
    if hasattr(x, "_data"):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(_np.asarray(x))


def _host(x):
    """numpy of an NDArray, tensor or host array: a host metric's sync."""
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.dtype is torch.bfloat16 \
            else x.detach().cpu().numpy()
    return _np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def get_config(self):
        config = {"metric": self.__class__.__name__, "name": self.name,
                  "output_names": self.output_names,
                  "label_names": self.label_names}
        config.update(self._kwargs)
        return config

    def update_dict(self, label, pred):
        chosen_preds = ([pred[n] for n in self.output_names]
                        if self.output_names is not None
                        else list(pred.values()))
        chosen_labels = ([label[n] for n in self.label_names]
                         if self.label_names is not None
                         else list(label.values()))
        self.update(chosen_labels, chosen_preds)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0   # a device scalar once a batch is in
        self._pending = []      # a host metric's kept (labels, preds)

    def _drain(self):
        """Fold kept batches into the sums (host metrics only)."""

    def get(self):
        self._drain()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(self.sum_metric) / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return _REG.get(metric)(*args, **kwargs)


def register(klass):
    _REG.register(klass)
    return klass


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError(f"Metric index {index} is out of range 0 "
                              f"and {len(self.metrics)}")

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            for n, v in metric.get_name_value():
                names.append(n)
                values.append(v)
        return (names, values)


class _DeviceMetric(EvalMetric):
    """A metric whose ``measure(label, pred) -> (contribution, count)``
    runs in torch on the outputs' device: the contribution stays a device
    scalar, the count comes from shapes, so ``update`` never syncs."""

    check_shapes = True

    def update(self, labels, preds):
        if self.check_shapes:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            contribution, count = self.measure(_tensor(label), _tensor(pred))
            self.sum_metric = self.sum_metric + contribution
            self.num_inst += count

    def measure(self, label, pred):
        raise NotImplementedError()


class _HostMetric(EvalMetric):
    """A metric whose ``measure`` is numpy: ``update`` keeps the batches
    (tensors are never written in place, so keeping one pins its value)
    and ``get`` folds them in on the host."""

    check_shapes = True

    def update(self, labels, preds):
        if self.check_shapes:
            check_label_shapes(labels, preds)
        self._pending.append(([_tensor(x) for x in labels],
                              [_tensor(x) for x in preds]))
        if len(self._pending) >= MAX_PENDING:
            self._drain()

    def _drain(self):
        pending, self._pending = self._pending, []
        for labels, preds in pending:
            for label, pred in zip(labels, preds):
                contribution, count = self.measure(_host(label), _host(pred))
                self.sum_metric += contribution
                self.num_inst += count

    def measure(self, label, pred):
        raise NotImplementedError()


@register
class Accuracy(_DeviceMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def measure(self, label, pred):
        if pred.dim() > 1 and pred.shape[-1] > 1 and pred.dim() != label.dim():
            pred = pred.argmax(dim=self.axis)  # class scores -> class ids
        guesses = pred.to(torch.int32).reshape(-1)
        truth = label.to(guesses.device).to(torch.int32).reshape(-1)
        check_label_shapes(truth, guesses, shape=1)
        return (guesses == truth).sum(), guesses.numel()


@register
class TopKAccuracy(_DeviceMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += f"_{self.top_k}"

    def measure(self, label, pred):
        assert pred.dim() <= 2, "Predictions should be no more than 2 dims"
        truth = label.to(pred.device).to(torch.int64).reshape(-1)
        if pred.dim() == 1:
            # reference semantics: a 1-D prediction vector is ranked and
            # its argsort index compared against the label
            order = torch.argsort(pred.float(), stable=True)
            return (order == truth).sum(), truth.numel()
        k = min(self.top_k, pred.shape[1])
        leaders = torch.topk(pred.float(), k, dim=1).indices
        hits = (leaders == truth[:, None]).any(dim=1)
        return hits.sum(), truth.numel()


@register
class F1(_HostMetric):
    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def measure(self, label, pred):
        truth = label.astype("int32").ravel()
        if _np.unique(truth).size > 2:
            raise ValueError("F1 currently only supports binary "
                             "classification.")
        positive = pred.argmax(axis=1).ravel() == 1
        actual = truth == 1
        tp = float(_np.sum(positive & actual))
        precision_denom = float(_np.sum(positive))
        recall_denom = float(_np.sum(actual))
        precision = tp / precision_denom if precision_denom else 0.0
        recall = tp / recall_denom if recall_denom else 0.0
        if precision + recall > 0:
            return 2 * precision * recall / (precision + recall), 1
        return 0.0, 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        total_nll = 0.0
        total_tokens = 0
        for label, pred in zip(labels, preds):
            label, pred = _tensor(label), _tensor(pred)
            assert label.numel() == pred.numel() / pred.shape[-1], \
                f"shape mismatch: {tuple(label.shape)} vs. {tuple(pred.shape)}"
            ids = label.to(pred.device).reshape(-1).to(torch.int64)
            token_probs = pred.reshape(-1, pred.shape[-1])[
                torch.arange(ids.numel(), device=pred.device), ids]
            if self.ignore_label is not None:
                keep = ids != self.ignore_label
                token_probs = torch.where(keep, token_probs, 1.0)
                # the ignored count is a device value: keep it there
                total_tokens = total_tokens - (~keep).sum()
            total_nll = total_nll - torch.log(
                torch.clamp(token_probs.float(), min=1e-10)).sum()
            total_tokens = total_tokens + ids.numel()
        self.sum_metric = (self.sum_metric
                           + torch.exp(total_nll / total_tokens) * total_tokens)
        self.num_inst = self.num_inst + total_tokens

    def get(self):
        if isinstance(self.num_inst, torch.Tensor):
            self.num_inst = int(self.num_inst)
        return super().get()


def _column(x):
    """1-D -> (n, 1); anything else unchanged (regression metrics)."""
    return x.reshape(-1, 1) if x.dim() == 1 else x


class _RegressionMetric(_DeviceMetric):
    """MAE/MSE/RMSE: one scalar per batch from the residual matrix."""

    def measure(self, label, pred):
        residuals = _column(label.to(pred.device)).float() - _column(pred).float()
        return self.residual_stat(residuals), 1


@register
class MAE(_RegressionMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def residual_stat(residuals):
        return residuals.abs().mean()


@register
class MSE(_RegressionMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def residual_stat(residuals):
        return (residuals ** 2).mean()


@register
class RMSE(_RegressionMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def residual_stat(residuals):
        return torch.sqrt((residuals ** 2).mean())


@register
class CrossEntropy(_DeviceMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def measure(self, label, pred):
        ids = label.to(pred.device).reshape(-1).to(torch.int64)
        assert ids.shape[0] == pred.shape[0]
        picked = pred[torch.arange(ids.shape[0], device=pred.device), ids]
        return -torch.log(picked.float() + self.eps).sum(), ids.shape[0]


@register
class Loss(EvalMetric):
    """Average of per-batch scalar loss outputs."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        # reference contract: the label argument is ignored entirely
        for pred in preds:
            pred = _tensor(pred)
            self.sum_metric = self.sum_metric + pred.float().sum()
            self.num_inst += pred.numel()


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(_HostMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:  # lambdas
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs
        self.check_shapes = not allow_extra_outputs

    def measure(self, label, pred):
        reported = self._feval(label, pred)
        return reported if isinstance(reported, tuple) else (reported, 1)

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference: metric.np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


_REG.alias("acc", "Accuracy")
_REG.alias("top_k_acc", "TopKAccuracy")
_REG.alias("top_k_accuracy", "TopKAccuracy")
_REG.alias("ce", "CrossEntropy")

"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``; reference
python/mxnet/gluon/data/dataset.py:25-90: Dataset, SimpleDataset,
ArrayDataset). ``RecordFileDataset`` reads RecordIO files, which is queue
A10's ``recordio``: it raises."""
from __future__ import annotations

from ...base import MXNetError
from ...ndarray import NDArray

__all__ = ["Dataset", "ArrayDataset", "RecordFileDataset", "SimpleDataset"]


class Dataset:
    """Abstract dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        return SimpleDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirst(fn), lazy)


class _TransformFirst:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    """Wrap any indexable, with an optional per-item transform."""

    def __init__(self, data, transform=None):
        self._data = data
        self._transform = transform

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if self._transform is None:
            return item
        if isinstance(item, tuple):
            return self._transform(*item)
        return self._transform(item)


class ArrayDataset(Dataset):
    """Zip of equal-length arrays (reference: dataset.py ArrayDataset:40);
    a 1-D NDArray is held as a numpy array, so that an item is a
    scalar."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; arg {i} differs"
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file (reference: dataset.py
    RecordFileDataset:67): needs ``recordio``, queue A10."""

    def __init__(self, filename):
        raise MXNetError(f"{type(self).__name__}({filename!r}) needs "
                         "recordio, queue A10, not ported yet")

"""Data iterators: the parts training needs.

Counterpart of part of ``mxnet_tpu/io.py`` (reference python/mxnet/io.py:
DataDesc, DataBatch, DataIter:41-175, NDArrayIter:515). Batches are
NDArrays on the CPU; ``Module`` copies them onto its device. ``NDArrayIter``
shuffles with an owned ``RandomState`` seeded as the JAX package seeds it
(``seed``, or one drawn from numpy's global stream), so that both packages
walk the same batches. Left out: ``state_dict`` (a mid-epoch resume, queue
A13), ``ResizeIter``, ``PrefetchingIter`` and the file iterators (queue
A10).
"""
from __future__ import annotations

from collections import namedtuple
from typing import List

import numpy as _np

from .context import cpu
from .ndarray import NDArray, array as _nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


def nd_array(value):
    """A batch array on the CPU."""
    return _nd_array(value, ctx=cpu())

class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name+shape(+dtype/layout) of one input (reference: io.py DataDesc)."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base (reference: io.py DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Normalize to list of (name, NDArray) (reference: io.py _init_data)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = []
    for k, v in data.items():
        if not isinstance(v, NDArray):
            try:
                v = nd_array(_np.asarray(v, dtype=v.dtype if hasattr(v, "dtype")
                                         else _np.float32))
            except Exception as e:
                raise TypeError(f"Invalid type '{type(v)}' for {k}") from e
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: io.py:515); the last
    batch is padded (``pad``), dropped (``discard``) or rolled into the next
    epoch (``roll_over``) as ``last_batch_handle`` says."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)

        # an owned RandomState, seeded as the JAX package seeds it: with
        # seed=None the seed is drawn from numpy's global stream, so
        # callers that np.random.seed(0) get the same order run over run
        self._rng = None
        if shuffle:
            if seed is None:
                seed = _np.random.randint(0, 2**31 - 1)
            self._rng = _np.random.RandomState(seed)
        self.idx = _np.arange(self.data[0][1].shape[0])
        if shuffle:
            self._rng.shuffle(self.idx)
        self._shuffle = shuffle

        if last_batch_handle == "discard":
            new_n = self.data[0][1].shape[0] - self.data[0][1].shape[0] % batch_size
            self.idx = self.idx[:new_n]

        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        # one host copy per source up front; per-batch slicing then stays
        # O(batch) instead of a whole-array device->host copy per batch
        self._np_cache = {id(x): x.asnumpy()
                          for _, x in self.data + self.label}
        self.num_source = len(self.data_list)
        self.num_data = len(self.idx)
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size"
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            sel = self.idx[self.cursor:self.cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + self.cursor
            sel = _np.concatenate([self.idx[self.cursor:], self.idx[:pad]])
        return [nd_array(self._np_cache[id(x)][sel]) for _, x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

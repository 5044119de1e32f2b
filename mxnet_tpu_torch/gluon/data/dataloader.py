"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``;
reference python/mxnet/gluon/data/dataloader.py:40).

Samples are gathered on the host and stacked with numpy; the batch goes
onto the current context (the card by default) in one copy.
``num_workers`` reads samples on a thread pool, as the JAX package does,
so that the batches are the same with 0 or more workers."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ...ndarray import NDArray, array as nd_array
from . import sampler as _sampler

__all__ = ["DataLoader"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference: dataloader.py
    default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return nd_array(np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    data = np.asarray(data)
    return nd_array(data)


class DataLoader:
    """Mini-batch iterator over a Dataset (reference: dataloader.py:40)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size is required when batch_sampler "
                                 "is not specified")
            if sampler is None:
                sampler = (_sampler.RandomSampler(len(dataset)) if shuffle
                           else _sampler.SequentialSampler(len(dataset)))
            elif shuffle:
                raise ValueError("shuffle must be False with a sampler")
            batch_sampler = _sampler.BatchSampler(sampler, batch_size,
                                                  last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size/shuffle/sampler/last_batch must be "
                             "unspecified with a batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers

    def __iter__(self):
        if self._num_workers > 0:
            with ThreadPoolExecutor(self._num_workers) as pool:
                for batch_idx in self._batch_sampler:
                    samples = list(pool.map(self._dataset.__getitem__,
                                            batch_idx))
                    yield self._batchify_fn(samples)
        else:
            for batch_idx in self._batch_sampler:
                yield self._batchify_fn([self._dataset[i]
                                         for i in batch_idx])

    def __len__(self):
        return len(self._batch_sampler)

"""Index samplers for Gluon data loading.

Counterpart of ``mxnet_tpu/gluon/data/sampler.py`` (reference
python/mxnet/gluon/data/sampler.py: Sampler, Sequential, Random, Batch
with the keep, discard and rollover tail policies). ``RandomSampler``
draws from numpy's global stream, as the JAX package's does. The batch
grouping takes the epoch's order once and chunks it by slicing.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]

_TAIL_POLICIES = ("keep", "discard", "rollover")


class Sampler:
    """Iterable over dataset indices; concrete samplers define the order."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """Indices ``0..length-1`` in order."""

    def __init__(self, length):
        self._n = int(length)

    def __iter__(self):
        yield from range(self._n)

    def __len__(self):
        return self._n


class RandomSampler(Sampler):
    """A fresh uniform permutation of ``0..length-1`` each epoch."""

    def __init__(self, length):
        self._n = int(length)

    def __iter__(self):
        yield from np.random.permutation(self._n).tolist()

    def __len__(self):
        return self._n


class BatchSampler(Sampler):
    """Chunk an index sampler into fixed-size batches.

    ``last_batch`` picks the tail policy: ``keep`` emits the short tail,
    ``discard`` drops it, ``rollover`` carries it into the next epoch's
    first batch.
    """

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _TAIL_POLICIES:
            raise ValueError(
                f"last_batch must be one of {_TAIL_POLICIES}, got "
                f"{last_batch!r}")
        self._source = sampler
        self._size = int(batch_size)
        self._policy = last_batch
        self._carry = []

    def __iter__(self):
        order = self._carry
        self._carry = []
        order = order + list(self._source)
        full = len(order) // self._size
        for b in range(full):
            yield order[b * self._size:(b + 1) * self._size]
        tail = order[full * self._size:]
        if tail and self._policy == "keep":
            yield tail
        elif tail and self._policy == "rollover":
            self._carry = tail

    def __len__(self):
        n = len(self._source)
        if self._policy == "keep":
            return -(-n // self._size)
        if self._policy == "rollover":
            n += len(self._carry)
        return n // self._size

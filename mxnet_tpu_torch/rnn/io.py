"""Bucketed sequence iterators for RNN training.

Counterpart of ``mxnet_tpu/rnn/io.py`` (reference python/mxnet/rnn/io.py:
``encode_sentences``, ``BucketSentenceIter`` :200). Sentences are packed
into one padded matrix a length bucket up front, next-token labels are
derived once, and ``reset`` reshuffles: the batch order with Python's
global ``random.shuffle`` and each bucket's rows with
``np.random.permutation``, the JAX package's streams, so that both
packages give the same batches from the same seeds. Batches are NDArrays
on the CPU, as ``io.NDArrayIter``'s are; ``Module`` copies them onto its
device.
"""
from __future__ import annotations

import logging
import random as _pyrandom

import numpy as np

from ..io import DataBatch, DataDesc, DataIter, nd_array

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0):
    """Map token sequences to integer ids (reference
    rnn/io.py:encode_sentences). With ``vocab=None`` a fresh vocabulary is
    grown as tokens appear; a supplied vocabulary is frozen and unknown
    tokens are an error."""
    grow = vocab is None
    if grow:
        vocab = {invalid_key: invalid_label}
    next_id = start_label

    def token_id(tok):
        nonlocal next_id
        if tok in vocab:
            return vocab[tok]
        assert grow, f"Unknown token {tok}"
        if next_id == invalid_label:  # keep the sentinel id unassigned
            next_id += 1
        vocab[tok] = next_id
        next_id += 1
        return vocab[tok]

    encoded = [[token_id(tok) for tok in sent] for sent in sentences]
    return encoded, vocab


def _auto_buckets(sentences, batch_size):
    """Every sentence length with at least one full batch of examples."""
    length_counts = np.bincount([len(s) for s in sentences])
    return [length for length, count in enumerate(length_counts)
            if count >= batch_size]


class BucketSentenceIter(DataIter):
    """Pads each sentence to its bucket length; batches are whole buckets
    (reference rnn/io.py:BucketSentenceIter). ``layout`` is ``NT`` (batch
    major) or ``TN`` (time major: each batch transposed)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError("Invalid layout %s: Must by NT (batch major) or"
                             " TN (time major)" % layout)

        self.buckets = sorted(buckets) if buckets \
            else sorted(_auto_buckets(sentences, batch_size))

        # pack: one padded (rows, bucket_len) matrix per bucket
        per_bucket = [[] for _ in self.buckets]
        too_long = 0
        for sent in sentences:
            slot = np.searchsorted(self.buckets, len(sent))
            if slot == len(self.buckets):
                too_long += 1
                continue
            row = np.full(self.buckets[slot], invalid_label, dtype=dtype)
            row[: len(sent)] = sent
            per_bucket[slot].append(row)
        if too_long:
            logging.info("discarded %d sentences longer than the largest "
                         "bucket", too_long)
        self.data = [np.asarray(rows, dtype=dtype) for rows in per_bucket]
        # next-token labels, derived once: row i's label is row i shifted
        # left with the sentinel appended; the shuffles permute data and
        # label together
        self._labels = []
        for mat in self.data:
            shifted = np.full_like(mat, invalid_label)
            if mat.size:
                shifted[:, :-1] = mat[:, 1:]
            self._labels.append(shifted)

        self.default_bucket_key = max(self.buckets)
        batch_major_shape = (batch_size, self.default_bucket_key)
        shape = (batch_major_shape if self.major_axis == 0
                 else batch_major_shape[::-1])
        self.provide_data = [DataDesc(name=data_name, shape=shape,
                                      layout=layout)]
        self.provide_label = [DataDesc(name=label_name, shape=shape,
                                       layout=layout)]

        # every full-batch window into every bucket, as (bucket, offset)
        self.idx = [(b, off)
                    for b, mat in enumerate(self.data)
                    for off in range(0, len(mat) - batch_size + 1,
                                     batch_size)]
        self.curr_idx = 0
        self.nddata = []
        self.ndlabel = []
        self.reset()

    def reset(self):
        self.curr_idx = 0
        _pyrandom.shuffle(self.idx)
        self.nddata = []
        self.ndlabel = []
        for mat, lab in zip(self.data, self._labels):
            order = np.random.permutation(len(mat))
            self.nddata.append(nd_array(mat[order]))
            self.ndlabel.append(nd_array(lab[order]))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        bucket, off = self.idx[self.curr_idx]
        self.curr_idx += 1

        window = slice(off, off + self.batch_size)
        data = self.nddata[bucket][window]
        label = self.ndlabel[bucket][window]
        if self.major_axis == 1:  # time-major: (T, N)
            data, label = data.T, label.T

        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[bucket],
                         provide_data=[DataDesc(
                             name=self.data_name, shape=data.shape,
                             layout=self.layout)],
                         provide_label=[DataDesc(
                             name=self.label_name, shape=label.shape,
                             layout=self.layout)])

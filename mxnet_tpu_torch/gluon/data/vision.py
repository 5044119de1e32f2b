"""Vision datasets (counterpart of ``mxnet_tpu/gluon/data/vision.py``;
reference python/mxnet/gluon/data/vision.py: MNIST:59, FashionMNIST:112,
CIFAR10:144, ImageRecordDataset:202, ImageFolderDataset:233).

The datasets read from ``root`` when the files are there and raise
otherwise: there is no download. MNIST and FashionMNIST read the idx
files (gzipped or not), CIFAR10 the python pickle batches. The image
datasets decode images, which is queue A10's ``image``: they raise."""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ...base import MXNetError
from ...ndarray import array as nd_array
from . import dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "ImageRecordDataset",
           "ImageFolderDataset"]


class _OnDiskDataset(dataset.Dataset):
    """In-memory (data, label) arrays loaded from local files; subclasses
    implement :meth:`_load` and assign ``self._data``/``self._label``."""

    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = bool(train)
        self._transform = transform
        self._data = self._label = None
        self._load()

    def __getitem__(self, idx):
        sample = (self._data[idx], self._label[idx])
        return sample if self._transform is None else self._transform(*sample)

    def __len__(self):
        return len(self._label)

    def _require(self, *fnames):
        paths = [os.path.join(self._root, f) for f in fnames]
        absent = [p for p in paths if not os.path.exists(p)]
        if absent:
            raise MXNetError(
                f"{type(self).__name__}: dataset files not found: {absent}. "
                "There is no download: place the files under "
                f"{self._root}.")
        return paths

    def _load(self):
        raise NotImplementedError


class MNIST(_OnDiskDataset):
    """MNIST from idx-format files (reference: vision.py MNIST:59)."""

    _train_files = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _test_files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    @staticmethod
    def _open(path):
        opener = gzip.open if path.endswith(".gz") else open
        return opener(path, "rb")

    def _load(self):
        wanted = self._train_files if self._train else self._test_files
        # accept both gzipped and unpacked idx files
        names = []
        for f in wanted:
            gz = os.path.join(self._root, f)
            names.append(f if os.path.exists(gz) or
                         not os.path.exists(gz[:-3]) else f[:-3])
        data_path, label_path = self._require(*names)
        with self._open(label_path) as fin:
            fin.read(8)  # idx header: magic + item count
            self._label = np.frombuffer(
                fin.read(), dtype=np.uint8).astype(np.int32)
        with self._open(data_path) as fin:
            _, num, rows, cols = struct.unpack(">IIII", fin.read(16))
            pixels = np.frombuffer(fin.read(), dtype=np.uint8)
        images = pixels.reshape(num, rows, cols, 1).astype(np.float32)
        self._data = nd_array(images / 255.0)


class FashionMNIST(MNIST):
    """Same idx format, different files (reference: vision.py:112)."""

    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_OnDiskDataset):
    """CIFAR10 from the python pickle batches (reference: vision.py:144)."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    @staticmethod
    def _read_batch(filename):
        with open(filename, "rb") as fin:
            raw = pickle.load(fin, encoding="latin1")
        images = raw["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return images, np.asarray(raw["labels"], np.int32)

    def _load(self):
        base = os.path.join(self._root, "cifar-10-batches-py")
        parts = ([f"data_batch_{i}" for i in range(1, 6)]
                 if self._train else ["test_batch"])
        names = [os.path.join(base, p) for p in parts]
        absent = [p for p in names if not os.path.exists(p)]
        if absent:
            raise MXNetError(
                f"CIFAR10: dataset files not found: {absent}. There is no "
                "download: unpack cifar-10-python.tar.gz under "
                f"{self._root}.")
        images, labels = zip(*map(self._read_batch, names))
        self._data = nd_array(np.concatenate(images).astype(np.float32)
                              / 255.0)
        self._label = np.concatenate(labels)


class ImageRecordDataset(dataset.Dataset):
    """Images and labels from a .rec file (reference: vision.py:202):
    needs ``recordio`` and ``image``, queue A10."""

    def __init__(self, filename, flag=1, transform=None):
        raise MXNetError(f"ImageRecordDataset({filename!r}) needs recordio "
                         "and image, queue A10, not ported yet")


class ImageFolderDataset(dataset.Dataset):
    """The root/category/image.jpg layout (reference: vision.py:233):
    needs ``image``, queue A10."""

    def __init__(self, root, flag=1, transform=None):
        raise MXNetError(f"ImageFolderDataset({root!r}) needs image, queue "
                         "A10, not ported yet")

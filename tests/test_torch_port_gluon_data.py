"""Parity of the PyTorch port's ``gluon.data`` with the JAX package.

The samplers (``SequentialSampler``, ``RandomSampler`` drawing from
numpy's global stream, ``BatchSampler`` with ``keep``, ``discard`` and
``rollover`` over two epochs) and ``DataLoader`` over an ``ArrayDataset``
with 0 and 2 worker threads give the JAX package's indices and batches bit
for bit from the same seed; ``transform``/``transform_first`` apply as
there; ``MNIST``, ``FashionMNIST`` and ``CIFAR10`` read tiny files
written here in their formats (idx, gzipped and not; CIFAR's python
batches) as the JAX package reads them; the RecordIO and image datasets
raise naming queue A10. No JAX program is compiled.
"""
import gzip
import pickle
import struct

import numpy as np
import pytest

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu
    return mxnet_tpu


def _draw(data, make, seed=0, epochs=2):
    np.random.seed(seed)
    obj = make(data)
    return [list(obj) for _ in range(epochs)], len(obj)


@pytest.mark.parametrize("kind", ["sequential", "random"])
def test_samplers_match_jax(ref, kind):
    name = {"sequential": "SequentialSampler",
            "random": "RandomSampler"}[kind]
    got = _draw(mxt.gluon.data, lambda d: getattr(d, name)(11))
    want = _draw(ref.gluon.data, lambda d: getattr(d, name)(11))
    assert got == want
    assert sorted(got[0][0]) == list(range(11))


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_sampler_matches_jax(ref, last_batch, shuffle):
    """Two epochs of 10 indices in batches of 4: keep emits the tail,
    discard drops it, rollover carries it into the next epoch."""
    def make(d):
        inner = d.RandomSampler(10) if shuffle else d.SequentialSampler(10)
        return d.BatchSampler(inner, 4, last_batch)

    got = _draw(mxt.gluon.data, make)
    want = _draw(ref.gluon.data, make)
    assert got == want
    sizes = [[len(b) for b in epoch] for epoch in got[0]]
    assert sizes == {"keep": [[4, 4, 2], [4, 4, 2]],
                     "discard": [[4, 4], [4, 4]],
                     "rollover": [[4, 4], [4, 4, 4]]}[last_batch]


def test_batch_sampler_rejects_an_unknown_tail_policy():
    with pytest.raises(ValueError):
        mxt.gluon.data.BatchSampler(mxt.gluon.data.SequentialSampler(3), 2,
                                    "pad")


def _loader_batches(mx, workers, shuffle, last_batch):
    rng = np.random.RandomState(4)
    x = rng.normal(0, 1, (10, 3, 2)).astype(np.float32)
    y = rng.randint(0, 5, (10,)).astype(np.float32)
    dataset = mx.gluon.data.ArrayDataset(mx.nd.array(x, ctx=mx.cpu()), y)
    np.random.seed(9)
    loader = mx.gluon.data.DataLoader(dataset, batch_size=4, shuffle=shuffle,
                                      last_batch=last_batch,
                                      num_workers=workers)
    out = []
    for _ in range(2):
        for data, label in loader:
            out.append((data.asnumpy(), label.asnumpy()))
    return out, len(loader)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle,last_batch", [
    (False, None), (True, "keep"), (True, "discard"), (True, "rollover")])
def test_data_loader_matches_jax(ref, workers, shuffle, last_batch):
    with mxt.cpu():
        got, got_len = _loader_batches(mxt, workers, shuffle, last_batch)
    want, want_len = _loader_batches(ref, workers, shuffle, last_batch)
    assert got_len == want_len and len(got) == len(want) > 0
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd.dtype == wd.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_data_loader_puts_the_batch_on_the_current_context():
    dataset = mxt.gluon.data.ArrayDataset(np.arange(6, dtype=np.float32))
    with mxt.cpu():
        (batch,) = list(mxt.gluon.data.DataLoader(dataset, batch_size=6))
    assert batch.context == mxt.cpu()
    np.testing.assert_array_equal(batch.asnumpy(), np.arange(6))


def test_data_loader_validates_its_arguments():
    dataset = mxt.gluon.data.SimpleDataset(list(range(5)))
    sampler = mxt.gluon.data.SequentialSampler(5)
    with pytest.raises(ValueError):
        mxt.gluon.data.DataLoader(dataset)
    with pytest.raises(ValueError):
        mxt.gluon.data.DataLoader(dataset, 2, shuffle=True, sampler=sampler)
    with pytest.raises(ValueError):
        mxt.gluon.data.DataLoader(
            dataset, 2, batch_sampler=mxt.gluon.data.BatchSampler(sampler, 2))


def test_dataset_transforms_match_jax(ref):
    def items(mx):
        pairs = mx.gluon.data.ArrayDataset(np.arange(5) * 1.5,
                                           np.arange(5) % 2)
        simple = mx.gluon.data.SimpleDataset([1, 2, 3])
        return ([pairs.transform_first(lambda v: v * 2)[i] for i in range(5)],
                [pairs.transform(lambda a, b: a - b)[i] for i in range(5)],
                [simple.transform(lambda v: v + 1)[i] for i in range(3)],
                [simple.transform_first(lambda v: -v)[i] for i in range(3)],
                len(pairs), len(simple))

    assert items(mxt) == items(ref)


def _write_idx(root, stem, images, labels, zipped):
    """MNIST's idx files: images (n, rows, cols) uint8, labels uint8."""
    opener = gzip.open if zipped else open
    suffix = ".gz" if zipped else ""
    n, rows, cols = images.shape
    with opener(root / f"{stem}-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols) + images.tobytes())
    with opener(root / f"{stem}-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _samples(dataset):
    return [(np.asarray(d.asnumpy() if hasattr(d, "asnumpy") else d),
             int(lab)) for d, lab in (dataset[i]
                                      for i in range(len(dataset)))]


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("zipped", [True, False], ids=["gz", "raw"])
def test_mnist_reads_idx_files_as_jax(ref, tmp_path, name, zipped):
    rng = np.random.RandomState(0)
    for stem, n in (("train", 5), ("t10k", 3)):
        _write_idx(tmp_path, stem, rng.randint(0, 256, (n, 4, 3)).astype(
            np.uint8), rng.randint(0, 10, (n,)).astype(np.uint8), zipped)
    for train in (True, False):
        with mxt.cpu():
            got = getattr(mxt.gluon.data.vision, name)(
                root=str(tmp_path), train=train)
        want = getattr(ref.gluon.data.vision, name)(root=str(tmp_path),
                                                    train=train)
        assert len(got) == len(want) == (5 if train else 3)
        for (gd, gl), (wd, wl) in zip(_samples(got), _samples(want)):
            assert gd.shape == (4, 3, 1) and gd.dtype == wd.dtype
            np.testing.assert_array_equal(gd, wd)
            assert gl == wl


def test_cifar10_reads_the_python_batches_as_jax(ref, tmp_path):
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.RandomState(1)
    for part in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / part, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (2, 3072)).astype(
                np.uint8), "labels": list(rng.randint(0, 10, 2))}, f)
    for train in (True, False):
        with mxt.cpu():
            got = mxt.gluon.data.vision.CIFAR10(root=str(tmp_path),
                                                train=train)
        want = ref.gluon.data.vision.CIFAR10(root=str(tmp_path), train=train)
        assert len(got) == len(want) == (10 if train else 2)
        for (gd, gl), (wd, wl) in zip(_samples(got), _samples(want)):
            assert gd.shape == (32, 32, 3)
            np.testing.assert_array_equal(gd, wd)
            assert gl == wl
    with mxt.cpu():
        transformed = mxt.gluon.data.vision.CIFAR10(
            root=str(tmp_path), train=False,
            transform=lambda d, lab: (d.asnumpy().mean(), lab + 100))
    assert transformed[0][1] >= 100


def test_vision_datasets_name_missing_files(tmp_path):
    for name in ("MNIST", "FashionMNIST", "CIFAR10"):
        with pytest.raises(MXNetError, match="no download"):
            getattr(mxt.gluon.data.vision, name)(root=str(tmp_path))


def test_recordio_and_image_datasets_raise_naming_a10(tmp_path):
    calls = (lambda: mxt.gluon.data.RecordFileDataset(str(tmp_path / "x.rec")),
             lambda: mxt.gluon.data.vision.ImageRecordDataset(
                 str(tmp_path / "x.rec")),
             lambda: mxt.gluon.data.vision.ImageFolderDataset(str(tmp_path)))
    for call in calls:
        with pytest.raises(MXNetError, match="A10"):
            call()

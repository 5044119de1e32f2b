"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data``; reference
python/mxnet/gluon/data/): datasets, samplers, the DataLoader and the
vision datasets read from files on disk. The RecordIO and image datasets
need queue A10 and raise."""
from . import dataset  # noqa: F401
from . import sampler  # noqa: F401
from . import dataloader  # noqa: F401
from . import vision  # noqa: F401
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset  # noqa: F401
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler  # noqa: F401
from .dataloader import DataLoader  # noqa: F401

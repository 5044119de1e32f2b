"""Module API: ``BaseModule`` and ``Module`` (reference
python/mxnet/module). The bucketing, sequential and python modules are
queue A8."""
from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401

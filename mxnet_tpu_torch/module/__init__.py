"""Module API (reference python/mxnet/module): ``BaseModule``, ``Module``,
``BucketingModule``, ``SequentialModule``, ``PythonModule`` and
``PythonLossModule``."""
from .base_module import BaseModule  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
from .module import Module  # noqa: F401
from .python_module import PythonLossModule, PythonModule  # noqa: F401
from .sequential_module import SequentialModule  # noqa: F401

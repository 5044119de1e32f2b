"""Device contexts mapped onto torch devices.

Counterpart of ``mxnet_tpu/context.py``. ``gpu`` names a CUDA card; ``tpu``
is kept as an alias of the accelerator so scripts written for the JAX
package run unchanged. The default context is ``gpu(0)``. Asking for the
accelerator where there is none raises :class:`MXNetError`: nothing falls
back to the CPU.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "num_gpus"]


class Context:
    """A device context. ``with Context('gpu', 0):`` sets the default."""

    _default = threading.local()
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 4: "cpu_shared", 5: "tpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 4, "tpu": 5}

    def __init__(self, device_type: str, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, device_type.device_id
        if device_type not in Context.devstr2type:
            raise MXNetError(f"unknown device type {device_type}")
        self.device_type = device_type
        self.device_id = device_id
        self._old = None

    @property
    def device_typeid(self) -> int:
        return Context.devstr2type[self.device_type]

    def torch_device(self) -> torch.device:
        """The torch device this context names. Raises MXNetError for an
        accelerator context on a machine without that CUDA card."""
        if self.device_type in ("gpu", "tpu"):
            n = num_gpus()
            if self.device_id >= n:
                raise MXNetError(
                    f"{self} asked for, but this machine has {n} CUDA "
                    "device(s); pass ctx=cpu() to run on the CPU")
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        self._old = getattr(Context._default, "ctx", None)
        Context._default.ctx = self
        return self

    def __exit__(self, *args):
        Context._default.ctx = self._old
        return False

    @staticmethod
    def default_ctx() -> "Context":
        ctx = getattr(Context._default, "ctx", None)
        return ctx if ctx is not None else gpu(0)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """CUDA card ``device_id``."""
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """Alias of :func:`gpu`: the accelerator, for scripts written for the
    JAX package."""
    return Context("tpu", device_id)


def current_context() -> Context:
    return Context.default_ctx()


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def context_of(device: torch.device) -> Context:
    """The Context naming a torch device."""
    if device.type == "cuda":
        return gpu(device.index or 0)
    return cpu(0)

"""The compiler layer's counters and dispatch signatures.

Counterpart of ``mxnet_tpu/compiler``'s ``stats()`` and
``batch_signature``. The port compiles nothing per program: symbol
graphs run eagerly, and its only build step is ``nvcc`` over the kernel
sources (``_build.py``), once per source, flags and header contents, into
an on-disk build directory that later processes reuse. So in
:func:`stats`:

- ``cache.hits``: kernel libraries found already built on disk;
- ``cache.misses``: kernel libraries that had to be built;
- ``programs.compiled``: ``nvcc`` builds that finished in this process;
- ``programs.loaded``: kernel libraries loaded into this process.

``InferenceServer.warm_up`` reports the first and third over its warm-up
as ``warmup_cache_hits`` and ``warmup_compiles``, the keys under which
the JAX package reports its executable cache's hits and XLA compiles.
Graph passes, the persistent program cache and symbolic-dim programs
come with A12.
"""
from __future__ import annotations

from typing import Dict

from .fingerprint import batch_signature  # noqa: F401

__all__ = ["batch_signature", "stats"]


def stats() -> Dict[str, Dict[str, int]]:
    """One snapshot of the build counters (see the module docstring)."""
    from .. import _build
    c = dict(_build.COUNTERS)
    return {"cache": {"hits": c["cache_hits"], "misses": c["cache_misses"]},
            "programs": {"compiled": c["compiled"], "loaded": c["loaded"]}}


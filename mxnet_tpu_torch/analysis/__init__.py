"""Markers of the runtime's hot and single-threaded code (``annotations``);
the JAX package's static analysis itself is not ported."""
from .annotations import hot_path, single_threaded  # noqa: F401

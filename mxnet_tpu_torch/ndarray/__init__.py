"""The ``nd`` namespace. This slice carries NDArray and its creation
functions; the op functions generated from the op table come with a later
slice."""
from .ndarray import NDArray, array, empty, zeros  # noqa: F401

"""Serving backends of the port. The threaded ``InferenceServer`` comes
with a later slice."""
from .backends import CallableBackend, PredictorBackend  # noqa: F401

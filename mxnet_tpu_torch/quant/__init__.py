"""Quantization and low-precision training: the port has the dynamic
loss-scale guard the fused step uses (``loss_scale``); int8 calibration,
the accuracy gate and the host-side loss scale are queue A12."""
from .loss_scale import LossScaleConfig  # noqa: F401

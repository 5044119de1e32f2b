"""Quantization and low-precision training: the port has the dynamic
loss-scale guard the fused step uses (``loss_scale``) and the host-side
schedule of the Gluon Trainer (``DynamicLossScale``); int8 calibration and
the accuracy gate are queue A12."""
from .loss_scale import DynamicLossScale, LossScaleConfig  # noqa: F401

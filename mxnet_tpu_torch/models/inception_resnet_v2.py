"""Inception-ResNet-v2 symbol builder (299x299 inputs).

Reference analogue: example/image-classification/symbols/
inception-resnet-v2.py (Szegedy et al. 2016). The residual variant:
inception towers whose concat is projected back to the trunk width by a
linear 1x1 conv+BN and added to the trunk under a small scale, then
relu'd. The tower interiors reuse the declarative tables of
:func:`mxnet_tpu.models._blocks.towers`; the residual wrapper is the only
block-specific code. Keeps the reference's quirks for parity (the 129-
filter tower in block17, inception-resnet-v2.py:62, and its off-axis
(1,2)/(2,1) padding pair, which round-trips the spatial shape).
"""
from __future__ import annotations

from .. import symbol as sym
from ._blocks import classifier, conv_bn_act, maybe_cast, towers

_MIX_5B = [
    [("conv", 96, (1, 1), (1, 1), (0, 0))],
    [("conv", 48, (1, 1), (1, 1), (0, 0)),
     ("conv", 64, (5, 5), (1, 1), (2, 2))],
    [("conv", 64, (1, 1), (1, 1), (0, 0)),
     ("conv", 96, (3, 3), (1, 1), (1, 1)),
     ("conv", 96, (3, 3), (1, 1), (1, 1))],
    [("pool", "avg", (3, 3), (1, 1), (1, 1)),
     ("conv", 64, (1, 1), (1, 1), (0, 0))],
]
_BLOCK_35 = [
    [("conv", 32, (1, 1), (1, 1), (0, 0))],
    [("conv", 32, (1, 1), (1, 1), (0, 0)),
     ("conv", 32, (3, 3), (1, 1), (1, 1))],
    [("conv", 32, (1, 1), (1, 1), (0, 0)),
     ("conv", 48, (3, 3), (1, 1), (1, 1)),
     ("conv", 64, (3, 3), (1, 1), (1, 1))],
]
_BLOCK_17 = [
    [("conv", 192, (1, 1), (1, 1), (0, 0))],
    [("conv", 129, (1, 1), (1, 1), (0, 0)),   # 129: reference quirk
     ("conv", 160, (1, 7), (1, 1), (1, 2)),
     ("conv", 192, (7, 1), (1, 1), (2, 1))],
]
_BLOCK_8 = [
    [("conv", 192, (1, 1), (1, 1), (0, 0))],
    [("conv", 192, (1, 1), (1, 1), (0, 0)),
     ("conv", 224, (1, 3), (1, 1), (0, 1)),
     ("conv", 256, (3, 1), (1, 1), (1, 0))],
]
_RED_A = [
    [("conv", 384, (3, 3), (2, 2), (0, 0))],
    [("conv", 256, (1, 1), (1, 1), (0, 0)),
     ("conv", 256, (3, 3), (1, 1), (1, 1)),
     ("conv", 384, (3, 3), (2, 2), (0, 0))],
    [("pool", "max", (3, 3), (2, 2), (0, 0))],
]
_RED_B = [
    [("conv", 256, (1, 1), (1, 1), (0, 0)),
     ("conv", 384, (3, 3), (2, 2), (0, 0))],
    [("conv", 256, (1, 1), (1, 1), (0, 0)),
     ("conv", 288, (3, 3), (2, 2), (0, 0))],
    [("conv", 256, (1, 1), (1, 1), (0, 0)),
     ("conv", 288, (3, 3), (1, 1), (1, 1)),
     ("conv", 320, (3, 3), (2, 2), (0, 0))],
    [("pool", "max", (3, 3), (2, 2), (0, 0))],
]


def _residual(trunk, spec, width, scale, name, layout, act=True):
    """trunk + scale * linear_proj(towers(trunk, spec)), then relu."""
    mixed = towers(trunk, spec, name, layout, fix_gamma=True)
    proj = conv_bn_act(mixed, width, (1, 1), f"{name}_proj",
                       layout=layout, fix_gamma=True, act=False)
    out = trunk + scale * proj
    if act:
        out = sym.Activation(data=out, act_type="relu", name=f"{name}_relu")
    return out


def get_symbol(num_classes=1000, layout="NHWC", dtype="float32", **kwargs):
    data = sym.Variable("data")

    def cv(x, nf, kernel, name, stride=(1, 1), pad=(0, 0)):
        return conv_bn_act(x, nf, kernel, name, stride, pad,
                           layout=layout, fix_gamma=True)

    body = cv(maybe_cast(data, dtype), 32, (3, 3), "c1a", stride=(2, 2))
    body = cv(body, 32, (3, 3), "c2a")
    body = cv(body, 64, (3, 3), "c2b", pad=(1, 1))
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max", layout=layout, name="p3a")
    body = cv(body, 80, (1, 1), "c3b")
    body = cv(body, 192, (3, 3), "c4a")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max", layout=layout, name="p5a")

    body = towers(body, _MIX_5B, "mix5b", layout, fix_gamma=True)  # 320ch
    for i in range(10):
        body = _residual(body, _BLOCK_35, 320, 0.17, f"b35_{i}", layout)
    body = towers(body, _RED_A, "redA", layout, fix_gamma=True)    # 1088ch
    for i in range(20):
        body = _residual(body, _BLOCK_17, 1088, 0.1, f"b17_{i}", layout)
    body = towers(body, _RED_B, "redB", layout, fix_gamma=True)    # 2080ch
    for i in range(9):
        body = _residual(body, _BLOCK_8, 2080, 0.2, f"b8_{i}", layout)
    body = _residual(body, _BLOCK_8, 2080, 1.0, "b8_final", layout,
                     act=False)
    body = cv(body, 1536, (1, 1), "conv_final")
    return classifier(body, num_classes, layout, dtype, dropout=0.2)

"""Inception-v4 symbol builder (299x299 inputs).

Reference analogue: example/image-classification/symbols/inception-v4.py
(Szegedy et al. 2016, "Inception-v4, Inception-ResNet and the Impact of
Residual Connections"). The pure-Inception variant: a three-concat stem,
then 4xA / ReductionA / 7xB / ReductionB / 3xC, all expressed as tower
tables for :func:`mxnet_tpu.models._blocks.towers` (the reference writes
each block as an imperative function). BN uses ``fix_gamma=True``.
"""
from __future__ import annotations

from .. import symbol as sym
from ._blocks import bn_axis, classifier, conv_bn_act, maybe_cast, towers

# 35x35 mix: pooled proj / 1x1 / double-3x3 / triple-3x3
_A = [
    [("pool", "avg", (3, 3), (1, 1), (1, 1)),
     ("conv", 96, (1, 1), (1, 1), (0, 0))],
    [("conv", 96, (1, 1), (1, 1), (0, 0))],
    [("conv", 64, (1, 1), (1, 1), (0, 0)),
     ("conv", 96, (3, 3), (1, 1), (1, 1))],
    [("conv", 64, (1, 1), (1, 1), (0, 0)),
     ("conv", 96, (3, 3), (1, 1), (1, 1)),
     ("conv", 96, (3, 3), (1, 1), (1, 1))],
]
_RED_A = [
    [("pool", "max", (3, 3), (2, 2), (0, 0))],
    [("conv", 384, (3, 3), (2, 2), (0, 0))],
    [("conv", 192, (1, 1), (1, 1), (0, 0)),
     ("conv", 224, (3, 3), (1, 1), (1, 1)),
     ("conv", 256, (3, 3), (2, 2), (0, 0))],
]
# 17x17 mix: pooled proj / 1x1 / factorized-7 pair / factorized-7 quad
_B = [
    [("pool", "avg", (3, 3), (1, 1), (1, 1)),
     ("conv", 128, (1, 1), (1, 1), (0, 0))],
    [("conv", 384, (1, 1), (1, 1), (0, 0))],
    [("conv", 192, (1, 1), (1, 1), (0, 0)),
     ("conv", 224, (1, 7), (1, 1), (0, 3)),
     ("conv", 256, (7, 1), (1, 1), (3, 0))],
    [("conv", 192, (1, 1), (1, 1), (0, 0)),
     ("conv", 192, (1, 7), (1, 1), (0, 3)),
     ("conv", 224, (7, 1), (1, 1), (3, 0)),
     ("conv", 224, (1, 7), (1, 1), (0, 3)),
     ("conv", 256, (7, 1), (1, 1), (3, 0))],
]
_RED_B = [
    [("pool", "max", (3, 3), (2, 2), (0, 0))],
    [("conv", 192, (1, 1), (1, 1), (0, 0)),
     ("conv", 192, (3, 3), (2, 2), (0, 0))],
    [("conv", 256, (1, 1), (1, 1), (0, 0)),
     ("conv", 256, (1, 7), (1, 1), (0, 3)),
     ("conv", 320, (7, 1), (1, 1), (3, 0)),
     ("conv", 320, (3, 3), (2, 2), (0, 0))],
]
# 8x8 mix: pooled proj / 1x1 / forked 1x3+3x1 / deep forked bank
_C = [
    [("pool", "avg", (3, 3), (1, 1), (1, 1)),
     ("conv", 256, (1, 1), (1, 1), (0, 0))],
    [("conv", 256, (1, 1), (1, 1), (0, 0))],
    [("conv", 384, (1, 1), (1, 1), (0, 0)),
     ("fork",
      [("conv", 256, (1, 3), (1, 1), (0, 1))],
      [("conv", 256, (3, 1), (1, 1), (1, 0))])],
    [("conv", 384, (1, 1), (1, 1), (0, 0)),
     ("conv", 448, (1, 3), (1, 1), (0, 1)),
     ("conv", 512, (3, 1), (1, 1), (1, 0)),
     ("fork",
      [("conv", 256, (3, 1), (1, 1), (1, 0))],
      [("conv", 256, (1, 3), (1, 1), (0, 1))])],
]


def _stem(data, layout):
    """Three-concat stem (reference Inception_stem, inception-v4.py:43-67)."""
    def cv(x, nf, kernel, name, stride=(1, 1), pad=(0, 0)):
        return conv_bn_act(x, nf, kernel, name, stride, pad,
                           layout=layout, fix_gamma=True)

    axis = bn_axis(layout)
    x = cv(data, 32, (3, 3), "stem_c1", stride=(2, 2))
    x = cv(x, 32, (3, 3), "stem_c2")
    x = cv(x, 64, (3, 3), "stem_c3", pad=(1, 1))
    x = sym.Concat(
        sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    layout=layout, name="stem_p1"),
        cv(x, 96, (3, 3), "stem_c4", stride=(2, 2)),
        dim=axis, name="stem_cat1")
    left = cv(cv(x, 64, (1, 1), "stem_c5"), 96, (3, 3), "stem_c6")
    right = cv(x, 64, (1, 1), "stem_c7")
    right = cv(right, 64, (7, 1), "stem_c8", pad=(3, 0))
    right = cv(right, 64, (1, 7), "stem_c9", pad=(0, 3))
    right = cv(right, 96, (3, 3), "stem_c10")
    x = sym.Concat(left, right, dim=axis, name="stem_cat2")
    return sym.Concat(
        cv(x, 192, (3, 3), "stem_c11", stride=(2, 2)),
        sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    layout=layout, name="stem_p2"),
        dim=axis, name="stem_cat3")


def get_symbol(num_classes=1000, layout="NHWC", dtype="float32", **kwargs):
    data = sym.Variable("data")
    body = _stem(maybe_cast(data, dtype), layout)
    schedule = ([("inA", _A)] * 4 + [("redA", _RED_A)]
                + [("inB", _B)] * 7 + [("redB", _RED_B)]
                + [("inC", _C)] * 3)
    for i, (kind, spec) in enumerate(schedule):
        body = towers(body, spec, f"{kind}_{i}", layout, fix_gamma=True)
    return classifier(body, num_classes, layout, dtype, pool_kernel=(8, 8),
                      dropout=0.2)

"""Inception-v3 symbol builder (299x299 inputs).

Reference analogue: example/image-classification/symbols/inception-v3.py
(Szegedy et al. 2015, "Rethinking the Inception Architecture"). Where the
reference composes five imperative block functions (Inception7A..7E), the
whole network here is a table of tower specs consumed by
:func:`mxnet_tpu.models._blocks.towers`: each stage row lists its branches
as (conv/pool/fork) step sequences, in the reference's concat order. BN
uses ``fix_gamma=True`` to match the reference Conv factory.
"""
from __future__ import annotations

from .. import symbol as sym
from ._blocks import classifier, conv_bn_act, maybe_cast, towers


def _A(n_proj, pool="avg"):
    """35x35 mix: 1x1 / 5x5 double / 3x3 triple / pooled projection."""
    return [
        [("conv", 64, (1, 1), (1, 1), (0, 0))],
        [("conv", 48, (1, 1), (1, 1), (0, 0)),
         ("conv", 64, (5, 5), (1, 1), (2, 2))],
        [("conv", 64, (1, 1), (1, 1), (0, 0)),
         ("conv", 96, (3, 3), (1, 1), (1, 1)),
         ("conv", 96, (3, 3), (1, 1), (1, 1))],
        [("pool", pool, (3, 3), (1, 1), (1, 1)),
         ("conv", n_proj, (1, 1), (1, 1), (0, 0))],
    ]


def _C(n_mid):
    """17x17 mix: 1x1 / factorized-7 pair / factorized-7 quad / proj."""
    return [
        [("conv", 192, (1, 1), (1, 1), (0, 0))],
        [("conv", n_mid, (1, 1), (1, 1), (0, 0)),
         ("conv", n_mid, (1, 7), (1, 1), (0, 3)),
         ("conv", 192, (7, 1), (1, 1), (3, 0))],
        [("conv", n_mid, (1, 1), (1, 1), (0, 0)),
         ("conv", n_mid, (7, 1), (1, 1), (3, 0)),
         ("conv", n_mid, (1, 7), (1, 1), (0, 3)),
         ("conv", n_mid, (7, 1), (1, 1), (3, 0)),
         ("conv", 192, (1, 7), (1, 1), (0, 3))],
        [("pool", "avg", (3, 3), (1, 1), (1, 1)),
         ("conv", 192, (1, 1), (1, 1), (0, 0))],
    ]


def _E(pool):
    """8x8 mix with expanded filter banks (1x3 / 3x1 forks)."""
    fork13 = ("fork",
              [("conv", 384, (1, 3), (1, 1), (0, 1))],
              [("conv", 384, (3, 1), (1, 1), (1, 0))])
    return [
        [("conv", 320, (1, 1), (1, 1), (0, 0))],
        [("conv", 384, (1, 1), (1, 1), (0, 0)), fork13],
        [("conv", 448, (1, 1), (1, 1), (0, 0)),
         ("conv", 384, (3, 3), (1, 1), (1, 1)), fork13],
        [("pool", pool, (3, 3), (1, 1), (1, 1)),
         ("conv", 192, (1, 1), (1, 1), (0, 0))],
    ]


# grid reductions (stride-2 stages); last branch is the parameter-free pool
_RED_35 = [
    [("conv", 384, (3, 3), (2, 2), (0, 0))],
    [("conv", 64, (1, 1), (1, 1), (0, 0)),
     ("conv", 96, (3, 3), (1, 1), (1, 1)),
     ("conv", 96, (3, 3), (2, 2), (0, 0))],
    [("pool", "max", (3, 3), (2, 2), (0, 0))],
]
_RED_17 = [
    [("conv", 192, (1, 1), (1, 1), (0, 0)),
     ("conv", 320, (3, 3), (2, 2), (0, 0))],
    [("conv", 192, (1, 1), (1, 1), (0, 0)),
     ("conv", 192, (1, 7), (1, 1), (0, 3)),
     ("conv", 192, (7, 1), (1, 1), (3, 0)),
     ("conv", 192, (3, 3), (2, 2), (0, 0))],
    [("pool", "max", (3, 3), (2, 2), (0, 0))],
]

# the full 11-mix schedule, in network order
_STAGES = [
    ("mixed", _A(32)),
    ("mixed_1", _A(64)),
    ("mixed_2", _A(64)),
    ("mixed_3", _RED_35),
    ("mixed_4", _C(128)),
    ("mixed_5", _C(160)),
    ("mixed_6", _C(160)),
    ("mixed_7", _C(192)),
    ("mixed_8", _RED_17),
    ("mixed_9", _E("avg")),
    ("mixed_10", _E("max")),
]


def get_symbol(num_classes=1000, layout="NHWC", dtype="float32", **kwargs):
    data = sym.Variable("data")
    data = maybe_cast(data, dtype)

    def stem(x, nf, kernel, name, stride=(1, 1), pad=(0, 0)):
        return conv_bn_act(x, nf, kernel, name, stride, pad,
                           layout=layout, fix_gamma=True)

    body = stem(data, 32, (3, 3), "conv", stride=(2, 2))
    body = stem(body, 32, (3, 3), "conv_1")
    body = stem(body, 64, (3, 3), "conv_2", pad=(1, 1))
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max", layout=layout, name="pool")
    body = stem(body, 80, (1, 1), "conv_3")
    body = stem(body, 192, (3, 3), "conv_4")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max", layout=layout, name="pool1")
    for name, spec in _STAGES:
        body = towers(body, spec, name, layout, fix_gamma=True)
    return classifier(body, num_classes, layout, dtype, pool_kernel=(8, 8))

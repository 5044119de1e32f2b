"""Inception-BN (Inception-v2) symbol builder.

Reference analogue: example/image-classification/symbols/inception-bn.py
(Ioffe & Szegedy 2015). Every conv carries BatchNorm; the A-mix keeps
resolution (1x1 / reduced 3x3 / double reduced 3x3 / pooled projection)
and the B-mix downsamples (stride-2 3x3 lanes + max pool). The small
input variant (height <= 28, the cifar benchmark net) uses the
Simple/Downsample factories.
"""
from __future__ import annotations

from .. import symbol as sym
from ._blocks import classifier, conv_bn_act, maybe_cast

# A mixes: (1x1, 3x3r, 3x3, d3x3r, d3x3, pool type, proj) — :126-137
_STAGES = [
    [("3a", (64, 64, 64, 64, 96, "avg", 32)),
     ("3b", (64, 64, 96, 64, 96, "avg", 64)),
     ("3c", "B", (128, 160, 64, 96))],
    [("4a", (224, 64, 96, 96, 128, "avg", 128)),
     ("4b", (192, 96, 128, 96, 128, "avg", 128)),
     ("4c", (160, 128, 160, 128, 160, "avg", 128)),
     ("4d", (96, 128, 192, 160, 192, "avg", 128)),
     ("4e", "B", (128, 192, 192, 256))],
    [("5a", (352, 192, 320, 160, 224, "avg", 128)),
     ("5b", (352, 192, 320, 192, 224, "max", 128))],
]

# the <=28px variant: Simple (1x1 + 3x3) and Downsample (3x3/2 + pool)
_SMALL = [("in3a", 32, 32), ("in3b", 32, 48), ("in3c", "D", 80),
          ("in4a", 112, 48), ("in4b", 96, 64), ("in4c", 80, 80),
          ("in4d", 48, 96), ("in4e", "D", 96),
          ("in5a", 176, 160), ("in5b", 176, 160)]


def _cat(layout):
    return 3 if layout == "NHWC" else 1


def _mix_a(data, spec, name, layout):
    p1, r3, p3, rd, pd, pool, proj = spec
    lane1 = conv_bn_act(data, p1, (1, 1), f"{name}_1x1", layout=layout)
    lane3 = conv_bn_act(
        conv_bn_act(data, r3, (1, 1), f"{name}_3x3r", layout=layout),
        p3, (3, 3), f"{name}_3x3", pad=(1, 1), layout=layout)
    laned = conv_bn_act(
        conv_bn_act(data, rd, (1, 1), f"{name}_d3x3r", layout=layout),
        pd, (3, 3), f"{name}_d3x3a", pad=(1, 1), layout=layout)
    laned = conv_bn_act(laned, pd, (3, 3), f"{name}_d3x3b", pad=(1, 1),
                        layout=layout)
    pooled = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1),
                         pad=(1, 1), pool_type=pool, layout=layout,
                         name=f"{name}_pool")
    lanep = conv_bn_act(pooled, proj, (1, 1), f"{name}_proj",
                        layout=layout)
    return sym.Concat(lane1, lane3, laned, lanep, dim=_cat(layout),
                      name=f"{name}_out")


def _mix_b(data, spec, name, layout):
    r3, p3, rd, pd = spec
    lane3 = conv_bn_act(
        conv_bn_act(data, r3, (1, 1), f"{name}_3x3r", layout=layout),
        p3, (3, 3), f"{name}_3x3", stride=(2, 2), pad=(1, 1),
        layout=layout)
    laned = conv_bn_act(
        conv_bn_act(data, rd, (1, 1), f"{name}_d3x3r", layout=layout),
        pd, (3, 3), f"{name}_d3x3a", pad=(1, 1), layout=layout)
    laned = conv_bn_act(laned, pd, (3, 3), f"{name}_d3x3b", stride=(2, 2),
                        pad=(1, 1), layout=layout)
    pooled = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                         pad=(1, 1), pool_type="max", layout=layout,
                         name=f"{name}_pool")
    return sym.Concat(lane3, laned, pooled, dim=_cat(layout),
                      name=f"{name}_out")


def _small_net(data, layout):
    body = conv_bn_act(data, 96, (3, 3), "conv1", pad=(1, 1),
                       layout=layout)
    for entry in _SMALL:
        if entry[1] == "D":
            name, _, ch = entry
            lane = conv_bn_act(body, ch, (3, 3), f"{name}_3x3",
                               stride=(2, 2), pad=(1, 1), layout=layout)
            pooled = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                                 pad=(1, 1), pool_type="max",
                                 layout=layout, name=f"{name}_pool")
            body = sym.Concat(lane, pooled, dim=_cat(layout),
                              name=f"{name}_out")
        else:
            name, c1, c3 = entry
            lane1 = conv_bn_act(body, c1, (1, 1), f"{name}_1x1",
                                layout=layout)
            lane3 = conv_bn_act(body, c3, (3, 3), f"{name}_3x3",
                                pad=(1, 1), layout=layout)
            body = sym.Concat(lane1, lane3, dim=_cat(layout),
                              name=f"{name}_out")
    return body


def get_symbol(num_classes=1000, image_shape="224,224,3", layout="NHWC",
               dtype="float32", **kwargs):
    height = int(str(image_shape).split(",")[0])
    data = maybe_cast(sym.Variable("data"), dtype)
    if height <= 28:
        body = _small_net(data, layout)
        return classifier(body, num_classes, layout, dtype)
    body = conv_bn_act(data, 64, (7, 7), "conv1", stride=(2, 2),
                       pad=(3, 3), layout=layout)
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max", layout=layout, name="pool1")
    body = conv_bn_act(body, 64, (1, 1), "conv2red", layout=layout)
    body = conv_bn_act(body, 192, (3, 3), "conv2", pad=(1, 1),
                       layout=layout)
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max", layout=layout, name="pool2")
    for stage in _STAGES:
        for entry in stage:
            if entry[1] == "B":
                name, _, spec = entry
                body = _mix_b(body, spec, name, layout)
            else:
                name, spec = entry
                body = _mix_a(body, spec, name, layout)
    return classifier(body, num_classes, layout, dtype)

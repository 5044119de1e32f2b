"""GoogLeNet / Inception-v1 symbol builder.

Reference analogue: example/image-classification/symbols/googlenet.py
(Szegedy et al. 2014, "Going Deeper with Convolutions"). The nine
inception mixes are a table here; each mix concatenates a 1x1 branch,
a reduced 3x3 branch, a reduced 5x5 branch, and a pooled projection
along channels.

Deviation from the reference symbol: the classifier keeps the paper's
0.4 dropout before the FC layer (Szegedy et al. §6); the reference
symbol file omits it. Noted in PARITY.md §1 L10.
"""
from __future__ import annotations

from .. import symbol as sym
from ._blocks import classifier, conv_act, maybe_cast

# (1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool proj) — googlenet.py:57-67
_MIXES = {
    "in3a": (64, 96, 128, 16, 32, 32),
    "in3b": (128, 128, 192, 32, 96, 64),
    "in4a": (192, 96, 208, 16, 48, 64),
    "in4b": (160, 112, 224, 24, 64, 64),
    "in4c": (128, 128, 256, 24, 64, 64),
    "in4d": (112, 144, 288, 32, 64, 64),
    "in4e": (256, 160, 320, 32, 128, 128),
    "in5a": (256, 160, 320, 32, 128, 128),
    "in5b": (384, 192, 384, 48, 128, 128),
}
# mixes after which a stride-2 max pool sits
_POOL_AFTER = {"in3b", "in4e"}


def _mix(data, spec, name, layout):
    p1, r3, p3, r5, p5, pp = spec
    lane1 = conv_act(data, p1, (1, 1), f"{name}_1x1", layout=layout)
    lane3 = conv_act(conv_act(data, r3, (1, 1), f"{name}_3x3r",
                              layout=layout),
                     p3, (3, 3), f"{name}_3x3", pad=(1, 1), layout=layout)
    lane5 = conv_act(conv_act(data, r5, (1, 1), f"{name}_5x5r",
                              layout=layout),
                     p5, (5, 5), f"{name}_5x5", pad=(2, 2), layout=layout)
    pooled = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1),
                         pad=(1, 1), pool_type="max", layout=layout,
                         name=f"{name}_pool")
    lanep = conv_act(pooled, pp, (1, 1), f"{name}_proj", layout=layout)
    dim = 3 if layout == "NHWC" else 1
    return sym.Concat(lane1, lane3, lane5, lanep, dim=dim,
                      name=f"{name}_out")


def get_symbol(num_classes=1000, layout="NHWC", dtype="float32", **kwargs):
    data = maybe_cast(sym.Variable("data"), dtype)
    body = conv_act(data, 64, (7, 7), "conv1", stride=(2, 2), pad=(3, 3),
                    layout=layout)
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max", layout=layout, name="pool1")
    body = conv_act(body, 64, (1, 1), "conv2", layout=layout)
    body = conv_act(body, 192, (3, 3), "conv3", pad=(1, 1), layout=layout)
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max", layout=layout, name="pool3")
    for name, spec in _MIXES.items():
        body = _mix(body, spec, name, layout)
        if name in _POOL_AFTER:
            body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                               pool_type="max", layout=layout,
                               name=f"{name}_down")
    return classifier(body, num_classes, layout, dtype, dropout=0.4)

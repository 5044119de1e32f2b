"""MobileNet-v1 symbol builder.

Reference analogue: example/image-classification/symbols/mobilenet.py
(Howard et al. 2017). Each row of the plan is one depthwise-separable
block: a 3x3 depthwise conv (num_group == channels, a grouped cuDNN
convolution) followed by a 1x1 pointwise conv. The
reference unrolls 14 of these by hand; here they come from the table.
``multiplier`` scales every width (the paper's alpha).
"""
from __future__ import annotations

from .. import symbol as sym
from ._blocks import classifier, conv_bn_act, maybe_cast

# (pointwise output channels, depthwise stride) — mobilenet.py:29-56
_PLAN = [
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
    (1024, 1),
]


def get_symbol(num_classes=1000, multiplier=1.0, layout="NHWC",
               dtype="float32", **kwargs):
    def width(ch):
        return max(8, int(ch * multiplier))

    data = maybe_cast(sym.Variable("data"), dtype)
    body = conv_bn_act(data, width(32), (3, 3), "conv1", stride=(2, 2),
                       pad=(1, 1), layout=layout)
    ch_in = width(32)
    for i, (ch_out, stride) in enumerate(_PLAN, start=2):
        body = conv_bn_act(body, ch_in, (3, 3), f"conv{i}_dw",
                           stride=(stride, stride), pad=(1, 1),
                           num_group=ch_in, layout=layout)
        ch_in = width(ch_out)
        body = conv_bn_act(body, ch_in, (1, 1), f"conv{i}_pw",
                           layout=layout)
    return classifier(body, num_classes, layout, dtype)

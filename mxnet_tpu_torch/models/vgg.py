"""VGG symbol (reference: example/image-classification/symbols/vgg.py)."""
from __future__ import annotations

from .. import symbol as sym
from ..base import MXNetError

# num_layers -> (convs per stage, filters per stage) — vgg.py:24-29
_CONFIG = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False,
               layout="NHWC", dtype="float32", **kwargs):
    if num_layers not in _CONFIG:
        raise MXNetError(f"no vgg config for {num_layers} layers")
    layers, filters = _CONFIG[num_layers]
    data = sym.Variable("data")
    if dtype in ("float16", "bfloat16"):
        data = sym.Cast(data=data, dtype=dtype)
    body = data
    bn_axis = 3 if layout == "NHWC" else 1
    for i, num in enumerate(layers):
        for j in range(num):
            body = sym.Convolution(data=body, kernel=(3, 3), pad=(1, 1),
                                   num_filter=filters[i], layout=layout,
                                   name=f"conv{i + 1}_{j + 1}")
            if batch_norm:
                body = sym.BatchNorm(data=body, axis=bn_axis,
                                     name=f"bn{i + 1}_{j + 1}")
            body = sym.Activation(data=body, act_type="relu",
                                  name=f"relu{i + 1}_{j + 1}")
        body = sym.Pooling(data=body, pool_type="max", kernel=(2, 2),
                           stride=(2, 2), layout=layout,
                           name=f"pool{i + 1}")
    flatten = sym.Flatten(data=body, name="flatten")
    fc6 = sym.FullyConnected(data=flatten, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(data=fc6, act_type="relu", name="relu6")
    drop6 = sym.Dropout(data=relu6, p=0.5, name="drop6")
    fc7 = sym.FullyConnected(data=drop6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(data=fc7, act_type="relu", name="relu7")
    drop7 = sym.Dropout(data=relu7, p=0.5, name="drop7")
    fc8 = sym.FullyConnected(data=drop7, num_hidden=num_classes, name="fc8")
    if dtype in ("float16", "bfloat16"):
        fc8 = sym.Cast(data=fc8, dtype="float32")
    return sym.SoftmaxOutput(data=fc8, name="softmax")

"""ResNeXt symbol builder (aggregated-transform residual nets).

Reference analogue: example/image-classification/symbols/resnext.py
(Xie et al. 2016). The bottleneck's 3x3 conv runs with ``num_group``
parallel transform groups at half the block width; stage layout and
depth table follow the reference resnet family.
"""
from __future__ import annotations

from .. import symbol as sym
from ..base import MXNetError
from ._blocks import bn_axis, classifier, conv, maybe_cast

# num_layers -> (bottleneck?, units per stage) — resnext.py:163-186
_UNITS = {
    50: (True, [3, 4, 6, 3]),
    101: (True, [3, 4, 23, 3]),
    152: (True, [3, 8, 36, 3]),
}


def _bn(data, name, layout):
    return sym.BatchNorm(data=data, fix_gamma=False, eps=2e-5,
                         momentum=0.9, axis=bn_axis(layout), name=name)


def _unit(data, num_filter, stride, dim_match, num_group, name, layout):
    """Post-activation bottleneck with a grouped 3x3
    (resnext.py:residual_unit:47-76)."""
    mid = num_filter // 2
    c1 = conv(data, mid, (1, 1), f"{name}_conv1", layout=layout)
    b1 = _bn(c1, f"{name}_bn1", layout)
    a1 = sym.Activation(data=b1, act_type="relu", name=f"{name}_relu1")
    c2 = conv(a1, mid, (3, 3), f"{name}_conv2", stride=stride,
              pad=(1, 1), num_group=num_group, layout=layout)
    b2 = _bn(c2, f"{name}_bn2", layout)
    a2 = sym.Activation(data=b2, act_type="relu", name=f"{name}_relu2")
    c3 = conv(a2, num_filter, (1, 1), f"{name}_conv3", layout=layout)
    b3 = _bn(c3, f"{name}_bn3", layout)
    if dim_match:
        shortcut = data
    else:
        sc = conv(data, num_filter, (1, 1), f"{name}_sc", stride=stride,
                  layout=layout)
        shortcut = _bn(sc, f"{name}_sc_bn", layout)
    return sym.Activation(data=b3 + shortcut, act_type="relu",
                          name=f"{name}_out")


def get_symbol(num_classes=1000, num_layers=50, num_group=32,
               image_shape="224,224,3", layout="NHWC", dtype="float32",
               **kwargs):
    if num_layers not in _UNITS:
        raise MXNetError(f"no resnext config for {num_layers} layers "
                         f"(choose from {sorted(_UNITS)})")
    _, units = _UNITS[num_layers]
    filters = [64, 256, 512, 1024, 2048]

    data = maybe_cast(sym.Variable("data"), dtype)
    body = conv(data, filters[0], (7, 7), "conv0", stride=(2, 2),
                pad=(3, 3), layout=layout)
    body = _bn(body, "bn0", layout)
    body = sym.Activation(data=body, act_type="relu", name="relu0")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pad=(1, 1), pool_type="max", layout=layout,
                       name="pool0")
    for s, n_units in enumerate(units):
        stride = (1, 1) if s == 0 else (2, 2)
        body = _unit(body, filters[s + 1], stride, False, num_group,
                     f"stage{s + 1}_unit1", layout)
        for u in range(2, n_units + 1):
            body = _unit(body, filters[s + 1], (1, 1), True, num_group,
                         f"stage{s + 1}_unit{u}", layout)
    return classifier(body, num_classes, layout, dtype)

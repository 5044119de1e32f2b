"""ResNet v1/v2 symbol builders.

Reference analogue: example/image-classification/symbols/resnet.py (preact
v2, He et al. 1603.05027) and resnet-v1.py; a copy of the JAX package's
builder, whose symbol JSON it reproduces bit for bit. Differences from the
reference:

* default layout is NHWC (channel-last), which cuDNN runs as channels_last
  without inserting transposes;
* BatchNorm runs over the last axis in NHWC;
* the stem/downsample structure and unit counts match the reference so
  checkpoints and per-layer shapes line up 1:1 (modulo layout).
"""
from __future__ import annotations

from .. import symbol as sym
from ..base import MXNetError

# num_layers -> (bottleneck?, units per stage) — resnet.py:141-165
_UNITS = {
    18: (False, [2, 2, 2, 2]),
    34: (False, [3, 4, 6, 3]),
    50: (True, [3, 4, 6, 3]),
    101: (True, [3, 4, 23, 3]),
    152: (True, [3, 8, 36, 3]),
    200: (True, [3, 24, 36, 3]),
    269: (True, [3, 30, 48, 8]),
}


def _conv(data, num_filter, kernel, stride, pad, name, layout):
    return sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, no_bias=True, name=name,
                           layout=layout, workspace=256)


def _bn(data, name, layout, eps=2e-5, momentum=0.9):
    axis = 3 if layout == "NHWC" else 1
    return sym.BatchNorm(data=data, fix_gamma=False, eps=eps,
                         momentum=momentum, axis=axis, name=name)


def residual_unit_v2(data, num_filter, stride, dim_match, name, bottle_neck,
                     layout):
    """Pre-activation unit (resnet.py:29-91)."""
    bn1 = _bn(data, name + "_bn1", layout)
    act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
    if bottle_neck:
        conv1 = _conv(act1, num_filter // 4, (1, 1), (1, 1), (0, 0),
                      name + "_conv1", layout)
        bn2 = _bn(conv1, name + "_bn2", layout)
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv2 = _conv(act2, num_filter // 4, (3, 3), stride, (1, 1),
                      name + "_conv2", layout)
        bn3 = _bn(conv2, name + "_bn3", layout)
        act3 = sym.Activation(data=bn3, act_type="relu", name=name + "_relu3")
        body = _conv(act3, num_filter, (1, 1), (1, 1), (0, 0),
                     name + "_conv3", layout)
    else:
        conv1 = _conv(act1, num_filter, (3, 3), stride, (1, 1),
                      name + "_conv1", layout)
        bn2 = _bn(conv1, name + "_bn2", layout)
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        body = _conv(act2, num_filter, (3, 3), (1, 1), (1, 1),
                     name + "_conv2", layout)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv(act1, num_filter, (1, 1), stride, (0, 0),
                         name + "_sc", layout)
    return body + shortcut


def residual_unit_v1(data, num_filter, stride, dim_match, name, bottle_neck,
                     layout):
    """Post-activation unit (resnet-v1.py:29-88)."""
    if bottle_neck:
        conv1 = _conv(data, num_filter // 4, (1, 1), (1, 1), (0, 0),
                      name + "_conv1", layout)
        bn1 = _bn(conv1, name + "_bn1", layout)
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv2 = _conv(act1, num_filter // 4, (3, 3), stride, (1, 1),
                      name + "_conv2", layout)
        bn2 = _bn(conv2, name + "_bn2", layout)
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv3 = _conv(act2, num_filter, (1, 1), (1, 1), (0, 0),
                      name + "_conv3", layout)
        body = _bn(conv3, name + "_bn3", layout)
    else:
        conv1 = _conv(data, num_filter, (3, 3), stride, (1, 1),
                      name + "_conv1", layout)
        bn1 = _bn(conv1, name + "_bn1", layout)
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv2 = _conv(act1, num_filter, (3, 3), (1, 1), (1, 1),
                      name + "_conv2", layout)
        body = _bn(conv2, name + "_bn2", layout)
    if dim_match:
        shortcut = data
    else:
        sc_conv = _conv(data, num_filter, (1, 1), stride, (0, 0),
                        name + "_sc", layout)
        shortcut = _bn(sc_conv, name + "_sc_bn", layout)
    return sym.Activation(data=body + shortcut, act_type="relu",
                          name=name + "_relu")


def get_symbol(num_classes=1000, num_layers=50, image_shape="224,224,3",
               version=2, layout="NHWC", dtype="float32", pipe_stages=0,
               **kwargs):
    """Build a ResNet (reference: resnet.py:95-185 get_symbol).

    image_shape is H,W,C regardless of layout (the data symbol is laid out
    per ``layout``).

    ``pipe_stages=N`` annotates the graph for pipeline parallelism: the
    stem becomes ``ctx_group='prologue'``, the residual units are spread
    contiguously over ``stage0..stage{N-1}`` (balanced by unit count),
    and the head becomes ``ctx_group='epilogue'``: the JAX package's
    pipeline parallelism reads these annotations (queue A11 ports it).
    """
    from ..symbol.symbol import AttrScope
    import contextlib

    if num_layers not in _UNITS:
        raise MXNetError(f"no unit config for resnet-{num_layers}")
    bottle_neck, units = _UNITS[num_layers]
    filter_list = ([64, 256, 512, 1024, 2048] if bottle_neck
                   else [64, 64, 128, 256, 512])
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    height = image_shape[0]
    unit = residual_unit_v2 if version == 2 else residual_unit_v1

    total_units = sum(units)
    if pipe_stages and pipe_stages > total_units:
        raise MXNetError(f"pipe_stages {pipe_stages} exceeds the "
                         f"{total_units} residual units of "
                         f"resnet-{num_layers}")

    def scope(label):
        return (AttrScope(ctx_group=label) if pipe_stages
                else contextlib.nullcontext())

    with scope("prologue"):
        data = sym.Variable(name="data")
        if dtype in ("float16", "bfloat16"):
            data = sym.Cast(data=data, dtype=dtype)
        if height <= 32:  # cifar-style stem (resnet.py:116-120)
            body = _conv(data, filter_list[0], (3, 3), (1, 1), (1, 1),
                         "conv0", layout)
        else:  # imagenet stem (resnet.py:121-127)
            body = _conv(data, filter_list[0], (7, 7), (2, 2), (3, 3),
                         "conv0", layout)
            body = _bn(body, "bn0", layout)
            body = sym.Activation(data=body, act_type="relu", name="relu0")
            body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                               pad=(1, 1), pool_type="max", layout=layout)

    u_idx = 0
    for i, n in enumerate(units):
        for j in range(n):
            label = (f"stage{u_idx * pipe_stages // total_units}"
                     if pipe_stages else None)
            with scope(label):
                stride = (1, 1) if (i == 0 or j > 0) else (2, 2)
                body = unit(body, filter_list[i + 1], stride, j > 0,
                            f"stage{i + 1}_unit{j + 1}", bottle_neck,
                            layout)
            u_idx += 1

    if version == 2:  # final bn-relu (resnet.py:172-173) — staged with
        # the last pipe stage: the epilogue runs replicated and cannot
        # carry BatchNorm aux state
        with scope(f"stage{pipe_stages - 1}" if pipe_stages else None):
            body = _bn(body, "bn1", layout)
            body = sym.Activation(data=body, act_type="relu", name="relu1")
    with scope("epilogue"):
        pool = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                           pool_type="avg", name="pool1", layout=layout)
        flat = sym.Flatten(data=pool)
        fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes,
                                 name="fc1")
        if dtype in ("float16", "bfloat16"):
            fc1 = sym.Cast(data=fc1, dtype="float32")
        return sym.SoftmaxOutput(data=fc1, name="softmax")

"""Shared conv-net building blocks for the symbolic model zoo.

The NHWC-default conv/bn/act trio every builder composes; keeping them
here stops each network file from re-declaring the same three wrappers.
"""
from __future__ import annotations

from .. import symbol as sym


def bn_axis(layout):
    return 3 if layout == "NHWC" else 1


def conv(data, num_filter, kernel, name, stride=(1, 1), pad=(0, 0),
         num_group=1, layout="NHWC", no_bias=True):
    return sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, num_group=num_group,
                           no_bias=no_bias, layout=layout, name=name)


def conv_act(data, num_filter, kernel, name, stride=(1, 1), pad=(0, 0),
             layout="NHWC"):
    """conv + relu (no BN) — the GoogLeNet-era factory."""
    c = conv(data, num_filter, kernel, f"{name}_conv", stride, pad,
             layout=layout, no_bias=False)
    return sym.Activation(data=c, act_type="relu", name=f"{name}_relu")


def conv_bn_act(data, num_filter, kernel, name, stride=(1, 1), pad=(0, 0),
                num_group=1, layout="NHWC", eps=2e-5, momentum=0.9,
                fix_gamma=False, act=True):
    """conv + batchnorm + relu — the BN-era factory."""
    c = conv(data, num_filter, kernel, f"{name}_conv", stride, pad,
             num_group, layout)
    b = sym.BatchNorm(data=c, fix_gamma=fix_gamma, eps=eps,
                      momentum=momentum, axis=bn_axis(layout),
                      name=f"{name}_bn")
    if not act:
        return b
    return sym.Activation(data=b, act_type="relu", name=f"{name}_relu")


def towers(data, branches, name, layout="NHWC", fix_gamma=False):
    """Parallel conv towers concatenated along channels — the declarative
    core the Inception-family builders share.

    Each branch is a list of steps applied in sequence:

    - ``("conv", filters, kernel, stride, pad)`` — conv+BN+relu
    - ``("pool", type, kernel, stride, pad)`` — avg/max pooling
    - ``("fork", stepsA, stepsB)`` — split into two sub-towers whose
      outputs both join the final concat (Inception-v3's mixed 9/10
      "expanded filter-bank" tails)

    Outputs are concatenated in branch order, fork outputs inline.
    """
    outs = []
    for bi, steps in enumerate(branches):
        x = data
        tag = f"{name}_b{bi}"
        for si, step in enumerate(steps):
            kind = step[0]
            if kind == "conv":
                _, nf, kernel, stride, pad = step
                x = conv_bn_act(x, nf, kernel, f"{tag}_{si}", stride, pad,
                                layout=layout, fix_gamma=fix_gamma)
            elif kind == "pool":
                _, ptype, kernel, stride, pad = step
                x = sym.Pooling(data=x, kernel=kernel, stride=stride,
                                pad=pad, pool_type=ptype, layout=layout,
                                name=f"{tag}_{si}_pool")
            elif kind == "fork":
                if si != len(steps) - 1:
                    raise ValueError(
                        f"{name}: 'fork' must be the last step in a branch")
                for fi, sub in enumerate(step[1:]):
                    y = x
                    for sj, substep in enumerate(sub):
                        _, nf, kernel, stride, pad = substep
                        y = conv_bn_act(y, nf, kernel,
                                        f"{tag}_f{fi}_{sj}", stride, pad,
                                        layout=layout, fix_gamma=fix_gamma)
                    outs.append(y)
                x = None
            else:
                raise ValueError(f"unknown tower step {kind!r}")
        if x is not None:
            outs.append(x)
    return sym.Concat(*outs, dim=bn_axis(layout), name=f"{name}_concat")


def maybe_cast(data, dtype):
    if dtype in ("float16", "bfloat16"):
        return sym.Cast(data=data, dtype=dtype)
    return data


def classifier(body, num_classes, layout, dtype, pool_kernel=(7, 7),
               dropout=0.0):
    """global avg pool -> (dropout) -> fc -> softmax output."""
    pool = sym.Pooling(data=body, pool_type="avg", kernel=pool_kernel,
                       global_pool=True, layout=layout, name="global_pool")
    flat = sym.Flatten(data=pool, name="flatten")
    if dropout > 0:
        flat = sym.Dropout(data=flat, p=dropout, name="drop_cls")
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    if dtype in ("float16", "bfloat16"):
        fc = sym.Cast(data=fc, dtype="float32")
    return sym.SoftmaxOutput(data=fc, name="softmax")

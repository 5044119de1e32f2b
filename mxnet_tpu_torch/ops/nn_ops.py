"""Neural-network layer ops of the LSTM LM graph.

Counterpart of the matching ops in ``mxnet_tpu/ops/nn_ops.py``:
FullyConnected, softmax and the forward of SoftmaxOutput. These are plain
torch: the product goes to ``torch.matmul`` as the JAX package left it to
XLA.
"""
from __future__ import annotations

import torch

from ..base import AttrSpec
from .registry import register


def _fc_param_shapes(attrs, shapes):
    d = shapes[0]
    nh = int(attrs["num_hidden"])
    in_dim = 1
    if attrs.get("flatten", True):
        for s in d[1:]:
            in_dim *= s
    else:
        in_dim = d[-1]
    out = [d, (nh, in_dim)]
    if len(shapes) > 2:
        out.append((nh,))
    return out


@register("FullyConnected",
          num_inputs=None, input_names=["data", "weight", "bias"],
          param_shapes=_fc_param_shapes,
          attrs=AttrSpec(num_hidden=("int",), no_bias=("bool", False),
                         flatten=("bool", True)))
def _fully_connected(*args, num_hidden, no_bias=False, flatten=True):
    data, weight = args[0], args[1]
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    # compute in the activation dtype (bf16 activations over fp32 master
    # weights stay in bf16)
    weight = weight.to(data.dtype)
    out = torch.matmul(data, weight.t())
    if not no_bias:
        out = out + args[2].to(data.dtype)
    return out


@register("softmax", attrs=AttrSpec(axis=("int", -1),
                                    temperature=("any", None)))
def _softmax(data, axis=-1, temperature=None):
    if temperature not in (None, "None"):
        data = data / float(temperature)
    return torch.softmax(data, dim=axis)


def _softmax_out_label_shape(attrs, shapes):
    d = shapes[0]
    if attrs.get("multi_output"):
        lab = (d[0],) + tuple(d[2:])
    elif attrs.get("preserve_shape"):
        lab = tuple(d[:-1])
    else:
        lab = (d[0],)
    return [d, lab]


@register("SoftmaxOutput", aliases=["Softmax"],
          param_shapes=_softmax_out_label_shape,
          num_inputs=2, input_names=["data", "label"],
          attrs=AttrSpec(grad_scale=("float", 1.0), ignore_label=("float", -1.0),
                         multi_output=("bool", False), use_ignore=("bool", False),
                         preserve_shape=("bool", False),
                         normalization=("str", "null"), out_grad=("bool", False),
                         smooth_alpha=("float", 0.0)))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False, preserve_shape=False,
                    normalization="null", out_grad=False, smooth_alpha=0.0):
    """Forward of the loss layer: a softmax that ignores the label. Its
    backward, which ignores the head gradient, comes with the training
    slice."""
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    prob = torch.softmax(data.reshape(data.shape[0], -1), dim=-1)
    return prob.reshape(data.shape)


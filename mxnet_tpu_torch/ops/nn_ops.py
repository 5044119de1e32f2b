"""Neural-network layer ops of the LSTM LM graph.

Counterpart of the matching ops in ``mxnet_tpu/ops/nn_ops.py``:
FullyConnected, softmax and SoftmaxOutput. These are plain torch: the
product goes to ``torch.matmul`` as the JAX package left it to XLA, and
autograd differentiates it. SoftmaxOutput's backward is its own
``torch.autograd.Function``: a loss layer's gradient that ignores the head
gradient, as the JAX package's custom VJP does.
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


def _softmax_out_fwd(data, multi_output, preserve_shape):
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    prob = torch.softmax(data.reshape(data.shape[0], -1), dim=-1)
    return prob.reshape(data.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """The loss layer: its forward is a softmax that ignores the label, its
    backward (``_softmax_output_bwd`` of the JAX package) is prob - onehot
    with the head gradient ignored unless ``out_grad``, masked where
    ``use_ignore``, scaled by ``grad_scale`` and divided by the rows of the
    reshaped prob (``normalization='batch'``) or the unignored labels
    (``'valid'``). The label gets no gradient. ``smooth_alpha`` is ignored,
    as the JAX package ignores it."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, preserve_shape, normalization, out_grad):
        prob = _softmax_out_fwd(data, multi_output, preserve_shape)
        ctx.save_for_backward(prob, label)
        ctx.attrs = (grad_scale, ignore_label, multi_output, use_ignore,
                     normalization, out_grad)
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        (grad_scale, ignore_label, multi_output, use_ignore, normalization,
         out_grad) = ctx.attrs
        class_axis = 1 if multi_output else prob.dim() - 1
        nclass = prob.shape[class_axis]
        lab = label.to(torch.int32)
        # a label outside [0, nclass) has an all-zero row, as jax.nn.one_hot
        onehot = (lab.unsqueeze(-1) == torch.arange(
            nclass, device=lab.device, dtype=torch.int32)).to(prob.dtype)
        if multi_output:
            onehot = torch.movedim(onehot, -1, 1)
        grad = prob - onehot
        if use_ignore:
            keep = lab != int(ignore_label)
            grad = grad * keep.to(prob.dtype).unsqueeze(class_axis)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / prob.shape[0]
        elif normalization == "valid" and use_ignore:
            valid = torch.clamp(keep.sum(), min=1)
            grad = grad / valid.to(prob.dtype)
        if out_grad:
            grad = grad * g
        return (grad * scale,) + (None,) * 8


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
    """The loss layer (:class:`_SoftmaxOutput`): a softmax forward whose
    backward ignores the head gradient unless ``out_grad``."""
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label,
                                multi_output, use_ignore, preserve_shape,
                                normalization, out_grad)


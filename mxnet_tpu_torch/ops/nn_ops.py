"""Neural-network layer ops of the LSTM LM and the CNN model zoo.

Counterpart of the matching ops in ``mxnet_tpu/ops/nn_ops.py``:
FullyConnected, Convolution, Deconvolution, Pooling, BatchNorm,
InstanceNorm, LRN, Activation, LeakyReLU, Dropout, softmax, log_softmax
and SoftmaxOutput. The JAX package left these to XLA, so here they are
torch calls: products go to cuBLAS (``torch.matmul``), convolutions to
cuDNN (``torch.nn.functional.conv*d`` and ``conv_transpose*d``), pooling
and batch normalisation to torch's own kernels, and autograd
differentiates them. Channel-last
layouts (``NHWC`` and the others) hand those calls permuted views whose
memory is torch's ``channels_last``, so no layout copy is made; weights
keep the JAX package's stored layout (OHWI for NHWC) and ``.params`` files
stay interchangeable. SoftmaxOutput's backward is its own
``torch.autograd.Function``: a loss layer's gradient that ignores the head
gradient, as the JAX package's custom VJP does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import AttrSpec, MXNetError
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


# ---------------------------------------------------------------------------
# Convolution (mxnet_tpu/ops/nn_ops.py:66-146)
# ---------------------------------------------------------------------------

_CONV_SPEC = AttrSpec(
    kernel=("tuple",), stride=("tuple", ()), dilate=("tuple", ()),
    pad=("tuple", ()), num_filter=("int",), num_group=("int", 1),
    workspace=("int", 1024), no_bias=("bool", False),
    cudnn_tune=("str", None), cudnn_off=("bool", False),
    layout=("str", None), adj=("tuple", ()), target_shape=("tuple", ()),
)

_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _channel_last(layout):
    """True for the ``N*C`` layouts (NWC, NHWC, NDHWC); None and the
    ``NC*`` layouts are channel-first."""
    if layout is None or layout == "None":
        return False
    layout = str(layout)
    if layout in ("NCW", "NCHW", "NCDHW"):
        return False
    if layout in ("NWC", "NHWC", "NDHWC"):
        return True
    raise MXNetError(f"unsupported conv layout {layout}")


def _to_channel_first(x):
    """(N, *spatial, C) as an (N, C, *spatial) view: no copy, and for 4-D
    and 5-D tensors torch's channels_last memory format."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_channel_last(x):
    """The inverse view of :func:`_to_channel_first`."""
    return x.permute(0, *range(2, x.dim()), 1)


def _norm_spatial(t, n, default):
    t = tuple(t) if t else ()
    return t if len(t) == n else (default,) * n


def _conv_param_shapes(attrs, shapes):
    d = shapes[0]
    nf = int(attrs["num_filter"])
    g = int(attrs.get("num_group", 1) or 1)
    kernel = tuple(attrs["kernel"])
    if _channel_last(attrs.get("layout")):
        w = (nf,) + kernel + (d[-1] // g,)
    else:
        w = (nf, d[1] // g) + kernel
    out = [d, w]
    if len(shapes) > 2:
        out.append((nf,))
    return out


@register("Convolution",
          num_inputs=None, input_names=["data", "weight", "bias"],
          param_shapes=_conv_param_shapes,
          attrs=_CONV_SPEC)
def _convolution(*args, kernel, stride=(), dilate=(), pad=(), num_filter=0,
                 num_group=1, workspace=1024, no_bias=False, cudnn_tune=None,
                 cudnn_off=False, layout=None, adj=(), target_shape=()):
    """1-, 2- and 3-D convolution, grouped and dilated, through cuDNN on
    the card. The weight is cast to the data's dtype; an ``N*C`` layout
    runs on channels_last views of data and weight (OHWI read as OIHW)."""
    data, weight = args[0], args[1]
    nsp = len(kernel)
    if nsp not in _CONV_FN or data.dim() != nsp + 2:
        raise MXNetError(f"Convolution: kernel {tuple(kernel)} over data of "
                         f"shape {tuple(data.shape)}")
    weight = weight.to(data.dtype)
    bias = None if no_bias else args[2].to(data.dtype)
    last = _channel_last(layout)
    if last:
        data, weight = _to_channel_first(data), _to_channel_first(weight)
    out = _CONV_FN[nsp](data, weight, bias,
                        stride=_norm_spatial(stride, nsp, 1),
                        padding=_norm_spatial(pad, nsp, 0),
                        dilation=_norm_spatial(dilate, nsp, 1),
                        groups=num_group)
    return _to_channel_last(out) if last else out


def _deconv_param_shapes(attrs, shapes):
    d = shapes[0]
    nf = int(attrs["num_filter"])
    g = int(attrs.get("num_group", 1) or 1)
    cin = d[-1] if _channel_last(attrs.get("layout")) else d[1]
    out = [d, (cin, nf // g) + tuple(attrs["kernel"])]
    if len(shapes) > 2:
        out.append((nf,))
    return out


_DECONV_FN = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
              3: F.conv_transpose3d}


@register("Deconvolution",
          num_inputs=None, input_names=["data", "weight", "bias"],
          param_shapes=_deconv_param_shapes,
          attrs=_CONV_SPEC)
def _deconvolution(*args, kernel, stride=(), dilate=(), pad=(), num_filter=0,
                   num_group=1, workspace=1024, no_bias=False, cudnn_tune=None,
                   cudnn_off=False, layout=None, adj=(), target_shape=()):
    """Transposed convolution (``mxnet_tpu/ops/nn_ops.py:159``) through
    cuDNN on the card (``F.conv_transpose*d``): the weight is
    (C_in, C_out / groups, *kernel) in every layout, ``adj`` adds rows at
    the high end of each output dim (torch's ``output_padding``, which
    must stay below the stride or the dilation there), and an ``N*C``
    layout runs on a channels_last view of the data. ``target_shape`` is
    ignored, as the JAX op ignores it."""
    data, weight = args[0], args[1]
    nsp = len(kernel)
    if nsp not in _DECONV_FN or data.dim() != nsp + 2:
        raise MXNetError(f"Deconvolution: kernel {tuple(kernel)} over data "
                         f"of shape {tuple(data.shape)}")
    stride = _norm_spatial(stride, nsp, 1)
    dilate = _norm_spatial(dilate, nsp, 1)
    adj = _norm_spatial(adj, nsp, 0)
    if any(a >= max(s, d) for a, s, d in zip(adj, stride, dilate)):
        raise MXNetError(f"Deconvolution: adj {adj} must be below the "
                         f"stride {stride} or the dilation {dilate}")
    weight = weight.to(data.dtype)
    bias = None if no_bias else args[2].to(data.dtype)
    last = _channel_last(layout)
    if last:
        data = _to_channel_first(data)
    out = _DECONV_FN[nsp](data, weight, bias, stride=stride,
                          padding=_norm_spatial(pad, nsp, 0),
                          output_padding=adj, groups=num_group,
                          dilation=dilate)
    return _to_channel_last(out) if last else out


# ---------------------------------------------------------------------------
# Pooling (mxnet_tpu/ops/nn_ops.py:205-253)
# ---------------------------------------------------------------------------

_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_padding(size, kernel, stride, pad, full):
    """(low, high) padding of each spatial dim, as the JAX op pads: the
    symmetric ``pad``, and with ``pooling_convention='full'`` extra cells
    on the high side so that the output has the ceil size."""
    out = []
    for n, k, s, p in zip(size, kernel, stride, pad):
        hi = p
        if full:
            padded = n + 2 * p
            out_full = int(math.ceil((padded - k) / s)) + 1
            hi += max(0, (out_full - 1) * s + k - padded)
        out.append((p, hi))
    return out


@register("Pooling",
          attrs=AttrSpec(kernel=("tuple", ()), pool_type=("str", "max"),
                         global_pool=("bool", False),
                         pooling_convention=("str", "valid"),
                         stride=("tuple", ()), pad=("tuple", ()),
                         cudnn_off=("bool", False), layout=("str", None)))
def _pooling(data, kernel=(), pool_type="max", global_pool=False,
             pooling_convention="valid", stride=(), pad=(), cudnn_off=False,
             layout=None):
    """max, avg and sum pooling over 1-3 spatial dims. Padded cells count
    in the avg divisor, which is always the whole kernel, padded and
    'full'-convention cells included (``divisor_override``); max pooling's
    gradient goes to the first largest element of a window in row-major
    order, as the JAX op's. avg and sum pooling pad explicitly (zeros):
    torch's CUDA backward of a padded avg pool over channels_last memory
    (torch 2.11) sends wrong gradients to the cells next to the padding.
    Max pooling takes torch's padding argument where torch can express
    it (at most half the kernel, both sides alike) and pads with -inf
    otherwise (the 'full' convention's extra high cells)."""
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"unknown pool_type {pool_type}")
    nsp = data.dim() - 2
    last = layout is not None and str(layout).endswith("C") \
        and not str(layout).startswith("NC")
    x = _to_channel_first(data) if last else data
    if global_pool:
        kernel = tuple(x.shape[2:])
        stride = (1,) * nsp
        pad = (0,) * nsp
    kernel = tuple(kernel)
    stride = _norm_spatial(stride, nsp, 1)
    pad = _norm_spatial(pad, nsp, 0)
    padding = _pool_padding(x.shape[2:], kernel, stride, pad,
                            pooling_convention == "full" and not global_pool)
    if nsp == 1:  # 1-D runs as 2-D over a unit height
        x, kernel, stride = x.unsqueeze(2), (1,) + kernel, (1,) + stride
        padding = [(0, 0)] + padding
    torch_pad = (0,) * len(kernel)
    if pool_type == "max" and all(lo == hi and 2 * lo <= k for (lo, hi), k
                                  in zip(padding, kernel)):
        torch_pad = tuple(lo for lo, _ in padding)
    elif any(lo or hi for lo, hi in padding):
        fill = -math.inf if pool_type == "max" else 0.0
        flat = [p for lo_hi in reversed(padding) for p in lo_hi]
        x = F.pad(x, flat, value=fill)
    if pool_type == "max":
        out = _MAX_POOL[len(kernel)](x, kernel, stride, torch_pad)
    else:
        divisor = math.prod(kernel) if pool_type == "avg" else 1
        out = _AVG_POOL[len(kernel)](x, kernel, stride, torch_pad,
                                     divisor_override=divisor)
    if nsp == 1:
        out = out.squeeze(2)
    return _to_channel_last(out) if last else out


# ---------------------------------------------------------------------------
# BatchNorm and LRN (mxnet_tpu/ops/nn_ops.py:282-386)
# ---------------------------------------------------------------------------


def _bn_nout(attrs):
    return 3 if attrs.get("output_mean_var") in (True, "True", "1") else 1


def _bn_param_shapes(attrs, shapes):
    d = shapes[0]
    axis = int(attrs.get("axis", 1) or 1) % len(d)
    c = (d[axis],)
    return [d, c, c, c, c]


@register("BatchNorm",
          num_inputs=5,
          input_names=["data", "gamma", "beta", "moving_mean", "moving_var"],
          num_outputs=_bn_nout,
          needs_is_train=True,
          aux_inputs=(3, 4),
          param_shapes=_bn_param_shapes,
          aux_update={1: 3, 2: 4},  # written back into moving_mean/var
          attrs=AttrSpec(eps=("float", 1e-3), momentum=("float", 0.9),
                         fix_gamma=("bool", True),
                         use_global_stats=("bool", False),
                         output_mean_var=("bool", False),
                         axis=("int", 1), cudnn_off=("bool", False)))
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                _is_train=False):
    """Batch normalisation over every axis but ``axis``, as one fused
    torch call (``torch.native_batch_norm``) and its fused backward: it
    keeps the input and two per-channel vectors for the gradient, no
    intermediate of activation size. Training reads the batch's
    statistics, in fp32 for every data dtype; eval mode and
    ``use_global_stats`` read the moving ones. ``fix_gamma`` reads gamma as
    ones, so gamma's gradient is exactly 0. Returns the output and the new
    moving mean and variance, ``momentum * old + (1 - momentum) * batch``
    over the biased batch variance (not torch's running-stat convention),
    computed apart from the graph; the executor writes them back in
    training, and ``output_mean_var`` makes them visible outputs."""
    axis = axis % data.dim()
    # NHWC's channel axis last: a channels_last view, no copy
    x = data.movedim(axis, 1)
    # parameters in fp32 under bf16 and fp16 data
    pdt = (torch.float32 if data.dtype in (torch.bfloat16, torch.float16)
           else data.dtype)
    g = gamma.new_ones(gamma.shape, dtype=pdt) if fix_gamma else gamma.to(pdt)
    b = beta.to(pdt)
    if _is_train and not use_global_stats:
        out, mean, invstd = torch.native_batch_norm(
            x, g, b, None, None, True, 0.0, eps)
        with torch.no_grad():
            # the biased batch variance, from the kernel's 1/sqrt(var + eps)
            var = torch.clamp(invstd.pow(-2) - eps, min=0.0)
            new_mean = momentum * moving_mean + (1 - momentum) * mean
            new_var = momentum * moving_var + (1 - momentum) * var
    else:
        out, _, _ = torch.native_batch_norm(
            x, g, b, moving_mean.to(pdt), moving_var.to(pdt), False, 0.0, eps)
        new_mean, new_var = moving_mean, moving_var
    return out.movedim(1, axis), new_mean, new_var


@register("LRN", attrs=AttrSpec(alpha=("float", 1e-4), beta=("float", 0.75),
                                knorm=("float", 2.0), nsize=("int",),
                                axis=("int", 1)))
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, axis=1):
    """Local response normalisation across ``nsize`` neighbours along
    ``axis`` (the JAX package's extension: NHWC models pass -1)."""
    axis = axis % data.dim()
    half = nsize // 2
    sq = torch.movedim(data * data, axis, -1)
    ssum = F.pad(sq, (half, half)).unfold(-1, nsize, 1).sum(-1)
    ssum = torch.movedim(ssum, -1, axis)
    return data / torch.pow(knorm + alpha / nsize * ssum, beta)


@register("InstanceNorm",
          num_inputs=3, input_names=["data", "gamma", "beta"],
          param_shapes=lambda attrs, shapes: [shapes[0], (shapes[0][1],),
                                              (shapes[0][1],)],
          attrs=AttrSpec(eps=("float", 1e-3)))
def _instance_norm(data, gamma, beta, eps=1e-3):
    """Instance normalisation (``mxnet_tpu/ops/nn_ops.py:356``): each
    (sample, channel) over its spatial axes, by the biased variance, then
    gamma and beta of the channel (axis 1)."""
    axes = tuple(range(2, data.dim()))
    var, mean = torch.var_mean(data, dim=axes, correction=0, keepdim=True)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return ((data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape)
            + beta.reshape(bshape))


# ---------------------------------------------------------------------------
# Activation and Dropout (mxnet_tpu/ops/nn_ops.py:392-448)
# ---------------------------------------------------------------------------


@register("Activation", attrs=AttrSpec(act_type=("str",)))
def _activation(data, act_type):
    """relu, sigmoid, tanh, softrelu and softsign. relu's gradient at an
    input of exactly 0 is 0, as in the reference's ``relu_grad``
    (jnp.maximum's splits it, 0.5)."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return data / (1 + torch.abs(data))
    raise MXNetError(f"unknown act_type {act_type}")


@register("Dropout", needs_rng=True, needs_is_train=True,
          attrs=AttrSpec(p=("float", 0.5), mode=("str", "training")))
def _dropout(rng, data, p=0.5, mode="training", _is_train=False):
    """Zero each element with probability ``p`` and scale the rest by
    1/(1 - p), drawing from ``rng`` (the device's ``random.generator``),
    in training or with ``mode='always'``; the identity otherwise and for
    ``p <= 0``."""
    if (not _is_train and mode != "always") or p <= 0:
        return data
    keep = 1.0 - p
    if rng is None and data.device.type != "meta":
        rng = _random.generator(data.device)
    mask = torch.rand(data.shape, generator=rng, device=data.device) < keep
    return torch.where(mask, data / keep, 0)


def _lrelu_param_shapes(attrs, shapes):
    if len(shapes) == 1:
        return list(shapes)
    return [shapes[0], (shapes[0][1],)]


@register("LeakyReLU",
          num_inputs=None, input_names=["data", "gamma"],
          param_shapes=_lrelu_param_shapes,
          needs_rng=lambda attrs: attrs.get("act_type") == "rrelu",
          needs_is_train=True,
          attrs=AttrSpec(act_type=("str", "leaky"), slope=("float", 0.25),
                         lower_bound=("float", 0.125),
                         upper_bound=("float", 0.334)))
def _leaky_relu(rng, *args, act_type="leaky", slope=0.25, lower_bound=0.125,
                upper_bound=0.334, _is_train=False):
    """``mxnet_tpu/ops/nn_ops.py:413``: leaky (``slope`` below 0), elu
    (``slope * expm1``), prelu (the learned ``gamma`` of channel axis 1)
    and rrelu: in training a slope uniform in [lower_bound, upper_bound)
    drawn per element from ``rng`` (the device's ``random.generator``),
    in eval their mean."""
    data = args[0]
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "prelu":
        bshape = (1, -1) + (1,) * (data.dim() - 2)
        return torch.where(data > 0, data,
                           args[1].reshape(bshape).to(data.dtype) * data)
    if act_type == "rrelu":
        if _is_train:
            if rng is None and data.device.type != "meta":
                rng = _random.generator(data.device)
            s = torch.empty(data.shape, dtype=data.dtype,
                            device=data.device)
            if data.device.type != "meta":
                s.uniform_(lower_bound, upper_bound, generator=rng)
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise MXNetError(f"unknown LeakyReLU act_type {act_type}")


@register("softmax", attrs=AttrSpec(axis=("int", -1),
                                    temperature=("any", None)))
def _softmax(data, axis=-1, temperature=None):
    if temperature not in (None, "None"):
        data = data / float(temperature)
    return torch.softmax(data, dim=axis)


@register("log_softmax", attrs=AttrSpec(axis=("int", -1),
                                        temperature=("any", None)))
def _log_softmax(data, axis=-1, temperature=None):
    """``mxnet_tpu/ops/nn_ops.py:459``: log of the softmax along ``axis``,
    of ``data / temperature`` when one is given."""
    if temperature not in (None, "None"):
        data = data / float(temperature)
    return torch.log_softmax(data, dim=axis)


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


"""Optimizer update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference
src/operator/optimizer_op.cc): sgd_update, sgd_mom_update, mp_sgd_update,
mp_sgd_mom_update (fp32 master weights), adam_update, rmsprop_update and
rmspropalex_update. Each returns the new weight and states, and the
Optimizer writes them back behind the parameter's NDArray. Every formula
keeps the JAX package's operation order, so fp32 results agree bit for
bit; a Python float in a formula is a weak scalar, as in jnp.
"""
from __future__ import annotations

import torch

from ..base import AttrSpec
from .registry import register

_COMMON = dict(lr=("float",), wd=("float", 0.0), rescale_grad=("float", 1.0),
               clip_gradient=("float", -1.0))


def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register("sgd_update", num_inputs=2, input_names=["weight", "grad"], attrs=AttrSpec(**_COMMON))
def _sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update", num_inputs=3, input_names=["weight", "grad", "mom"], num_outputs=2,
          attrs=AttrSpec(momentum=("float", 0.0), **_COMMON))
def _sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


@register("mp_sgd_update", num_inputs=3,
          input_names=["weight", "grad", "weight32"], num_outputs=2, attrs=AttrSpec(**_COMMON))
def _mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _prep_grad(grad.to(torch.float32), rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * (g + wd * weight32)
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", num_inputs=4,
          input_names=["weight", "grad", "mom", "weight32"], num_outputs=3,
          attrs=AttrSpec(momentum=("float", 0.0), **_COMMON))
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad.to(torch.float32), rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("adam_update", num_inputs=4,
          input_names=["weight", "grad", "mean", "var"], num_outputs=3,
          attrs=AttrSpec(beta1=("float", 0.9), beta2=("float", 0.999),
                         epsilon=("float", 1e-8), **_COMMON))
def _adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


@register("rmsprop_update", num_inputs=3, input_names=["weight", "grad", "n"], num_outputs=2,
          attrs=AttrSpec(gamma1=("float", 0.95), epsilon=("float", 1e-8),
                         clip_weights=("float", -1.0), **_COMMON))
def _rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8,
                    clip_weights=-1.0, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_w = weight - lr * g * torch.rsqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n


@register("rmspropalex_update", num_inputs=5,
          input_names=["weight", "grad", "n", "g", "delta"], num_outputs=4,
          attrs=AttrSpec(gamma1=("float", 0.95), gamma2=("float", 0.9),
                         epsilon=("float", 1e-8), clip_weights=("float", -1.0),
                         **_COMMON))
def _rmspropalex_update(weight, grad, n, g_state, delta, lr, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, clip_weights=-1.0, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_g = gamma1 * g_state + (1 - gamma1) * g
    new_delta = gamma2 * delta - lr * g * torch.rsqrt(
        new_n - torch.square(new_g) + epsilon)
    new_w = weight + new_delta
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n, new_g, new_delta

"""Attention operators: multi-head attention and the flash-attention op.

Counterpart of ``mxnet_tpu/ops/attention_ops.py`` and of the
``_contrib_flash_attention`` registration in
``mxnet_tpu/ops/pallas/attention.py``. The JAX ``MultiHeadAttention`` is
plain jnp (``parallel/sequence.py:_full_attn``); the port's runs its core
through the flash-attention kernels in bf16 and fp16 where the masks
agree, else as the JAX op does, on one device:
the port has no mesh yet, so a nonempty ``seq_axis`` runs the local
attention, as the JAX op does when no ambient mesh carries that axis.
Sequence-parallel attention comes with the mesh.
"""
from __future__ import annotations

import torch

from ..base import AttrSpec, MXNetError
from .cuda.attention import MAX_HEAD_DIM, flash_attention
from .registry import register

_NEG = -1e30


def _split_heads(x, num_heads):
    b, s, e = x.shape
    if e % num_heads:
        raise MXNetError(
            f"MultiHeadAttention: embed dim {e} not divisible by "
            f"num_heads {num_heads}")
    return x.reshape(b, s, num_heads, e // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _full_attn(q, k, v, causal, scale):
    """``parallel/sequence.py:_full_attn``. Its causal mask is
    ``kpos <= qpos``, aligned to the top left with no (Sk - Sq) offset,
    unlike the flash kernels' diagonal."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        mask = (torch.arange(sk, device=s.device)[None, :]
                <= torch.arange(sq, device=s.device)[:, None])
        s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _flash_route(q, k, causal):
    """Whether the op's core runs :func:`flash_attention`: bf16 or fp16
    heads of a dim the kernels take (up to ``MAX_HEAD_DIM``), and a mask
    that is the kernels' (not causal, or Sq = Sk; over Sq != Sk this op's
    causal mask is top-left aligned and the kernels' diagonal is not).
    fp32 keeps :func:`_full_attn`'s cuBLAS products: it was never timed
    through the kernels, which run it on CUDA cores."""
    return (q.dtype in (torch.bfloat16, torch.float16)
            and q.shape[-1] <= MAX_HEAD_DIM
            and not (causal and q.shape[2] != k.shape[2]))


@register("MultiHeadAttention",
          attrs=AttrSpec(num_heads=("int",), causal=("bool", False),
                         seq_axis=("str", ""), seq_mode=("str", "auto"),
                         batch_axis=("str", "data"),
                         head_axis=("str", "model")),
          num_inputs=3, input_names=["query", "key", "value"],
          output_names=["output"])
def _multi_head_attention(query, key, value, num_heads, causal=False,
                          seq_axis="", seq_mode="auto", batch_axis="data",
                          head_axis="model"):
    """Scaled-dot-product multi-head attention over (B, S, E) inputs.
    ``seq_axis``, ``seq_mode``, ``batch_axis`` and ``head_axis`` name mesh
    axes; with no mesh the attention is local, with identical numerics.
    The heads are (B, H, S, D) views of the projections; the core is
    :func:`flash_attention` where :func:`_flash_route` says so (the
    Hopper kernels B2, forward and backward, on CUDA tensors; their plain
    versions on the CPU), else :func:`_full_attn`."""
    q = _split_heads(query, num_heads)
    k = _split_heads(key, num_heads)
    v = _split_heads(value, num_heads)
    if _flash_route(q, k, causal):
        out = flash_attention(q, k, v, causal)
    else:
        out = _full_attn(q, k, v, causal, None)
    return _merge_heads(out).to(query.dtype)


@register("_contrib_flash_attention", aliases=["flash_attention_op"],
          num_inputs=3, input_names=["query", "key", "value"],
          attrs=AttrSpec(causal=("bool", False), scale=("any", None)))
def _flash_attention_op(q, k, v, causal=False, scale=None):
    """Memory-efficient exact attention over (B, H, S, D) inputs."""
    return flash_attention(q, k, v, causal,
                           None if scale is None else float(scale))

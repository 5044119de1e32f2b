"""Decoder-only transformer LM: the port of ``mxnet_tpu/models/transformer.py``.

A functional model over a dict of tensors, as in the JAX package: RoPE
positions, pre-norm blocks, SwiGLU MLP, an untied head. Attention runs
:func:`~mxnet_tpu_torch.ops.cuda.attention.flash_attention` with
``causal=True``, which on the card launches the Hopper kernel
(``csrc/flash_attention.cu``) once per layer. The products are
``torch.matmul`` (cuBLAS), as the JAX package left them to XLA, with the
bf16 casts where the JAX code puts them. The loss, the gradient and
``train_step`` come with the training slice; sequence parallelism
(``mesh``/``seq_axis``) comes with the mesh.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray.ndarray import torch_dtype
from ..ops.cuda.attention import flash_attention

__all__ = ["TransformerConfig", "init_params", "forward", "TransformerLM"]


class TransformerConfig:
    def __init__(self, vocab_size=32000, num_layers=4, num_heads=8,
                 d_model=512, d_ff=None, max_seq_len=2048,
                 dtype="bfloat16", rope_theta=10000.0):
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.d_model = d_model
        self.d_ff = d_ff or 4 * d_model
        self.head_dim = d_model // num_heads
        self.max_seq_len = max_seq_len
        self.dtype = (torch.bfloat16 if str(dtype) in ("bfloat16",
                                                       "torch.bfloat16")
                      else torch_dtype(dtype))
        self.rope_theta = rope_theta
        if d_model % num_heads:
            raise MXNetError(f"d_model {d_model} % num_heads {num_heads}")


def init_params(rng_or_seed, cfg: TransformerConfig,
                ctx: Optional[Context] = None):
    """Parameter dict on ``ctx`` (default: the current context); layers
    stacked on a leading dim, weights laid out (in, out). The draws, their
    order and their fp32 values are the JAX package's, so the same seed
    gives bit-identical arrays."""
    rng = (np.random.RandomState(rng_or_seed)
           if isinstance(rng_or_seed, int) else rng_or_seed)
    device = (ctx or current_context()).torch_device()
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers

    def w(*shape, scale=None):
        scale = scale if scale is not None else (2.0 / (shape[-2] + shape[-1])) ** 0.5
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).to(device)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return {
        "embed": w(cfg.vocab_size, d, scale=0.02),
        "blocks": {
            "ln1": ones(L, d),
            "ln2": ones(L, d),
            "wq": w(L, d, d),
            "wk": w(L, d, d),
            "wv": w(L, d, d),
            "wo": w(L, d, d),
            "w_gate": w(L, d, f),
            "w_up": w(L, d, f),
            "w_down": w(L, f, d),
        },
        "ln_f": ones(d),
        # LLaMA-style untied head
        "head": w(d, cfg.vocab_size, scale=0.02),
    }


def _rmsnorm(x, g):
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-6)
    return (x32 * inv * g).to(x.dtype)


def _rope(x, theta, offset=0):
    """Rotary embedding over (B, H, S, D_head); angles in fp32, the result
    in x's dtype."""
    b, h, s, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = torch.arange(s, dtype=torch.float32, device=x.device) + offset
    ang = pos[:, None] * freqs[None, :]  # (S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def token_rows(tokens, vocab_size):
    """The embedding rows JAX's gather reads for ``tokens``: a negative id
    wraps once (id + V), then every id is clamped to [0, V-1]. Done before
    the gather, so that no id is out of range on the card, where an
    out-of-range index is a device assert that ends the CUDA context."""
    tokens = tokens.long()
    tokens = torch.where(tokens < 0, tokens + vocab_size, tokens)
    return tokens.clamp(0, vocab_size - 1)


def forward(params, tokens, cfg: TransformerConfig, mesh=None,
            seq_axis: Optional[str] = None, seq_mode: str = "auto"):
    """tokens (B, S) int on the params' device -> fp32 logits
    (B, S, vocab)."""
    if mesh is not None or seq_axis is not None:
        raise MXNetError("transformer forward: sequence-parallel attention "
                         "(mesh/seq_axis) is not ported yet")
    b, s = tokens.shape
    nh, hd, dt = cfg.num_heads, cfg.head_dim, cfg.dtype
    blocks = params["blocks"]
    x = F.embedding(token_rows(tokens, cfg.vocab_size),
                    params["embed"]).to(dt)  # (B, S, D)

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2)

    for i in range(cfg.num_layers):
        h = _rmsnorm(x, blocks["ln1"][i])
        q = heads(h @ blocks["wq"][i].to(dt))
        k = heads(h @ blocks["wk"][i].to(dt))
        v = heads(h @ blocks["wv"][i].to(dt))
        q = _rope(q, cfg.rope_theta)
        k = _rope(k, cfg.rope_theta)
        att = flash_attention(q, k, v, causal=True)
        att = att.transpose(1, 2).reshape(b, s, cfg.d_model)
        x = x + (att @ blocks["wo"][i].to(dt))
        h2 = _rmsnorm(x, blocks["ln2"][i])
        gate = F.silu(h2 @ blocks["w_gate"][i].to(dt))
        up = h2 @ blocks["w_up"][i].to(dt)
        x = x + ((gate * up) @ blocks["w_down"][i].to(dt))
    x = _rmsnorm(x, params["ln_f"])
    return x.float() @ params["head"]


class TransformerLM(torch.nn.Module):
    """The functional model with its parameters on one device (``ctx``,
    default ``gpu(0)``; ``ctx=cpu()`` runs the plain attention).
    ``seq_mode`` is taken for the JAX package's signature; it has effect
    only with ``mesh``/``seq_axis``, which are not ported yet."""

    def __init__(self, cfg: TransformerConfig, mesh=None, seq_axis=None,
                 seq_mode="auto", seed=0, ctx: Optional[Context] = None):
        super().__init__()
        if mesh is not None or seq_axis is not None:
            raise MXNetError("TransformerLM: sequence-parallel attention "
                             "(mesh/seq_axis) is not ported yet")
        self.cfg = cfg
        self.ctx = ctx or current_context()
        self.device = self.ctx.torch_device()
        self.params = init_params(seed, cfg, self.ctx)

    def forward(self, tokens):
        return forward(self.params, tokens, self.cfg)

    def logits(self, tokens):
        """tokens (B, S) ints, host or device -> fp32 logits (B, S, vocab)
        on the model's device."""
        tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens).to(self.device)
        with torch.inference_mode():
            return forward(self.params, tokens, self.cfg)

"""Flash attention: the port's counterpart of ``mxnet_tpu/ops/pallas/attention.py``.

``flash_attention(q, k, v, causal, scale, ..., lengths, segment_ids)`` is
exact softmax attention over (B, H, S, D) inputs with the JAX package's
dispatch: with neither ``lengths`` nor ``segment_ids`` it is the dense core
(B2, ``_flash_attention_dense``), else the masked core (B3,
``_masked_attention``). On CUDA tensors both launch the hand-written Hopper
kernel in ``csrc/flash_attention.cu`` (counted in
``flash_attention.launches`` and ``flash_attention.masked_launches``) or
raise. The library picks the variant by dtype, head dim, masks and
alignment: the dense core in bf16 at D = 64 or 128 over views TMA can
describe takes the wgmma/TMA variant (also counted in
``flash_attention.wgmma_launches``), the masked core the mma.sync one,
fp32 and unaligned views the CUDA-core one. On CPU and ``meta`` tensors
they run :func:`attention_plain` and
:func:`masked_attention_plain`, the torch transcriptions of
``_attn_reference`` and ``_masked_reference``. The backward
(``_blockwise_bwd`` there) comes with the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...base import MXNetError

__all__ = ["flash_attention", "attention_plain", "masked_attention_plain"]

_NEG = -1e30

# the kernel holds a head's D values of a row in registers, up to 128
MAX_HEAD_DIM = 128

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _default_scale(d, scale):
    return 1.0 / (d ** 0.5) if scale is None else float(scale)


def attention_plain(q, k, v, causal=False, scale=None):
    """``_attn_reference``: the (Sq, Sk) scores in fp32, the causal diagonal
    at ``kpos <= qpos + (Sk - Sq)``, output in q's dtype."""
    scale = _default_scale(q.shape[-1], scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        s = torch.where(_causal_mask(sq, sk, s.device), s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _causal_mask(sq, sk, device):
    return (torch.arange(sk, device=device)[None, :]
            <= torch.arange(sq, device=device)[:, None] + (sk - sq))


def _combined_mask(sq, sk, causal, lengths, segment_ids, device):
    """(B, 1, Sq, Sk) bool mask, True = attend: the causal diagonal,
    per-batch KEY lengths (kpos < length) and packed-row segment ids (the
    same NONZERO segment attends; 0 marks pad tokens, which attend to and
    from nothing). None when nothing masks."""
    mask = None
    if causal:
        mask = _causal_mask(sq, sk, device)[None, None]
    if lengths is not None:
        lens = lengths.to(device=device, dtype=torch.int32)
        lmask = (torch.arange(sk, device=device)[None, :]
                 < lens[:, None])[:, None, None, :]
        mask = lmask if mask is None else mask & lmask
    if segment_ids is not None:
        seg = segment_ids.to(device=device, dtype=torch.int32)
        smask = ((seg[:, None, :, None] == seg[:, None, None, :])
                 & (seg[:, None, :, None] > 0))
        mask = smask if mask is None else mask & smask
    return mask


def masked_attention_plain(q, k, v, lengths=None, segment_ids=None,
                           causal=False, scale=None):
    """``_masked_reference``: fully masked query rows (pad tokens, rows
    whose keys are all past their length) come out exact 0."""
    scale = _default_scale(q.shape[-1], scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _combined_mask(s.shape[-2], s.shape[-1], causal, lengths,
                          segment_ids, s.device)
    if mask is None:  # nothing masks: the dense reference
        p = torch.softmax(s, dim=-1)
    else:
        p = torch.softmax(torch.where(mask, s, _NEG), dim=-1)
        p = torch.where(mask, p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _check(q, k, v, causal, lengths, segment_ids):
    """The JAX package's ValueErrors, and the shapes every path needs."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError(f"flash_attention takes (B, H, S, D) inputs, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != tuple(k.shape)):
        raise MXNetError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, H, Sk, D) with q's "
                         f"B, H and D {(b, h, d)}")
    if causal and sq > sk:
        # rows past the KV length would have an empty causal window
        raise ValueError(
            f"flash_attention(causal=True) requires seq_q <= seq_k, got "
            f"{sq} > {sk}")
    if segment_ids is not None and sq != sk:
        raise ValueError(
            f"segment_ids masking is self-attention only (seq_q == "
            f"seq_k); got {sq} != {sk}")
    if lengths is not None and tuple(lengths.shape) != (b,):
        raise MXNetError(f"flash_attention: lengths {tuple(lengths.shape)} "
                         f"must be (B,) = {(b,)}")
    if segment_ids is not None and tuple(segment_ids.shape) != (b, sk):
        raise MXNetError(f"flash_attention: segment_ids "
                         f"{tuple(segment_ids.shape)} must be (B, S) = "
                         f"{(b, sk)}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise MXNetError(f"flash_attention: inputs on several devices "
                         f"{devices}")


# the variant number the library reports for the wgmma/TMA kernel (0 is
# the CUDA-core one, 1 mma.sync)
_WGMMA = 2


def _launch(q, k, v, causal, scale, lengths, segment_ids, route=0):
    """``route`` 0 lets the library pick the variant; 1 takes the mma.sync
    variant (see :func:`_dense_mma_sync`)."""
    tensors = (q, k, v)
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or q.dtype not in _KERNEL_DTYPES:
        raise MXNetError(f"flash_attention kernel takes one dtype of "
                         f"{sorted(map(str, _KERNEL_DTYPES))} for q, k and "
                         f"v, got {sorted(map(str, dtypes))}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise MXNetError("flash_attention on CUDA has no backward yet: its "
                         "gradient comes with the training slice")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention kernel takes a head dim up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if any(t.stride(3) != 1 for t in tensors):
        raise MXNetError("flash_attention kernel takes inputs whose last "
                         "(head) dim is contiguous")
    # the output keeps q's layout, so a (B, S, H, D) view stays one
    out = torch.empty_like(q)
    if min(b, h, sq, sk, d) == 0:  # no keys: zeros, as the plain version
        return out.zero_()
    masked = lengths is not None or segment_ids is not None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=q.device).contiguous()
    if segment_ids is not None:
        segment_ids = torch.as_tensor(segment_ids, dtype=torch.int32,
                                      device=q.device).contiguous()
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _lib()
    variant = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr() if lengths is not None else None,
            segment_ids.data_ptr() if segment_ids is not None else None,
            strides, b, h, sq, sk, d, ctypes.c_float(scale), int(causal),
            _KERNEL_DTYPES[q.dtype], route, ctypes.byref(variant), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise MXNetError(f"flash_attention kernel launch failed: {msg} "
                         f"({err})")
    if masked:
        flash_attention.masked_launches += 1
    else:
        flash_attention.launches += 1
    if variant.value == _WGMMA:
        flash_attention.wgmma_launches += 1
    return out


def _dense_mma_sync(q, k, v, causal=False, scale=None):
    """The dense core through the mma.sync variant, which the dense bf16
    path no longer takes where TMA applies: for timing the two side by
    side, never on a model's path. Raises where that variant does not
    apply (not bf16, D not 64 or 128, unaligned rows)."""
    _check(q, k, v, causal, None, None)
    if q.device.type != "cuda":
        raise MXNetError("_dense_mma_sync takes CUDA tensors")
    return _launch(q, k, v, causal, _default_scale(q.shape[-1], scale),
                   None, None, route=1)


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_forward.argtypes is None:
        lib.flash_attention_forward.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_void_p])
        lib.flash_attention_forward.restype = ctypes.c_int
        lib.flash_attention_wgmma_smem_bytes.argtypes = [ctypes.c_int]
        lib.flash_attention_wgmma_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def wgmma_shared_bytes(d):
    """Dynamic shared memory of a wgmma/TMA variant block at head dim ``d``
    (64 or 128): the Q tile, 3 K/V stages, the mbarriers and the slack
    that aligns the tiles to 1024 bytes."""
    return int(_lib().flash_attention_wgmma_smem_bytes(d))


def flash_attention(q, k, v, causal=False, scale=None, block_q=256,
                    block_k=512, lengths=None, segment_ids=None):
    """Attention over (B, H, S, D) inputs; exact and memory-efficient.

    ``lengths`` (B,) int: per-batch real KEY length; positions at or past
    it are masked out. ``segment_ids`` (B, S) int: packed-row bookkeeping;
    tokens attend only within their own nonzero segment, 0 marks pad
    tokens (masked entirely; their output rows are exact 0). ``block_q``
    and ``block_k`` are tile hints kept for the JAX package's signature:
    they do not change the result, and the Hopper kernel picks its own
    tiles. CUDA tensors launch the kernel or raise; CPU and meta tensors
    run the plain versions."""
    del block_q, block_k
    if lengths is not None and not isinstance(lengths, torch.Tensor):
        lengths = torch.as_tensor(lengths)
    if segment_ids is not None and not isinstance(segment_ids, torch.Tensor):
        segment_ids = torch.as_tensor(segment_ids)
    _check(q, k, v, causal, lengths, segment_ids)
    scale = _default_scale(q.shape[-1], scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale, lengths, segment_ids)
    if q.device.type in ("cpu", "meta"):
        if lengths is None and segment_ids is None:
            return attention_plain(q, k, v, causal, scale)
        return masked_attention_plain(q, k, v, lengths, segment_ids, causal,
                                      scale)
    raise MXNetError(f"flash_attention: no kernel for device {q.device}")


flash_attention.launches = 0         # dense core (B2) launches
flash_attention.masked_launches = 0  # masked core (B3) launches
flash_attention.wgmma_launches = 0   # of those, the wgmma/TMA variant's

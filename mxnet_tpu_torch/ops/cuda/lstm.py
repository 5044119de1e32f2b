"""Fused LSTM cell: the port's counterpart of ``mxnet_tpu/ops/pallas/lstm.py``.

``lstm_cell_fused(xproj, h, c, w_h2h) -> (h', c')`` computes one LSTM step
(gate order i, f, g, o, fp32 accumulation, outputs in the types of h and
c). On CUDA tensors it launches the hand-written Hopper kernel in
``csrc/lstm_cell.cu`` or raises; on CPU and ``meta`` tensors it runs
:func:`lstm_cell_plain`, the torch transcription of the JAX package's
``_cell_jnp``. The backward (``_cell_bwd`` there) comes with the training
slice.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...base import MXNetError

__all__ = ["lstm_cell_fused", "lstm_cell_plain"]

# the most dynamic shared memory one block may use on Hopper (227 KB); the
# kernel stages 4 rows of H fp32 weights there
MAX_SHARED_BYTES = 232448

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lstm_cell_plain(xproj, h, c, w_h2h):
    """One LSTM step in plain torch: the reference the kernel is held to."""
    H = h.shape[-1]
    g = xproj.float() + torch.matmul(h.float(), w_h2h.float().t())
    i = torch.sigmoid(g[:, 0 * H:1 * H])
    f = torch.sigmoid(g[:, 1 * H:2 * H])
    gg = torch.tanh(g[:, 2 * H:3 * H])
    o = torch.sigmoid(g[:, 3 * H:4 * H])
    c_new = f * c.float() + i * gg
    h_new = o * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def _check_shapes(xproj, h, c, w_h2h):
    if h.dim() != 2 or c.shape != h.shape:
        raise MXNetError(f"lstm_cell: h {tuple(h.shape)} and c "
                         f"{tuple(c.shape)} must both be (N, H)")
    n, hdim = h.shape
    if tuple(xproj.shape) != (n, 4 * hdim) or tuple(w_h2h.shape) != (4 * hdim, hdim):
        raise MXNetError(
            f"lstm_cell: xproj {tuple(xproj.shape)} must be {(n, 4 * hdim)} "
            f"and w_h2h {tuple(w_h2h.shape)} must be {(4 * hdim, hdim)}")
    devices = {t.device for t in (xproj, h, c, w_h2h)}
    if len(devices) != 1:
        raise MXNetError(f"lstm_cell: inputs on several devices {devices}")


def _launch(xproj, h, c, w_h2h):
    tensors = (xproj, h, c, w_h2h)
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or h.dtype not in _KERNEL_DTYPES:
        raise MXNetError(f"lstm_cell kernel takes one dtype of "
                         f"{sorted(map(str, _KERNEL_DTYPES))} for all four "
                         f"inputs, got {sorted(map(str, dtypes))}")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError("lstm_cell kernel takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise MXNetError("lstm_cell on CUDA has no backward yet: its "
                         "gradient comes with the training slice")
    n, hdim = h.shape
    if 4 * hdim * 4 > MAX_SHARED_BYTES:
        raise MXNetError(f"lstm_cell kernel stages 4*H fp32 weights in shared "
                         f"memory: H={hdim} needs {16 * hdim} bytes, above the "
                         f"{MAX_SHARED_BYTES} a Hopper block may use")
    lib = _lib()
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.lstm_cell_forward(
            xproj.data_ptr(), h.data_ptr(), c.data_ptr(), w_h2h.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), n, hdim,
            _KERNEL_DTYPES[h.dtype], stream)
    if err != 0:
        msg = lib.lstm_cell_error_string(err).decode()
        raise MXNetError(f"lstm_cell kernel launch failed: {msg} ({err})")
    lstm_cell_fused.launches += 1
    return h_out, c_out


def _lib():
    lib = _build.load("lstm_cell")
    if lib.lstm_cell_forward.argtypes is None:
        lib.lstm_cell_forward.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.lstm_cell_forward.restype = ctypes.c_int
        lib.lstm_cell_error_string.argtypes = [ctypes.c_int]
        lib.lstm_cell_error_string.restype = ctypes.c_char_p
    return lib


def lstm_cell_fused(xproj, h, c, w_h2h):
    """One LSTM step: (xproj (N,4H), h (N,H), c (N,H), w_h2h (4H,H)) ->
    (h', c'). CUDA tensors launch the Hopper kernel (and count the launch
    in ``lstm_cell_fused.launches``) or raise; CPU and meta tensors run
    :func:`lstm_cell_plain`."""
    _check_shapes(xproj, h, c, w_h2h)
    if h.device.type == "cuda":
        return _launch(xproj, h, c, w_h2h)
    if h.device.type in ("cpu", "meta"):
        return lstm_cell_plain(xproj, h, c, w_h2h)
    raise MXNetError(f"lstm_cell: no kernel for device {h.device}")


lstm_cell_fused.launches = 0

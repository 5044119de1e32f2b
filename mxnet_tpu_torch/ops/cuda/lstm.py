"""Fused LSTM: the port's counterpart of ``mxnet_tpu/ops/pallas/lstm.py``.

``lstm_cell_fused(xproj, h, c, w_h2h) -> (h', c')`` computes one LSTM step
(gate order i, f, g, o, fp32 accumulation, outputs in the types of h and
c). ``lstm_sequence_fused(xproj, h0, c0, w_h2h, reverse) -> (out, hT, cT)``
computes the whole time loop of one layer and direction, as the JAX
package's ``lax.scan`` over that step does, with the states rounded to
their dtypes after every step. On CUDA tensors each launches a hand-written
Hopper kernel in ``csrc/lstm_cell.cu`` or raises; on CPU and ``meta``
tensors each runs its plain version (:func:`lstm_cell_plain`, the torch
transcription of the JAX package's ``_cell_jnp``, and
:func:`lstm_sequence_plain`, its loop). The backward (``_cell_bwd`` there)
comes with the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...base import MXNetError

__all__ = ["lstm_cell_fused", "lstm_cell_plain", "lstm_sequence_fused",
           "lstm_sequence_plain", "sequence_fits"]

# the most dynamic shared memory one block may use on Hopper (227 KB); both
# kernels stage their gate rows of w_h2h there as fp32
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


def lstm_sequence_plain(xproj, h0, c0, w_h2h, reverse=False,
                        cell=lstm_cell_plain):
    """The time loop of one layer, one ``cell`` step at a time:
    (out (T,N,H), hT, cT). With :func:`lstm_cell_plain`, the plain torch
    reference the sequence kernel is held to."""
    steps = xproj.shape[0]
    out = torch.empty((steps,) + tuple(h0.shape), dtype=h0.dtype,
                      device=h0.device)
    h, c = h0, c0
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        h, c = cell(xproj[t], h, c, w_h2h)
        out[t] = h
    return out, h, c


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


def _check_kernel_inputs(name, tensors):
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or tensors[0].dtype not in _KERNEL_DTYPES:
        raise MXNetError(f"{name} kernel takes one dtype of "
                         f"{sorted(map(str, _KERNEL_DTYPES))} for all four "
                         f"inputs, got {sorted(map(str, dtypes))}")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError(f"{name} kernel takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise MXNetError(f"{name} on CUDA has no backward yet: its "
                         "gradient comes with the training slice")


def _launch(xproj, h, c, w_h2h):
    _check_kernel_inputs("lstm_cell", (xproj, h, c, w_h2h))
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
    _raise_on(lib, err, "lstm_cell")
    lstm_cell_fused.launches += 1
    return h_out, c_out


def _lib():
    lib = _build.load("lstm_cell")
    if lib.lstm_cell_forward.argtypes is None:
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.lstm_cell_forward.argtypes = [c_ptr] * 6 + [c_int] * 3 + [c_ptr]
        lib.lstm_cell_forward.restype = c_int
        lib.lstm_sequence_forward.argtypes = [c_ptr] * 8 + [c_int] * 6 + [
            c_ptr]
        lib.lstm_sequence_forward.restype = c_int
        lib.lstm_sequence_shared_bytes.argtypes = [c_int] * 3
        lib.lstm_sequence_shared_bytes.restype = c_int
        lib.lstm_sequence_barriers.argtypes = [c_ptr] + [c_int] * 4 + [c_ptr]
        lib.lstm_sequence_barriers.restype = c_int
        lib.lstm_cell_error_string.argtypes = [c_int]
        lib.lstm_cell_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, name):
    if err != 0:
        msg = lib.lstm_cell_error_string(err).decode()
        raise MXNetError(f"{name} kernel launch failed: {msg} ({err})")


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


def _check_sequence_shapes(xproj, h0, c0, w_h2h):
    if h0.dim() != 2 or c0.shape != h0.shape:
        raise MXNetError(f"lstm_sequence: h0 {tuple(h0.shape)} and c0 "
                         f"{tuple(c0.shape)} must both be (N, H)")
    n, hdim = h0.shape
    if (xproj.dim() != 3 or tuple(xproj.shape[1:]) != (n, 4 * hdim)
            or tuple(w_h2h.shape) != (4 * hdim, hdim)):
        raise MXNetError(
            f"lstm_sequence: xproj {tuple(xproj.shape)} must be "
            f"(T, {n}, {4 * hdim}) and w_h2h {tuple(w_h2h.shape)} must be "
            f"{(4 * hdim, hdim)}")
    devices = {t.device for t in (xproj, h0, c0, w_h2h)}
    if len(devices) != 1:
        raise MXNetError(f"lstm_sequence: inputs on several devices {devices}")


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def sequence_fits(n, hdim, device):
    """Whether the sequence kernel takes N rows of H units on the card of
    ``device``: whether one layer's weights fit in the shared memory of the
    blocks it may keep resident. The kernel library plans the launch
    (``lstm_sequence_shared_bytes`` in ``csrc/lstm_cell.cu``).

    Each of at most one block per SM owns ``units = ceil(H / SMs)`` hidden
    units and keeps their 4 gate rows of w_h2h in shared memory as fp32 for
    all T steps, beside a chunk of h_{t-1}, the K groups' partial sums and
    the gate pre-activations. The chunk is the least power of two
    >= min(N, 16), halved while the block's bytes exceed the 232,448 a
    Hopper block may use; N is walked in chunks. The layer does not fit
    when even a 1-row chunk does not, or when ``4 * units`` exceeds the
    block's 512 threads: on 132 SMs, fp32 and bf16 alike (bf16 weights are
    staged as fp32), H up to 1320 fits and H from 1321 does not."""
    return _lib().lstm_sequence_shared_bytes(n, hdim, _sm_count(device)) >= 0


def _sequence_launch(xproj, h0, c0, w_h2h, reverse):
    _check_kernel_inputs("lstm_sequence", (xproj, h0, c0, w_h2h))
    steps = xproj.shape[0]
    n, hdim = h0.shape
    if not sequence_fits(n, hdim, h0.device):
        return lstm_sequence_plain(xproj, h0, c0, w_h2h, reverse,
                                   cell=lstm_cell_fused)
    lib = _lib()
    out = torch.empty((steps, n, hdim), dtype=h0.dtype, device=h0.device)
    h_last, c_last = torch.empty_like(h0), torch.empty_like(c0)
    # the grid barrier's arrival counter
    scratch = torch.zeros(1, dtype=torch.int32, device=h0.device)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream(h0.device).cuda_stream
        err = lib.lstm_sequence_forward(
            xproj.data_ptr(), h0.data_ptr(), c0.data_ptr(), w_h2h.data_ptr(),
            out.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
            scratch.data_ptr(), steps, n, hdim, _KERNEL_DTYPES[h0.dtype],
            int(reverse), _sm_count(h0.device), stream)
    _raise_on(lib, err, "lstm_sequence")
    lstm_sequence_fused.launches += 1
    return out, h_last, c_last


def lstm_sequence_fused(xproj, h0, c0, w_h2h, reverse=False):
    """One layer and direction of the LSTM over all T steps:
    (xproj (T,N,4H), h0 (N,H), c0 (N,H), w_h2h (4H,H)) -> (out (T,N,H),
    hT, cT), t running from T-1 down to 0 when ``reverse``.

    CUDA tensors launch one of two Hopper kernels or raise. Where
    :func:`sequence_fits` (the layer's weights fit in the resident blocks'
    shared memory: H <= 1320 on 132 SMs), the persistent sequence kernel
    runs all T steps in one cooperative launch, counted in
    ``lstm_sequence_fused.launches``; a refused launch raises MXNetError
    with CUDA's error. Where they do not, the per-step kernel runs T
    times, counted in ``lstm_cell_fused.launches``. CPU and meta tensors
    run :func:`lstm_sequence_plain`."""
    _check_sequence_shapes(xproj, h0, c0, w_h2h)
    if h0.device.type == "cuda":
        return _sequence_launch(xproj, h0, c0, w_h2h, reverse)
    if h0.device.type in ("cpu", "meta"):
        return lstm_sequence_plain(xproj, h0, c0, w_h2h, reverse)
    raise MXNetError(f"lstm_sequence: no kernel for device {h0.device}")


lstm_sequence_fused.launches = 0


def sequence_barriers(steps, n, hdim, device):
    """Launch ``steps`` grid barriers, with no step body, on the grid the
    sequence kernel takes for N rows of H units: the latency floor of its
    time loop, for timing. Counted nowhere."""
    if not sequence_fits(n, hdim, device):
        raise MXNetError(f"lstm_sequence: N={n} H={hdim} does not fit")
    lib = _lib()
    scratch = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lstm_sequence_barriers(scratch.data_ptr(), steps, n, hdim,
                                         _sm_count(device), stream)
    _raise_on(lib, err, "lstm_sequence barrier")

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
:func:`lstm_sequence_plain`, its loop).

Training goes through one ``torch.autograd.Function`` over a layer and
direction, ``(xproj, h0, c0, w_h2h) -> (out, hT, cT)``: whenever a tensor
needs a gradient, both entry points apply it. Its forward keeps the
activated gates (fp32) and every step's c (:func:`lstm_sequence_train`,
plain version :func:`lstm_sequence_train_plain`); its backward computes
what ``jax.vjp`` of the scan over the JAX package's ``_cell`` computes,
with ``_cell_bwd`` at each step (:func:`lstm_sequence_backward`, plain
version :func:`lstm_sequence_backward_plain`). On CUDA tensors the
backward launches one persistent kernel a layer and direction, or one
per-step kernel a step where the layer's weights do not fit.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...base import MXNetError

__all__ = ["lstm_cell_fused", "lstm_cell_plain", "lstm_sequence_fused",
           "lstm_sequence_plain", "sequence_fits", "backward_fits",
           "lstm_sequence_train", "lstm_sequence_train_plain",
           "lstm_sequence_backward", "lstm_sequence_backward_plain",
           "lstm_cell_backward", "lstm_cell_backward_plain"]

# the most dynamic shared memory one block may use on Hopper (227 KB); both
# kernels stage their gate rows of w_h2h there as fp32
MAX_SHARED_BYTES = 232448

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _cell_train_plain(xproj, h, c, w_h2h):
    """One LSTM step in plain torch: (h', c', gates), gates the activated
    i, f, g, o (N, 4H) in fp32."""
    H = h.shape[-1]
    g = xproj.float() + torch.matmul(h.float(), w_h2h.float().t())
    i = torch.sigmoid(g[:, 0 * H:1 * H])
    f = torch.sigmoid(g[:, 1 * H:2 * H])
    gg = torch.tanh(g[:, 2 * H:3 * H])
    o = torch.sigmoid(g[:, 3 * H:4 * H])
    c_new = f * c.float() + i * gg
    h_new = o * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype), torch.cat([i, f, gg, o], -1)


def lstm_cell_plain(xproj, h, c, w_h2h):
    """One LSTM step in plain torch: the reference the kernel is held to."""
    h_new, c_new, _ = _cell_train_plain(xproj, h, c, w_h2h)
    return h_new, c_new


def lstm_sequence_plain(xproj, h0, c0, w_h2h, reverse=False,
                        cell=lstm_cell_plain, train=False):
    """The time loop of one layer, one ``cell`` step at a time:
    (out (T,N,H), hT, cT). With :func:`lstm_cell_plain`, the plain torch
    reference the sequence kernel is held to. With ``train`` the cell
    also returns the step's activated gates, and the loop also returns
    what the backward reads: gates (T,N,4H) fp32 and cs (T,N,H), every
    step's c in c's dtype."""
    steps, n, hdim = xproj.shape[0], h0.shape[0], h0.shape[1]
    out = torch.empty((steps, n, hdim), dtype=h0.dtype, device=h0.device)
    if train:
        cs = torch.empty((steps, n, hdim), dtype=c0.dtype, device=c0.device)
        gates = torch.empty((steps, n, 4 * hdim), dtype=torch.float32,
                            device=h0.device)
    h, c = h0, c0
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        if train:
            h, c, gates[t] = cell(xproj[t], h, c, w_h2h)
            cs[t] = c
        else:
            h, c = cell(xproj[t], h, c, w_h2h)
        out[t] = h
    return (out, h, c, gates, cs) if train else (out, h, c)


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


def _check_kernel_inputs(name, tensors, gates=()):
    """The kernels take one dtype of _KERNEL_DTYPES for every state and
    weight tensor, fp32 for the gate tensors, and contiguous tensors."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or tensors[0].dtype not in _KERNEL_DTYPES:
        raise MXNetError(f"{name} kernel takes one dtype of "
                         f"{sorted(map(str, _KERNEL_DTYPES))} for all "
                         f"{len(tensors)} inputs, got "
                         f"{sorted(map(str, dtypes))}")
    if any(g.dtype != torch.float32 for g in gates):
        raise MXNetError(f"{name} kernel keeps the gates in float32")
    if not all(t.is_contiguous() for t in tuple(tensors) + tuple(gates)):
        raise MXNetError(f"{name} kernel takes contiguous tensors")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch(xproj, h, c, w_h2h, gates=None):
    """One launch of the per-step kernel; ``gates`` (N, 4H) fp32, when
    given, receives the activated gates."""
    _check_kernel_inputs("lstm_cell", (xproj, h, c, w_h2h),
                         () if gates is None else (gates,))
    n, hdim = h.shape
    if 4 * hdim * 4 > MAX_SHARED_BYTES:
        raise MXNetError(f"lstm_cell kernel stages 4*H fp32 weights in shared "
                         f"memory: H={hdim} needs {16 * hdim} bytes, above the "
                         f"{MAX_SHARED_BYTES} a Hopper block may use")
    lib = _lib()
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    with torch.cuda.device(h.device):
        err = lib.lstm_cell_forward(
            xproj.data_ptr(), h.data_ptr(), c.data_ptr(), w_h2h.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), _ptr(gates), n, hdim,
            _KERNEL_DTYPES[h.dtype], _stream(h.device))
    _raise_on(lib, err, "lstm_cell")
    lstm_cell_fused.launches += 1
    return h_out, c_out


def _lib():
    lib = _build.load("lstm_cell")
    if lib.lstm_cell_forward.argtypes is None:
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.lstm_cell_forward.argtypes = [c_ptr] * 7 + [c_int] * 3 + [c_ptr]
        lib.lstm_cell_forward.restype = c_int
        lib.lstm_sequence_forward.argtypes = [c_ptr] * 10 + [c_int] * 6 + [
            c_ptr]
        lib.lstm_sequence_forward.restype = c_int
        lib.lstm_sequence_shared_bytes.argtypes = [c_int] * 3
        lib.lstm_sequence_shared_bytes.restype = c_int
        lib.lstm_cell_backward.argtypes = [c_ptr] * 10 + [c_int] * 3 + [c_ptr]
        lib.lstm_cell_backward.restype = c_int
        lib.lstm_sequence_backward.argtypes = [c_ptr] * 11 + [c_int] * 6 + [
            c_ptr]
        lib.lstm_sequence_backward.restype = c_int
        lib.lstm_sequence_backward_shared_bytes.argtypes = [c_int] * 3
        lib.lstm_sequence_backward_shared_bytes.restype = c_int
        lib.lstm_sequence_barriers.argtypes = [c_ptr] + [c_int] * 4 + [c_ptr]
        lib.lstm_sequence_barriers.restype = c_int
        lib.lstm_cell_error_string.argtypes = [c_int]
        lib.lstm_cell_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, name):
    if err != 0:
        msg = lib.lstm_cell_error_string(err).decode()
        raise MXNetError(f"{name} kernel launch failed: {msg} ({err})")


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_cell_fused(xproj, h, c, w_h2h):
    """One LSTM step: (xproj (N,4H), h (N,H), c (N,H), w_h2h (4H,H)) ->
    (h', c'). CUDA tensors launch the Hopper kernel (and count the launch
    in ``lstm_cell_fused.launches``) or raise; CPU and meta tensors run
    :func:`lstm_cell_plain`. When a tensor needs a gradient the step runs
    as a one-step sequence through the training Function."""
    _check_shapes(xproj, h, c, w_h2h)
    if _needs_grad(xproj, h, c, w_h2h):
        _, h_new, c_new = _Sequence.apply(xproj[None], h, c, w_h2h, False)
        return h_new, c_new
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


def backward_fits(n, hdim, device):
    """Whether the backward sequence kernel takes N rows of H units on the
    card of ``device`` (``lstm_sequence_backward_shared_bytes``). A block
    keeps the columns w_h2h[:, J] of its ``units = ceil(H / SMs)`` units
    (at most 10) as fp32, the same bytes as the forward's rows, beside a
    chunk of the previous step's dgates (N, 4H): the least power of two >=
    min(N, 32 // units, 16) rows, halved while the block's bytes exceed
    232,448. On 132 SMs H up to 1320 fits, as in the forward."""
    return _lib().lstm_sequence_backward_shared_bytes(
        n, hdim, _sm_count(device)) >= 0


def _sequence_launch(xproj, h0, c0, w_h2h, reverse, gates=None, cs=None):
    """One launch of the sequence kernel; in training ``gates`` (T, N, 4H)
    fp32 and ``cs`` (T, N, H) receive what the backward reads."""
    _check_kernel_inputs(
        "lstm_sequence", (xproj, h0, c0, w_h2h) + (() if cs is None else (cs,)),
        () if gates is None else (gates,))
    steps = xproj.shape[0]
    n, hdim = h0.shape
    lib = _lib()
    out = torch.empty((steps, n, hdim), dtype=h0.dtype, device=h0.device)
    h_last, c_last = torch.empty_like(h0), torch.empty_like(c0)
    # the grid barrier's arrival counter
    scratch = torch.zeros(1, dtype=torch.int32, device=h0.device)
    with torch.cuda.device(h0.device):
        err = lib.lstm_sequence_forward(
            xproj.data_ptr(), h0.data_ptr(), c0.data_ptr(), w_h2h.data_ptr(),
            out.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
            _ptr(gates), _ptr(cs), scratch.data_ptr(), steps, n, hdim,
            _KERNEL_DTYPES[h0.dtype], int(reverse), _sm_count(h0.device),
            _stream(h0.device))
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
    run :func:`lstm_sequence_plain`. When a tensor needs a gradient, the
    layer runs through the training Function (the same kernels, keeping
    what the backward reads)."""
    _check_sequence_shapes(xproj, h0, c0, w_h2h)
    if _needs_grad(xproj, h0, c0, w_h2h):
        return _Sequence.apply(xproj, h0, c0, w_h2h, reverse)
    if h0.device.type == "cuda":
        if not sequence_fits(h0.shape[0], h0.shape[1], h0.device):
            return lstm_sequence_plain(xproj, h0, c0, w_h2h, reverse,
                                       cell=lstm_cell_fused)
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
        err = lib.lstm_sequence_barriers(scratch.data_ptr(), steps, n, hdim,
                                         _sm_count(device), _stream(device))
    _raise_on(lib, err, "lstm_sequence barrier")


# ---------------------------------------------------------------------------
# training: the forward that keeps what the backward reads, the backward,
# and the autograd Function over both


def _steps(steps, reverse):
    return range(steps) if reverse else range(steps - 1, -1, -1)


def _previous(t, reverse):
    """The step whose state step t reads (t-1, or t+1 when reverse)."""
    return t + 1 if reverse else t - 1


def lstm_sequence_train_plain(xproj, h0, c0, w_h2h, reverse=False,
                              cell=_cell_train_plain):
    """The training forward in plain torch: (out (T,N,H), hT, cT, gates
    (T,N,4H) fp32, cs (T,N,H)), gates the activated i, f, g, o of every
    step and cs every step's c in c's dtype, one ``cell`` step at a
    time."""
    return lstm_sequence_plain(xproj, h0, c0, w_h2h, reverse, cell,
                               train=True)


def _cell_train_launch(xproj, h, c, w_h2h):
    gates = torch.empty(xproj.shape, dtype=torch.float32, device=xproj.device)
    h_new, c_new = _launch(xproj, h, c, w_h2h, gates)
    return h_new, c_new, gates


def lstm_sequence_train(xproj, h0, c0, w_h2h, reverse=False):
    """The training forward of one layer and direction: (out, hT, cT,
    gates, cs) as :func:`lstm_sequence_train_plain` gives them. CUDA
    tensors launch the sequence kernel once (``lstm_sequence_fused.
    launches``), or the per-step kernel T times where the layer does not
    fit (``lstm_cell_fused.launches``), each keeping the gates; CPU and
    meta tensors run the plain version."""
    _check_sequence_shapes(xproj, h0, c0, w_h2h)
    if h0.device.type in ("cpu", "meta"):
        return lstm_sequence_train_plain(xproj, h0, c0, w_h2h, reverse)
    if h0.device.type != "cuda":
        raise MXNetError(f"lstm_sequence: no kernel for device {h0.device}")
    steps, n, hdim = xproj.shape[0], h0.shape[0], h0.shape[1]
    if not sequence_fits(n, hdim, h0.device):
        return lstm_sequence_train_plain(xproj, h0, c0, w_h2h, reverse,
                                         cell=_cell_train_launch)
    gates = torch.empty((steps, n, 4 * hdim), dtype=torch.float32,
                        device=h0.device)
    cs = torch.empty((steps, n, hdim), dtype=c0.dtype, device=c0.device)
    out, h_last, c_last = _sequence_launch(xproj, h0, c0, w_h2h, reverse,
                                           gates, cs)
    return out, h_last, c_last, gates, cs


def lstm_cell_backward_plain(dh_new, dc_new, gates, c, w_h2h, h):
    """The adjoint of one step in plain torch: the JAX package's
    ``_cell_bwd``, with the step's activated gates (N, 4H, fp32) kept by
    the forward in place of their recomputation. (dh_new, dc_new) are the
    cotangents of (h', c'); returns (dgates fp32, dh in h's dtype, dc_prev
    in c's dtype, dw in w_h2h's dtype)."""
    H = h.shape[-1]
    i, f = gates[:, 0 * H:1 * H], gates[:, 1 * H:2 * H]
    g, o = gates[:, 2 * H:3 * H], gates[:, 3 * H:4 * H]
    cf = c.float()
    c_new = f * cf + i * g
    tc = torch.tanh(c_new)
    dh32 = dh_new.float()
    dc = dc_new.float() + dh32 * o * (1 - tc * tc)
    d_i = dc * g * i * (1 - i)
    d_f = dc * cf * f * (1 - f)
    d_g = dc * i * (1 - g * g)
    d_o = dh32 * tc * o * (1 - o)
    dgates = torch.cat([d_i, d_f, d_g, d_o], -1)
    dh = torch.matmul(dgates, w_h2h.float()).to(h.dtype)
    dc_prev = (dc * f).to(c.dtype)
    dw = torch.matmul(dgates.t(), h.float()).to(w_h2h.dtype)
    return dgates, dh, dc_prev, dw


def lstm_sequence_backward_plain(dout, dh_last, dc_last, gates, cs, out, h0,
                                 c0, w_h2h, reverse=False):
    """The backward of one layer and direction in plain torch, as
    ``jax.vjp`` of the scan computes it: t walks back through the steps
    (upward when ``reverse``); each step's h cotangent is the carry plus
    dout[t], summed in h's dtype; the carries dh and dc keep the states'
    dtypes and dw accumulates step by step in w_h2h's dtype. Returns
    (dgates (T,N,4H) fp32, which is dxproj before its cast, dh0, dc0,
    dw_h2h)."""
    steps = gates.shape[0]
    dgates = torch.empty_like(gates)
    dw = torch.zeros_like(w_h2h)
    dh, dc = dh_last, dc_last
    for t in _steps(steps, reverse):
        p = _previous(t, reverse)
        first = not 0 <= p < steps
        h_prev = h0 if first else out[p]
        c_prev = c0 if first else cs[p]
        dgates[t], dh, dc, dw_t = lstm_cell_backward_plain(
            dh + dout[t], dc, gates[t], c_prev, w_h2h, h_prev)
        dw = dw + dw_t
    return dgates, dh, dc, dw


def _dw_product(dgates, out, h0, w_h2h, reverse):
    """dw_h2h = sum over t of dgates_t^T . h_{t-1}: one product over all
    T*N rows, summed in fp32, then cast to w_h2h's dtype."""
    steps, n, hdim = out.shape
    if reverse:
        h_prev = torch.cat([out[1:], h0[None]])
    else:
        h_prev = torch.cat([h0[None], out[:-1]])
    dw = torch.matmul(dgates.reshape(steps * n, 4 * hdim).t(),
                      h_prev.reshape(steps * n, hdim).float())
    return dw.to(w_h2h.dtype)


def lstm_cell_backward(dg_next, w_t, gates, c_prev, dy, dh_in, dc_in, dg_out,
                       dc_out, dh_out=None):
    """One launch of the per-step backward kernel on CUDA tensors:
    dh = dg_next . w_h2h (``w_t`` = w_h2h^T, (H, 4H)) in h's dtype, or
    ``dh_in`` where ``dg_next`` is None (the first step); then the cell's
    adjoint writes the step's dgates into ``dg_out`` (N, 4H, fp32) and the
    dc carry into ``dc_out`` (which may be ``dc_in``). With ``gates`` None
    it only writes ``dh_out`` = dg_next . w_h2h (the layer's dh0). Counted
    in ``lstm_cell_backward.launches``."""
    hdim = w_t.shape[0]
    n = dg_out.shape[0] if dg_out is not None else dh_out.shape[0]
    states = [t for t in (w_t, c_prev, dy, dh_in, dc_in, dc_out, dh_out)
              if t is not None]
    floats = [t for t in (dg_next, gates, dg_out) if t is not None]
    _check_kernel_inputs("lstm_cell_backward", states, floats)
    if 4 * hdim * 4 > MAX_SHARED_BYTES:
        raise MXNetError(f"lstm_cell_backward kernel stages a column of "
                         f"w_h2h (4*H fp32): H={hdim} does not fit")
    lib = _lib()
    with torch.cuda.device(w_t.device):
        err = lib.lstm_cell_backward(
            _ptr(dg_next), w_t.data_ptr(), _ptr(gates), _ptr(c_prev),
            _ptr(dy), _ptr(dh_in), _ptr(dc_in), _ptr(dg_out), _ptr(dc_out),
            _ptr(dh_out), n, hdim, _KERNEL_DTYPES[w_t.dtype],
            _stream(w_t.device))
    _raise_on(lib, err, "lstm_cell_backward")
    lstm_cell_backward.launches += 1


lstm_cell_backward.launches = 0


def _backward_per_step(dout, dh_last, dc_last, gates, cs, h0, c0, w_h2h,
                       reverse):
    """The per-step kernel's route: T launches and one for dh0."""
    steps = gates.shape[0]
    w_t = w_h2h.t().contiguous()
    dgates = torch.empty_like(gates)
    dc = dc_last.clone()  # the dc carry, updated in place
    done = None
    for t in _steps(steps, reverse):
        p = _previous(t, reverse)
        c_prev = c0 if not 0 <= p < steps else cs[p]
        lstm_cell_backward(None if done is None else dgates[done], w_t,
                           gates[t], c_prev, dout[t], dh_last, dc, dgates[t],
                           dc)
        done = t
    dh0 = torch.empty_like(h0)
    lstm_cell_backward(dgates[done], w_t, None, None, None, None, None, None,
                       None, dh0)
    return dgates, dh0, dc


def lstm_sequence_backward(dout, dh_last, dc_last, gates, cs, out, h0, c0,
                           w_h2h, reverse=False):
    """The backward of one layer and direction: what
    :func:`lstm_sequence_backward_plain` computes, from the cotangents of
    (out, hT, cT) and what :func:`lstm_sequence_train` kept. Returns
    (dgates (T,N,4H) fp32, dh0, dc0, dw_h2h).

    CUDA tensors launch, where :func:`backward_fits`, the persistent
    backward kernel once (all T steps, counted in
    ``lstm_sequence_backward.launches``), else the per-step backward kernel
    T + 1 times (``lstm_cell_backward.launches``); dw_h2h is then one fp32
    product over all steps (``torch.matmul``), cast to w_h2h's dtype once,
    where the plain version rounds its sum to that dtype every step. CPU
    and meta tensors run the plain version."""
    if h0.device.type in ("cpu", "meta"):
        return lstm_sequence_backward_plain(dout, dh_last, dc_last, gates, cs,
                                            out, h0, c0, w_h2h, reverse)
    if h0.device.type != "cuda":
        raise MXNetError(f"lstm_sequence: no kernel for device {h0.device}")
    # the head cotangents in the states' dtype, contiguous, as the kernels
    # take them
    dout, dh_last, dc_last = (x.to(h0.dtype).contiguous()
                              for x in (dout, dh_last, dc_last))
    if backward_fits(h0.shape[0], h0.shape[1], h0.device):
        dgates, dh0, dc0 = _sequence_backward_launch(
            dout, dh_last, dc_last, gates, cs, h0, c0, w_h2h, reverse)
    else:
        dgates, dh0, dc0 = _backward_per_step(dout, dh_last, dc_last, gates,
                                              cs, h0, c0, w_h2h, reverse)
    return dgates, dh0, dc0, _dw_product(dgates, out, h0, w_h2h, reverse)


def _sequence_backward_launch(dout, dh_last, dc_last, gates, cs, h0, c0,
                              w_h2h, reverse):
    """One launch of the backward sequence kernel: (dgates, dh0, dc0)."""
    _check_kernel_inputs("lstm_sequence_backward",
                         (dout, dh_last, dc_last, cs, h0, c0, w_h2h), (gates,))
    steps, n, hdim = cs.shape
    lib = _lib()
    dgates = torch.empty_like(gates)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    scratch = torch.zeros(1, dtype=torch.int32, device=h0.device)
    with torch.cuda.device(h0.device):
        err = lib.lstm_sequence_backward(
            dout.data_ptr(), dh_last.data_ptr(), dc_last.data_ptr(),
            gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), w_h2h.data_ptr(),
            dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            scratch.data_ptr(), steps, n, hdim, _KERNEL_DTYPES[h0.dtype],
            int(reverse), _sm_count(h0.device), _stream(h0.device))
    _raise_on(lib, err, "lstm_sequence_backward")
    lstm_sequence_backward.launches += 1
    return dgates, dh0, dc0


lstm_sequence_backward.launches = 0


class _Sequence(torch.autograd.Function):
    """One layer and direction, (xproj, h0, c0, w_h2h) -> (out, hT, cT),
    differentiable in all four: the counterpart of ``jax.vjp`` of the
    JAX package's scan over its custom-VJP cell."""

    @staticmethod
    def forward(ctx, xproj, h0, c0, w_h2h, reverse):
        out, h_last, c_last, gates, cs = lstm_sequence_train(
            xproj, h0, c0, w_h2h, reverse)
        ctx.save_for_backward(out, gates, cs, h0, c0, w_h2h)
        ctx.reverse = reverse
        ctx.xproj_dtype = xproj.dtype
        return out, h_last, c_last

    @staticmethod
    def backward(ctx, dout, dh_last, dc_last):
        out, gates, cs, h0, c0, w_h2h = ctx.saved_tensors
        dgates, dh0, dc0, dw = lstm_sequence_backward(
            dout, dh_last, dc_last, gates, cs, out, h0, c0, w_h2h,
            ctx.reverse)
        return dgates.to(ctx.xproj_dtype), dh0, dc0, dw, None

"""Fused recurrent op: multi-layer (bi)directional RNN/LSTM/GRU.

Counterpart of ``mxnet_tpu/ops/rnn_ops.py``. The input projection of the
whole sequence is one ``torch.matmul`` outside the time loop, as the JAX
package leaves it to XLA. The LSTM's time loop (``lax.scan`` over the fused
cell there) is one call of ``lstm_sequence_fused`` (``ops/cuda/lstm.py``) a
layer and direction, which on CUDA tensors launches one persistent Hopper
kernel for all T steps; in training it runs through that module's
autograd Function, whose backward is a kernel too, while autograd
differentiates the input projection. GRU and the plain RNN modes are plain
torch, a Python loop over the steps taking the place of ``lax.scan``.

Weight packing follows the cuDNN convention bit for bit: all layer weights
first (per layer, per direction: i2h (G*H, in) then h2h (G*H, H), row-major),
then all biases (per layer, per direction: i2h bias then h2h bias). Gate
order: LSTM i,f,g,o; GRU r,z,n.
"""
from __future__ import annotations

import functools

import torch

from .. import random as _random
from ..base import AttrSpec, MXNetError
from ..dtypes import torch_dtype
from .cuda.lstm import lstm_sequence_fused
from .registry import register

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _num_directions(bidirectional):
    return 2 if bidirectional else 1


def _layer_param_size(input_size, state_size, mode, bidirectional):
    G = _GATES[mode]
    D = _num_directions(bidirectional)
    return D * (G * state_size * (input_size + state_size)  # i2h + h2h
                + 2 * G * state_size)                        # two biases


def rnn_param_size(num_layers, input_size, state_size, mode,
                   bidirectional=False):
    """Total packed-parameter length (reference rnn-inl.h GetParamSize)."""
    D = _num_directions(bidirectional)
    size = _layer_param_size(input_size, state_size, mode, bidirectional)
    for _ in range(num_layers - 1):
        size += _layer_param_size(D * state_size, state_size, mode,
                                  bidirectional)
    return size


def _unpack(params, num_layers, input_size, state_size, mode, bidirectional):
    """Split the flat parameter vector into per-(layer, direction) pieces.

    Returns [(w_i2h, w_h2h, b_i2h, b_h2h)] indexed [layer][direction]; the
    pieces are views of ``params``.
    """
    G = _GATES[mode]
    D = _num_directions(bidirectional)
    H = state_size
    weights, biases = [], []
    off = 0
    in_size = input_size
    for _ in range(num_layers):
        per_layer = []
        for _ in range(D):
            w_i2h = params[off:off + G * H * in_size].reshape(G * H, in_size)
            off += G * H * in_size
            w_h2h = params[off:off + G * H * H].reshape(G * H, H)
            off += G * H * H
            per_layer.append([w_i2h, w_h2h])
        weights.append(per_layer)
        in_size = D * H
    for _ in range(num_layers):
        per_layer = []
        for _ in range(D):
            b_i2h = params[off:off + G * H]
            off += G * H
            b_h2h = params[off:off + G * H]
            off += G * H
            per_layer.append([b_i2h, b_h2h])
        biases.append(per_layer)
    return [[tuple(weights[l][d]) + tuple(biases[l][d])
             for d in range(D)] for l in range(num_layers)]


def _cell_step(mode, H):
    """step(carry, xproj, w_h2h, b_h2h) -> new carry for one time step of
    GRU or a plain RNN, given the precomputed x-projection; carry is
    (h,)."""
    if mode == "gru":
        def step(carry, xproj, w_h2h, b_h2h):
            (h,) = carry
            hproj = torch.matmul(h, w_h2h.t()) + b_h2h
            r = torch.sigmoid(xproj[:, 0 * H:1 * H] + hproj[:, 0 * H:1 * H])
            z = torch.sigmoid(xproj[:, 1 * H:2 * H] + hproj[:, 1 * H:2 * H])
            n = torch.tanh(xproj[:, 2 * H:3 * H] + r * hproj[:, 2 * H:3 * H])
            return ((1 - z) * n + z * h,)
        return step
    act = torch.tanh if mode == "rnn_tanh" else torch.relu

    def step(carry, xproj, w_h2h, b_h2h):
        (h,) = carry
        return (act(xproj + torch.matmul(h, w_h2h.t())),)
    return step


def _run_direction(x, h0, c0, w_i2h, w_h2h, b_i2h, b_h2h, mode, H,
                   reverse=False):
    """One direction of one layer. x: (T, N, in). Returns (out(T,N,H), hT, cT).
    Data, weights and states promote to one dtype first, as jnp's ``@``
    does (bf16 data over fp32 parameters computes in fp32)."""
    T, N = x.shape[0], x.shape[1]
    ts = (x, h0, c0, w_i2h, w_h2h, b_i2h, b_h2h)
    dt = functools.reduce(torch.promote_types,
                          (t.dtype for t in ts if t is not None))
    x, h0, c0, w_i2h, w_h2h, b_i2h, b_h2h = (
        None if t is None else t.to(dt) for t in ts)
    # GRU keeps the h2h bias apart (the reset gate multiplies the
    # h-projection); the other modes fold both biases into the x-projection
    bias = b_i2h if mode == "gru" else b_i2h + b_h2h
    xproj = torch.matmul(x.reshape(T * N, -1), w_i2h.t()) + bias
    xproj = xproj.reshape(T, N, -1)
    if mode == "lstm":
        # the kernel takes contiguous tensors of one dtype
        return lstm_sequence_fused(xproj, h0.contiguous(), c0.contiguous(),
                                   w_h2h.contiguous(), reverse=reverse)
    step = _cell_step(mode, H)
    carry = (h0,)
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        carry = step(carry, xproj[t], w_h2h, b_h2h)
        outs[t] = carry[0]
    return torch.stack(outs), carry[0], None


def _rnn_impl(rng, data, parameters, state, state_cell, state_size,
              num_layers, mode, bidirectional, p, _is_train):
    T, N, input_size = data.shape
    H = state_size
    D = _num_directions(bidirectional)
    pieces = _unpack(parameters, num_layers, input_size, H, mode,
                     bidirectional)
    x = data
    h_states, c_states = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(D):
            w_i2h, w_h2h, b_i2h, b_h2h = pieces[layer][d]
            idx = layer * D + d
            h0 = state[idx]
            c0 = state_cell[idx] if mode == "lstm" else None
            out, hT, cT = _run_direction(x, h0, c0, w_i2h, w_h2h, b_i2h,
                                         b_h2h, mode, H, reverse=(d == 1))
            outs.append(out)
            h_states.append(hT)
            if mode == "lstm":
                c_states.append(cT)
        x = outs[0] if D == 1 else torch.cat(outs, dim=-1)
        if p > 0 and _is_train and layer < num_layers - 1:
            # the reference draws a dropout mask between layers
            gen = rng if rng is not None else _random.generator(x.device)
            keep = torch.empty(x.shape, device=x.device).bernoulli_(
                1 - p, generator=gen)
            x = torch.where(keep.bool(), x / (1 - p), 0).to(x.dtype)
    hy = torch.stack(h_states)
    if mode == "lstm":
        return x, hy, torch.stack(c_states)
    return x, hy, torch.zeros_like(hy)


@register("_begin_state_zeros",
          attrs=AttrSpec(shape=("tuple",), batch_axis=("int", 0),
                         dtype=("str", "float32")))
def _begin_state_zeros(data, shape, batch_axis=0, dtype="float32"):
    """Zero initial RNN state whose batch dim (marked 0 in ``shape``) is
    taken from ``data``, on ``data``'s device."""
    out_shape = tuple(data.shape[batch_axis] if s == 0 else s for s in shape)
    return torch.zeros(out_shape, dtype=torch_dtype(dtype), device=data.device)


def _rnn_nout(attrs):
    if attrs.get("state_outputs") in (True, "True", "1"):
        return 3 if attrs.get("mode") == "lstm" else 2
    return 1


def _rnn_param_shapes(attrs, shapes):
    d = shapes[0]
    H = int(attrs["state_size"])
    L = int(attrs["num_layers"])
    bi = attrs.get("bidirectional") in (True, "True", "1")
    D = 2 if bi else 1
    mode = attrs.get("mode", "lstm")
    psize = rnn_param_size(L, d[2], H, mode, bi)
    st = (L * D, d[1], H)
    out = [d, (psize,), st]
    if mode == "lstm":
        out.append(st)
    return out


def _rnn_uses_rng(attrs):
    """Inter-layer dropout is the RNN op's only randomness: with p=0 the
    op draws nothing (the signature still takes a key, unused)."""
    try:
        return float(attrs.get("p", 0.0) or 0.0) > 0.0
    except (TypeError, ValueError):
        return True


@register("RNN",
          num_inputs=None,
          input_names=["data", "parameters", "state", "state_cell"],
          num_outputs=_rnn_nout,
          needs_rng=_rnn_uses_rng,
          needs_is_train=True,
          param_shapes=_rnn_param_shapes,
          attrs=AttrSpec(state_size=("int",), num_layers=("int",),
                         mode=("str", "lstm"),
                         bidirectional=("bool", False),
                         p=("float", 0.0),
                         state_outputs=("bool", False),
                         lstm_state_clip_min=("any", None),
                         lstm_state_clip_max=("any", None)))
def _rnn(rng, *inputs, state_size, num_layers, mode="lstm",
         bidirectional=False, p=0.0, state_outputs=False,
         lstm_state_clip_min=None, lstm_state_clip_max=None,
         _is_train=False):
    """Fused multi-layer RNN (reference rnn-inl.h; cuDNN-equivalent).
    ``rng`` is the ``torch.Generator`` of the data's device (None: the
    package's, ``random.generator``) for inter-layer dropout, the op's only
    randomness, drawn only in training between layers: a one-layer op with
    p > 0 draws nothing. The mask keeps each element with probability
    1 - p and scales it by 1 / (1 - p); it cannot match ``jax.random``'s
    bits."""
    if mode not in _GATES:
        raise MXNetError(f"unknown RNN mode {mode}")
    if mode == "lstm":
        if len(inputs) != 4:
            raise MXNetError("lstm mode needs data, parameters, state, "
                             "state_cell")
        data, parameters, state, state_cell = inputs
    else:
        if len(inputs) != 3:
            raise MXNetError(f"{mode} mode needs data, parameters, state")
        data, parameters, state = inputs
        state_cell = None
    # hidden outputs are always produced; the registry's num_outputs picks
    # the visible prefix (out [, hy [, cy]])
    return _rnn_impl(rng, data, parameters, state, state_cell, state_size,
                     num_layers, mode, bidirectional, p, _is_train)

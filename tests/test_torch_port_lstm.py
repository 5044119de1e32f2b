"""Parity of the PyTorch port's LSTM path with the JAX package.

The same numpy inputs, made from a seed, go through ``mxnet_tpu`` and
``mxnet_tpu_torch``: the fused LSTM cell and the LSTM time loop of one
layer (their plain versions on the CPU against the Pallas kernel in
interpret mode and the jnp cell, the loop against the JAX package's
``_run_direction`` scan), the ``RNN`` op in every mode, and the
packed-weight layout. Tests marked ``cuda`` hold the Hopper kernels to
their plain versions and skip without a card. They need
neither JAX nor the JAX package, which the other tests import through the
``ref`` fixture, so on a card without JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_port_lstm.py``.
"""
import functools
import math
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import rnn_ops as port_rnn_ops
from mxnet_tpu_torch.ops.cuda import lstm as port_lstm
from mxnet_tpu_torch.ops.cuda.lstm import (lstm_cell_fused, lstm_cell_plain,
                                           lstm_sequence_fused,
                                           lstm_sequence_plain, sequence_fits)

RTOL, ATOL = 1e-5, 1e-6  # fp32 on both sides; only summation order differs
# the sequence kernel against its plain version in fp32: each step differs
# from it in summation order only (~1e-7), and the differences compound
# through the recurrence over up to 128 steps
SEQ_FP32_TOL = 1e-4
# where the recurrence amplifies rounding (``_rnn_inputs``' N(0, 0.4)
# weights), an fp32 path is held to an fp64 reference: it may lie this many
# times as far from it as the CPU's fp32 path does. At the card test's
# inputs, fp32 with other summation orders lies up to 1.9 times as far
# (test_rnn_op_fp32_orders_stay_near_fp64 prints each ratio); this is about
# twice that.
SUM_ORDER_FACTOR = 4


@pytest.fixture(scope="module")
def ref():
    """The JAX package's counterparts."""
    import jax.numpy as jnp
    import mxnet_tpu
    from mxnet_tpu.ops import rnn_ops
    from mxnet_tpu.ops.pallas import lstm
    return types.SimpleNamespace(jnp=jnp, mx=mxnet_tpu, rnn_ops=rnn_ops,
                                 lstm=lstm)


def _cell_arrays(n, hdim, seed):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, s, shape).astype(np.float32)
            for s, shape in ((1.0, (n, 4 * hdim)), (0.7, (n, hdim)),
                             (0.7, (n, hdim)), (0.5, (4 * hdim, hdim)))]


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run "
                    "`python -m pytest --noconftest -m cuda "
                    "tests/test_torch_port_lstm.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
@pytest.mark.parametrize("n,hdim", [(1, 8), (3, 16), (4, 32)])
def test_cell_matches_jax(ref, n, hdim, impl):
    arrays = _cell_arrays(n, hdim, seed=n * 100 + hdim)
    h_j, c_j = ref.lstm.lstm_cell_fused(*map(ref.jnp.asarray, arrays),
                                        impl=impl)
    h_t, c_t = lstm_cell_fused(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=RTOL, atol=ATOL)


def test_cell_on_cpu_runs_plain_and_counts_no_launch():
    arrays = [torch.from_numpy(a) for a in _cell_arrays(2, 8, seed=1)]
    before = lstm_cell_fused.launches
    h, c = lstm_cell_fused(*arrays)
    h_p, c_p = lstm_cell_plain(*arrays)
    assert lstm_cell_fused.launches == before
    assert torch.equal(h, h_p) and torch.equal(c, c_p)


def test_cell_on_meta_infers_shapes():
    n, hdim = 3, 12
    xproj, h, c, w = (torch.empty(s, device="meta", dtype=torch.bfloat16)
                      for s in ((n, 4 * hdim), (n, hdim), (n, hdim),
                                (4 * hdim, hdim)))
    h_new, c_new = lstm_cell_fused(xproj, h, c, w)
    assert h_new.device.type == "meta" and h_new.shape == (n, hdim)
    assert c_new.dtype == torch.bfloat16 and c_new.shape == (n, hdim)


def test_cell_keeps_state_dtypes():
    xproj, h, c, w = (torch.from_numpy(a) for a in _cell_arrays(2, 8, seed=2))
    h_new, c_new = lstm_cell_fused(xproj.double(), h.bfloat16(), c, w)
    assert h_new.dtype == torch.bfloat16 and c_new.dtype == torch.float32


@pytest.mark.parametrize("bad", ["xproj", "w_h2h", "c"])
def test_cell_rejects_bad_shapes(bad):
    arrays = dict(zip(("xproj", "h", "c", "w_h2h"),
                      map(torch.from_numpy, _cell_arrays(2, 8, seed=3))))
    arrays[bad] = arrays[bad][:, :-1]
    with pytest.raises(MXNetError):
        lstm_cell_fused(arrays["xproj"], arrays["h"], arrays["c"],
                        arrays["w_h2h"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("n,hdim", [(1, 1024), (16, 1024), (3, 200)])
def test_cell_kernel_matches_plain(card, n, hdim, dtype, tol):
    rng = np.random.RandomState(n + hdim)
    arrays = (rng.normal(0, 1, (n, 4 * hdim)), rng.uniform(-1, 1, (n, hdim)),
              rng.uniform(-1, 1, (n, hdim)),
              rng.uniform(-0.05, 0.05, (4 * hdim, hdim)))
    args = [torch.tensor(a, dtype=dtype, device=card) for a in arrays]
    before = lstm_cell_fused.launches
    h_k, c_k = lstm_cell_fused(*args)
    torch.cuda.synchronize()
    assert lstm_cell_fused.launches == before + 1
    h_p, c_p = lstm_cell_plain(*args)
    assert h_k.dtype == dtype and c_k.dtype == dtype
    assert (h_k.float() - h_p.float()).abs().max().item() <= tol
    assert (c_k.float() - c_p.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_cell_kernel_rejects_what_it_does_not_take(card):
    args = [torch.from_numpy(a).to(card) for a in _cell_arrays(2, 32, seed=4)]
    with pytest.raises(MXNetError):  # mixed dtypes
        lstm_cell_fused(args[0].double(), *args[1:])
    with pytest.raises(MXNetError):  # not contiguous
        lstm_cell_fused(args[0], args[1], args[2], args[3].t().contiguous().t())
    w = args[3].clone().requires_grad_()
    h, c = lstm_cell_fused(args[0], args[1], args[2], w)  # a gradient flows
    (dw,) = torch.autograd.grad((h.sum() + c.sum(),), (w,))
    assert dw.shape == w.shape and torch.isfinite(dw).all()


def _rnn_inputs(mode, layers, bidirectional, T=4, N=3, I=5, H=6, seed=0):
    rng = np.random.RandomState(seed)
    D = 2 if bidirectional else 1
    psize = port_rnn_ops.rnn_param_size(layers, I, H, mode, bidirectional)
    arrays = [rng.normal(0, 1, (T, N, I)), rng.normal(0, 0.4, (psize,)),
              rng.normal(0, 0.5, (layers * D, N, H))]
    if mode == "lstm":
        arrays.append(rng.normal(0, 0.5, (layers * D, N, H)))
    return [a.astype(np.float32) for a in arrays], H


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_matches_jax(ref, mode, layers, bidirectional):
    arrays, H = _rnn_inputs(mode, layers, bidirectional,
                            seed=layers * 7 + bidirectional)
    attrs = dict(state_size=H, num_layers=layers, mode=mode,
                 bidirectional=bidirectional)
    outs_j = ref.mx.nd.RNN(*[ref.mx.nd.array(a) for a in arrays],
                           state_outputs=True, **attrs)
    outs_t = mxt.OP_TABLE["RNN"].fn(None, *map(torch.from_numpy, arrays),
                                    **attrs)
    for o_j, o_t in zip(outs_j, outs_t):
        np.testing.assert_allclose(o_t.numpy(), o_j.asnumpy(), rtol=RTOL,
                                   atol=ATOL)


def _toy_rnn(mode, layers=1, seed=3):
    """The RNN op's inputs at a toy size (T=3, N=2, in=4, H=5) and its
    attributes."""
    arrays, H = _rnn_inputs(mode, layers, False, T=3, N=2, I=4, H=5,
                            seed=seed)
    return arrays, dict(state_size=H, num_layers=layers, mode=mode,
                        state_outputs=True)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
@pytest.mark.parametrize("path", ["nd", "bf16_data"])
def test_rnn_op_entry_matches_jax(ref, path, mode):
    """``mx.nd.RNN`` on the CPU runs (the op takes a key it does not draw
    from at p = 0) and matches the JAX package's; bf16 data over fp32
    parameters promotes to fp32 as jnp's ``@`` does."""
    import jax
    arrays, attrs = _toy_rnn(mode)
    if path == "nd":
        with jax.enable_x64(False):
            outs_j = [o.asnumpy() for o in ref.mx.nd.RNN(
                *map(ref.mx.nd.array, arrays), **attrs)]
        outs_t = mxt.nd.RNN(*(mxt.nd.array(a, ctx=mxt.cpu())
                              for a in arrays), **attrs)
        assert all(o.context == mxt.cpu() for o in outs_t)
        outs_t = [o.asnumpy() for o in outs_t]
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        with jax.enable_x64(False):
            ins = [ref.jnp.asarray(a) for a in arrays]
            ins[0] = ins[0].astype(ref.jnp.bfloat16)
            outs_j = ref.mx.ops.get_op("RNN").fn(None, *ins, **attrs)
            assert all(o.dtype == ref.jnp.float32 for o in outs_j)
            outs_j = [np.asarray(o) for o in outs_j]
        ins = [torch.from_numpy(a) for a in arrays]
        ins[0] = ins[0].to(torch.bfloat16)
        # the op's fn returns the hidden outputs too; the registry shows a
        # prefix of them
        outs_t = mxt.OP_TABLE["RNN"].fn(None, *ins, **attrs)
        assert all(o.dtype == torch.float32 for o in outs_t)
        outs_t = [o.numpy() for o in outs_t]
        tol = dict(rtol=1e-2, atol=1e-2)
    n = 3 if mode == "lstm" else 2  # out, hy (, cy) are visible
    assert len(outs_t[:n]) == len(outs_j[:n]) == n
    for o_j, o_t in zip(outs_j[:n], outs_t[:n], strict=True):
        np.testing.assert_allclose(o_t, o_j, **tol)


@pytest.mark.parametrize("layers", [1, 2])
def test_rnn_op_dropout_in_training(layers, monkeypatch):
    """The reference draws dropout only between layers: a one-layer op
    with p > 0 in training equals the p = 0 result. A deeper one draws
    its mask from the given generator (the same seed, the same mask): the
    second layer's input is the first layer's output, each element kept
    with probability 1 - p and scaled by 1 / (1 - p), or zeroed. The mask
    cannot match jax.random's bits, so the keep rate is held to a
    binomial bound."""
    arrays, attrs = _toy_rnn("lstm", layers)
    fn = mxt.OP_TABLE["RNN"].fn
    ins = [torch.from_numpy(a) for a in arrays]
    assert mxt.OP_TABLE["RNN"].uses_rng({"p": 0.5})
    assert not mxt.OP_TABLE["RNN"].uses_rng({"p": 0.0})
    if layers == 1:
        want = fn(None, *ins, p=0.0, _is_train=True, **attrs)
        got = fn(None, *ins, p=0.5, _is_train=True, **attrs)
        for w, g in zip(want, got, strict=True):
            assert torch.equal(w, g)
        return
    p = 0.3
    seen = []
    run = port_rnn_ops._run_direction

    def spy(x, *args, **kwargs):
        out = run(x, *args, **kwargs)
        seen.append((x, out[0]))
        return out

    monkeypatch.setattr(port_rnn_ops, "_run_direction", spy)
    arrays, hdim = _rnn_inputs("lstm", 2, False, T=4, N=50, I=4, H=5, seed=3)
    ins = [torch.from_numpy(a) for a in arrays]
    attrs = dict(attrs, state_size=hdim)
    outs = [fn(torch.Generator().manual_seed(7), *ins, p=p, _is_train=True,
               **attrs) for _ in range(2)]
    for a, b in zip(*outs, strict=True):
        assert torch.equal(a, b)  # one seed, one mask
    first_out, second_in = seen[0][1], seen[1][0]  # layer 0 out, 1 in
    kept = second_in != 0
    torch.testing.assert_close(second_in[kept], first_out[kept] / (1 - p))
    keep_rate = kept.float().mean().item()
    assert abs(keep_rate - (1 - p)) <= 4 * math.sqrt(p * (1 - p)
                                                     / kept.numel())


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_unpack_matches_jax_bit_for_bit(ref, mode, bidirectional):
    layers, I, H = 2, 5, 3
    size = port_rnn_ops.rnn_param_size(layers, I, H, mode, bidirectional)
    assert size == ref.rnn_ops.rnn_param_size(layers, I, H, mode,
                                              bidirectional)
    flat = np.arange(size, dtype=np.float32)
    pieces_j = ref.rnn_ops._unpack(ref.jnp.asarray(flat), layers, I, H, mode,
                                   bidirectional)
    pieces_t = port_rnn_ops._unpack(torch.from_numpy(flat), layers, I, H,
                                    mode, bidirectional)
    for layer_j, layer_t in zip(pieces_j, pieces_t, strict=True):
        for dir_j, dir_t in zip(layer_j, layer_t, strict=True):
            for p_j, p_t in zip(dir_j, dir_t, strict=True):
                np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("mode,bidirectional", [("lstm", False), ("gru", True)])
def test_fused_cell_unpack_pack_round_trip(ref, mode, bidirectional):
    layers, I, H = 2, 4, 3
    size = port_rnn_ops.rnn_param_size(layers, I, H, mode, bidirectional)
    flat = np.random.RandomState(5).normal(size=size).astype(np.float32)
    cell_j = ref.mx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                     bidirectional=bidirectional, prefix="f_")
    cell_t = mxt.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                  bidirectional=bidirectional, prefix="f_")
    named_j = cell_j.unpack_weights({"f_parameters": ref.mx.nd.array(flat)})
    named_t = cell_t.unpack_weights(
        {"f_parameters": mxt.nd.array(flat, ctx=mxt.cpu())})
    assert sorted(named_t) == sorted(named_j)
    for k in named_j:
        np.testing.assert_array_equal(named_t[k].asnumpy(),
                                      named_j[k].asnumpy())
    packed = cell_t.pack_weights(named_t)
    assert list(packed) == ["f_parameters"]
    assert packed["f_parameters"].context == mxt.cpu()
    np.testing.assert_array_equal(packed["f_parameters"].asnumpy(), flat)


def test_begin_state_zeros_follows_data():
    data = torch.zeros((7, 3, 5))
    out = mxt.OP_TABLE["_begin_state_zeros"].fn(data, shape=(2, 0, 4),
                                                batch_axis=1)
    assert out.shape == (2, 3, 4) and not out.any()


def _sequence_arrays(steps, n, hdim, seed, w_scale=0.5):
    """xproj (T,N,4H), h0, c0 (N,H), w_h2h (4H,H); |h0|, |c0| < 1 as a
    cell's state is."""
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, (steps, n, 4 * hdim)).astype(np.float32),
            rng.uniform(-1, 1, (n, hdim)).astype(np.float32),
            rng.uniform(-1, 1, (n, hdim)).astype(np.float32),
            rng.uniform(-w_scale, w_scale, (4 * hdim, hdim)).astype(np.float32)]


def _jax_direction(ref, monkeypatch, arrays, reverse, impl, dtype):
    """The JAX package's ``_run_direction`` scan for LSTM with its cell
    forced to ``impl``. Identity input weights and zero biases make the
    scan's xproj exactly ``arrays[0]``."""
    jnp = ref.jnp
    monkeypatch.setattr(ref.lstm, "lstm_cell_fused",
                        functools.partial(ref.lstm.lstm_cell_fused, impl=impl))
    xproj, h0, c0, w = (jnp.asarray(a, dtype=dtype) for a in arrays)
    hdim = h0.shape[1]
    zeros = jnp.zeros((4 * hdim,), dtype)
    outs = ref.rnn_ops._run_direction(xproj, h0, c0,
                                      jnp.eye(4 * hdim, dtype=dtype), w,
                                      zeros, zeros, "lstm", hdim,
                                      reverse=reverse)
    return [np.asarray(o.astype(jnp.float32)) for o in outs]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("impl", ["interpret", "jnp"])
def test_sequence_matches_jax_scan(ref, monkeypatch, impl, n, reverse):
    arrays = _sequence_arrays(6, n, 16, seed=10 * n + reverse)
    want = _jax_direction(ref, monkeypatch, arrays, reverse, impl,
                          ref.jnp.float32)
    got = lstm_sequence_fused(*map(torch.from_numpy, arrays), reverse=reverse)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
def test_sequence_bf16_rounds_both_states_every_step(ref, monkeypatch, impl):
    """In bf16 the scan's carry rounds c and h to bf16 after every step.
    bf16 products are exact in fp32 and 16-term sums differ only in order,
    so the port's loop agrees with the scan bit for bit here, and a loop
    that carries c in fp32 does not."""
    arrays = _sequence_arrays(6, 3, 16, seed=3)
    want = _jax_direction(ref, monkeypatch, arrays, True, impl,
                          ref.jnp.bfloat16)
    xproj, h0, c0, w = (torch.from_numpy(a).bfloat16() for a in arrays)
    got = lstm_sequence_fused(xproj, h0, c0, w, reverse=True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, w_ in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.float().numpy(), w_)
    fp32_carry = lstm_sequence_plain(xproj, h0, c0.float(), w, reverse=True)
    assert not np.array_equal(fp32_carry[2].bfloat16().float().numpy(),
                              want[2])


def test_sequence_on_meta_infers_shapes():
    steps, n, hdim = 5, 3, 12
    xproj, h0, c0, w = (torch.empty(s, device="meta", dtype=torch.bfloat16)
                        for s in ((steps, n, 4 * hdim), (n, hdim), (n, hdim),
                                  (4 * hdim, hdim)))
    out, h_last, c_last = lstm_sequence_fused(xproj, h0, c0, w, reverse=True)
    assert out.device.type == "meta" and out.shape == (steps, n, hdim)
    assert h_last.shape == (n, hdim) and c_last.shape == (n, hdim)
    assert out.dtype == c_last.dtype == torch.bfloat16


def test_sequence_on_cpu_runs_plain_and_counts_no_launch():
    arrays = [torch.from_numpy(a) for a in _sequence_arrays(4, 2, 8, seed=1)]
    before = (lstm_sequence_fused.launches, lstm_cell_fused.launches)
    got = lstm_sequence_fused(*arrays)
    assert (lstm_sequence_fused.launches, lstm_cell_fused.launches) == before
    for g, p in zip(got, lstm_sequence_plain(*arrays), strict=True):
        assert torch.equal(g, p)


@pytest.mark.parametrize("bad", ["xproj", "w_h2h", "c0"])
def test_sequence_rejects_bad_shapes(bad):
    arrays = dict(zip(("xproj", "h0", "c0", "w_h2h"),
                      map(torch.from_numpy, _sequence_arrays(3, 2, 8, seed=2))))
    arrays[bad] = arrays[bad][..., :-1]
    with pytest.raises(MXNetError):
        lstm_sequence_fused(arrays["xproj"], arrays["h0"], arrays["c0"],
                            arrays["w_h2h"])


@pytest.mark.parametrize("reverse", [False, True])
def test_sequence_plain_steps_the_given_cell(reverse):
    seen = []

    def cell(xproj, h, c, w_h2h):
        seen.append(int(xproj[0, 0]))
        return h + 1, c - 1

    xproj = torch.arange(4.0).reshape(4, 1, 1).expand(4, 2, 12).contiguous()
    h0, c0, w = torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(12, 3)
    out, h_last, c_last = lstm_sequence_plain(xproj, h0, c0, w,
                                              reverse=reverse, cell=cell)
    order = [3, 2, 1, 0] if reverse else [0, 1, 2, 3]
    assert seen == order
    for k, t in enumerate(order):  # out[t] is h after the step at t
        assert torch.equal(out[t], torch.full((2, 3), k + 1.0))
    assert torch.equal(h_last, torch.full((2, 3), 4.0))
    assert torch.equal(c_last, torch.full((2, 3), -4.0))


def _cell_fp64(xproj, h, c, w_h2h):
    """:func:`lstm_cell_plain` in fp64: the reference that fp32 paths are
    measured against."""
    H = h.shape[-1]
    g = xproj.double() + h.double() @ w_h2h.double().t()
    c_new = (torch.sigmoid(g[:, H:2 * H]) * c.double()
             + torch.sigmoid(g[:, :H]) * torch.tanh(g[:, 2 * H:3 * H]))
    return torch.sigmoid(g[:, 3 * H:]) * torch.tanh(c_new), c_new


def _cell_split_k(xproj, h, c, w_h2h, splits):
    """:func:`lstm_cell_plain` in fp32 with another summation order: K in
    ``splits`` strided slices, whose products are summed last to first."""
    H = h.shape[-1]
    acc = torch.zeros_like(xproj)
    for k in reversed(range(splits)):
        acc = acc + h[:, k::splits] @ w_h2h[:, k::splits].t()
    g = xproj + acc
    c_new = (torch.sigmoid(g[:, H:2 * H]) * c
             + torch.sigmoid(g[:, :H]) * torch.tanh(g[:, 2 * H:3 * H]))
    return torch.sigmoid(g[:, 3 * H:]) * torch.tanh(c_new), c_new


def _rnn_op(arrays, attrs, device="cpu", dtype=torch.float32):
    return mxt.OP_TABLE["RNN"].fn(
        None, *(torch.from_numpy(a).to(device, dtype) for a in arrays),
        **attrs)


def _rnn_op_with_cell(monkeypatch, cell, arrays, attrs, dtype):
    """The RNN op on the CPU with the LSTM's time loop stepping ``cell``."""
    with monkeypatch.context() as m:
        m.setattr(port_rnn_ops, "lstm_sequence_fused",
                  functools.partial(lstm_sequence_plain, cell=cell))
        return _rnn_op(arrays, attrs, dtype=dtype)


def _gap(outs, exact):
    """The largest distance of any output from its fp64 reference."""
    return max((o.cpu().double() - e).abs().max().item()
               for o, e in zip(outs, exact, strict=True))


def _amplifying_lstm(bidirectional):
    """A 2-layer LSTM RNN op's inputs at which the recurrence amplifies
    rounding, and its attributes."""
    arrays, H = _rnn_inputs("lstm", 2, bidirectional, T=16, N=4, I=64, H=256,
                            seed=8)
    return arrays, dict(state_size=H, num_layers=2, mode="lstm",
                        bidirectional=bidirectional, state_outputs=True)


@pytest.mark.parametrize("splits", [4, 16, 32, 64])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_op_fp32_orders_stay_near_fp64(monkeypatch, bidirectional, splits):
    arrays, attrs = _amplifying_lstm(bidirectional)
    exact = _rnn_op_with_cell(monkeypatch, _cell_fp64, arrays, attrs,
                              torch.float64)
    cpu_gap = _gap(_rnn_op(arrays, attrs), exact)
    split = functools.partial(_cell_split_k, splits=splits)
    split_gap = _gap(_rnn_op_with_cell(monkeypatch, split, arrays, attrs,
                                       torch.float32), exact)
    print(f"bidirectional={bidirectional} splits={splits}: max|d| from fp64 "
          f"{split_gap:.3e}, {split_gap / cpu_gap:.2f} times the CPU "
          f"path's {cpu_gap:.3e}")
    assert 1e-6 < cpu_gap < 1e-3  # rounding, amplified
    assert split_gap <= SUM_ORDER_FACTOR * cpu_gap


def test_rnn_op_runs_one_sequence_call_per_layer_and_direction(monkeypatch):
    calls = []

    def counting(*args, **kwargs):
        calls.append(kwargs.get("reverse"))
        return lstm_sequence_fused(*args, **kwargs)

    monkeypatch.setattr(port_rnn_ops, "lstm_sequence_fused", counting)
    arrays, H = _rnn_inputs("lstm", 2, True, seed=4)
    mxt.OP_TABLE["RNN"].fn(None, *map(torch.from_numpy, arrays),
                           state_size=H, num_layers=2, mode="lstm",
                           bidirectional=True)
    assert calls == [False, True, False, True]


def _bf16_state_tol(ref):
    """Two bf16 ulps at the largest magnitude of ``ref``."""
    mag = ref.float().abs().max().item()
    return 2 * 2.0 ** (math.floor(math.log2(mag)) - 7) if mag else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steps,n,hdim", [
    (128, 1, 1024), (128, 16, 1024),
    (7, 3, 200),   # ragged: the last block owns fewer units
    (5, 2, 13),    # H % 4 != 0: h loaded element by element, K padded
    (3, 40, 64),   # N > 16: rows walked in chunks
])
def test_sequence_kernel_matches_plain(card, steps, n, hdim, dtype, reverse):
    arrays = _sequence_arrays(steps, n, hdim, seed=steps + n + hdim,
                              w_scale=0.05)
    args = [torch.tensor(a, dtype=dtype, device=card) for a in arrays]
    before = (lstm_sequence_fused.launches, lstm_cell_fused.launches)
    got = lstm_sequence_fused(*args, reverse=reverse)
    torch.cuda.synchronize()
    assert (lstm_sequence_fused.launches, lstm_cell_fused.launches) == (
        before[0] + 1, before[1])
    want = lstm_sequence_plain(*args, reverse=reverse)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == dtype and g.shape == w.shape
        tol = SEQ_FP32_TOL if dtype == torch.float32 else _bf16_state_tol(w)
        assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_sequence_over_the_shared_memory_budget_runs_the_step_kernel(card):
    steps, n, hdim = 3, 2, 1400
    assert not sequence_fits(n, hdim, card)
    args = [torch.from_numpy(a).to(card)
            for a in _sequence_arrays(steps, n, hdim, seed=5, w_scale=0.05)]
    before = (lstm_sequence_fused.launches, lstm_cell_fused.launches)
    got = lstm_sequence_fused(*args, reverse=True)
    torch.cuda.synchronize()
    assert (lstm_sequence_fused.launches, lstm_cell_fused.launches) == (
        before[0], before[1] + steps)
    for g, w in zip(got, lstm_sequence_plain(*args, reverse=True), strict=True):
        assert (g - w).abs().max().item() <= SEQ_FP32_TOL


@pytest.mark.cuda
def test_sequence_refused_launch_raises(card, monkeypatch):
    # planned for 4096 SMs, the grid is 1024 blocks of one unit: more than
    # the card's SMs can hold at once, so the cooperative launch is refused
    monkeypatch.setattr(port_lstm, "_sm_count", lambda device: 4096)
    args = [torch.from_numpy(a).to(card)
            for a in _sequence_arrays(4, 2, 1024, seed=6)]
    before = lstm_sequence_fused.launches
    with pytest.raises(MXNetError, match="cooperative launch"):
        lstm_sequence_fused(*args)
    assert lstm_sequence_fused.launches == before
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,hdim,sm_count,fits", [
    (16, 1024, 132, True),   # the served width: 8 units on 128 blocks
    (1, 1024, 132, True),
    (3, 200, 132, True),     # ragged: 100 blocks of 2 units
    (5, 13, 132, True),      # H % 4 != 0
    (40, 1280, 132, True),   # the chunk halves to 4 rows to fit
    (1, 1320, 132, True),    # the widest that fits on 132 SMs
    (1, 1321, 132, False),
    (16, 1536, 132, False),  # bf16 weights are staged as fp32 too
    (1, 2048, 512, True),    # more SMs fit wider layers
])
def test_sequence_plan_rule(card, n, hdim, sm_count, fits):
    nbytes = port_lstm._lib().lstm_sequence_shared_bytes(n, hdim, sm_count)
    if fits:
        assert 0 < nbytes <= port_lstm.MAX_SHARED_BYTES
    else:
        assert nbytes == -1


@pytest.mark.cuda
def test_sequence_kernel_rejects_what_it_does_not_take(card):
    args = [torch.from_numpy(a).to(card)
            for a in _sequence_arrays(3, 2, 32, seed=7)]
    with pytest.raises(MXNetError):  # mixed dtypes
        lstm_sequence_fused(args[0].double(), *args[1:])
    with pytest.raises(MXNetError):  # not contiguous
        lstm_sequence_fused(args[0], args[1], args[2],
                            args[3].t().contiguous().t())
    w = args[3].clone().requires_grad_()
    out, _, _ = lstm_sequence_fused(args[0], args[1], args[2], w)
    (dw,) = torch.autograd.grad((out.sum(),), (w,))  # a gradient flows
    assert dw.shape == w.shape and torch.isfinite(dw).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_op_launches_the_sequence_kernel_once_a_layer(card, monkeypatch,
                                                          bidirectional):
    """Each layer and direction is one launch of the sequence kernel and
    none of the per-step kernel. Both kernels' routes, on inputs at which
    the recurrence amplifies rounding, lie about as far from an fp64
    reference as the CPU's fp32 path (SUM_ORDER_FACTOR)."""
    arrays, attrs = _amplifying_lstm(bidirectional)
    directions = attrs["num_layers"] * (2 if bidirectional else 1)
    steps = arrays[0].shape[0]

    def counts():
        return lstm_sequence_fused.launches, lstm_cell_fused.launches

    before = counts()
    seq_outs = _rnn_op(arrays, attrs, card)
    torch.cuda.synchronize()
    assert counts() == (before[0] + directions, before[1])
    with monkeypatch.context() as m:  # the per-step kernel's route
        m.setattr(port_lstm, "sequence_fits", lambda n, hdim, device: False)
        before = counts()
        step_outs = _rnn_op(arrays, attrs, card)
        torch.cuda.synchronize()
        assert counts() == (before[0], before[1] + directions * steps)
    exact = _rnn_op_with_cell(monkeypatch, _cell_fp64, arrays, attrs,
                              torch.float64)
    gaps = {"cpu fp32": _gap(_rnn_op(arrays, attrs), exact),
            "sequence kernel": _gap(seq_outs, exact),
            "per-step kernel": _gap(step_outs, exact)}
    print(f"bidirectional={bidirectional}: max|d| from fp64 {gaps}")
    assert gaps["sequence kernel"] <= SUM_ORDER_FACTOR * gaps["cpu fp32"]
    assert gaps["per-step kernel"] <= SUM_ORDER_FACTOR * gaps["cpu fp32"]

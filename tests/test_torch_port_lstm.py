"""Parity of the PyTorch port's LSTM path with the JAX package.

The same numpy inputs, made from a seed, go through ``mxnet_tpu`` and
``mxnet_tpu_torch``: the fused LSTM cell (its plain version on the CPU
against the Pallas kernel in interpret mode and the jnp cell), the ``RNN``
op in every mode, and the packed-weight layout. Tests marked ``cuda`` hold
the Hopper kernel to its plain version and skip without a card. They need
neither JAX nor the JAX package, which the other tests import through the
``ref`` fixture, so on a card without JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_port_lstm.py``.
"""
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import rnn_ops as port_rnn_ops
from mxnet_tpu_torch.ops.cuda.lstm import lstm_cell_fused, lstm_cell_plain

RTOL, ATOL = 1e-5, 1e-6  # fp32 on both sides; only summation order differs


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
    with pytest.raises(MXNetError):  # no backward yet
        lstm_cell_fused(args[0], args[1], args[2], w)


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

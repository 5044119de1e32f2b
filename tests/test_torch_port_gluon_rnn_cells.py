"""Parity of the PyTorch port's Gluon recurrent cells with the JAX package.

At toy size (N=3, T=4, input and hidden width 6): each cell of
``mxnet_tpu/gluon/rnn/rnn_cell.py`` (RNN, LSTM, GRU, a Sequential stack,
Residual, Bidirectional) is unrolled under ``autograd.record()`` from the
same seeded weights and input, and its merged outputs, final states, input
gradient and parameter gradients agree with the JAX package's, imperative
and hybridized (the JAX references run imperative: the JAX package's
hybridized cells refuse a states list). A ``gluon.rnn.LSTM`` layer's
weights load by name into a stack of ``LSTMCell``s, which then gives the
layer's outputs and gradients. Dropout and Zoneout are the identity at
inference and drop or zone at their rate in training (statistics, not
bits).
"""
import contextlib
import os
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt

N, T, C, H = 3, 4, 6, 6
# fp32 on both sides: summation order differs only (measured <= 2.2e-6 at
# gradients of magnitude <= 10)
TOL = dict(rtol=1e-5, atol=1e-5)
CELLS = ("rnn", "lstm", "gru", "seq", "res", "bi")


@contextlib.contextmanager
def _no_disk_cache():
    """The JAX package's programs compiled in this process only."""
    old = os.environ.get("MXTPU_COMPILE_CACHE")
    os.environ["MXTPU_COMPILE_CACHE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["MXTPU_COMPILE_CACHE"]
        else:
            os.environ["MXTPU_COMPILE_CACHE"] = old


def _make(mx, name):
    r = mx.gluon.rnn
    if name == "rnn":
        return r.RNNCell(H, prefix="rnn_", input_size=C)
    if name == "lstm":
        return r.LSTMCell(H, prefix="lstm_", input_size=C)
    if name == "gru":
        return r.GRUCell(H, prefix="gru_", input_size=C)
    if name == "seq":
        seq = r.SequentialRNNCell(prefix="seq_")
        with seq.name_scope():
            seq.add(r.LSTMCell(H, prefix="l0_", input_size=C))
            seq.add(r.GRUCell(H, prefix="l1_", input_size=H))
        return seq
    if name == "res":
        return r.ResidualCell(r.GRUCell(H, prefix="res_", input_size=C))
    return r.BidirectionalCell(r.LSTMCell(H, prefix="bl_", input_size=C),
                               r.LSTMCell(H, prefix="br_", input_size=C))


def _run(mx, name, hybrid, weights=None):
    """One recorded unroll and backward of a sum of squares: outputs,
    states, the input's and every parameter's gradient, and the
    weights."""
    cell = _make(mx, name)
    cell.initialize(mx.init.Xavier(), ctx=mx.cpu())
    params = cell.collect_params()
    rng = np.random.RandomState(0)
    for k, p in params.items():
        value = (weights[k] if weights is not None
                 else rng.uniform(-0.5, 0.5, p.shape).astype(np.float32))
        p.set_data(mx.nd.array(value, ctx=mx.cpu()))
    if hybrid:
        cell.hybridize()
    x = mx.nd.array(np.random.RandomState(1).normal(0, 1, (N, T, C))
                    .astype(np.float32), ctx=mx.cpu())
    x.attach_grad()
    with mx.autograd.record():
        out, states = cell.unroll(T, x, layout="NTC", merge_outputs=True)
        loss = (out * out).sum()
        for s in states:
            loss = loss + (s * s).sum()
    loss.backward()
    return types.SimpleNamespace(
        cell=cell, out=out.asnumpy(), states=[s.asnumpy() for s in states],
        dx=x.grad.asnumpy(),
        grads={k: p.grad().asnumpy() for k, p in params.items()},
        weights={k: p.data().asnumpy() for k, p in params.items()})


@pytest.fixture(scope="module")
def jax_runs():
    import jax
    import mxnet_tpu
    with jax.enable_x64(False), _no_disk_cache(), mxnet_tpu.cpu():
        return {name: _run(mxnet_tpu, name, False) for name in CELLS}


@pytest.mark.parametrize("hybrid", [False, True],
                         ids=["imperative", "hybridized"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_matches_jax(jax_runs, name, hybrid):
    want = jax_runs[name]
    got = _run(mxt, name, hybrid, want.weights)
    assert sorted(got.grads) == sorted(want.grads)
    np.testing.assert_allclose(got.out, want.out, **TOL)
    assert len(got.states) == len(want.states)
    for g, w in zip(got.states, want.states):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got.dx, want.dx, **TOL)
    for k, w in want.grads.items():
        np.testing.assert_allclose(got.grads[k], w, err_msg=k, **TOL)
    if hybrid and name in ("rnn", "lstm", "gru"):
        # one cached op a (shapes, train) key, called once a step
        assert [op.calls for op in got.cell._cached_ops.values()] == [T]


def test_state_info_and_begin_state_match_jax():
    import mxnet_tpu
    for name in CELLS:
        want, got = _make(mxnet_tpu, name), _make(mxt, name)
        assert got.state_info(N) == want.state_info(N), name
        with mxt.cpu():
            states = got.begin_state(batch_size=N)
        assert [s.shape for s in states] == \
            [i["shape"] for i in want.state_info(N)], name


def test_lstm_layer_weights_load_into_a_stack_of_cells():
    """gluon.rnn.LSTM(H, num_layers=2) and a SequentialRNNCell of two
    LSTMCells named as its layers: the layer's i2h/h2h pieces load into
    the cells by name, and the stack gives the layer's outputs and
    gradients."""
    with mxt.cpu():
        layer = mxt.gluon.rnn.LSTM(H, num_layers=2, layout="NTC",
                                   input_size=C, prefix="lm_")
        layer.initialize(mxt.init.Xavier())
        stack = mxt.gluon.rnn.SequentialRNNCell(prefix="lm_")
        with stack.name_scope():
            stack.add(mxt.gluon.rnn.LSTMCell(H, input_size=C, prefix="l0_"))
            stack.add(mxt.gluon.rnn.LSTMCell(H, input_size=H, prefix="l1_"))
        stack.initialize(mxt.init.Xavier())
        layer_params = layer.collect_params()
        stack_params = stack.collect_params()
        assert sorted(layer_params) == sorted(stack_params)
        rng = np.random.RandomState(3)
        for k, p in layer_params.items():
            value = rng.uniform(-0.3, 0.3, p.shape).astype(np.float32)
            p.set_data(mxt.nd.array(value))
            stack_params[k].set_data(mxt.nd.array(value))
        x = mxt.nd.array(rng.normal(0, 1, (N, T, C)))
        results = []
        for block in (layer, stack):
            with mxt.autograd.record():
                if block is layer:
                    out = block(x)
                else:
                    out, _ = block.unroll(T, x, layout="NTC",
                                          merge_outputs=True)
                loss = (out * out).sum()
            loss.backward()
            results.append((out.asnumpy(), {
                k: p.grad().asnumpy()
                for k, p in block.collect_params().items()}))
    (lo, lg), (so, sg) = results
    np.testing.assert_allclose(so, lo, **TOL)
    for k in lg:
        np.testing.assert_allclose(sg[k], lg[k], err_msg=k, **TOL)


def _modified_unroll(kind, train, rate, n=256):
    """A modifier (Zoneout over an LSTM cell, or Dropout in front of one)
    and the bare cell, unrolled over ones from the same weights: the two
    merged outputs."""
    outs = []
    x = mxt.nd.ones((n, T, C), ctx=mxt.cpu())
    weights = None
    for modified in (True, False):
        base = mxt.gluon.rnn.LSTMCell(H, input_size=C, prefix="m_")
        cell = base
        if modified and kind == "zoneout":
            cell = mxt.gluon.rnn.ZoneoutCell(base, zoneout_outputs=rate,
                                             zoneout_states=rate)
        elif modified:
            cell = mxt.gluon.rnn.SequentialRNNCell()
            cell.add(mxt.gluon.rnn.DropoutCell(rate))
            cell.add(base)
        cell.initialize(mxt.init.Xavier(), ctx=mxt.cpu())
        params = base.collect_params()
        if weights is None:
            mxt.random.seed(1)
            weights = {k: p.data().asnumpy() for k, p in params.items()}
        for k, p in params.items():
            p.set_data(mxt.nd.array(weights[k], ctx=mxt.cpu()))
        mxt.random.seed(0)
        with mxt.autograd.record(train_mode=train):
            out, _ = cell.unroll(T, x, layout="NTC", merge_outputs=True)
        outs.append(out.asnumpy())
    return outs


@pytest.mark.parametrize("kind", ["dropout", "zoneout"])
def test_dropout_and_zoneout_are_the_identity_at_inference(kind):
    modified, bare = _modified_unroll(kind, False, 0.5)
    np.testing.assert_array_equal(modified, bare)


def test_dropout_cell_drops_at_its_rate_in_training():
    cell = mxt.gluon.rnn.DropoutCell(0.3)
    x = mxt.nd.ones((256, T, C), ctx=mxt.cpu())
    mxt.random.seed(0)
    with mxt.autograd.record():
        out, states = cell.unroll(T, x, layout="NTC", merge_outputs=True)
    got = out.asnumpy()
    assert states == []
    assert set(np.unique(got)) <= {0.0, np.float32(1 / 0.7)}
    kept = (got != 0).mean()
    assert abs(kept - 0.7) < 0.03, kept  # 6144 draws: 4.9 standard errors


def test_zoneout_keeps_the_previous_output_at_its_rate_in_training():
    """Each first-step output unit is the fresh step's or the zeros before
    it, the zeros with probability p (1536 draws: 4.8 standard errors)."""
    rate = 0.4
    zoned, bare = _modified_unroll("zoneout", True, rate)
    first_zero = zoned[:, 0] == 0
    assert ((zoned[:, 0] == bare[:, 0]) | first_zero).all()
    assert abs(first_zero.mean() - rate) < 0.06, first_zero.mean()

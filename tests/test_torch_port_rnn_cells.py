"""Parity of the PyTorch port's symbolic RNN cells with the JAX package.

At toy size (N=3, T=4, input and hidden width 6): every cell of
``mxnet_tpu/rnn/rnn_cell.py`` (RNN with tanh and relu, LSTM, GRU, a
Sequential stack, Residual, Bidirectional, and the fused cell at 2 layers
and bidirectional) is unrolled over one shared input into one grouped
symbol, bound in each package and run forward and backward once from the
same seeded weights and head gradients: the argument names, the outputs,
the final states and every gradient agree (the JAX package's executor
compiles the group once). ``FusedRNNCell.unfuse()`` gives the fused
stack's outputs and gradients through ``unpack_weights`` and
``pack_weights``, which convert as the JAX package's do. Dropout and
Zoneout are the identity at inference and drop or zone at their rate in
training (statistics, not bits).
"""
import contextlib
import os
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt

N, T, C, H = 3, 4, 6, 6
# fp32 on both sides: summation order differs only (measured <= 1.5e-6 at
# gradients of magnitude <= 10)
TOL = dict(rtol=1e-5, atol=1e-5)
# the cells of the grouped symbol, by the prefix of their parameters
CELLS = ("rnnt_", "rnnr_", "lstm_", "gru_", "seq", "res_", "bi", "fl_",
         "fb_")


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


def _cells(mx):
    """{prefix: cell} for each entry of CELLS."""
    r = mx.rnn
    seq = r.SequentialRNNCell()
    seq.add(r.LSTMCell(H, prefix="seq0_"))
    seq.add(r.GRUCell(H, prefix="seq1_"))
    return {
        "rnnt_": r.RNNCell(H, activation="tanh", prefix="rnnt_"),
        "rnnr_": r.RNNCell(H, activation="relu", prefix="rnnr_"),
        "lstm_": r.LSTMCell(H, prefix="lstm_"),
        "gru_": r.GRUCell(H, prefix="gru_"),
        "seq": seq,
        "res_": r.ResidualCell(r.GRUCell(H, prefix="res_")),
        "bi": r.BidirectionalCell(r.LSTMCell(H, prefix="bil_"),
                                  r.LSTMCell(H, prefix="bir_"),
                                  output_prefix="bi_"),
        "fl_": r.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="fl_"),
        "fb_": r.FusedRNNCell(H, mode="lstm", bidirectional=True,
                              prefix="fb_", get_next_state=True),
    }


def _group_run(mx, weights=None):
    """The grouped unroll of every cell: (argument names, weights, heads
    by cell, gradients); the weights drawn from a seed unless given."""
    data = mx.sym.var("data")
    heads, owner = [], []
    for name, cell in _cells(mx).items():
        out, states = cell.unroll(T, data, layout="NTC", merge_outputs=True)
        heads += [out] + list(states)
        owner += [name] * (1 + len(states))
    group = mx.sym.Group(heads)
    ex = group.simple_bind(ctx=mx.cpu(), grad_req="write", data=(N, T, C))
    rng = np.random.RandomState(0)
    if weights is None:
        weights = {k: rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
                   for k, v in ex.arg_dict.items()}
    for k, v in weights.items():
        ex.arg_dict[k][:] = v
    outs = ex.forward(is_train=True)
    cots = [mx.nd.array(np.random.RandomState(i).normal(0, 1, o.shape)
                        .astype(np.float32), ctx=mx.cpu())
            for i, o in enumerate(outs)]
    ex.backward(cots)
    by_cell = {}
    for name, o in zip(owner, outs):
        by_cell.setdefault(name, []).append(o.asnumpy())
    return types.SimpleNamespace(
        args=group.list_arguments(), weights=weights, heads=by_cell,
        grads={k: v.asnumpy() for k, v in ex.grad_dict.items()})


@pytest.fixture(scope="module")
def runs():
    import jax
    import mxnet_tpu
    with jax.enable_x64(False), _no_disk_cache():
        want = _group_run(mxnet_tpu)
    return want, _group_run(mxt, want.weights)


def test_grouped_unroll_has_the_jax_packages_arguments(runs):
    want, got = runs
    assert got.args == want.args


@pytest.mark.parametrize("cell", CELLS)
def test_cell_unroll_matches_jax(runs, cell):
    """One cell's merged outputs, final states and parameter gradients
    through the executor, against the JAX package's."""
    want, got = runs
    assert [h.shape for h in got.heads[cell]] == \
        [h.shape for h in want.heads[cell]]
    for g, w in zip(got.heads[cell], want.heads[cell]):
        np.testing.assert_allclose(g, w, **TOL)
    names = [k for k in want.grads if k.startswith(cell)]
    assert names
    for k in names:
        np.testing.assert_allclose(got.grads[k], want.grads[k], err_msg=k,
                                   **TOL)


def test_input_gradient_matches_jax(runs):
    want, got = runs
    np.testing.assert_allclose(got.grads["data"], want.grads["data"], **TOL)


def test_cell_state_info_and_begin_state_match_jax():
    import mxnet_tpu
    want_cells, got_cells = _cells(mxnet_tpu), _cells(mxt)
    for name in CELLS:
        want, got = want_cells[name], got_cells[name]
        assert got.state_info == want.state_info, name
        assert got.state_shape == want.state_shape, name
        assert ([s.name for s in got.begin_state()]
                == [s.name for s in want.begin_state()]), name


def _unfuse_case(mode, bidirectional):
    """A 2-layer fused cell, its unfused twin with the fused weights
    carried over by unpack_weights, both run forward and backward on the
    port: (outputs, packed gradients) of each."""
    fused = mxt.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                 bidirectional=bidirectional, prefix="f_")
    data = mxt.sym.var("data")
    rng = np.random.RandomState(5)
    x = rng.normal(0, 1, (N, T, C)).astype(np.float32)
    cot = None
    results = []
    blob = None
    for cell in (fused, fused.unfuse()):
        out, _ = cell.unroll(T, data, layout="NTC", merge_outputs=True)
        ex = out.simple_bind(ctx=mxt.cpu(), grad_req="write", data=(N, T, C))
        if blob is None:
            blob = rng.uniform(-0.5, 0.5, ex.arg_dict["f_parameters"].shape)
            args = {"f_parameters": mxt.nd.array(blob, ctx=mxt.cpu())}
        else:
            args = fused.unpack_weights(
                {"f_parameters": mxt.nd.array(blob, ctx=mxt.cpu())})
        for k, v in args.items():
            ex.arg_dict[k][:] = v
        ex.arg_dict["data"][:] = x
        (o,) = ex.forward(is_train=True)
        if cot is None:
            cot = rng.normal(0, 1, o.shape).astype(np.float32)
        ex.backward([mxt.nd.array(cot, ctx=mxt.cpu())])
        grads = {k: v for k, v in ex.grad_dict.items() if k != "data"}
        if "f_parameters" not in grads:
            grads = fused.pack_weights(grads)
        results.append((o.asnumpy(), grads["f_parameters"].asnumpy(),
                        ex.grad_dict["data"].asnumpy()))
    return results


@pytest.mark.parametrize("mode,bidirectional", [
    ("lstm", False), ("gru", False), ("rnn_tanh", False), ("lstm", True)],
    ids=["lstm", "gru", "rnn_tanh", "bidirectional"])
def test_unfuse_matches_the_fused_cell(mode, bidirectional):
    """The unfused stack (cells named as the fused cell's unpacked
    weights) gives the fused cell's outputs and, packed back, its
    parameter gradient, and the same input gradient."""
    (fo, fg, fx), (uo, ug, ux) = _unfuse_case(mode, bidirectional)
    np.testing.assert_allclose(uo, fo, **TOL)
    np.testing.assert_allclose(ug, fg, **TOL)
    np.testing.assert_allclose(ux, fx, **TOL)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_relu"])
def test_pack_and_unpack_weights_match_jax(mode):
    """unpack_weights of a fused blob and of a dense cell's i2h/h2h, and
    pack_weights back, name and slice as the JAX package's."""
    import mxnet_tpu
    rng = np.random.RandomState(1)
    size = mxt.ops.rnn_ops.rnn_param_size(2, C, H, mode, False)
    blob = rng.normal(0, 1, (size,)).astype(np.float32)

    def unpacked(mx):
        fused = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode, prefix="f_")
        pieces = fused.unpack_weights(
            {"f_parameters": mx.nd.array(blob, ctx=mx.cpu())})
        stack = fused.unfuse()
        gates = stack.unpack_weights(dict(pieces))
        packed = fused.pack_weights(stack.pack_weights(dict(gates)))
        return ({k: v.asnumpy() for k, v in pieces.items()},
                {k: v.asnumpy() for k, v in gates.items()},
                packed["f_parameters"].asnumpy())

    got, want = unpacked(mxt), unpacked(mxnet_tpu)
    for g, w in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_array_equal(got[2], blob)
    np.testing.assert_array_equal(want[2], blob)


def _modifier_run(kind, is_train, rate, seed=0):
    """A modifier over an LSTM cell (or a dropout cell alone) and the bare
    cell, unrolled over ones from the same weights: (modified outputs,
    bare outputs)."""
    data = mxt.sym.var("data")
    outs = []
    for modified in (True, False):
        base = mxt.rnn.LSTMCell(H, prefix="m_")
        if not modified:
            cell = base
        elif kind == "zoneout":
            cell = mxt.rnn.ZoneoutCell(base, zoneout_outputs=rate,
                                       zoneout_states=rate)
        else:
            cell = mxt.rnn.SequentialRNNCell()
            cell.add(mxt.rnn.DropoutCell(rate, prefix="d_"))
            cell.add(base)
        out, _ = cell.unroll(T, data, layout="NTC", merge_outputs=True)
        ex = out.simple_bind(ctx=mxt.cpu(), grad_req="null",
                             data=(256, T, C))
        rng = np.random.RandomState(2)
        for k, v in ex.arg_dict.items():
            v[:] = (np.ones(v.shape, np.float32) if k == "data"
                    else rng.uniform(-0.5, 0.5, v.shape))
        mxt.random.seed(seed)
        outs.append(ex.forward(is_train=is_train)[0].asnumpy())
    return outs


@pytest.mark.parametrize("kind", ["dropout", "zoneout"])
def test_dropout_and_zoneout_are_the_identity_at_inference(kind):
    modified, bare = _modifier_run(kind, False, 0.5)
    np.testing.assert_array_equal(modified, bare)


def test_dropout_cell_drops_at_its_rate_in_training():
    """DropoutCell before the LSTM in training: its Dropout op keeps each
    input unit with probability 1 - p, scaled by 1 / (1 - p)."""
    data = mxt.sym.var("data")
    cell = mxt.rnn.DropoutCell(0.3, prefix="d_")
    out, _ = cell.unroll(T, data, layout="NTC", merge_outputs=True)
    ex = out.simple_bind(ctx=mxt.cpu(), grad_req="null", data=(256, T, C))
    ex.arg_dict["data"][:] = 1.0
    mxt.random.seed(0)
    got = ex.forward(is_train=True)[0].asnumpy()
    assert set(np.unique(got)) <= {0.0, np.float32(1 / 0.7)}
    kept = (got != 0).mean()
    assert abs(kept - 0.7) < 0.03, kept  # 6144 draws: 4.9 standard errors


def test_zoneout_keeps_the_previous_output_at_its_rate_in_training():
    """ZoneoutCell in training: each output unit is the fresh step's or the
    previous step's (zeros before the first), the fresh one with
    probability 1 - p; the bare cell's first step is never zero here."""
    rate = 0.4
    zoned, bare = _modifier_run("zoneout", True, rate)
    first_fresh = zoned[:, 0] == bare[:, 0]
    first_zero = zoned[:, 0] == 0
    assert (first_fresh | first_zero).all()
    assert abs(first_zero.mean() - rate) < 0.06, first_zero.mean()

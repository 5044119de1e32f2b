"""Parity of the port's in-flight decode batcher with the JAX package.

One LSTM decode step, built by ``mxnet_tpu.rnn.LSTMCell`` (H=16, input
8, a FullyConnected head of 5) and grouped with its next states, is
saved as symbol JSON; both packages load it with the same ``.params``
into a forward-only ``Module`` at capacity 4 and serve it through
``Module.as_decode_backend`` and ``InflightBatcher`` under
``MXTPU_RETRACE_STRICT=1``. Sequences join, leave and churn between
steps; a fifth join meets ``SlotsFull``. Each package's outputs must
equal its own solo decode of each sequence bit for bit (rows are
computed independently at a fixed capacity), the two packages must
agree within ``TOL``, and the batchers' ``stats()`` must agree key for
key and value for value.
"""
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt

CAP, DIM, H, OUT = 4, 8, 16, 5
# fp32 products of at most 16 terms and the gate nonlinearities, over
# 6 recurrent steps: summation order and libm only
TOL = 1e-6
# which sequences feed at each step; a slot joins at its first feed and
# leaves after its last
SCHEDULE = [("A", "B"), ("A", "B"), ("A", "B", "C"), ("B", "C"),
            ("B", "C", "D"), ("C", "D")]


def _step_symbol_json():
    import mxnet_tpu as mx
    with mx.sym.NameManager():
        cell = mx.rnn.LSTMCell(H, prefix="dec_")
        out, (nh, nc) = cell(mx.sym.var("data"),
                             [mx.sym.var("h"), mx.sym.var("c")])
        logits = mx.sym.FullyConnected(out, name="proj", num_hidden=OUT)
        return mx.sym.Group([logits, nh, nc]).tojson()


def _params():
    rng = np.random.RandomState(11)
    shapes = {"dec_i2h_weight": (4 * H, DIM), "dec_i2h_bias": (4 * H,),
              "dec_h2h_weight": (4 * H, H), "dec_h2h_bias": (4 * H,),
              "proj_weight": (OUT, H), "proj_bias": (OUT,)}
    return {k: (rng.randn(*s) * 0.3).astype(np.float32)
            for k, s in shapes.items()}


def _tokens():
    rng = np.random.RandomState(5)
    return {name: [rng.rand(DIM).astype(np.float32) for _ in SCHEDULE]
            for name in "ABCD"}


def _module(mx, ctx, symbol_json, params_file):
    mod = mx.mod.Module(mx.sym.load_json(symbol_json),
                        data_names=["data", "h", "c"], label_names=[],
                        context=ctx)
    mod.bind(data_shapes=[("data", (CAP, DIM)), ("h", (CAP, H)),
                          ("c", (CAP, H))], for_training=False)
    loaded = mx.nd.load(params_file, ctx=ctx) if mx is mxt \
        else mx.nd.load(params_file)
    mod.set_params({k[4:]: v for k, v in loaded.items()}, {})
    return mod


def _decode(mx, mod):
    """The churned schedule, then each sequence alone; returns the
    outputs by sequence, the solo outputs, the stats and the typed
    errors."""
    serving = mx.serving
    batcher = serving.InflightBatcher(mod.as_decode_backend(["h", "c"]),
                                      name="decode").warm_up()
    toks = _tokens()
    last = {n: max(i for i, s in enumerate(SCHEDULE) if n in s)
            for n in "ABCD"}
    slots, got, errors = {}, {n: [] for n in "ABCD"}, []
    for t, fed in enumerate(SCHEDULE):
        for name in fed:
            if name not in slots:
                slots[name] = batcher.join()
        outs = batcher.step({slots[n]: {"data": toks[n][len(got[n])]}
                             for n in fed})
        for name in fed:
            got[name].append(outs[slots[name]][0])
            if last[name] == t:
                batcher.leave(slots.pop(name))
        if t == 4:   # full: a fifth sequence cannot join
            extra = [batcher.join() for _ in range(CAP - len(slots))]
            try:
                batcher.join()
            except serving.SlotsFull as err:
                errors.append(type(err).__name__)
            for s in extra:
                batcher.leave(s)
    stats = batcher.stats()
    solo = {}
    for name in "ABCD":
        alone = serving.InflightBatcher(
            mod.as_decode_backend(["h", "c"]), name="solo").warm_up()
        s = alone.join()
        solo[name] = [alone.step({s: {"data": tok}})[s][0]
                      for tok in toks[name][:len(got[name])]]
    return types.SimpleNamespace(got=got, solo=solo, stats=stats,
                                 errors=errors)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import mxnet_tpu
    params_file = str(tmp_path_factory.mktemp("slots") / "step.params")
    mxnet_tpu.nd.save(params_file, {"arg:" + k: mxnet_tpu.nd.array(v)
                                    for k, v in _params().items()})
    symbol_json = _step_symbol_json()
    mp = pytest.MonkeyPatch()
    mp.setenv("MXTPU_RETRACE_STRICT", "1")
    try:
        with jax.enable_x64(False):
            theirs = _decode(mxnet_tpu, _module(
                mxnet_tpu, mxnet_tpu.cpu(), symbol_json, params_file))
        mine = _decode(mxt, _module(mxt, mxt.cpu(), symbol_json,
                                    params_file))
    finally:
        mp.undo()
    return types.SimpleNamespace(jax=theirs, port=mine)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_churned_decode_is_bitwise_its_solo_decode(runs, pkg):
    run = getattr(runs, pkg)
    for name in "ABCD":
        assert len(run.got[name]) == sum(name in s for s in SCHEDULE)
        for a, b in zip(run.got[name], run.solo[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_decode_matches_jax_package(runs):
    for name in "ABCD":
        for a, b in zip(runs.port.got[name], runs.jax.got[name]):
            assert a.shape == b.shape == (OUT,)
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                       err_msg=name)


def test_batcher_stats_and_errors_match_jax_package(runs):
    assert runs.port.errors == runs.jax.errors == ["SlotsFull"]
    assert runs.port.stats == runs.jax.stats
    assert runs.port.stats["retraced"] is False
    assert runs.port.stats["steps"] == len(SCHEDULE)


def test_module_step_backend_validation():
    net = mxt.sym.FullyConnected(mxt.sym.var("data"), num_hidden=2)
    mod = mxt.mod.Module(net, label_names=[], context=mxt.cpu())
    mod.bind(data_shapes=[("data", (2, 3))], for_training=False)
    with pytest.raises(mxt.MXNetError):
        mod.as_decode_backend(["h"])

"""Parity of the PyTorch port's Gluon blocks and layers with the JAX
package.

The cases of ``tests/test_gluon.py`` (parameters and parameter dicts,
sharing, hybridized consistency of outputs and gradients, deferred init
through convolutions and BatchNorm, BatchNorm's moving statistics, the
pooling layers' shapes, Embedding, every loss, attribute registration,
``split_and_load``, ``clip_global_norm``, the lambda blocks), and beside
them ``SymbolBlock``, the RNN layers and the cached ops a hybridized
block builds, run through ``mxnet_tpu`` and ``mxnet_tpu_torch`` on the CPU
from the same seeded inputs and initializers (both draw the same bits
after ``mx.random.seed``), and their results are held to each other.
Every JAX run happens once, in a module-scope fixture, with x64 off as
users run the JAX package. The layers' values and the attention layer
are in ``tests/test_torch_port_gluon_layers.py``, the Trainer's cases in
``tests/test_torch_port_gluon_trainer.py``.
"""
import contextlib
import os
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError

# fp32 on both sides, only summation order differs: held at 1e-5 of each
# result's largest magnitude
REL = 1e-5


@contextlib.contextmanager
def _jax_package():
    """The JAX package as users run it: x64 off, on the CPU; its
    persistent compile cache (a directory the test session shares across
    workers) off, so that its fused Trainer update compiles in this
    process."""
    import jax
    import mxnet_tpu
    old = os.environ.get("MXTPU_COMPILE_CACHE")
    os.environ["MXTPU_COMPILE_CACHE"] = "0"
    try:
        with jax.enable_x64(False), mxnet_tpu.cpu():
            yield
    finally:
        if old is None:
            del os.environ["MXTPU_COMPILE_CACHE"]
        else:
            os.environ["MXTPU_COMPILE_CACHE"] = old


@pytest.fixture(scope="module")
def ref():
    import jax
    import mxnet_tpu
    return types.SimpleNamespace(jax=jax, mx=mxnet_tpu)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = REL * max(float(np.abs(want).max()) if want.size else 0.0, 1e-6)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, f"{what}: max |err| {err:.3g} > {tol:.3g}"


def _params(net, grads=False):
    return {(k + ".grad" if grads else k): (p.grad() if grads else p.data())
            .asnumpy() for k, p in net.collect_params().items()
            if not grads or p.grad_req != "null"}


def _data(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


# -- scenarios: each takes a package and whether to hybridize, and returns
# named numpy results


def _conv_bn(mx, hybrid):
    """Deferred init through a convolution, BatchNorm (its moving
    statistics move in training only), pooling and Dense."""
    mx.random.seed(1)
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="cbn_")
    with net.name_scope():
        net.add(nn.Conv2D(8, kernel_size=3, padding=1, activation="relu"),
                nn.BatchNorm(),
                nn.MaxPool2D(),
                nn.GlobalAvgPool2D(),
                nn.Flatten(),
                nn.Dense(10))
    net.initialize(mx.init.Xavier())
    if hybrid:
        net.hybridize()
    x = mx.nd.array(_data((3, 3, 8, 8), 3, shift=0.5))
    out = {"eval": net(x).asnumpy(),
           "weight shape": np.array(net[0].weight.shape)}
    with mx.autograd.record():
        y = net(x)
    y.backward(mx.nd.array(_data((3, 10), 4)))
    out["train"] = y.asnumpy()
    out.update(_params(net))
    out.update(_params(net, grads=True))
    out["eval after"] = net(x).asnumpy()
    return out


def _embedding(mx, hybrid):
    mx.random.seed(2)
    layer = mx.gluon.nn.Embedding(10, 5, prefix="emb_")
    layer.initialize()
    if hybrid:
        layer.hybridize()
    x = mx.nd.array([2, 4, 6, 2])
    with mx.autograd.record():
        out = layer(x)
    out.backward(mx.nd.array(_data((4, 5), 8)))
    return {"out": out.asnumpy(), "grad": layer.weight.grad().asnumpy()}


class _AllLosses:
    """Every loss class (with its options) in one block, so that the JAX
    package runs them as one program: the output stacks every loss's
    per-sample values, and a seeded cotangent mixes every loss's gradient
    with respect to the prediction."""

    @staticmethod
    def make(mx):
        loss = mx.gluon.loss

        class AllLosses(mx.gluon.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                self.fns = [
                    loss.SoftmaxCrossEntropyLoss(),
                    loss.SoftmaxCrossEntropyLoss(sparse_label=False,
                                                 weight=0.5),
                    loss.L2Loss(), loss.L1Loss(),
                    loss.SigmoidBinaryCrossEntropyLoss(),
                    loss.SigmoidBCELoss(from_sigmoid=True),
                    loss.KLDivLoss(), loss.KLDivLoss(from_logits=False),
                    loss.HuberLoss(rho=0.5), loss.HingeLoss()]

            def hybrid_forward(self, F, pred, idx, dense, signs, weight):
                prob = F.softmax(dense)
                binary = dense > 0.5
                f = self.fns
                return F.stack(
                    f[0](pred, idx), f[1](pred, prob, weight),
                    f[2](pred, dense), f[3](pred, dense, weight),
                    f[4](pred, binary), f[5](F.sigmoid(pred), binary),
                    f[6](F.log_softmax(pred), prob), f[7](pred, prob),
                    f[8](pred, dense), f[9](pred, signs), axis=0)

        return AllLosses(prefix="losses_")


def _losses(mx, hybrid):
    block = _AllLosses.make(mx)
    if hybrid:
        block.hybridize()
    pred = mx.nd.array(_data((4, 10), 9))
    inputs = [mx.nd.array(np.array([1, 0, 7, 3], dtype=np.float32)),
              mx.nd.array(np.random.RandomState(10).rand(4, 10)
                          .astype(np.float32)),
              mx.nd.array(np.sign(_data((4, 10), 11))),
              mx.nd.array(np.array([[0.5], [1.0], [2.0], [0.0]],
                                   dtype=np.float32))]
    pred.attach_grad()
    with mx.autograd.record():
        values = block(pred, *inputs)
    values.backward(mx.nd.array(_data((10, 4), 12)))
    return {"values": values.asnumpy(), "grad": pred.grad.asnumpy()}


def _cached_ops(mx, hybrid):
    """One cached op a (shapes, dtypes, is_train) key: two shapes in
    predict mode and one in train mode make three."""
    mx.random.seed(5)
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="cache_")
    with net.name_scope():
        net.add(nn.Dense(4, in_units=8), nn.Dropout(0.0))
    net.initialize()
    net.hybridize()
    outs = [net(mx.nd.array(_data((n, 8), 22))).asnumpy() for n in (2, 3, 2)]
    with mx.autograd.record():
        net(mx.nd.array(_data((2, 8), 22)))
    return {"n": np.array(len(net._cached_ops)), "out": outs[2],
            "keys": np.array(sorted(int(k[1]) for k in net._cached_ops))}


def _sharing_and_registration(mx, hybrid):
    nn = mx.gluon.nn

    class Net(mx.gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.dense0 = nn.Dense(5, in_units=5)
                self.dense1 = nn.Dense(5, in_units=5)
                self.extra = mx.gluon.Parameter("extra", shape=(2, 2))

        def forward(self, x):
            return self.dense1(self.dense0(x))

    mx.random.seed(6)
    net1 = Net(prefix="net1_")
    net2 = Net(prefix="net2_", params=net1.collect_params())
    net1.collect_params().initialize()
    x = mx.nd.array(_data((3, 5), 23))
    return {"out1": net1(x).asnumpy(), "out2": net2(x).asnumpy(),
            "names": np.array(sorted(net1.collect_params().keys()))}


def _utils(mx, hybrid):
    data = mx.nd.array(np.arange(24, dtype=np.float32).reshape(6, 4))
    splits = mx.gluon.utils.split_data(data, 3)
    uneven = mx.gluon.utils.split_data(data, 4, even_split=False)
    loaded = mx.gluon.utils.split_and_load(data, [mx.cpu(0)])
    arrays = [mx.nd.ones((3, 3)) * 2, mx.nd.ones((2,)) * 3]
    norm = mx.gluon.utils.clip_global_norm(arrays, 1.0)
    lam = mx.gluon.nn.Sequential()
    lam.add(mx.gluon.nn.Lambda("tanh"),
            mx.gluon.nn.HybridLambda(lambda F, x: F.relu(x)))
    return {"split1": splits[1].asnumpy(), "uneven3": uneven[3].asnumpy(),
            "loaded": loaded[0].asnumpy(), "norm": np.array(norm),
            "clipped0": arrays[0].asnumpy(), "clipped1": arrays[1].asnumpy(),
            "lambda": lam(mx.nd.array(_data((2, 3), 24))).asnumpy()}


SCENARIOS = {f.__name__[1:]: f for f in (
    _conv_bn, _embedding, _losses, _cached_ops, _sharing_and_registration,
    _utils)}


@pytest.fixture(scope="module")
def jax_runs(ref):
    """Every scenario through the JAX package, hybridized: one program a
    block and call signature, the cheapest way to its numbers, which its
    imperative path gives too (tests/test_gluon.py:
    test_hybridize_consistency)."""
    with _jax_package():
        return {name: f(ref.mx, True) for name, f in SCENARIOS.items()}


@pytest.fixture(scope="module")
def port_runs():
    """Every scenario through the port on the CPU, imperative and
    hybridized."""
    with mxt.cpu():
        return {(name, hybrid): f(mxt, hybrid)
                for name, f in SCENARIOS.items() for hybrid in (False, True)}


@pytest.mark.parametrize("hybrid", [False, True],
                         ids=["imperative", "hybridized"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gluon_matches_jax(jax_runs, port_runs, name, hybrid):
    got = port_runs[name, hybrid]
    want = jax_runs[name]
    assert sorted(got) == sorted(want)
    for key in want:
        if want[key].dtype.kind in "US":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            _close(got[key], want[key], f"{name}: {key}")


def test_hybridized_matches_imperative(port_runs):
    """The hybridized block's outputs, gradients and updates are the
    imperative ones bit for bit: the cached op runs the same body."""
    for name in ("conv_bn", "losses"):
        imp, hyb = port_runs[name, False], port_runs[name, True]
        for key in imp:
            np.testing.assert_array_equal(hyb[key], imp[key],
                                          err_msg=f"{name}: {key}")


def test_cached_ops_write_back_moving_statistics():
    """A hybridized block's training cached op writes BatchNorm's moving
    statistics back into their parameters (its ``aux_update``); its
    predict-mode one writes nothing."""
    nn = mxt.gluon.nn
    with mxt.cpu():
        net = nn.HybridSequential(prefix="aux_")
        with net.name_scope():
            net.add(nn.Conv2D(4, 3, in_channels=3), nn.BatchNorm(in_channels=4))
        net.initialize()
        net.hybridize()
        x = mxt.nd.array(_data((2, 3, 6, 6), 60))
        net(x)
        mean0 = net[1].running_mean.data().asnumpy()
        with mxt.autograd.record():
            net(x)
        ops = {key[1]: op for key, op in net._cached_ops.items()}
        assert ops[False].aux_update == []
        assert ops[True].aux_update == ["aux_batchnorm0_running_mean",
                                        "aux_batchnorm0_running_var"]
        assert (net[1].running_mean.data().asnumpy() != mean0).all()
        assert [op.calls for op in ops.values()] == [1, 1]


def test_symbol_block_runs_the_symbol():
    """A SymbolBlock over a symbol gives the bound executor's outputs and
    parameter gradients. (The JAX package's SymbolBlock names its
    parameters with the block's prefix and looks them up by those names
    in the graph, so it cannot run this.)"""
    mx = mxt
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    act = mx.sym.Activation(fc, act_type="tanh", name="act")
    block = mx.gluon.SymbolBlock(act, data)
    values = {"fc_weight": _data((3, 5), 19), "fc_bias": _data((3,), 20),
              "data": _data((4, 5), 21)}
    with mx.cpu():
        params = block.collect_params()
        for name, p in params.items():
            p.set_data(mx.nd.array(values[name[len(params.prefix):]]))
        with mx.autograd.record():
            y = block(mx.nd.array(values["data"]))
        y.backward()
        exe = act.simple_bind(ctx=mx.cpu(), data=(4, 5))
        for name, value in values.items():
            exe.arg_dict[name][:] = value
        exe.forward(is_train=True)
        exe.backward(mx.nd.ones((4, 3)))
        np.testing.assert_allclose(y.asnumpy(), exe.outputs[0].asnumpy(),
                                   rtol=1e-6)
        for name, p in params.items():
            np.testing.assert_allclose(
                p.grad().asnumpy(),
                exe.grad_dict[name[len(params.prefix):]].asnumpy(),
                rtol=1e-6)


def test_rnn_layers_run_the_rnn_op():
    """GRU (NTC, two layers) and a bidirectional tanh RNN through Gluon
    give the RNN op's outputs and gradients over the layers' pieces packed
    in the op's order (convert.pack_rnn_pieces): Concat's backward splits
    the packed gradient back into the pieces'. (The LSTM layer is held to
    the JAX package in tests/test_torch_port_gluon_lm.py.)"""
    rnn = mxt.gluon.rnn
    with mxt.cpu():
        for i, (layer, mode, layers, bi, layout) in enumerate((
                (rnn.GRU(6, num_layers=2, layout="NTC"), "gru", 2, False,
                 "NTC"),
                (rnn.RNN(6, activation="tanh", bidirectional=True),
                 "rnn_tanh", 1, True, "TNC"))):
            mxt.random.seed(30 + i)
            layer.initialize(mxt.init.Xavier())
            x = _data((3, 4, 5), 40 + i)
            with mxt.autograd.record():
                y = layer(mxt.nd.array(x))
            cot = _data(y.shape, 50 + i)
            y.backward(mxt.nd.array(cot))
            params = layer.collect_params()
            pieces = {k[len(params.prefix):]: p.data()
                      for k, p in params.items()}
            flat = mxt.nd.array(mxt.convert.pack_rnn_pieces(pieces, layers,
                                                            bi))
            flat.attach_grad()
            tnc = x.transpose(1, 0, 2) if layout == "NTC" else x
            state = mxt.nd.zeros((layers * (2 if bi else 1), tnc.shape[1],
                                  6))
            with mxt.autograd.record():
                out = mxt.nd.RNN(mxt.nd.array(tnc), flat, state,
                                 state_size=6, num_layers=layers, mode=mode,
                                 bidirectional=bi)
            tnc_cot = cot.transpose(1, 0, 2) if layout == "NTC" else cot
            out.backward(mxt.nd.array(tnc_cot))
            want = out.asnumpy()
            if layout == "NTC":
                want = want.transpose(1, 0, 2)
            np.testing.assert_allclose(y.asnumpy(), want, rtol=1e-6,
                                       atol=1e-7)
            grads = {k[len(params.prefix):]: p.grad()
                     for k, p in params.items()}
            np.testing.assert_allclose(
                mxt.convert.pack_rnn_pieces(grads, layers, bi),
                flat.grad.asnumpy(), rtol=1e-5, atol=1e-7)


def test_layer_shapes():
    """tests/test_gluon.py's shape cases (conv, transposed conv and
    pooling layers in 1-3 D, ceil mode), and the channel-last layouts'."""
    nn = mxt.gluon.nn
    with mxt.cpu():
        x1 = mxt.nd.zeros((1, 4, 10))
        x2 = mxt.nd.zeros((1, 4, 10, 10))
        x3 = mxt.nd.zeros((1, 4, 6, 6, 6))
        for layer, x, want in (
                (nn.Conv1D(6, 3), x1, (1, 6, 8)),
                (nn.Conv2D(6, (3, 3), strides=2), x2, (1, 6, 4, 4)),
                (nn.Conv3D(2, 3, padding=1), x3, (1, 2, 6, 6, 6)),
                (nn.Conv1DTranspose(6, 3), x1, (1, 6, 12)),
                (nn.Conv2DTranspose(6, (3, 3), strides=2, output_padding=1),
                 x2, (1, 6, 22, 22)),
                (nn.Conv3DTranspose(2, 2, strides=2), x3, (1, 2, 12, 12, 12)),
                (nn.MaxPool1D(2), x1, (1, 4, 5)),
                (nn.AvgPool2D((2, 2)), x2, (1, 4, 5, 5)),
                (nn.AvgPool3D(2), x3, (1, 4, 3, 3, 3)),
                (nn.MaxPool2D(3, ceil_mode=False), x2, (1, 4, 3, 3)),
                (nn.MaxPool2D(3, ceil_mode=True), x2, (1, 4, 4, 4)),
                (nn.GlobalAvgPool2D(), x2, (1, 4, 1, 1)),
                (nn.GlobalMaxPool1D(), x1, (1, 4, 1)),
                (nn.Conv2D(6, 3, layout="NHWC"), mxt.nd.zeros((1, 10, 10, 4)),
                 (1, 8, 8, 6)),
                (nn.MaxPool2D(2, layout="NHWC"), mxt.nd.zeros((1, 10, 10, 4)),
                 (1, 5, 5, 4)),
                (nn.GlobalAvgPool2D(layout="NHWC"),
                 mxt.nd.zeros((1, 10, 10, 4)), (1, 1, 1, 4))):
            layer.initialize()
            assert layer(x).shape == want, layer


def test_parameter_access_and_deferred_init():
    with mxt.cpu():
        p = mxt.gluon.Parameter("weight", shape=(10, 10))
        with pytest.raises(MXNetError):
            p.data()
        p.initialize(init="xavier")
        assert p.data().shape == p.grad().shape == (10, 10)
        assert len(p.list_data()) == 1 and p.list_ctx() == [mxt.cpu()]
        dense = mxt.gluon.nn.Dense(3)
        dense.initialize()
        with pytest.raises(mxt.gluon.parameter.DeferredInitializationError):
            dense.weight.data()
        dense(mxt.nd.ones((2, 7)))
        assert dense.weight.shape == (3, 7)


@pytest.mark.parametrize("make", [
    lambda: mxt.gluon.Trainer({}, "sgd", mesh=object()),
    lambda: mxt.gluon.nn.MultiHeadAttention(8, 2, seq_axis="seq"),
    lambda: mxt.gluon.nn.SwitchFFN(8, 16, 4),
    lambda: mxt.gluon.model_zoo.vision.get_model("vgg16"),
    lambda: mxt.gluon.model_zoo.vision.get_model("no_such_net"),
])
def test_unported_parts_raise(make):
    with pytest.raises(MXNetError):
        make()

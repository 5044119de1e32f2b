"""Parity of the PyTorch port's Gluon LSTM language model with the JAX
package, and with the port's own ``Module`` LM.

The model is ``benchmarks/bench_lstm.py``'s graph written as MXNet's Gluon
word-language-model example writes it (``Embedding``, a 2-layer
``rnn.LSTM`` over TNC, a reshape to (T*N, H), ``Dense(V,
flatten=False)``, ``SoftmaxCrossEntropyLoss``) at a toy size (V=50,
2 x 16, N=3, T=5). From the same weights and batch, the loss, every
gradient of the first step and every parameter after 3 ``Trainer`` steps
of SGD with momentum and of Adam (``trainer.step(N*T)``) are held to the
JAX package's, imperative and hybridized. The JAX package runs each
optimizer once, hybridized (one program a block; its imperative path
gives the same numbers, tests/test_gluon.py: test_hybridize_consistency),
with x64 off as users run it. The Gluon step's gradients are then held to
``Module``'s classic step on the same weights (the LSTM pieces packed into
the RNN op's vector by ``convert.pack_rnn_pieces``): the per-token cross
entropy's and ``SoftmaxOutput``'s gradients are the same sums.
"""
import contextlib
import os
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt

V, H, LAYERS, N, T = 50, 16, 2, 3, 5
STEPS = 3
OPTIMIZERS = {"sgd_momentum": ("sgd", {"learning_rate": 0.5,
                                       "momentum": 0.9}),
              "adam": ("adam", {"learning_rate": 0.01})}
# fp32 on both sides, only summation order differs (measured <= 4.4e-7 of
# each gradient's largest magnitude, parameters after 3 steps within
# 4.2e-7): the loss, each gradient and each parameter are held at 1e-5 of
# their own largest magnitude
REL = 1e-5


@contextlib.contextmanager
def _jax_package():
    """The JAX package as users run it (x64 off, the CPU), its persistent
    compile cache off so that its programs compile in this process."""
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


def gluon_lm(mx):
    """The word-language-model example's RNNModel, without dropout or tied
    weights."""
    gluon = mx.gluon

    class RNNModel(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.encoder = gluon.nn.Embedding(V, H)
                self.rnn = gluon.rnn.LSTM(H, num_layers=LAYERS,
                                          layout="TNC")
                self.decoder = gluon.nn.Dense(V, flatten=False)

        def hybrid_forward(self, F, x):
            out = self.rnn(self.encoder(x))
            return self.decoder(F.reshape(out, shape=(-1, H)))

    return RNNModel(prefix="lm_")


def _batch():
    rng = np.random.RandomState(0)
    data = rng.randint(0, V, (T, N)).astype(np.float32)
    label = rng.randint(0, V, (T * N,)).astype(np.float32)
    return data, label


def _train(mx, hybrid, optimizer, init=None):
    """From seeded Xavier weights (or ``init``): the per-token losses and
    gradients of the first step and the parameters after STEPS steps."""
    mx.random.seed(0)
    net = gluon_lm(mx)
    net.initialize(mx.init.Xavier())
    data, label = _batch()
    x, y = mx.nd.array(data), mx.nd.array(label)
    net(x)  # fixes the deferred shapes
    if init is not None:
        mx.convert.gluon_params_from_numpy(net, init)
    if hybrid:
        net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    name, params = OPTIMIZERS[optimizer]
    trainer = mx.gluon.Trainer(net.collect_params(), name, dict(params))
    out = {"init": {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}}
    for step in range(STEPS):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        if step == 0:
            out["loss"] = loss.asnumpy()
            out["grads"] = {k: p.grad().asnumpy()
                            for k, p in net.collect_params().items()}
        trainer.step(N * T)
    out["params"] = {k: p.data().asnumpy()
                     for k, p in net.collect_params().items()}
    out["cached_ops"] = len(net._cached_ops) if hybrid else 0
    return out


@pytest.fixture(scope="module")
def jax_runs(ref):
    with _jax_package():
        return {opt: _train(ref.mx, True, opt) for opt in OPTIMIZERS}


def _close(got, want, what):
    tol = REL * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= tol, \
        f"{what}: max |err| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("hybrid", [False, True],
                         ids=["imperative", "hybridized"])
@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_gluon_lm_matches_jax(jax_runs, optimizer, hybrid):
    want = jax_runs[optimizer]
    with mxt.cpu():
        got = _train(mxt, hybrid, optimizer, init=want["init"])
    _close(got["loss"], want["loss"], "loss")
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k in want["grads"]:
        _close(got["grads"][k], want["grads"][k], f"gradient {k}")
        _close(got["params"][k], want["params"][k],
               f"{k} after {STEPS} steps")
    assert got["cached_ops"] == (1 if hybrid else 0)


def test_seeded_init_draws_the_jax_packages_bits(jax_runs):
    """Xavier after mx.random.seed gives both packages' Gluon LMs the same
    weights, bit for bit (the same host stream, the same order)."""
    with mxt.cpu():
        mxt.random.seed(0)
        net = gluon_lm(mxt)
        net.initialize(mxt.init.Xavier())
        net(mxt.nd.array(_batch()[0]))
        for k, p in net.collect_params().items():
            np.testing.assert_array_equal(
                p.data().asnumpy(), jax_runs["adam"]["init"][k], err_msg=k)


def test_gluon_step_is_the_module_step():
    """The Gluon LM's loss and gradients equal Module's classic step on
    the same weights and batch (data (N, T), its label reshaped in the
    graph as bench_lstm.py does, so Gluon takes data.T and the label
    flattened the same way); the LSTM pieces' gradients, packed, are the
    Module's ``lstm_parameters`` gradient."""
    rng = np.random.RandomState(1)
    data = rng.randint(0, V, (N, T)).astype(np.float32)
    label = rng.randint(0, V, (N, T)).astype(np.float32)
    with mxt.cpu():
        mxt.random.seed(2)
        net = gluon_lm(mxt)
        net.initialize(mxt.init.Xavier())
        x, y = mxt.nd.array(data.T), mxt.nd.array(label.reshape(-1))
        with mxt.autograd.record():
            loss = mxt.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
        loss.backward()
        params = net.collect_params()
        pieces = {k[len("lm_lstm0_"):]: p for k, p in params.items()
                  if k.startswith("lm_lstm0_")}
        sym = _module_lm(mxt)
        mod = mxt.mod.Module(sym, context=mxt.cpu())
        mod.bind(data_shapes=[("data", (N, T))],
                 label_shapes=[("softmax_label", (N, T))])
        mod.init_params(mxt.init.Xavier())
        mod.set_params({
            "embed_weight": params["lm_embedding0_weight"].data(),
            "lstm_parameters": mxt.nd.array(mxt.convert.pack_rnn_pieces(
                {k: p.data() for k, p in pieces.items()}, LAYERS)),
            "pred_weight": params["lm_dense0_weight"].data(),
            "pred_bias": params["lm_dense0_bias"].data()}, {})
        batch = mxt.io.DataBatch([mxt.nd.array(data)],
                                 [mxt.nd.array(label)])
        mod.forward(batch, is_train=True)
        mod.backward()
        prob = mod.get_outputs()[0].asnumpy()
        rows = np.arange(N * T)
        ce = -np.log(prob[rows, label.reshape(-1).astype(int)])
        np.testing.assert_allclose(loss.asnumpy(), ce, rtol=1e-5)
        grads = {k: v.asnumpy() for k, v in mod._exec.grad_dict.items()}
        want = {"embed_weight": params["lm_embedding0_weight"],
                "pred_weight": params["lm_dense0_weight"],
                "pred_bias": params["lm_dense0_bias"]}
        for name, p in want.items():
            _close(p.grad().asnumpy(), grads[name], name)
        _close(mxt.convert.pack_rnn_pieces(
            {k: p.grad() for k, p in pieces.items()}, LAYERS),
            grads["lstm_parameters"], "lstm_parameters")


def _module_lm(mx):
    """bench_lstm.py's training graph (chip_smoke.py:build_lm)."""
    data = mx.sym.var("data")
    embed = mx.sym.Embedding(data, input_dim=V, output_dim=H, name="embed")
    embed = mx.sym.SwapAxis(embed, dim1=0, dim2=1)
    stack = mx.rnn.FusedRNNCell(H, num_layers=LAYERS, mode="lstm",
                                prefix="lstm_")
    out, _ = stack.unroll(T, inputs=embed, merge_outputs=True, layout="TNC")
    pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, H)),
                                 num_hidden=V, name="pred")
    label = mx.sym.Reshape(mx.sym.var("softmax_label"), shape=(-1,))
    return mx.sym.SoftmaxOutput(pred, label, name="softmax")


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_port_gluon_lm.py`")
    mxt.gpu(0).torch_device()  # TF32 off, as the port runs
    return mxt.gpu(0)


@pytest.mark.cuda
@pytest.mark.parametrize("hybrid", [False, True],
                         ids=["imperative", "hybridized"])
def test_gluon_lm_on_card_matches_cpu(card, hybrid):
    """The toy LM's training steps on the card (B1's sequence kernels
    forward and backward: 2 + 2 launches a step) against the port's CPU
    path from the same weights, at the file's tolerance."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    with mxt.cpu():
        want = _train(mxt, hybrid, "sgd_momentum")
    with card:
        L.lstm_sequence_fused.launches = 0
        L.lstm_sequence_backward.launches = 0
        got = _train(mxt, hybrid, "sgd_momentum", init=want["init"])
        assert L.lstm_sequence_fused.launches == LAYERS * (STEPS + 1)
        assert L.lstm_sequence_backward.launches == LAYERS * STEPS
    _close(got["loss"], want["loss"], "loss")
    for k in want["grads"]:
        _close(got["grads"][k], want["grads"][k], f"gradient {k}")
        _close(got["params"][k], want["params"][k],
               f"{k} after {STEPS} steps")

"""Parity of the PyTorch port's Module training loop with the JAX package.

At toy size (the bench LSTM LM with V=50, H=16, 2 layers, T=5, N=4):
``random.seed`` plus ``Xavier`` fill both packages' parameters with the
same bits; five ``Module.fit`` steps (SGD with momentum 0.9 and weight
decay) leave parameters and metrics allclose to ``mxnet_tpu``'s
``Module.fit`` (its fused step, fp32); a checkpoint written by either
package's ``save_checkpoint`` loads in the other's ``Module``; and
``NDArrayIter``, the metrics and the initializers follow the JAX package.
The JAX runs are computed once, in one module-scope fixture, with x64
off as users run the JAX package.
"""
import contextlib
import logging
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError

V, H, LAYERS, T, N = 50, 16, 2, 5, 4
BATCHES = 5
SGD = {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-3}
# fp32 on both sides, 5 SGD steps: the gradients differ in summation order
# only (measured <= 1.2e-7 at parameters of magnitude <= 1)
FIT_TOL = dict(rtol=1e-5, atol=1e-6)


def bench_lm(mx, steps=T):
    """benchmarks/bench_lstm.py's graph over ``steps`` tokens, named by a
    fresh NameManager."""
    with mx.sym.NameManager():
        data = mx.sym.var("data")
        embed = mx.sym.Embedding(data, input_dim=V, output_dim=H,
                                 name="embed")
        embed = mx.sym.SwapAxis(embed, dim1=0, dim2=1)
        stack = mx.rnn.FusedRNNCell(H, num_layers=LAYERS, mode="lstm",
                                    prefix="lstm_")
        out, _ = stack.unroll(steps, inputs=embed, merge_outputs=True,
                              layout="TNC")
        pred = mx.sym.Reshape(out, shape=(-1, H))
        pred = mx.sym.FullyConnected(pred, num_hidden=V, name="pred")
        label = mx.sym.Reshape(mx.sym.var("softmax_label"), shape=(-1,))
        return mx.sym.SoftmaxOutput(pred, label, name="softmax")


def _tokens():
    rng = np.random.RandomState(0)
    return (rng.randint(0, V, (BATCHES * N, T)).astype(np.float32),
            rng.randint(0, V, (BATCHES * N, T)).astype(np.float32))


def _fit(mx, ctx, prefix):
    """Seeded Xavier init, then one epoch of BATCHES steps; the
    initial and trained params, the metric, and a checkpoint."""
    mx.random.seed(0)
    mod = mx.mod.Module(bench_lm(mx), context=ctx)
    mod.bind(data_shapes=[("data", (N, T))],
             label_shapes=[("softmax_label", (N, T))])
    mod.init_params(mx.init.Xavier())
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    data, label = _tokens()
    metric = mx.metric.create(["ce", "perplexity"])
    mod.fit(mx.io.NDArrayIter(data, label, batch_size=N), num_epoch=1,
            optimizer="sgd", optimizer_params=SGD, eval_metric=metric)
    trained = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    return types.SimpleNamespace(init=init, trained=trained,
                                 metric=metric.get_name_value())


@contextlib.contextmanager
def _no_disk_cache():
    """The JAX package's programs compiled in this process only: its
    persistent compile cache (a directory the test session shares across
    workers) stays off for the reference runs, whose programs no other
    test shares."""
    old = os.environ.get("MXTPU_COMPILE_CACHE")
    os.environ["MXTPU_COMPILE_CACHE"] = "0"
    try:
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


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    with ref.jax.enable_x64(False), _no_disk_cache():
        jax_run = _fit(ref.mx, ref.mx.cpu(), str(root / "jax"))
    port_run = _fit(mxt, mxt.cpu(), str(root / "port"))
    return root, jax_run, port_run


def test_seeded_xavier_init_is_bit_identical(runs):
    _, jax_run, port_run = runs
    assert sorted(jax_run.init) == sorted(port_run.init)
    for name, value in jax_run.init.items():
        np.testing.assert_array_equal(port_run.init[name], value,
                                      err_msg=name)


@pytest.mark.parametrize("init", ["xavier", "xavier_gaussian_in", "uniform",
                                  "normal", "msraprelu", "orthogonal",
                                  "lstmbias", "constant", "mixed"])
def test_initializers_draw_the_jax_packages_bits(ref, init):
    def make(mx):
        return {
            "xavier": mx.init.Xavier(),
            "xavier_gaussian_in": mx.init.Xavier("gaussian", "in", 2),
            "uniform": mx.init.Uniform(0.3),
            "normal": mx.init.Normal(0.2),
            "msraprelu": mx.init.MSRAPrelu(),
            "orthogonal": mx.init.Orthogonal(),
            "lstmbias": mx.init.LSTMBias(2.0),
            "constant": mx.init.Constant(0.25),
            "mixed": mx.init.Mixed([".*bias", ".*"],
                                   [mx.init.Zero(), mx.init.Uniform(0.1)]),
        }[init]

    results = {}
    for tag, mx, ctx in (("jax", ref.mx, ref.mx.cpu()),
                         ("port", mxt, mxt.cpu())):
        mx.random.seed(5)
        initializer = make(mx)
        out = []
        for name, shape in (("fc_weight", (6, 4)), ("conv_weight", (3, 2, 3, 3)),
                            ("fc_bias", (8,)), ("lstm_parameters", (20,)),
                            ("bn_gamma", (4,)), ("bn_moving_var", (4,))):
            arr = mx.nd.zeros(shape, ctx=ctx)
            initializer(mx.init.InitDesc(name), arr)
            out.append(arr.asnumpy())
        results[tag] = out
    for want, got in zip(results["jax"], results["port"], strict=True):
        np.testing.assert_array_equal(got, want)


def test_init_attribute_override_and_registry():
    net = mxt.sym.FullyConnected(
        mxt.sym.var("data"), mxt.sym.var("w", init=mxt.init.Constant(0.5)),
        num_hidden=3, no_bias=True, name="fc")
    mod = mxt.mod.Module(net, label_names=None, context=mxt.cpu())
    mod.bind(data_shapes=[("data", (2, 4))])
    mod.init_params(mxt.init.create("uniform", scale=0.1))
    np.testing.assert_array_equal(mod.get_params()[0]["w"].asnumpy(),
                                  np.full((3, 4), 0.5, np.float32))


def test_module_fit_matches_jax(runs):
    _, jax_run, port_run = runs
    for name, value in jax_run.trained.items():
        assert not np.array_equal(value, jax_run.init[name]), name
        np.testing.assert_allclose(port_run.trained[name], value, **FIT_TOL,
                                   err_msg=name)
    names_j, values_j = zip(*jax_run.metric)
    names_t, values_t = zip(*port_run.metric)
    assert names_t == names_j
    np.testing.assert_allclose(values_t, values_j, rtol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_the_other_package(ref, runs, writer):
    root, jax_run, port_run = runs
    written = {"jax": jax_run, "port": port_run}[writer]
    if writer == "jax":
        mod = mxt.mod.Module.load(str(root / "jax"), 1, context=mxt.cpu())
        mod.bind(data_shapes=[("data", (N, T))],
                 label_shapes=[("softmax_label", (N, T))])
        params = mod.get_params()[0]
    else:
        with ref.jax.enable_x64(False):
            mod = ref.mx.mod.Module.load(str(root / "port"), 1,
                                         context=ref.mx.cpu())
            mod.bind(data_shapes=[("data", (N, T))],
                     label_shapes=[("softmax_label", (N, T))])
            params = mod.get_params()[0]
    assert sorted(params) == sorted(written.trained)
    for name, value in written.trained.items():
        np.testing.assert_array_equal(params[name].asnumpy(), value)
    sym, args, _ = mxt.model.load_checkpoint(str(root / writer), 1)
    assert sym.list_arguments() == bench_lm(mxt).list_arguments()
    assert sorted(args) == sorted(written.trained)


def test_port_checkpoint_resumes_its_optimizer_state(runs):
    """The port's own .states file restores the momentum, so one more
    step from the checkpoint equals one more step of a module that kept
    it."""
    root, _, _ = runs
    data, label = _tokens()
    batch = mxt.io.DataBatch([mxt.nd.array(data[:N], ctx=mxt.cpu())],
                             [mxt.nd.array(label[:N], ctx=mxt.cpu())])
    results = []
    for load_states in (True, False):
        mod = mxt.mod.Module.load(str(root / "port"), 1,
                                  load_optimizer_states=load_states,
                                  context=mxt.cpu())
        mod.bind(data_shapes=[("data", (N, T))],
                 label_shapes=[("softmax_label", (N, T))])
        mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
        mod.forward_backward(batch)
        mod.update()
        results.append(mod.get_params()[0]["pred_weight"].asnumpy())
    assert not np.array_equal(results[0], results[1])


def test_module_forward_backward_update_steps(runs):
    """The bench's --classic step: forward(is_train=True), backward(),
    update(); the loss on a repeated batch falls."""
    data, label = _tokens()
    mxt.random.seed(1)
    mod = mxt.mod.Module(bench_lm(mxt), context=mxt.cpu())
    mod.bind(data_shapes=[("data", (N, T))],
             label_shapes=[("softmax_label", (N, T))])
    mod.init_params(mxt.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5,
                                         "momentum": 0.0})
    batch = mxt.io.DataBatch([mxt.nd.array(data[:N], ctx=mxt.cpu())],
                             [mxt.nd.array(label[:N], ctx=mxt.cpu())])
    losses = []
    for _ in range(4):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        metric = mxt.metric.CrossEntropy()
        mod.update_metric(metric, batch.label)
        losses.append(metric.get()[1])
    assert losses[-1] < losses[0]
    assert mod.output_shapes[0].shape == (N * T, V)


def _repeated_batch_losses(mx, steps, n_updates):
    """Seeded Xavier init, then ``n_updates`` forward/backward/update steps
    at the bench's SGD (learning rate 0.5, no momentum) on one batch of
    ``steps`` tokens a row; the cross-entropy after each."""
    rng = np.random.RandomState(0)
    data = rng.randint(0, V, (N, steps)).astype(np.float32)
    label = rng.randint(0, V, (N, steps)).astype(np.float32)
    mx.random.seed(0)
    mod = mx.mod.Module(bench_lm(mx, steps), context=mx.cpu())
    mod.bind(data_shapes=[("data", (N, steps))],
             label_shapes=[("softmax_label", (N, steps))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5,
                                         "momentum": 0.0})
    batch = mx.io.DataBatch([mx.nd.array(data, ctx=mx.cpu())],
                            [mx.nd.array(label, ctx=mx.cpu())])
    losses = []
    for _ in range(n_updates):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        metric = mx.metric.CrossEntropy()
        mod.update_metric(metric, batch.label)
        losses.append(metric.get()[1])
    return np.array(losses)


def test_bench_learning_rate_rises_at_the_bench_length_in_both_packages(ref):
    """At the bench's T=256 the softmax gradient, summed over N*T rows and
    rescaled by 1/N, takes a step T times the per-token one: at learning
    rate 0.5 the loss on a repeated batch rises, in the JAX package as in
    the port, step for step."""
    with ref.jax.enable_x64(False), _no_disk_cache():
        jax_losses = _repeated_batch_losses(ref.mx, 256, 6)
    port_losses = _repeated_batch_losses(mxt, 256, 6)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    assert jax_losses[-1] > 2 * jax_losses[0]


def test_module_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only behaviour")
    mod = mxt.mod.Module(bench_lm(mxt))
    with pytest.raises(MXNetError):
        mod.bind(data_shapes=[("data", (N, T))],
                 label_shapes=[("softmax_label", (N, T))])


@pytest.mark.parametrize("kwargs", [
    {"checkpoint_batch_period": 2}, {"resume": "auto"}, {"supervisor": True},
    {"async_checkpoint": True}, {"kvstore": "dist_sync"}])
def test_fit_raises_for_parts_not_ported(kwargs):
    data, label = _tokens()
    mod = mxt.mod.Module(bench_lm(mxt), context=mxt.cpu())
    with pytest.raises(MXNetError):
        mod.fit(mxt.io.NDArrayIter(data, label, batch_size=N), num_epoch=1,
                checkpoint_prefix="unused", **kwargs)


def test_several_contexts_raise():
    with pytest.raises(MXNetError):
        mxt.mod.Module(bench_lm(mxt), context=[mxt.cpu(0), mxt.cpu(1)])


def test_fit_checkpoints_callbacks_and_score(tmp_path, caplog):
    data, label = _tokens()
    mxt.random.seed(2)
    mod = mxt.mod.Module(bench_lm(mxt), context=mxt.cpu())
    it = mxt.io.NDArrayIter(data, label, batch_size=N)
    seen = []
    with caplog.at_level(logging.INFO):
        mod.fit(it, eval_data=it, num_epoch=2, eval_metric="ce",
                initializer=mxt.init.Xavier(),
                optimizer_params={"learning_rate": 0.1},
                batch_end_callback=[mxt.callback.Speedometer(N, 2),
                                    lambda p: seen.append(p.nbatch)],
                epoch_end_callback=mxt.callback.do_checkpoint(
                    str(tmp_path / "cb")),
                checkpoint_prefix=str(tmp_path / "fit"))
    assert seen == list(range(BATCHES)) * 2
    assert any("Speed" in r.message for r in caplog.records)
    for stem in ("cb-0001", "cb-0002", "fit-0001", "fit-0002"):
        assert (tmp_path / f"{stem}.params").exists()
        assert (tmp_path / f"{stem}.manifest.json").exists()
    assert (tmp_path / "fit-0002.states").exists()
    ((name, value),) = mod.score(it, "ce")
    assert name == "cross-entropy" and np.isfinite(value)
    probs = mod.predict(it)
    assert probs.shape == (BATCHES * N * T, V)


# -- io and metric -------------------------------------------------------------

@pytest.mark.parametrize("handle,shuffle", [("pad", False), ("discard", False),
                                            ("roll_over", False),
                                            ("pad", True)])
def test_ndarrayiter_walks_the_jax_packages_batches(ref, handle, shuffle):
    data = np.arange(22, dtype=np.float32).reshape(11, 2)
    label = np.arange(11, dtype=np.float32)
    walked = {}
    for tag, mx in (("jax", ref.mx), ("port", mxt)):
        it = mx.io.NDArrayIter(data, label, batch_size=4, shuffle=shuffle,
                               last_batch_handle=handle, seed=3)
        batches = []
        for _ in range(2):
            batches += [(b.data[0].asnumpy().tolist(),
                         b.label[0].asnumpy().tolist(), b.pad) for b in it]
            it.reset()
        walked[tag] = (batches, [tuple(d) for d in it.provide_data],
                       [tuple(d) for d in it.provide_label])
    assert walked["port"] == walked["jax"]


@pytest.mark.parametrize("name", ["acc", "top_k_accuracy", "ce", "perplexity",
                                  "mae", "mse", "rmse", "f1", "loss",
                                  "custom"])
def test_metrics_match_jax(ref, name):
    rng = np.random.RandomState(4)
    probs = rng.dirichlet(np.ones(5), 12).astype(np.float32)
    labels = rng.randint(0, 5, 12).astype(np.float32)
    if name == "f1":
        probs = probs[:, :2] / probs[:, :2].sum(1, keepdims=True)
        labels = labels % 2
    if name in ("mae", "mse", "rmse"):
        probs, labels = probs[:, 0], labels / 5

    def make(mx):
        if name == "top_k_accuracy":
            return mx.metric.create(name, top_k=3)
        if name == "custom":
            return mx.metric.np(lambda l, p: float(np.abs(l - p.argmax(1))
                                                   .sum()))
        return mx.metric.create(name)

    values = {}
    for tag, mx, ctx in (("jax", ref.mx, ref.mx.cpu()),
                         ("port", mxt, mxt.cpu())):
        metric = make(mx)
        for half in (slice(0, 6), slice(6, 12)):
            metric.update([mx.nd.array(labels[half], ctx=ctx)],
                          [mx.nd.array(probs[half], ctx=ctx)])
        values[tag] = metric.get()
    assert values["port"][0] == values["jax"][0]
    np.testing.assert_allclose(values["port"][1], values["jax"][1],
                               rtol=1e-5)

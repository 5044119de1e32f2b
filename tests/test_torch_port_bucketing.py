"""Parity of the PyTorch port's sequence-training path with the JAX package.

At toy size (V=30, H=8, a 2-layer fused LSTM, buckets of 5 and 10 tokens,
N=4): ``Module.bind(shared_module=...)`` hands the bound module the shared
module's own parameter, gradient and auxiliary NDArrays in both packages;
``encode_sentences`` and ``BucketSentenceIter`` give the same batches,
bucket keys and descriptions bit for bit from the same seeds (Python's
``random`` for the batch order, numpy's global stream for the rows), in
both layouts; ``BucketingModule.fit`` over both buckets (upstream
``lstm_bucketing.py``'s graph: ``SoftmaxOutput`` ignoring label 0) leaves
the parameters and the perplexity allclose to the JAX package's, every
bucket's module holding the default module's arrays and one update
capture serving both buckets; ``SequentialModule`` with a
``PythonLossModule`` tail trains as the JAX package's does. The JAX runs
are computed once, in module-scope fixtures, with x64 off as users run
the JAX package. Tests marked ``cuda`` hold B1 to its plain version at a
bucket's shape and train the bucketed LM on the card against the CPU
path; they need neither JAX nor the JAX package (``python -m pytest
--noconftest -m cuda tests/test_torch_port_bucketing.py`` on a card).
"""
import contextlib
import os
import random
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.cuda import lstm as port_lstm

V, H, LAYERS, N = 30, 8, 2, 4
BUCKETS = [5, 10]
SENTENCES = 40
EPOCHS = 2
SGD = {"learning_rate": 0.1}
# fp32 on both sides through 18 SGD steps: summation order differs only
# (measured <= 3e-8 at parameters of magnitude <= 1)
FIT_TOL = dict(rtol=1e-5, atol=1e-5)


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


def _corpus(seed=1, count=SENTENCES, vocab=V, longest=max(BUCKETS)):
    """Token lists of 2 to ``longest`` tokens, ids 1..vocab-1 (0 pads)."""
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, vocab, rng.randint(2, longest + 1)))
            for _ in range(count)]


def _seed(mx, seed=0):
    random.seed(seed)
    np.random.seed(seed)
    mx.random.seed(seed)


def _sym_gen(mx, vocab=V, hidden=H):
    """Upstream example/rnn/lstm_bucketing.py's graph a bucket: one fused
    cell, unrolled NTC, shared by every bucket's symbol."""
    stack = mx.rnn.FusedRNNCell(hidden, num_layers=LAYERS, mode="lstm",
                                prefix="lstm_")

    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=hidden,
                                 name="embed")
        out, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True,
                              layout="NTC")
        pred = mx.sym.Reshape(out, shape=(-1, hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, name="softmax",
                                    use_ignore=True, ignore_label=0)
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def _fit(mx, ctx):
    """BucketingModule.fit over both buckets from a seeded Xavier init: the
    trained parameters, the perplexity, and the bucket modules."""
    _seed(mx)
    it = mx.rnn.BucketSentenceIter(_corpus(), N, buckets=BUCKETS,
                                   invalid_label=0)
    mod = mx.mod.BucketingModule(_sym_gen(mx),
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    metric = mx.metric.Perplexity(ignore_label=0)
    mod.fit(it, num_epoch=EPOCHS, optimizer="sgd", optimizer_params=SGD,
            initializer=mx.init.Xavier(), eval_metric=metric)
    return types.SimpleNamespace(
        params={k: v.asnumpy() for k, v in mod.get_params()[0].items()},
        perplexity=metric.get()[1], mod=mod, steps=EPOCHS * len(it.idx))


def _shared_pair(mx, ctx):
    """Two modules over a BatchNorm net, the second bound at another batch
    size against the first; one training step through the first."""
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=5, name="fc1")
    net = mx.sym.BatchNorm(net, name="bn")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    first = mx.mod.Module(net, context=ctx)
    first.bind(data_shapes=[("data", (4, 6))],
               label_shapes=[("softmax_label", (4,))])
    _seed(mx)
    first.init_params(mx.init.Xavier())
    first.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    second = mx.mod.Module(net, context=ctx)
    second.bind(data_shapes=[("data", (2, 6))],
                label_shapes=[("softmax_label", (2,))], shared_module=first)
    rng = np.random.RandomState(3)
    batch = mx.io.DataBatch(
        [mx.nd.array(rng.normal(0, 1, (4, 6)), ctx=ctx)],
        [mx.nd.array(rng.randint(0, 3, (4,)), ctx=ctx)])
    first.forward(batch, is_train=True)
    first.backward()
    first.update()
    return first, second


@pytest.fixture(scope="module")
def jax_runs(ref):
    with ref.jax.enable_x64(False), _no_disk_cache():
        fit = _fit(ref.mx, ref.mx.cpu())
        seq = _sequential(ref.mx, ref.mx.cpu())
    return types.SimpleNamespace(fit=fit, seq=seq)


@pytest.fixture(scope="module")
def port_fit():
    return _fit(mxt, mxt.cpu())


@pytest.mark.parametrize("package", ["jax", "port"])
def test_shared_module_shares_the_arrays(ref, package):
    """A module bound against another holds that module's own NDArrays for
    every parameter, gradient and auxiliary state (the port copied them
    before, so it missed the other's later updates), and sees its
    update."""
    if package == "jax":
        with ref.jax.enable_x64(False), _no_disk_cache():
            first, second = _shared_pair(ref.mx, ref.mx.cpu())
    else:
        first, second = _shared_pair(mxt, mxt.cpu())
    a, b = first._exec, second._exec
    params = ["fc1_weight", "fc1_bias", "bn_gamma", "bn_beta", "fc2_weight",
              "fc2_bias"]
    for name in params:
        assert b.arg_dict[name] is a.arg_dict[name], name
        assert b.grad_dict[name] is a.grad_dict[name], name
    for name in ("bn_moving_mean", "bn_moving_var"):
        assert b.aux_dict[name] is a.aux_dict[name], name
    # the data and the label have another batch size: not shared
    assert b.arg_dict["data"] is not a.arg_dict["data"]
    got, _ = second.get_params()
    want, _ = first.get_params()
    for name in params:
        np.testing.assert_array_equal(got[name].asnumpy(),
                                      want[name].asnumpy())


def test_encode_sentences_matches_jax(ref):
    words = [["the", "cat", "sat"], ["a", "cat"], ["the", "end", "\n"]]
    for kwargs in ({}, {"invalid_label": 0, "start_label": 0},
                   {"invalid_label": 2, "start_label": 1}):
        got = mxt.rnn.encode_sentences(words, **kwargs)
        want = ref.mx.rnn.encode_sentences(words, **kwargs)
        assert got == want
    vocab = want[1]
    assert (mxt.rnn.encode_sentences(words, vocab=dict(vocab))
            == ref.mx.rnn.encode_sentences(words, vocab=dict(vocab)))
    with pytest.raises(AssertionError):
        mxt.rnn.encode_sentences([["unknown"]], vocab=dict(vocab))


def _iter_batches(mx, layout, buckets):
    _seed(mx, 7)
    it = mx.rnn.BucketSentenceIter(_corpus(2), N, buckets=buckets,
                                   invalid_label=0, layout=layout)
    head = (it.buckets, it.default_bucket_key,
            [(d.name, d.shape, d.layout) for d in it.provide_data],
            [(d.name, d.shape, d.layout) for d in it.provide_label])
    epochs = []
    for _ in range(2):
        epochs.append([
            (b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
             [(d.name, d.shape, d.layout) for d in b.provide_data],
             [(d.name, d.shape, d.layout) for d in b.provide_label], b.pad)
            for b in it])
        it.reset()
    return head, epochs


@pytest.mark.parametrize("buckets", [BUCKETS, None], ids=["given", "auto"])
@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(ref, layout, buckets):
    """Two epochs of batches, bit for bit: the order, bucket keys, data,
    next-token labels and their descriptions (time-major with TN)."""
    got_head, got = _iter_batches(mxt, layout, buckets)
    want_head, want = _iter_batches(ref.mx, layout, buckets)
    assert got_head == want_head
    assert len(got[0]) > 1 and got[0] != [] and len(got) == len(want)
    for got_epoch, want_epoch in zip(got, want, strict=True):
        assert len(got_epoch) == len(want_epoch)
        for g, w in zip(got_epoch, want_epoch):
            assert g[0] == w[0] and g[3:] == w[3:]
            assert g[1].dtype == w[1].dtype == np.float32
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
            t_axis = 1 if layout == "NT" else 0
            assert g[1].shape[t_axis] == g[0]


def test_bucket_sentence_iter_rejects_a_bad_layout():
    with pytest.raises(ValueError):
        mxt.rnn.BucketSentenceIter(_corpus(), N, buckets=BUCKETS,
                                   layout="TC")


def test_bucketing_fit_matches_jax(jax_runs, port_fit):
    """Both buckets trained: the parameters and the perplexity against the
    JAX package's BucketingModule.fit."""
    want, got = jax_runs.fit, port_fit
    assert sorted(got.mod._buckets) == sorted(want.mod._buckets) == BUCKETS
    assert sorted(got.params) == sorted(want.params)
    for name, value in want.params.items():
        np.testing.assert_allclose(got.params[name], value, err_msg=name,
                                   **FIT_TOL)
    np.testing.assert_allclose(got.perplexity, want.perplexity, rtol=1e-5)


def test_bucket_modules_share_the_default_modules_arrays(port_fit):
    """Every bucket's executor holds the default bucket's parameter and
    gradient NDArrays, and the one optimizer's fused update was captured
    once for both buckets."""
    mod = port_fit.mod
    default = mod._buckets[max(BUCKETS)]
    for key, bucket in mod._buckets.items():
        assert bucket._updater is default._updater, key
        for name in default._param_names:
            assert bucket._exec.arg_dict[name] is \
                default._exec.arg_dict[name], (key, name)
            assert bucket._exec.grad_dict[name] is \
                default._exec.grad_dict[name], (key, name)
    assert default._updater._fused_apply.guard.count == 1


def test_bucketing_module_routes_and_guards():
    sym_gen = _sym_gen(mxt)
    with pytest.raises(MXNetError):
        mxt.mod.BucketingModule(sym_gen)
    mod = mxt.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                  context=mxt.cpu())
    assert mod.data_names == ("data",)
    assert mod.output_names == ["softmax_output"]
    mod.bind(data_shapes=[("data", (N, 10))],
             label_shapes=[("softmax_label", (N, 10))])
    with pytest.raises(MXNetError):
        mod.bind(data_shapes=[("data", (N, 10))], force_rebind=True,
                 shared_module=mod)
    mod.init_params(mxt.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    batch = mxt.io.DataBatch([mxt.nd.zeros((N, 5), ctx=mxt.cpu())],
                             [mxt.nd.zeros((N, 5), ctx=mxt.cpu())],
                             bucket_key=5,
                             provide_data=[mxt.io.DataDesc("data", (N, 5))],
                             provide_label=[mxt.io.DataDesc(
                                 "softmax_label", (N, 5))])
    mod.prepare(batch)  # builds bucket 5, stays on 10
    assert sorted(mod._buckets) == [5, 10] and mod._curr_bucket_key == 10
    assert mod._buckets[5]._optimizer is mod._buckets[10]._optimizer
    mod.forward(batch, is_train=True)
    assert mod._curr_bucket_key == 5
    assert mod.get_outputs()[0].shape == (N * 5, V)
    assert [d.shape for d in mod.data_shapes] == [(N, 5)]


def _sequential(mx, ctx, steps=6):
    """upstream's SequentialModule example at toy size: a net module
    chained into a PythonLossModule (its default softmax gradient), and a
    second chain whose loss module has a ``grad_func``."""
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (64, 10)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    out = {}
    for label, grad_func in (("default", None),
                             ("grad_func", lambda s, lab: s.asnumpy() * 0.5)):
        with mx.sym.NameManager():
            net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2,
                                        name="fc")
            net = mx.sym.softmax(net, name="prob")
        seq = mx.mod.SequentialModule()
        seq.add(mx.mod.Module(net, data_names=["data"], label_names=[],
                              context=ctx))
        seq.add(mx.mod.PythonLossModule(data_names=("prob_output",),
                                        grad_func=grad_func),
                take_labels=True, auto_wiring=True)
        it = mx.io.NDArrayIter(x, y, 16, label_name="softmax_label")
        seq.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        _seed(mx)
        seq.init_params(mx.init.Xavier())
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        for _ in range(steps):
            it.reset()
            for batch in it:
                seq.forward(batch, is_train=True)
                seq.backward()
                seq.update()
        it.reset()
        batch = next(iter(it))
        seq.forward(batch, is_train=False)
        out[label] = {
            "params": {k: v.asnumpy()
                       for k, v in seq.get_params()[0].items()},
            "outputs": seq.get_outputs()[0].asnumpy(),
            "output_names": seq.output_names,
            "shapes": [(d.name, d.shape) for d in seq.output_shapes]}
    return out


def test_sequential_module_with_python_loss_matches_jax(jax_runs):
    got = _sequential(mxt, mxt.cpu())
    for label, want in jax_runs.seq.items():
        assert got[label]["output_names"] == want["output_names"]
        assert got[label]["shapes"] == want["shapes"]
        for name, value in want["params"].items():
            np.testing.assert_allclose(got[label]["params"][name], value,
                                       err_msg=f"{label} {name}", **FIT_TOL)
        np.testing.assert_allclose(got[label]["outputs"], want["outputs"],
                                   **FIT_TOL)


def test_python_modules_validate_their_arguments():
    seq = mxt.mod.SequentialModule()
    with pytest.raises(MXNetError):
        seq.add(mxt.mod.PythonLossModule(), bogus_meta=True)
    with pytest.raises(MXNetError):
        seq.bind(data_shapes=[("data", (2, 3))])
    with pytest.raises(MXNetError):
        mxt.mod.PythonLossModule(grad_func=3)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_port_bucketing.py`")
    mxt.gpu(0).torch_device()  # TF32 off, as the port runs
    return torch.device("cuda", 0)


# B1 against its plain version in fp32: summation order only, compounding
# through the recurrence (chip_smoke.py's SEQ_FP32_TOL); dw relative to its
# magnitude
SEQ_FP32_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("steps", [10, 60])
def test_b1_at_a_bucket_shape_matches_plain(card, steps, reverse):
    """B1 forward (the training sequence kernel) and backward (the plan's
    register kernel at N=32) at the bucketed LM's shapes, (T, 32, 1024)
    fp32, against the plain versions on the same card tensors."""
    n, hdim = 32, 1024
    rng = np.random.RandomState(steps)

    def normal(scale, *shape):
        return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32,
                            device=card)

    xproj, h0, c0 = normal(1.0, steps, n, 4 * hdim), normal(0.5, n, hdim), \
        normal(0.5, n, hdim)
    w = torch.tensor(rng.uniform(-0.05, 0.05, (4 * hdim, hdim)),
                     dtype=torch.float32, device=card)
    assert port_lstm.backward_plan(n, hdim, card).variant == "register"
    got = port_lstm.lstm_sequence_train(xproj, h0, c0, w, reverse)
    want = port_lstm.lstm_sequence_train_plain(xproj, h0, c0, w, reverse)
    for g, p in zip(got, want, strict=True):
        assert (g - p).abs().max().item() <= SEQ_FP32_TOL
    out, _, _, gates, cs = want
    dout, dh, dc = normal(0.1, steps, n, hdim), normal(0.1, n, hdim), \
        normal(0.1, n, hdim)
    case = (dout, dh, dc, gates, cs, out, h0, c0, w)
    before = port_lstm.lstm_sequence_backward.register_launches
    got = port_lstm.lstm_sequence_backward(*case, reverse=reverse)
    torch.cuda.synchronize()
    assert port_lstm.lstm_sequence_backward.register_launches == before + 1
    want = port_lstm.lstm_sequence_backward_plain(*case, reverse=reverse)
    for name, g, p in zip(("dgates", "dh0", "dc0", "dw"), got, want):
        scale = max(1.0, p.abs().max().item()) if name == "dw" else 1.0
        assert (g - p).abs().max().item() <= SEQ_FP32_TOL * scale, name


@pytest.mark.cuda
def test_bucketed_lm_trains_on_card_as_on_cpu(card):
    """The toy bucketed LM's fit on the card (2 sequence forward and 2
    sequence backward launches a step, one update capture for both
    buckets) against the port's CPU path from the same seeds."""
    want = _fit(mxt, mxt.cpu())
    port_lstm.lstm_sequence_fused.launches = 0
    port_lstm.lstm_sequence_backward.launches = 0
    got = _fit(mxt, mxt.gpu(0))
    assert sorted(got.mod._buckets) == BUCKETS
    assert port_lstm.lstm_sequence_fused.launches == LAYERS * got.steps
    assert port_lstm.lstm_sequence_backward.launches == LAYERS * got.steps
    default = got.mod._buckets[max(BUCKETS)]
    assert default._updater._fused_apply.guard.count == 1
    for name, value in want.params.items():
        np.testing.assert_allclose(got.params[name], value, err_msg=name,
                                   **FIT_TOL)
    np.testing.assert_allclose(got.perplexity, want.perplexity, rtol=1e-5)

"""Both served models through the port's ``InferenceServer``, against the
JAX package's server.

At a small width, the same requests go through each package's server in
the deterministic ``workers=0`` mode with ``max_batch=4`` (buckets 1, 2,
4, coalesced):

- the LSTM LM (``benchmarks/bench_lstm.py``'s graph, V=50, 2 x 16, T=8,
  seeded weights) through ``Module.as_serving_backend()``; the graph ends
  in a reshape and a swap to (N, T, V), so the server can scatter its
  answers by row;
- the transformer LM (2 layers, width 64, S=32, fp32) through
  ``CallableBackend`` over ``TransformerLM.logits``, its weights carried
  across by ``convert.transformer_params_from_numpy``.

The ``cuda``-marked test serves the small LSTM LM on the card and checks
that each dispatch launched the sequence kernel once a layer.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt

V, H, LAYERS, T = 50, 16, 2, 8
# fp32 both sides, the LSTM's recurrence over 8 steps and a softmax:
# summation order only (measured 6e-9)
LSTM_TOL = 1e-5
# the transformer's fp32 tolerance in tests/test_torch_port_transformer.py
TF_RTOL, TF_ATOL = 1e-5, 1e-5
TF_V, TF_S = 64, 32
MAX_BATCH = 4
# rows of the requests: coalesced into buckets 4, 4 and 1
ROWS = (1, 1, 2, 1, 3, 1)


def served_lm(mx):
    """bench_lstm.py's LM, its (T*N, V) probabilities reshaped and
    swapped to batch-major (N, T, V)."""
    with mx.sym.NameManager():
        data = mx.sym.var("data")
        embed = mx.sym.Embedding(data, input_dim=V, output_dim=H,
                                 name="embed")
        embed = mx.sym.SwapAxis(embed, dim1=0, dim2=1)
        stack = mx.rnn.FusedRNNCell(H, num_layers=LAYERS, mode="lstm",
                                    prefix="lstm_")
        out, _ = stack.unroll(T, inputs=embed, merge_outputs=True,
                              layout="TNC")
        pred = mx.sym.Reshape(out, shape=(-1, H))
        pred = mx.sym.FullyConnected(pred, num_hidden=V, name="pred")
        probs = mx.sym.SoftmaxOutput(pred, mx.sym.var("softmax_label"),
                                     name="softmax")
        return mx.sym.SwapAxis(mx.sym.Reshape(probs, shape=(T, -1, V)),
                               dim1=0, dim2=1)


def lm_params(net):
    arg_shapes, _, _ = net.infer_shape(data=(1, T))
    rng = np.random.RandomState(0)
    return {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def lm_backend(mx, ctx):
    net = served_lm(mx)
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (MAX_BATCH, T))], for_training=False)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in lm_params(net).items()},
                    aux_params={})
    return mod.as_serving_backend()


def requests(vocab, width):
    rng = np.random.RandomState(1)
    return [rng.randint(0, vocab, (rows, width)).astype(np.float32)
            for rows in ROWS]


def serve(mx, backend, reqs, name):
    srv = mx.serving.InferenceServer(backend, max_batch=MAX_BATCH,
                                     workers=0, name=name)
    try:
        srv.warm_up()
        pending = [srv.submit(r) for r in reqs]
        srv.run_pending()
        return [srv.result(r)[0] for r in pending], srv.stats()
    finally:
        srv.close()


def _same_counters(mine, theirs):
    for key in ("completed", "dispatches", "coalesced_requests",
                "warmed_buckets", "failed"):
        assert mine[key] == theirs[key], key
    assert mine["pad_waste"] == theirs["pad_waste"]


def test_lstm_lm_served_matches_jax_package():
    import jax
    import mxnet_tpu
    reqs = requests(V, T)
    with jax.enable_x64(False):
        theirs, jax_stats = serve(mxnet_tpu, lm_backend(
            mxnet_tpu, mxnet_tpu.cpu()), reqs, "lm")
    mine, stats = serve(mxt, lm_backend(mxt, mxt.cpu()), reqs, "lm")
    assert stats["dispatches"] == 3 and stats["completed"] == len(ROWS)
    _same_counters(stats, jax_stats)
    for req, a, b in zip(reqs, mine, theirs):
        assert a.shape == b.shape == (req.shape[0], T, V)
        np.testing.assert_allclose(a, b, rtol=0, atol=LSTM_TOL)


def test_transformer_served_matches_jax_package():
    import jax
    from mxnet_tpu.models import transformer as jax_tf
    import mxnet_tpu
    from mxnet_tpu_torch.convert import transformer_params_from_numpy
    from mxnet_tpu_torch.models import transformer as port_tf

    def cfg(mod):
        return mod.TransformerConfig(vocab_size=TF_V, num_layers=2,
                                     num_heads=4, d_model=64,
                                     max_seq_len=TF_S, dtype="float32")

    reqs = requests(TF_V, TF_S)
    with jax.enable_x64(False):
        jlm = jax_tf.TransformerLM(cfg(jax_tf), seed=0)
        jax_backend = mxnet_tpu.serving.CallableBackend(
            lambda a: np.asarray(jlm.logits(a["data"].astype(np.int32))),
            input_specs={"data": (TF_S,)})
        theirs, jax_stats = serve(mxnet_tpu, jax_backend, reqs, "tf")
        jparams = jax.tree.map(np.asarray, jlm.params)
    plm = port_tf.TransformerLM(cfg(port_tf), seed=0, ctx=mxt.cpu())
    plm.params = transformer_params_from_numpy(jparams, ctx=mxt.cpu())
    mine, stats = serve(mxt, mxt.serving.CallableBackend(
        lambda a: plm.logits(a["data"]).numpy(),
        input_specs={"data": (TF_S,)}), reqs, "tf")
    _same_counters(stats, jax_stats)
    for req, a, b in zip(reqs, mine, theirs):
        assert a.shape == b.shape == (req.shape[0], TF_S, TF_V)
        np.testing.assert_allclose(a, b, rtol=TF_RTOL, atol=TF_ATOL)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest "
                    "-m cuda tests/test_torch_port_serving_lm.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_lstm_lm_served_on_the_card(card):
    from mxnet_tpu_torch.ops.cuda.lstm import (lstm_cell_fused,
                                               lstm_sequence_fused)
    reqs = requests(V, T)
    srv = mxt.serving.InferenceServer(lm_backend(mxt, mxt.gpu(0)),
                                      max_batch=MAX_BATCH, workers=0,
                                      name="lm-card")
    try:
        srv.warm_up()
        lstm_sequence_fused.launches = lstm_cell_fused.launches = 0
        pending = [srv.submit(r) for r in reqs]
        srv.run_pending()
        got = [srv.result(r)[0] for r in pending]
        stats = srv.stats()
    finally:
        srv.close()
    assert stats["completed"] == len(ROWS) and stats["failed"] == 0
    assert lstm_sequence_fused.launches == LAYERS * stats["dispatches"]
    assert lstm_cell_fused.launches == 0
    want, _ = serve(mxt, lm_backend(mxt, mxt.cpu()), reqs, "lm-cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=LSTM_TOL)

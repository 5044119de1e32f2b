"""Parity of the PyTorch port's predict path with the JAX package.

The LSTM language model (Embedding -> SwapAxis -> FusedRNNCell LSTM ->
Reshape -> FullyConnected -> SoftmaxOutput) is built in both packages at a
small size; its symbol JSON, its ops, its ``.params`` bytes and its
``Predictor`` outputs are held against the JAX package. Host logic must
match exactly; numerics match to the stated tolerance. Also: the port
imports no JAX, and asking it for a GPU where there is none raises.
"""
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mxj
import mxnet_tpu.c_predict  # noqa: F401
from mxnet_tpu.ops import tensor_ops as jax_tensor_ops
from mxnet_tpu.ops.registry import OP_TABLE as JAX_OPS
from mxnet_tpu.serving.backends import PredictorBackend as JaxPredictorBackend

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import tensor_ops as port_tensor_ops
from mxnet_tpu_torch.serving import PredictorBackend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, H, LAYERS, T = 50, 16, 2, 5
PROB_ATOL = 1e-6  # fp32 softmax rows of 50 classes on both sides


def build_lm(mx, vocab=V, hidden=H, layers=LAYERS, seq_len=T):
    """benchmarks/bench_lstm.py's model with an un-reshaped label, named
    by a fresh NameManager so both packages give the same names."""
    with mx.sym.NameManager():
        data = mx.sym.var("data")
        embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=hidden,
                                 name="embed")
        embed = mx.sym.SwapAxis(embed, dim1=0, dim2=1)
        stack = mx.rnn.FusedRNNCell(hidden, num_layers=layers, mode="lstm",
                                    prefix="lstm_")
        out, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True,
                              layout="TNC")
        pred = mx.sym.Reshape(out, shape=(-1, hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        return mx.sym.SoftmaxOutput(pred, mx.sym.var("softmax_label"),
                                    name="softmax")


@pytest.fixture(scope="module")
def lm():
    """Symbol JSON from the port, random params as .params bytes, tokens."""
    net = build_lm(mxt)
    arg_shapes, _, _ = net.infer_shape(data=(3, T))
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    tokens = rng.randint(0, V, (3, T)).astype(np.float32)
    return net.tojson(), mxt.convert.params_to_bytes(params, {}), params, tokens


def _predict(module, symbol_json, param_bytes, tokens):
    pred = module.c_predict.Predictor(symbol_json, param_bytes, 1, 0,
                                      {"data": tokens.shape})
    pred.set_input("data", memoryview(tokens.reshape(-1)), tokens.shape)
    pred.forward()
    out = np.empty(int(np.prod(pred.output_shape(0))), np.float32)
    pred.get_output(0, memoryview(out))
    return out.reshape(pred.output_shape(0))


@pytest.mark.parametrize("shape,code", [
    ((2, 3, 4), (0, -1)), ((2, 3, 4), (-1, 4)), ((2, 3, 4), (-2,)),
    ((2, 3, 4), (-3, 4)), ((2, 3, 4), (0, -3)), ((2, 12), (0, -4, 3, -1)),
    ((2, 12), (-4, 1, 2, 0)), ((6, 5), (0, -4, -1, 5)),
])
def test_reshape_codes_match_jax(shape, code):
    assert (port_tensor_ops._infer_reshape(shape, code)
            == jax_tensor_ops._infer_reshape(shape, code))
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    out_j = JAX_OPS["Reshape"].fn(jnp.asarray(x), shape=code)
    out_t = mxt.OP_TABLE["Reshape"].fn(torch.from_numpy(x), shape=code)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_reshape_reverse_matches_jax():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    out_j = JAX_OPS["Reshape"].fn(jnp.asarray(x), shape=(-1, 0), reverse=True)
    out_t = mxt.OP_TABLE["Reshape"].fn(torch.from_numpy(x), shape=(-1, 0),
                                       reverse=True)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


_OP_CASES = {
    "SwapAxis": ([(2, 3, 4)], dict(dim1=0, dim2=2)),
    "expand_dims": ([(2, 3)], dict(axis=1)),
    "Concat": ([(2, 3), (2, 5)], dict(dim=1)),
    "SliceChannel": ([(2, 6, 3)], dict(num_outputs=3, axis=1,
                                       squeeze_axis=False)),
    "FullyConnected": ([(4, 2, 3), (5, 6), (5,)], dict(num_hidden=5)),
    "softmax": ([(3, 7)], dict(axis=-1)),
    "SoftmaxOutput": ([(6, 7), (6,)], dict()),
}


@pytest.mark.parametrize("op", sorted(_OP_CASES))
def test_graph_ops_match_jax(op):
    shapes, attrs = _OP_CASES[op]
    rng = np.random.RandomState(len(op))
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    out_j = JAX_OPS[op].fn(*map(jnp.asarray, arrays), **attrs)
    out_t = mxt.OP_TABLE[op].fn(*map(torch.from_numpy, arrays), **attrs)
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    assert len(out_t) == len(out_j)
    for o_j, o_t in zip(out_j, out_t):
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-6,
                                   atol=1e-6)


def test_embedding_matches_jax_and_rejects_bad_ids():
    rng = np.random.RandomState(1)
    weight = rng.normal(size=(9, 4)).astype(np.float32)
    ids = rng.randint(0, 9, (3, 5)).astype(np.float32)
    out_j = JAX_OPS["Embedding"].fn(jnp.asarray(ids), jnp.asarray(weight),
                                    input_dim=9, output_dim=4)
    out_t = mxt.OP_TABLE["Embedding"].fn(torch.from_numpy(ids),
                                         torch.from_numpy(weight),
                                         input_dim=9, output_dim=4)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    with pytest.raises(MXNetError):
        mxt.OP_TABLE["Embedding"].fn(torch.tensor([[9.0]]),
                                     torch.from_numpy(weight),
                                     input_dim=9, output_dim=4)


def test_lm_symbol_json_equals_jax():
    graph_j = json.loads(build_lm(mxj).tojson())
    graph_t = json.loads(build_lm(mxt).tojson())
    assert graph_t == graph_j
    ops = [n["op"] for n in graph_t["nodes"] if n["op"] != "null"]
    assert ops == (["Embedding", "SwapAxis", "SliceChannel"]
                   + ["expand_dims"] * T + ["Concat"]
                   + ["_begin_state_zeros"] * 2
                   + ["RNN", "Reshape", "FullyConnected", "SoftmaxOutput"])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_symbol_json_loads_across_packages(writer, reader):
    pkgs = {"jax": mxj, "port": mxt}
    text = build_lm(pkgs[writer]).tojson()
    loaded = pkgs[reader].sym.load_json(text)
    assert json.loads(loaded.tojson()) == json.loads(text)
    assert loaded.list_arguments() == ["data", "embed_weight",
                                       "lstm_parameters", "pred_weight",
                                       "pred_bias", "softmax_label"]


def test_lm_infer_shape_matches_jax():
    shapes_j = build_lm(mxj).infer_shape(data=(3, T))
    shapes_t = build_lm(mxt).infer_shape(data=(3, T))
    assert shapes_t == tuple(list(s) for s in shapes_j)
    assert shapes_t[1] == [(3 * T, V)]


@pytest.mark.parametrize("rows", [1, 3])
def test_predictor_matches_jax(lm, rows):
    symbol_json, param_bytes, _, tokens = lm
    tokens = tokens[:rows]
    out_j = _predict(mxj, symbol_json, param_bytes, tokens)
    out_t = _predict(mxt, symbol_json, param_bytes, tokens)
    assert out_t.shape == (rows * T, V)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(out_t.sum(axis=1), 1.0, atol=1e-5)


def test_predictor_backend_answers_two_buckets(lm):
    symbol_json, param_bytes, _, tokens = lm
    backend = PredictorBackend(symbol_json, param_bytes, row_shape=(T,),
                               dev_type=1)
    reference = JaxPredictorBackend(symbol_json, param_bytes, row_shape=(T,))
    backend.load()
    for rows in (1, 2, 1):
        batch = tokens[:rows]
        (out,) = backend.infer({"data": batch})
        (ref,) = reference.infer({"data": batch})
        np.testing.assert_allclose(out, ref, rtol=0, atol=PROB_ATOL)
    assert sorted(backend._predictors) == [1, 2]


@pytest.mark.parametrize("returns_list", [False, True])
def test_callable_backend_matches_jax(returns_list):
    from mxnet_tpu.serving.backends import CallableBackend as JaxCallable

    def fn(arrays):
        out = arrays["data"].sum(axis=1)
        return [out, out * 2] if returns_list else out

    batch = {"data": np.arange(6, dtype=np.float32).reshape(2, 3)}
    port = mxt.serving.CallableBackend(fn, input_specs={"data": (3,)})
    ref = JaxCallable(fn, input_specs={"data": (3,)})
    port.load()
    assert port.input_specs == ref.input_specs == {"data": (3,)}
    outs_t, outs_j = port.infer(batch), ref.infer(batch)
    assert len(outs_t) == len(outs_j) == (2 if returns_list else 1)
    for o_t, o_j in zip(outs_t, outs_j):
        np.testing.assert_array_equal(o_t, o_j)


def test_predictor_backend_defaults_to_the_gpu():
    backend = PredictorBackend("{}", b"", row_shape=(T,))
    assert backend.dev_type == 2


def test_predictor_rejects_corrupt_params(lm):
    symbol_json, param_bytes, _, _ = lm
    with pytest.raises(MXNetError):
        mxt.c_predict.Predictor(symbol_json, param_bytes[:100], 1, 0,
                                {"data": (1, T)})


def test_params_round_trip_between_packages(lm):
    _, param_bytes, params, _ = lm
    arg_j, aux_j = mxj.c_predict._params_from_bytes(param_bytes)
    arg_t, aux_t = mxt.c_predict._params_from_bytes(param_bytes)
    assert sorted(arg_j) == sorted(arg_t) == sorted(params) and not aux_t
    nd_args, nd_aux = mxt.convert.params_from_numpy(
        arg_j, {"bn_moving_mean": np.ones(3, np.float32)}, ctx=mxt.cpu())
    assert all(a.context == mxt.cpu() for a in nd_args.values())
    again = mxt.convert.params_to_bytes(nd_args, nd_aux)
    arg_2, aux_2 = mxj.c_predict._params_from_bytes(again)
    for name, value in params.items():
        np.testing.assert_array_equal(arg_2[name], value)
    np.testing.assert_array_equal(aux_2["bn_moving_mean"], np.ones(3))


@pytest.mark.parametrize("keys", ["indexed", "named"])
def test_load_ndarray_file_matches_jax(keys):
    rng = np.random.RandomState(3)
    arrays = [rng.normal(size=s).astype(np.float32) for s in ((2, 3), (4,))]
    names = (["1", "0"] if keys == "indexed" else ["arg:w", "b"])
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(names, arrays)))
    names_j, arrays_j = mxj.c_predict.load_ndarray_file(buf.getvalue())
    names_t, arrays_t = mxt.c_predict.load_ndarray_file(buf.getvalue())
    assert names_t == names_j
    for a_t, a_j in zip(arrays_t, arrays_j, strict=True):
        np.testing.assert_array_equal(a_t, a_j)
    with pytest.raises(MXNetError):
        mxt.c_predict.load_ndarray_file(buf.getvalue()[:50])


def test_explicit_begin_state_graph_equals_jax():
    def graph(mx):
        with mx.sym.NameManager():
            cell = mx.rnn.FusedRNNCell(H, num_layers=LAYERS, mode="lstm",
                                       prefix="lstm_")
            states = cell.begin_state(shape=(LAYERS, 3, H))
            out, _ = cell.unroll(T, inputs=mx.sym.var("x"), layout="TNC",
                                 begin_state=states, merge_outputs=True)
            return out
    assert json.loads(graph(mxt).tojson()) == json.loads(graph(mxj).tojson())
    _, out_shapes, _ = graph(mxt).infer_shape(x=(T, 3, 4))
    assert out_shapes == [(T, 3, H)]


def test_params_from_numpy_keeps_dtypes():
    args, _ = mxt.convert.params_from_numpy(
        {"w": np.zeros(2, np.float64), "i": np.zeros(2, np.int64)}, {},
        ctx=mxt.cpu())
    assert args["w"].dtype == np.float64 and args["i"].dtype == np.int64


def test_port_imports_no_jax():
    code = ("import sys, mxnet_tpu_torch\n"
            "import mxnet_tpu_torch.models.transformer\n"
            "import mxnet_tpu_torch.ops.cuda.attention\n"
            "import mxnet_tpu_torch.serving, mxnet_tpu_torch.resilience\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mxnet_tpu' "
            "or m.startswith('mxnet_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("ask", ["predictor", "array_gpu", "default_ctx",
                                 "zeros_tpu"])
def test_gpu_without_card_raises(lm, ask):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    symbol_json, param_bytes, _, _ = lm
    with pytest.raises(MXNetError):
        if ask == "predictor":
            mxt.c_predict.Predictor(symbol_json, param_bytes, 2, 0,
                                    {"data": (1, T)})
        elif ask == "array_gpu":
            mxt.nd.array(np.zeros(3), ctx=mxt.gpu())
        elif ask == "default_ctx":
            assert mxt.current_context() == mxt.gpu(0)
            mxt.nd.array(np.zeros(3))
        else:
            mxt.nd.zeros((2,), ctx=mxt.tpu())


def test_executor_is_forward_only(lm):
    """An executor bound with grad_req='null' (the predict path's) is
    forward only: it holds no gradient array, and backward raises until a
    training forward has run. With grad_req 'write' it trains
    (tests/test_torch_port_train.py)."""
    net = build_lm(mxt)
    ex = net.simple_bind(mxt.cpu(), grad_req="null", data=(1, T))
    assert ex.grad_dict == {} and set(ex.grad_arrays) == {None}
    with pytest.raises(MXNetError):
        ex.backward()
    (out,) = ex.forward()
    assert out.shape == (T, V) and out.context == mxt.cpu()
    with pytest.raises(MXNetError):  # an inference forward records nothing
        ex.backward()
    (train_out,) = ex.forward(is_train=True)
    np.testing.assert_array_equal(train_out.asnumpy(), out.asnumpy())
    ex.backward()
    assert ex.grad_dict == {}
    trainable = net.simple_bind(mxt.cpu(), data=(1, T))  # grad_req 'write'
    assert sorted(trainable.grad_dict) == sorted(net.list_arguments())

"""Parity of the PyTorch port's training path with the JAX package.

The same numpy inputs, made from a seed, go through ``mxnet_tpu`` and
``mxnet_tpu_torch`` at toy size (V=50, H=16, 2 layers, T=5, N=4): the
LSTM layer's backward (the port's autograd Function, on the CPU its plain
version, against ``jax.vjp`` of ``mxnet_tpu.ops.rnn_ops._run_direction``,
whose scan runs the JAX package's ``_cell_bwd`` each step), SoftmaxOutput's
gradient, and the executor's gradients of the whole LM graph with
``grad_req`` write, add and null. JAX references run with x64 off, as
users run the JAX package. Tests marked ``cuda`` hold the backward kernels
to their plain versions and skip without a card; they need neither JAX nor
the JAX package (``python -m pytest --noconftest -m cuda
tests/test_torch_port_train.py`` on a card).
"""
import contextlib
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import rnn_ops as port_rnn_ops
from mxnet_tpu_torch.ops.cuda import lstm as port_lstm

V, H, LAYERS, T, N = 50, 16, 2, 5, 4
# fp32 on both sides: summation order differs only (measured <= 1e-6 at
# gradients of magnitude <= 7)
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: both packages round the same quantities at the same points (the
# dh and dc carries each step, dw's running sum), but XLA and torch sum
# the products and the bias gradient's T*N rows in other orders, so a
# rounding may land one bf16 ulp apart and travel on: measured up to 2
# ulps at an output's largest magnitude; the bound is 4
BF16_ULPS = 4


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
    """The JAX package's counterparts."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu
    from mxnet_tpu.ops import rnn_ops
    from mxnet_tpu.ops.registry import OP_TABLE
    return types.SimpleNamespace(jax=jax, jnp=jnp, mx=mxnet_tpu,
                                 rnn_ops=rnn_ops, ops=OP_TABLE)


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_port_train.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _ulp_tol(ref_arr, ulps):
    """``ulps`` bf16 ulps at the largest magnitude of ``ref_arr``."""
    mag = float(np.abs(ref_arr).max())
    return ulps * 2.0 ** (np.floor(np.log2(mag)) - 7) if mag else 0.0


def _direction_arrays(seed, steps=T, n=N, in_dim=H, hdim=H):
    rng = np.random.RandomState(seed)
    ins = [rng.normal(0, s, shape).astype(np.float32) for s, shape in (
        (1.0, (steps, n, in_dim)), (0.5, (n, hdim)), (0.5, (n, hdim)),
        (0.3, (4 * hdim, in_dim)), (0.3, (4 * hdim, hdim)),
        (0.1, (4 * hdim,)), (0.1, (4 * hdim,)))]
    cots = [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((steps, n, hdim), (n, hdim), (n, hdim))]
    return ins, cots


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp(ref, dtype, reverse):
    """The LSTM layer's gradients in all seven inputs (data, h0, c0 and
    the four weight pieces; the input projection through autograd, the
    recurrence through the Function's plain backward) against jax.vjp of
    the JAX package's _run_direction, both directions."""
    ins, cots = _direction_arrays(seed=3 + reverse)
    jd = ref.jnp.bfloat16 if dtype == "bfloat16" else ref.jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with ref.jax.enable_x64(False):
        def f(*args):
            return ref.rnn_ops._run_direction(*args, "lstm", H,
                                              reverse=reverse)
        outs_j, vjp = ref.jax.vjp(f, *[ref.jnp.asarray(a).astype(jd)
                                       for a in ins])
        grads_j = vjp(tuple(ref.jnp.asarray(c).astype(jd) for c in cots))
        outs_j = [np.asarray(o.astype(ref.jnp.float32)) for o in outs_j]
        grads_j = [np.asarray(g.astype(ref.jnp.float32)) for g in grads_j]
    leaves = [torch.tensor(a).to(td).requires_grad_() for a in ins]
    outs_t = port_rnn_ops._run_direction(*leaves, "lstm", H, reverse=reverse)
    grads_t = torch.autograd.grad(outs_t, leaves,
                                  [torch.tensor(c).to(td) for c in cots])
    for want, got in zip(outs_j + grads_j, list(outs_t) + list(grads_t),
                         strict=True):
        got = got.detach().float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **FP32_TOL)
        else:
            assert np.abs(got - want).max() <= _ulp_tol(want, BF16_ULPS)


@pytest.mark.parametrize("reverse", [False, True])
def test_function_matches_autograd_of_the_plain_loop(reverse):
    """The Function's backward (its own adjoint, from the gates the
    forward kept) equals autograd through the plain forward loop."""
    rng = np.random.RandomState(11)
    arrays = [rng.normal(0, s, shape).astype(np.float32) for s, shape in (
        (1.0, (T, N, 4 * H)), (0.5, (N, H)), (0.5, (N, H)),
        (0.3, (4 * H, H)))]
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = port_lstm.lstm_sequence_fused(*leaves, reverse=reverse)
    cots = [torch.tensor(rng.normal(0, 1, o.shape).astype(np.float32))
            for o in outs]
    got = torch.autograd.grad(outs, leaves, cots)
    want = torch.autograd.grad(
        port_lstm.lstm_sequence_plain(*leaves, reverse=reverse), leaves, cots)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_one_step_with_gradients_runs_as_a_one_step_sequence():
    arrays = [torch.randn(shape, generator=torch.Generator().manual_seed(i))
              for i, shape in enumerate(((3, 4 * H), (3, H), (3, H),
                                         (4 * H, H)))]
    leaves = [a.clone().requires_grad_() for a in arrays]
    h, c = port_lstm.lstm_cell_fused(*leaves)
    want = port_lstm.lstm_cell_plain(*arrays)
    torch.testing.assert_close(h.detach(), want[0])
    torch.testing.assert_close(c.detach(), want[1])
    grads = torch.autograd.grad((h.sum() + c.sum(),), leaves)
    assert all(g.shape == a.shape for g, a in zip(grads, arrays))


def test_backward_on_cpu_counts_no_launch():
    before = (port_lstm.lstm_sequence_backward.launches,
              port_lstm.lstm_cell_backward.launches,
              port_lstm.lstm_sequence_fused.launches)
    ins, cots = _direction_arrays(seed=5)
    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    outs = port_rnn_ops._run_direction(*leaves, "lstm", H)
    torch.autograd.grad(outs, leaves, [torch.tensor(c) for c in cots])
    assert (port_lstm.lstm_sequence_backward.launches,
            port_lstm.lstm_cell_backward.launches,
            port_lstm.lstm_sequence_fused.launches) == before


# -- SoftmaxOutput -----------------------------------------------------------

SOFTMAX_CASES = [
    dict(),
    dict(normalization="batch"),
    dict(normalization="valid", use_ignore=True, ignore_label=3.0),
    dict(use_ignore=True, ignore_label=3.0),
    dict(out_grad=True),
    dict(grad_scale=0.5, normalization="batch", out_grad=True),
    dict(multi_output=True, normalization="valid", use_ignore=True,
         ignore_label=1.0),
    dict(preserve_shape=True, smooth_alpha=0.1),
]


@pytest.mark.parametrize("attrs", SOFTMAX_CASES,
                         ids=lambda a: "-".join(f"{k}={v}" for k, v in
                                                a.items()) or "defaults")
def test_softmax_output_gradient_matches_jax(ref, attrs):
    rng = np.random.RandomState(7)
    if attrs.get("multi_output"):
        data = rng.normal(0, 1, (3, 5, 4)).astype(np.float32)
        label = rng.randint(0, 5, (3, 4)).astype(np.float32)
    elif attrs.get("preserve_shape"):
        data = rng.normal(0, 1, (3, 2, 6)).astype(np.float32)
        label = rng.randint(0, 6, (3, 2)).astype(np.float32)
    else:
        data = rng.normal(0, 1, (8, 6)).astype(np.float32)
        label = rng.randint(0, 6, (8,)).astype(np.float32)
        label[:3] = 3.0  # ignored rows where use_ignore
    head = rng.uniform(0.5, 1.5, data.shape).astype(np.float32)
    with ref.jax.enable_x64(False):
        fn = ref.ops["SoftmaxOutput"].fn
        prob_j, vjp = ref.jax.vjp(lambda d: fn(d, ref.jnp.asarray(label),
                                               **attrs),
                                  ref.jnp.asarray(data))
        (grad_j,) = vjp(ref.jnp.asarray(head))
    d = torch.tensor(data, requires_grad=True)
    lab = torch.tensor(label, requires_grad=True)
    prob_t = mxt.OP_TABLE["SoftmaxOutput"].fn(d, lab, **attrs)
    grad_t, grad_lab = torch.autograd.grad(prob_t, (d, lab),
                                           torch.tensor(head),
                                           allow_unused=True)
    np.testing.assert_allclose(prob_t.detach().numpy(), np.asarray(prob_j),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j),
                               rtol=1e-6, atol=1e-7)
    assert grad_lab is None  # the label gets no gradient


# -- the executor over the whole LM graph -------------------------------------

def bench_lm(mx, vocab=V, hidden=H, layers=LAYERS, seq_len=T):
    """benchmarks/bench_lstm.py's graph (label reshaped in the graph),
    named by a fresh NameManager so both packages give the same names."""
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
        label = mx.sym.Reshape(mx.sym.var("softmax_label"), shape=(-1,))
        return mx.sym.SoftmaxOutput(pred, label, name="softmax")


SHAPES = {"data": (N, T), "softmax_label": (N, T)}
GRAD_REQS = {
    "write": "write",
    "add": "add",
    "null": {"embed_weight": "write", "lstm_parameters": "write",
             "pred_weight": "null", "pred_bias": "add"},
}


def _lm_inputs():
    net = bench_lm(mxt)
    arg_shapes, _, _ = net.infer_shape(**SHAPES)
    rng = np.random.RandomState(0)
    values = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in SHAPES}
    values["data"] = rng.randint(0, V, SHAPES["data"]).astype(np.float32)
    values["softmax_label"] = rng.randint(
        0, V, SHAPES["softmax_label"]).astype(np.float32)
    return values


def _train_executor(mx, ctx, grad_req, values):
    """Bind with ``grad_req`` (inputs null), two forward/backward passes
    (so that 'add' sums two gradients); returns the output and grads."""
    net = bench_lm(mx)
    if isinstance(grad_req, str):
        grad_req = {n: grad_req for n in values if n not in SHAPES}
    reqs = {n: grad_req.get(n, "null") for n in net.list_arguments()}
    ex = net.simple_bind(ctx, grad_req=reqs, **SHAPES)
    for name, value in values.items():
        ex.arg_dict[name][:] = mx.nd.array(value, ctx=ctx)
    for _ in range(2):
        ex.forward(is_train=True)
        ex.backward()
    grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()
             if g is not None}
    return ex.outputs[0].asnumpy(), grads


@pytest.fixture(scope="module")
def jax_executor_grads(ref):
    """The JAX package's executor, once for every grad_req case."""
    values = _lm_inputs()
    with ref.jax.enable_x64(False), _no_disk_cache():
        return values, {case: _train_executor(ref.mx, ref.mx.cpu(), req,
                                              values)
                        for case, req in GRAD_REQS.items()}


@pytest.mark.parametrize("case", sorted(GRAD_REQS))
def test_executor_gradients_match_jax(jax_executor_grads, case):
    values, results = jax_executor_grads
    out_j, grads_j = results[case]
    out_t, grads_t = _train_executor(mxt, mxt.cpu(), GRAD_REQS[case], values)
    np.testing.assert_allclose(out_t, out_j, **FP32_TOL)
    assert sorted(grads_t) == sorted(grads_j)
    for name in grads_j:
        np.testing.assert_allclose(grads_t[name], grads_j[name], **FP32_TOL,
                                   err_msg=name)


def test_executor_bind_takes_the_callers_arrays():
    """Symbol.bind writes gradients into the arrays it was given, and
    backward before a training forward raises."""
    values = _lm_inputs()
    net = bench_lm(mxt)
    names = net.list_arguments()
    ctx = mxt.cpu()
    args = [mxt.nd.array(values[n], ctx=ctx) for n in names]
    grads = [mxt.nd.zeros(a.shape, ctx=ctx) for a in args]
    reqs = ["null" if n in SHAPES else "write" for n in names]
    ex = net.bind(ctx, args, args_grad=grads, grad_req=reqs)
    with pytest.raises(MXNetError):
        ex.backward()
    ex.forward(is_train=False)
    with pytest.raises(MXNetError):  # an inference forward records nothing
        ex.backward()
    outs = ex.forward_backward()
    assert outs[0].shape == (N * T, V)
    weight = names.index("pred_weight")
    assert ex.grad_arrays[weight] is grads[weight]
    assert float(np.abs(grads[weight].asnumpy()).sum()) > 0
    assert float(np.abs(grads[names.index("data")].asnumpy()).sum()) == 0
    assert sorted(ex.output_dict) == ["softmax_output"]


# -- kernels against their plain versions on the card --------------------------

def _backward_case(steps, n, hdim, dtype, reverse, seed, device):
    """A training forward's saved tensors and the head cotangents, at the
    LM's scale, on ``device``."""
    rng = np.random.RandomState(seed)
    xproj = torch.tensor(rng.normal(0, 1, (steps, n, 4 * hdim)), dtype=dtype,
                         device=device)
    h0, c0 = (torch.tensor(rng.uniform(-1, 1, (n, hdim)), dtype=dtype,
                           device=device) for _ in range(2))
    w = torch.tensor(rng.uniform(-0.05, 0.05, (4 * hdim, hdim)), dtype=dtype,
                     device=device)
    out, _, _, gates, cs = port_lstm.lstm_sequence_train_plain(
        xproj, h0, c0, w, reverse)
    dout = torch.tensor(rng.normal(0, 0.1, (steps, n, hdim)), dtype=dtype,
                        device=device)
    dh_last, dc_last = (torch.tensor(rng.normal(0, 0.1, (n, hdim)),
                                     dtype=dtype, device=device)
                        for _ in range(2))
    return (dout, dh_last, dc_last, gates, cs, out, h0, c0, w)


# the backward kernels against their plain version: fp32 differs in
# summation order only, compounding through the recurrence; dw is one
# fp32 product against a per-step sum, held relative to its magnitude.
# bf16: two bf16 ulps at each output's largest magnitude, dw against the
# fp32 sum of the plain version's dgates (the plain version rounds its
# running dw to bf16 every step, the kernel route once).
BWD_FP32_TOL = 1e-4


def _check_backward(got, want, dtype):
    """dgates, dh0, dc0 and dw of a kernel route against the plain
    backward's (dw in fp32 only; the bf16 dw is held apart)."""
    names = ("dgates", "dh0", "dc0", "dw")
    for name, g, p in zip(names, got, want):
        assert g.dtype == p.dtype and g.shape == p.shape, name
    for name, g, p in zip(names, got, want):
        err = (g.float() - p.float()).abs().max().item()
        if dtype == torch.float32:
            scale = max(1.0, p.abs().max().item()) if name == "dw" else 1.0
            assert err <= BWD_FP32_TOL * scale, (name, err)
        elif name != "dw":
            assert err <= _ulp_tol(p.float().cpu().numpy(), 2), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steps,n,hdim", [(7, 3, 200), (16, 16, 1024),
                                          (9, 64, 1024), (4, 1, 1536)])
def test_backward_kernels_match_plain(card, steps, n, hdim, dtype, reverse):
    """The backward sequence kernel (one launch) where the layer fits, the
    per-step kernel (T + 1 launches) at H=1536, against the plain
    backward on the same card tensors."""
    case = _backward_case(steps, n, hdim, dtype, reverse, seed=steps + n,
                          device=card)
    fits = port_lstm.backward_fits(n, hdim, card)
    assert fits == (hdim <= 1320)
    before = (port_lstm.lstm_sequence_backward.launches,
              port_lstm.lstm_cell_backward.launches)
    got = port_lstm.lstm_sequence_backward(*case, reverse=reverse)
    torch.cuda.synchronize()
    after = (port_lstm.lstm_sequence_backward.launches,
             port_lstm.lstm_cell_backward.launches)
    assert after == ((before[0] + 1, before[1]) if fits
                     else (before[0], before[1] + steps + 1))
    want = port_lstm.lstm_sequence_backward_plain(*case, reverse=reverse)
    _check_backward(got, want, dtype)
    if dtype == torch.bfloat16:
        dgates, out, h0 = want[0], case[5], case[6]
        h_prev = (torch.cat([out[1:], h0[None]]) if reverse
                  else torch.cat([h0[None], out[:-1]]))
        dw32 = torch.einsum("tnk,tnh->kh", dgates, h_prev.float())
        tol = _ulp_tol(dw32.cpu().numpy(), 2)
        assert (got[3].float() - dw32).abs().max().item() <= tol


@pytest.mark.cuda
def test_training_forward_kernel_keeps_what_the_plain_version_keeps(card):
    for hdim in (200, 1536):
        rng = np.random.RandomState(hdim)
        args = [torch.tensor(rng.normal(0, s, shape), dtype=torch.float32,
                             device=card)
                for s, shape in ((1.0, (6, 3, 4 * hdim)), (0.5, (3, hdim)),
                                 (0.5, (3, hdim)), (0.03, (4 * hdim, hdim)))]
        for reverse in (False, True):
            got = port_lstm.lstm_sequence_train(*args, reverse=reverse)
            want = port_lstm.lstm_sequence_train_plain(*args, reverse=reverse)
            for g, w in zip(got, want, strict=True):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert (g - w).abs().max().item() <= BWD_FP32_TOL


@pytest.mark.cuda
def test_rnn_op_trains_through_the_kernels(card):
    """A 2-layer bidirectional LSTM's gradients on the card (4 sequence
    forward and 4 sequence backward launches, no per-step launch) against
    the CPU path."""
    rng = np.random.RandomState(2)
    hdim, in_dim, steps, n, layers = 64, 32, 6, 5, 2
    psize = port_rnn_ops.rnn_param_size(layers, in_dim, hdim, "lstm", True)
    arrays = [rng.normal(0, 1, (steps, n, in_dim)),
              rng.uniform(-0.1, 0.1, (psize,)),
              rng.uniform(-1, 1, (2 * layers, n, hdim)),
              rng.uniform(-1, 1, (2 * layers, n, hdim))]
    attrs = dict(state_size=hdim, num_layers=layers, mode="lstm",
                 bidirectional=True, state_outputs=True, _is_train=True)
    fn = mxt.OP_TABLE["RNN"].fn
    grads = {}
    counts = None
    for device in ("cpu", card):
        leaves = [torch.tensor(a, dtype=torch.float32, device=device,
                               requires_grad=True) for a in arrays]
        before = (port_lstm.lstm_sequence_fused.launches,
                  port_lstm.lstm_sequence_backward.launches,
                  port_lstm.lstm_cell_fused.launches,
                  port_lstm.lstm_cell_backward.launches)
        outs = fn(None, *leaves, **attrs)
        loss = sum((o * (k + 1)).sum() for k, o in enumerate(outs))
        grads[str(device)] = [g.cpu() for g in
                              torch.autograd.grad(loss, leaves)]
        after = (port_lstm.lstm_sequence_fused.launches,
                 port_lstm.lstm_sequence_backward.launches,
                 port_lstm.lstm_cell_fused.launches,
                 port_lstm.lstm_cell_backward.launches)
        counts = tuple(a - b for a, b in zip(after, before))
    assert counts == (4, 4, 0, 0)
    for g, w in zip(grads[str(card)], grads["cpu"]):
        assert (g - w).abs().max().item() <= BWD_FP32_TOL * max(
            1.0, w.abs().max().item())

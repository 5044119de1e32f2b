"""Parity of the PyTorch port's Gluon layers with the JAX package.

tests/test_gluon.py's layer cases with values (a strided and a grouped
channel-last convolution, 1-D and 2-D transposed convolutions with
output padding, InstanceNorm, LeakyReLU), each layer's output and its
input's and parameters' gradients under a seeded cotangent, and
``nn.MultiHeadAttention`` (causal self-attention, and causal attention
over a shorter key sequence, the op's top-left mask), imperative and
hybridized, through ``mxnet_tpu`` and ``mxnet_tpu_torch`` on the CPU from
the same seeded weights. The JAX package runs each hybridized, once, in a
module-scope fixture, with x64 off as users run it. Which core the
attention op runs (the flash-attention kernels, or the plain products as
the JAX op) is decided from dtype, head dim and mask; the ``cuda`` tests
run the op on the card on each side of that decision.
"""
import contextlib
import os
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt

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


def _layers(mx, hybrid):
    """tests/test_gluon.py's layer cases with values: each layer's output
    and its input and parameter gradients, from seeded weights."""
    nn = mx.gluon.nn
    x1 = _data((2, 4, 10), 5)
    x2 = _data((1, 4, 10, 10), 6)
    layers = [
        ("conv2d_s2", nn.Conv2D(6, (3, 3), strides=2, prefix="c2_"), x2),
        ("conv2d_nhwc_group", nn.Conv2D(4, 3, padding=1, groups=2,
                                        layout="NHWC", in_channels=4,
                                        prefix="c2n_"),
         x2.transpose(0, 2, 3, 1).copy()),
        ("conv1d_t", nn.Conv1DTranspose(6, 3, prefix="t1_"), x1),
        ("conv2d_t", nn.Conv2DTranspose(6, (3, 3), strides=2,
                                        output_padding=1, prefix="t2_"),
         x2),
        ("instancenorm", nn.InstanceNorm(scale=True, prefix="in_"), x2),
        ("leakyrelu", nn.LeakyReLU(0.1, prefix="lr_"), x2),
    ]
    out = {}
    for i, (name, layer, x) in enumerate(layers):
        mx.random.seed(10 + i)
        layer.initialize(mx.init.Xavier())
        if hybrid:
            layer.hybridize()
        xa = mx.nd.array(x)
        xa.attach_grad()
        with mx.autograd.record():
            y = layer(xa)
        y.backward(mx.nd.array(_data(y.shape, 100 + i)))
        out[name] = y.asnumpy()
        out[name + " dx"] = xa.grad.asnumpy()
        for k, p in layer.collect_params().items():
            if p.grad_req != "null":
                out[name + " d" + k] = p.grad().asnumpy()
    return out


def _attention(mx, hybrid):
    """Causal self-attention and causal attention over a shorter key
    sequence (the op's top-left mask)."""
    mx.random.seed(3)
    att = mx.gluon.nn.MultiHeadAttention(16, 4, causal=True, prefix="mha_")
    att.initialize(mx.init.Xavier())
    if hybrid:
        att.hybridize()
    q = mx.nd.array(_data((2, 6, 16), 16))
    kv = mx.nd.array(_data((2, 5, 16), 17))
    out = {}
    with mx.autograd.record():
        y = att(q) + att(q, kv, kv).sum()
    y.backward(mx.nd.array(_data((2, 6, 16), 18)))
    out["out"] = y.asnumpy()
    out.update(_params(att, grads=True))
    # a key bias moves every score of a query row alike, which the softmax
    # cancels: its gradient is 0 up to rounding in both packages
    del out["mha_key_bias.grad"]
    return out


SCENARIOS = {f.__name__[1:]: f for f in (_layers, _attention)}


@pytest.fixture(scope="module")
def jax_runs(ref):
    """Both scenarios through the JAX package, hybridized: one program a
    block and call signature (its imperative path gives the same
    numbers, tests/test_gluon.py: test_hybridize_consistency)."""
    with _jax_package():
        return {name: f(ref.mx, True) for name, f in SCENARIOS.items()}


@pytest.fixture(scope="module")
def port_runs():
    with mxt.cpu():
        return {(name, hybrid): f(mxt, hybrid)
                for name, f in SCENARIOS.items() for hybrid in (False, True)}


@pytest.mark.parametrize("hybrid", [False, True],
                         ids=["imperative", "hybridized"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_layers_match_jax(jax_runs, port_runs, name, hybrid):
    got, want = port_runs[name, hybrid], jax_runs[name]
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], f"{name}: {key}")


def test_hybridized_layers_match_imperative(port_runs):
    """The hybridized layers' outputs and gradients are the imperative
    ones bit for bit: the cached op runs the same body."""
    for name in SCENARIOS:
        imp, hyb = port_runs[name, False], port_runs[name, True]
        for key in imp:
            np.testing.assert_array_equal(hyb[key], imp[key],
                                          err_msg=f"{name}: {key}")


@pytest.mark.parametrize("dtype, d, sk, want", [
    ("bfloat16", 64, 8, True),
    ("bfloat16", 128, 8, True),
    ("bfloat16", 256, 8, True),
    ("bfloat16", 64, 5, False),
    ("float16", 64, 8, True),
    ("float32", 64, 8, False),
], ids=["bf16-d64", "bf16-d128", "bf16-d256", "bf16-causal-sk5",
        "fp16-d64", "fp32-d64"])
def test_attention_core_route(dtype, d, sk, want):
    """The attention op's core is the flash kernels for bf16 and fp16
    heads of a dim they take (up to ``MAX_HEAD_DIM``) and their causal
    mask (Sq = Sk), and the plain products otherwise: fp32, a causal mask
    over Sq != Sk."""
    import torch
    from mxnet_tpu_torch.ops.attention_ops import _flash_route
    q = torch.zeros((1, 2, 8, d), dtype=getattr(torch, dtype))
    k = torch.zeros((1, 2, sk, d), dtype=q.dtype)
    assert _flash_route(q, k, causal=True) is want


# the card against the CPU in the same dtype: fp32 at REL, bf16 and fp16
# at the attention phases' bound (2**-6 of each result's largest
# magnitude, floored at 2**-10)
LOW_REL, LOW_FLOOR = 2.0 ** -6, 2.0 ** -10


def _mha_op(mx, dtype, d, ctx=None, weights=None):
    """nn.MultiHeadAttention (2 heads of dim ``d``, causal) forward and
    backward under record() on (2, 64, 2 d) seeded inputs: the output,
    the input's and the parameters' gradients (host fp32), and the
    weights."""
    mx.random.seed(6)
    att = mx.gluon.nn.MultiHeadAttention(2 * d, 2, causal=True, dtype=dtype,
                                         prefix="mha_")
    att.initialize(mx.init.Xavier(), ctx=ctx)
    if weights is not None:
        for k, p in att.collect_params().items():
            p.data()[:] = weights[k]
    x = mx.nd.array(_data((2, 64, 2 * d), 7), ctx=ctx, dtype=dtype)
    cot = mx.nd.array(_data((2, 64, 2 * d), 8), ctx=ctx, dtype=dtype)
    x.attach_grad()
    with mx.autograd.record():
        out = att(x)
    out.backward(cot)
    res = {"out": out.asnumpy(), "dx": x.grad.asnumpy()}
    # the key bias's gradient is 0 up to rounding (see _attention)
    res.update({k: p.grad().asnumpy() for k, p in
                att.collect_params().items() if k != "mha_key_bias"})
    return ({k: v.astype(np.float32) for k, v in res.items()},
            {k: p.data().asnumpy() for k, p in att.collect_params().items()})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d", [("bfloat16", 64), ("bfloat16", 256),
                                      ("float16", 64), ("float32", 64)],
                         ids=["bf16-d64", "bf16-d256", "fp16-d64",
                              "fp32-d64"])
def test_attention_op_on_card_matches_cpu(card, dtype, d):
    """nn.MultiHeadAttention on the card, forward and backward, against
    the CPU from the same weights: bf16 at D=64 and 256 and fp16 at D=64
    through one flash forward and one flash backward launch, fp32 through
    the plain products with no launch."""
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention as fa
    before = (fa.launches, fa.backward_launches)
    with card:
        got, weights = _mha_op(mxt, dtype, d)
    launched = (fa.launches - before[0], fa.backward_launches - before[1])
    assert launched == ((0, 0) if dtype == "float32" else (1, 1)), launched
    with mxt.cpu():
        want, _ = _mha_op(mxt, dtype, d, weights=weights)
    rel, floor = (REL, 1e-6) if dtype == "float32" else (LOW_REL, LOW_FLOOR)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.isfinite(got[key]).all(), key
        tol = rel * max(float(np.abs(want[key]).max()), floor)
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= tol, f"{dtype} d={d} {key}: |err| {err:.3g} > {tol:.3g}"


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_port_gluon_layers.py`")
    mxt.gpu(0).torch_device()  # TF32 off, as the port runs
    return mxt.gpu(0)

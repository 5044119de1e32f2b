"""Parity of the PyTorch port with the JAX package at the dtypes and head
dims the JAX kernels take past bf16 and D = 128 (ROADMAP.md B5).

The same numpy inputs, made from a seed, go through ``mxnet_tpu`` and
``mxnet_tpu_torch`` on the CPU: ``flash_attention`` in fp16 at D = 16, in
bf16 at D = 256 and in fp32 at D = 320, dense, causal, with key lengths
and packed (the port's plain versions against the JAX package's Pallas
kernels in interpret mode, and their gradients against ``jax.vjp`` of the
JAX package's ``flash_attention``); the LSTM cell (``lstm_cell_fused(impl=
"interpret")``) and the RNN op at fp16 states and at bf16 states over fp32
parameters; the transformer LM's forward and loss at fp16 and at head dim
256; and a Gluon ``rnn.LSTM`` cast to fp16, its weights carried over by
``convert.gluon_params_from_numpy``. Every JAX reference but the Gluon
layer comes from two jits, with x64 off as users run the JAX package: the
attention and LM references in one, the LSTM's in the other (in one jit
XLA took half as long again to compile them all, on this file's CPU
runs, as in these two).

The tests marked ``cuda`` hold the Hopper kernels at these dtypes and
head dims to their plain versions on the card and skip without one; they
need neither JAX nor the JAX package, so on a card they run with ``python
-m pytest --noconftest -m cuda tests/test_torch_port_dtypes.py``.
"""
import contextlib
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.convert import transformer_params_from_numpy
from mxnet_tpu_torch.models.transformer import TransformerConfig, forward
from mxnet_tpu_torch.models.transformer import lm_loss
from mxnet_tpu_torch.ops.cuda import attention as A
from mxnet_tpu_torch.ops.cuda import lstm as L

# fp32 on both sides: only the summation order differs (over D = 320
# products), so each result is held at RTOL of its own largest magnitude
RTOL = 1e-5
# fp16 and bf16 results in their own dtype, compared in fp32 at unit-scale
# inputs: both packages compute in fp32 and round once, so they sit within
# an ulp or two of each other (fp16's 2**-10 at 1.0, bf16's 2**-7)
FP16_TOL = 2e-3
BF16_TOL = 1.6e-2
TOLS = {"float16": FP16_TOL, "bfloat16": BF16_TOL}
DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}

# name -> (dtype, (B, H, S, D), causal, key lengths, packed segment ids)
ATT_CASES = {
    "fp16_dense": ("float16", (2, 2, 32, 16), False, None, False),
    "fp16_causal": ("float16", (2, 2, 32, 16), True, None, False),
    "fp16_lengths": ("float16", (2, 2, 32, 16), True, [32, 11], False),
    "fp16_packed": ("float16", (2, 2, 32, 16), True, None, True),
    "d256_causal": ("bfloat16", (1, 2, 16, 256), True, None, False),
    "d256_lengths_packed": ("bfloat16", (2, 1, 16, 256), False, [16, 5],
                            True),
    "d320_causal_lengths": ("float32", (2, 1, 16, 320), True, [9, 0],
                            False),
    "d320_packed": ("float32", (2, 1, 16, 320), False, None, True),
}

# the LSTM: (T, N, H) of the RNN op's toy layer (two layers, input 6)
RNN_T, RNN_N, RNN_I, RNN_H = 5, 3, 6, 8
# name -> (states' dtype, xproj's and w_h2h's dtype)
CELL_CASES = {"fp16": ("float16", "float16"),
              "bf16_over_fp32": ("bfloat16", "float32")}

# the transformer: 2 layers, vocab 64; fp16 at 4 heads of 32, and bf16 at
# 2 heads of 256 (the head dim of Gemma's published 2B and 7B)
TF_V, TF_S = 64, 16
TF_CASES = {"fp16": dict(d_model=128, num_heads=4, dtype="float16"),
            "d256": dict(d_model=512, num_heads=2, dtype="bfloat16")}
# the LM's logits and loss against the JAX package's: fp16 and bf16
# activations round at other places in the two frameworks over 2 layers;
# relative to the logits' largest magnitude
TF_TOL = {"fp16": 2e-3, "d256": 1.6e-2}


def _segments(b, s):
    seg = np.zeros((b, s), np.int32)
    seg[0, :s // 4], seg[0, s // 4:s // 2], seg[0, s // 2:s - 3] = 1, 2, 3
    seg[1:, s // 8:] = 1
    return seg


def _att_case(name, seed=0):
    dtype, (b, h, s, d), causal, lengths, packed = ATT_CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.normal(0, 1, (b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    seg = _segments(b, s) if packed else None
    return q, k, v, do, causal, lens, seg


def _cell_case(name, seed=0):
    rng = np.random.RandomState(seed)
    n, h = 3, 8
    return [rng.normal(0, 0.5, shape).astype(np.float32) for shape in
            ((n, 4 * h), (n, h), (n, h), (4 * h, h))]


def _rnn_case(seed=0):
    """The RNN op's inputs: data (T, N, I), the packed parameters of two
    layers, h0 and c0 (2, N, H)."""
    rng = np.random.RandomState(seed)
    size = 4 * RNN_H * (RNN_I + RNN_H + 2) + 4 * RNN_H * (2 * RNN_H + 2)
    return [rng.normal(0, 0.5, shape).astype(np.float32) for shape in
            ((RNN_T, RNN_N, RNN_I), (size,), (2, RNN_N, RNN_H),
             (2, RNN_N, RNN_H))]


def _tf_tokens():
    return np.random.RandomState(4).randint(0, TF_V, (2, TF_S + 1))


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX reference of this file but the Gluon layer's, from two
    jits (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu
    from mxnet_tpu.models import transformer
    from mxnet_tpu.ops.pallas import attention
    from mxnet_tpu.ops.pallas.lstm import lstm_cell_fused
    rnn = mxnet_tpu.ops.get_op("RNN").fn
    cfgs = {n: transformer.TransformerConfig(
        vocab_size=TF_V, num_layers=2, max_seq_len=64, **kw)
        for n, kw in TF_CASES.items()}

    def attend(qkv, lens, seg, name, **kw):
        return attention.flash_attention(*qkv, causal=ATT_CASES[name][2],
                                         lengths=lens, segment_ids=seg, **kw)

    def run(arrays, params):
        out = {"att": {}, "att_grad": {}, "tf": {}}
        for name, (q, k, v, do, lens, seg) in arrays["att"].items():
            dt = jnp.dtype(ATT_CASES[name][0])
            q, k, v, do = (x.astype(dt) for x in (q, k, v, do))
            out["att"][name] = attend(
                (q, k, v), lens, seg, name, block_q=8, block_k=8,
                force_pallas=True).astype(jnp.float32)
            _, vjp = jax.vjp(
                lambda *qkv, lens=lens, seg=seg, name=name: attend(
                    qkv, lens, seg, name), q, k, v)
            out["att_grad"][name] = [g.astype(jnp.float32) for g in vjp(do)]
        for name, cfg in cfgs.items():
            toks = arrays["tokens"]
            out["tf"][name] = {
                "logits": transformer.forward(params[name], toks[:, :-1], cfg),
                "loss": transformer.lm_loss(params[name], toks, cfg)}
        return out

    def run_lstm(arrays):
        out = {"cell": {}, "rnn": {}}
        for name, (sdt, odt) in CELL_CASES.items():
            x, h, c, w = arrays["cell"][name]
            hn, cn = lstm_cell_fused(x.astype(odt), h.astype(sdt),
                                     c.astype(sdt), w.astype(odt),
                                     impl="interpret")
            out["cell"][name] = [hn.astype(jnp.float32),
                                 cn.astype(jnp.float32)]
            data, par, h0, c0 = arrays["rnn"]
            res = rnn(None, data.astype(odt), par.astype(odt),
                      h0.astype(sdt), c0.astype(sdt), state_size=RNN_H,
                      num_layers=2, mode="lstm", state_outputs=True)
            out["rnn"][name] = [r.astype(jnp.float32) for r in res[:3]]
        return out

    inputs = {"att": {n: _att_case(n, seed=i)[:4] + _att_case(n)[5:]
                      for i, n in enumerate(ATT_CASES)},
              "cell": {n: _cell_case(n, seed=10 + i)
                       for i, n in enumerate(CELL_CASES)},
              "rnn": _rnn_case(seed=20), "tokens": _tf_tokens()}
    with jax.enable_x64(False):
        params = {n: transformer.init_params(i, cfg)
                  for i, (n, cfg) in enumerate(cfgs.items())}
        arrays = jax.tree.map(lambda a: None if a is None else jnp.asarray(a),
                              inputs, is_leaf=lambda a: a is None)
        out = jax.device_get({**jax.jit(run)(arrays, params),
                              **jax.jit(run_lstm)(arrays)})
        out = jax.tree.map(np.asarray, out)
        params = jax.tree.map(np.asarray, params)
    return types.SimpleNamespace(out=out, params=params)


def _t(a, dtype):
    return None if a is None else torch.from_numpy(a).to(DTYPES[dtype])


def _close(got, want, tol, what):
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert got.shape == want.shape and err <= tol, \
        f"{what}: |err| {err:.3g} > {tol:.3g}"


def _tol(dtype, want):
    """fp16 and bf16 absolute; fp32 RTOL of the result's largest
    magnitude."""
    if dtype == "float32":
        return RTOL * max(float(np.abs(want).max()), 1e-6)
    return TOLS[dtype]


@pytest.mark.parametrize("name", sorted(ATT_CASES))
def test_attention_matches_pallas_interpret(jax_ref, name):
    """The port's plain forward (what a CPU tensor runs) against the JAX
    package's Pallas kernel in interpret mode, in the case's dtype."""
    dtype = ATT_CASES[name][0]
    q, k, v, _, causal, lens, seg = _att_case(
        name, seed=list(ATT_CASES).index(name))
    got = A.flash_attention(
        *(_t(a, dtype) for a in (q, k, v)), causal=causal,
        lengths=None if lens is None else torch.from_numpy(lens),
        segment_ids=None if seg is None else torch.from_numpy(seg))
    assert got.dtype == DTYPES[dtype]
    want = jax_ref.out["att"][name]
    _close(got.float().numpy(), want, _tol(dtype, want), name)


@pytest.mark.parametrize("name", sorted(ATT_CASES))
def test_attention_gradients_match_jax(jax_ref, name):
    """dq, dk and dv through the port's autograd Functions (their plain
    backward versions on the CPU) against ``jax.vjp``, in the case's
    dtype; fp32 relative to each gradient's largest magnitude."""
    dtype = ATT_CASES[name][0]
    q, k, v, do, causal, lens, seg = _att_case(
        name, seed=list(ATT_CASES).index(name))
    leaves = [_t(a, dtype).requires_grad_() for a in (q, k, v)]
    out = A.flash_attention(
        *leaves, causal=causal,
        lengths=None if lens is None else torch.from_numpy(lens),
        segment_ids=None if seg is None else torch.from_numpy(seg))
    grads = torch.autograd.grad(out, leaves, _t(do, dtype))
    for g, want, what in zip(grads, jax_ref.out["att_grad"][name],
                             ("dq", "dk", "dv")):
        assert g.dtype == DTYPES[dtype]
        _close(g.float().numpy(), want, _tol(dtype, want), f"{name} {what}")


def test_head_dim_past_the_library_limit_raises_naming_b5():
    """Past MAX_HEAD_DIM the kernel wrapper refuses before any launch,
    naming the queue entry that holds the rest; a head dim whose stride is
    not 1 is copied, not refused."""
    wide = torch.zeros(1, 1, 4, A.MAX_HEAD_DIM + 4)
    with pytest.raises(mxt.base.MXNetError, match="B5"):
        A._kernel_operands((wide, wide, wide))
    x = torch.zeros(1, 1, 4, 32)[..., ::2]
    assert all(t.stride(3) == 1 for t in A._kernel_operands((x, x, x)))


@pytest.mark.parametrize("name", sorted(CELL_CASES))
def test_lstm_cell_matches_interpret(jax_ref, name):
    """One step of the port's cell (``lstm_cell_fused`` on CPU tensors)
    against the JAX package's Pallas cell in interpret mode: fp16 states,
    and bf16 states over an fp32 xproj and w_h2h; h' and c' keep the
    states' dtype."""
    sdt, odt = CELL_CASES[name]
    x, h, c, w = _cell_case(name, seed=10 + list(CELL_CASES).index(name))
    hn, cn = L.lstm_cell_fused(_t(x, odt), _t(h, sdt), _t(c, sdt),
                               _t(w, odt))
    for got, want, what in zip((hn, cn), jax_ref.out["cell"][name],
                               ("h", "c")):
        assert got.dtype == DTYPES[sdt]
        _close(got.float().numpy(), want, TOLS[sdt], f"{name} {what}")


@pytest.mark.parametrize("name", sorted(CELL_CASES))
def test_rnn_op_matches_jax(jax_ref, name):
    """The RNN op's two-layer LSTM (out, hy, cy) against the JAX
    package's: fp16 data, parameters and states, and bf16 states over fp32
    data and parameters (the second layer's xproj is then fp32 over bf16
    states, as jnp promotes it)."""
    sdt, odt = CELL_CASES[name]
    data, par, h0, c0 = _rnn_case(seed=20)
    outs = mxt.OP_TABLE["RNN"].fn(
        None, _t(data, odt), _t(par, odt), _t(h0, sdt), _t(c0, sdt),
        state_size=RNN_H, num_layers=2, mode="lstm", state_outputs=True)
    for got, want, what in zip(outs[:3], jax_ref.out["rnn"][name],
                               ("out", "hy", "cy")):
        assert got.dtype == DTYPES[sdt]
        _close(got.float().numpy(), want, TOLS[sdt], f"{name} {what}")


@pytest.mark.parametrize("name", sorted(TF_CASES))
def test_transformer_matches_jax(jax_ref, name):
    """``TransformerLM``'s forward and loss at fp16 and at head dim 256,
    from the JAX package's parameters, against its own: logits relative
    to their largest magnitude, the loss relative to itself."""
    cfg = TransformerConfig(vocab_size=TF_V, num_layers=2, max_seq_len=64,
                            **TF_CASES[name])
    assert cfg.head_dim == (32 if name == "fp16" else 256)
    params = transformer_params_from_numpy(jax_ref.params[name],
                                           ctx=mxt.cpu())
    toks = torch.from_numpy(_tf_tokens())
    want = jax_ref.out["tf"][name]
    logits = forward(params, toks[:, :-1], cfg)
    tol = TF_TOL[name]
    _close(logits.numpy(), want["logits"],
           tol * float(np.abs(want["logits"]).max()), f"{name} logits")
    loss = float(lm_loss(params, toks, cfg))
    assert abs(loss - float(want["loss"])) <= tol * float(want["loss"])


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
            yield mxnet_tpu
    finally:
        if old is None:
            del os.environ["MXTPU_COMPILE_CACHE"]
        else:
            os.environ["MXTPU_COMPILE_CACHE"] = old


def _gluon_lstm(mx, x, ctx=None):
    """A two-layer Gluon ``rnn.LSTM`` from seeded Xavier, cast to fp16,
    run on ``x`` (T, N, C) with fp16 begin states (``begin_state(N,
    dtype="float16")``, the parameters' dtype): (out, h, c, weights)."""
    mx.random.seed(0)
    net = mx.gluon.rnn.LSTM(RNN_H, num_layers=2, layout="TNC",
                            input_size=RNN_I)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.cast("float16")
    return net, net.begin_state(RNN_N, dtype="float16")


def test_gluon_lstm_cast_to_fp16_matches_jax():
    """Gluon's rnn.LSTM after ``cast('float16')``, the JAX package's
    weights carried over by ``convert.gluon_params_from_numpy``: outputs
    and the final states in fp16, within FP16_TOL of the JAX package's."""
    x = _rnn_case(seed=21)[0].astype(np.float16)
    with _jax_package() as mx:
        net, states = _gluon_lstm(mx, x)
        out, (h, c) = net(mx.nd.array(x, dtype="float16"), states)
        want = [a.asnumpy().astype(np.float32) for a in (out, h, c)]
        weights = {k: p.data().asnumpy()
                   for k, p in net.collect_params().items()}
    with mxt.cpu():
        net, states = _gluon_lstm(mxt, x)
        mxt.convert.gluon_params_from_numpy(net, weights)
        out, (h, c) = net(mxt.nd.array(x, dtype="float16"), states)
    for got, ref_, what in zip((out, h, c), want, ("out", "h", "c")):
        assert got.dtype == np.float16
        _close(got.asnumpy(), ref_, FP16_TOL, what)


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_port_dtypes.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# kernel against plain on the card: (dtype, (B, H, Sq, Sk, D), causal,
# masked, the variant counter the forward must move)
CARD_ATT = [
    ("float16", (2, 3, 200, 200, 64), True, None, "wgmma"),
    ("float16", (2, 3, 130, 257, 128), False, None, "wgmma"),
    ("float16", (2, 3, 256, 256, 64), True, "lengths", "wgmma"),
    ("float16", (2, 3, 256, 256, 128), True, "packed", "wgmma"),
    ("bfloat16", (2, 2, 200, 200, 256), True, None, "mma"),
    ("float16", (2, 2, 150, 150, 256), False, "packed", "mma"),
    ("float32", (2, 2, 150, 150, 320), True, "lengths", None),
    ("bfloat16", (1, 2, 70, 90, 320), False, None, None),
    ("float32", (1, 2, 64, 64, A.MAX_HEAD_DIM), True, None, None),
]
# the card's tolerances: fp32 summation order only, absolute; fp16 and
# bf16 (P and dS rounded to the inputs' type for the tensor-core
# products) for results of unit scale, scaled by the result's largest
# magnitude past 1 (one fp16 ulp at |x| in [4, 8) is 3.9e-3)
CARD_TOL = {"float32": 2e-5, "float16": 2e-3, "bfloat16": 1.6e-2}


def _card_tol(dtype, ref):
    if dtype == "float32":
        return CARD_TOL[dtype]
    return CARD_TOL[dtype] * max(1.0, ref.float().abs().max().item())


def _card_masks(kind, b, s, device):
    if kind == "lengths":
        lens = torch.tensor([s, s // 3] + [0] * (b - 2),
                            dtype=torch.int32)[:b]
        return lens.to(device), None
    if kind == "packed":
        return None, torch.from_numpy(_segments(b, s)).to(device)
    return None, None


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_ATT,
                         ids=[f"{c[0]}-d{c[1][4]}-{c[3] or 'dense'}"
                              for c in CARD_ATT])
def test_attention_kernels_match_plain_on_card(card, case):
    """The attention kernels, forward and backward, at the B5 dtypes and
    head dims against their plain versions on the same card tensors, each
    launch on the variant the case must take."""
    dtype, (b, h, sq, sk, d), causal, kind, variant = case
    gen = torch.Generator(device="cpu").manual_seed(sum(case[1]))
    q, do = (torch.randn(b, h, sq, d, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, generator=gen) for _ in range(2))
    q, k, v, do = (t.to(card, DTYPES[dtype]) for t in (q, k, v, do))
    lens, seg = _card_masks(kind, b, sk, card)
    before = (A.flash_attention.wgmma_launches, A.flash_attention.mma_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.flash_attention(*leaves, causal=causal, lengths=lens,
                            segment_ids=seg)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    moved = (A.flash_attention.wgmma_launches - before[0],
             A.flash_attention.mma_launches - before[1])
    assert moved == {"wgmma": (1, 0), "mma": (0, 1), None: (0, 0)}[variant]
    if kind is None:
        want = A.attention_plain(q, k, v, causal)
        wgrads = A.attention_backward_plain(q, k, v, want, do, causal)
    else:
        want = A.masked_attention_plain(q, k, v, lens, seg, causal)
        wgrads = A.masked_attention_backward_plain(q, k, v, do, lens, seg,
                                                   causal)
    for got, ref_ in zip((out, *grads), (want, *wgrads)):
        assert got.dtype == ref_.dtype == DTYPES[dtype]
        assert ((got.float() - ref_.float()).abs().max().item()
                <= _card_tol(dtype, ref_))


# (T, N, H, states' dtype, xproj's and w_h2h's dtype, reverse) on the card
CARD_LSTM = [
    (128, 16, 1024, "float16", "float16", False),
    (64, 3, 200, "float16", "float16", True),
    (64, 16, 1024, "bfloat16", "float32", False),
    (32, 5, 1024, "float16", "float32", True),
    (6, 2, 1536, "float16", "float16", False),
]
# h and c over 128 steps: fp16 states rounded every step as the plain
# version rounds them; bf16 at the file's bf16 bound
CARD_LSTM_TOL = {"float16": 4e-3, "bfloat16": 1.6e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_LSTM,
                         ids=[f"{c[3]}-over-{c[4]}-H{c[2]}"
                              f"{'-rev' if c[5] else ''}" for c in CARD_LSTM])
def test_lstm_kernels_match_plain_on_card(card, case):
    """B1 forward and backward at fp16 states and at fp32 operands over
    narrower states against their plain versions on the same card
    tensors: the sequence kernel (the per-step one at H = 1536) and the
    backward the plan takes."""
    steps, n, hdim, sdt, odt, reverse = case
    gen = torch.Generator(device="cpu").manual_seed(steps + n + hdim)
    x = (torch.randn(steps, n, 4 * hdim, generator=gen) * 0.5).to(
        card, DTYPES[odt])
    w = (torch.randn(4 * hdim, hdim, generator=gen) / hdim ** 0.5).to(
        card, DTYPES[odt])
    h0, c0 = ((torch.randn(n, hdim, generator=gen) * 0.5).to(
        card, DTYPES[sdt]) for _ in range(2))
    fwd = L.lstm_sequence_train(x, h0, c0, w, reverse)
    want = L.lstm_sequence_train_plain(x, h0, c0, w, reverse)
    cot = [torch.randn(s, generator=gen).to(card, DTYPES[sdt])
           for s in ((steps, n, hdim), (n, hdim), (n, hdim))]
    bwd = L.lstm_sequence_backward(*cot, fwd[3], fwd[4], fwd[0], h0, c0, w,
                                   reverse)
    wbwd = L.lstm_sequence_backward_plain(*cot, want[3], want[4], want[0],
                                          h0, c0, w, reverse)
    torch.cuda.synchronize()
    tol = CARD_LSTM_TOL[sdt]
    for got, ref_ in zip(fwd[:3] + bwd[1:3], want[:3] + wbwd[1:3]):
        assert got.dtype == ref_.dtype == DTYPES[sdt]
        assert (got.float() - ref_.float()).abs().max().item() <= tol

"""Parity of the PyTorch port's attention with the JAX package.

The same numpy inputs, made from a seed, go through ``mxnet_tpu`` and
``mxnet_tpu_torch``: ``flash_attention`` dense and masked (the port's plain
versions on the CPU against the JAX package's jnp path, and against its
Pallas kernels in interpret mode), its gradients (the port's plain
backward versions and its autograd Functions against ``jax.vjp`` of the
JAX package's ``flash_attention``, whose dense core runs
``_blockwise_bwd``), ``MultiHeadAttention`` and the
``_contrib_flash_attention`` op, forward and gradients through the
executor. Tests marked ``cuda`` hold the Hopper kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) to their
plain versions and skip without a card; they need neither JAX nor the JAX
package, so on a card they run with ``python -m pytest --noconftest -m
cuda tests/test_torch_port_attention.py``.
"""
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import _build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention_ops as port_attention_ops
from mxnet_tpu_torch.ops.cuda.attention import (
    _combined_mask, _launch, _mma_sync, _mma_sync_backward,
    attention_backward_plain, attention_lse_plain, attention_plain,
    flash_attention, masked_attention_backward_plain, masked_attention_plain)

# fp32 on both sides: only the summation order differs
RTOL, ATOL = 1e-5, 1e-6
# bf16 output: both round the same fp32 value, one bf16 ulp apart at most
BF16_ATOL = 1e-2
# gradients in fp32, relative to each gradient's largest magnitude: only the
# summation order differs
GRAD_TOL = 1e-5
# bf16 gradients against JAX's: both sum in fp32 and round each gradient
# once at the end (measured equal bit for bit at these shapes); a sum that
# lands on the other side of a rounding is one bf16 ulp of the gradient's
# largest magnitude
BF16_GRAD_TOL = 2.0 ** -8


@pytest.fixture(scope="module")
def ref():
    """The JAX package's counterparts."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import attention_ops
    from mxnet_tpu.ops.pallas import attention
    return types.SimpleNamespace(jnp=jnp, attention=attention,
                                 attention_ops=attention_ops)


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run "
                    "`python -m pytest --noconftest -m cuda "
                    "tests/test_torch_port_attention.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d))]


def _segments(b, s):
    """Three packed segments and a pad tail in row 0; one segment and a
    pad head in the other rows."""
    seg = np.zeros((b, s), np.int32)
    cut = [s // 4, s // 2, (3 * s) // 4]
    seg[0, :cut[0]], seg[0, cut[0]:cut[1]], seg[0, cut[1]:cut[2]] = 1, 2, 3
    seg[1:, s // 8:] = 1
    return seg


# name -> (B, H, Sq, Sk, D, causal, lengths, segments)
CASES = {
    "dense": (2, 2, 16, 16, 8, False, None, False),
    "dense_causal": (2, 2, 16, 16, 8, True, None, False),
    "causal_sq_lt_sk": (1, 2, 5, 13, 8, True, None, False),
    "noncausal_sq_ne_sk": (1, 2, 7, 12, 8, False, None, False),
    "lengths": (3, 2, 16, 16, 8, False, [16, 9, 0], False),
    "lengths_causal": (3, 2, 16, 16, 8, True, [16, 9, 0], False),
    "segments": (2, 2, 16, 16, 8, False, None, True),
    "segments_lengths_causal": (2, 2, 16, 16, 8, True, [12, 16], True),
}


def _case(name, seed=0):
    b, h, sq, sk, d, causal, lengths, segments = CASES[name]
    q, k, v = _qkv(b, h, sq, sk, d, seed)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    seg = _segments(b, sk) if segments else None
    return q, k, v, causal, lens, seg


def _mha_inputs(sq, sk, seed):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, (2, s, 16)).astype(np.float32)
            for s in (sq, sk, sk)]


BF16_CASES = ["dense_causal", "lengths_causal"]
# name -> (case of CASES, block_k): the gradient cases; a block_k below Sk
# makes _blockwise_bwd scan several K blocks
GRAD_CASES = {
    "dense": ("dense", 512),
    "dense_causal": ("dense_causal", 512),
    "causal_sq_lt_sk": ("causal_sq_lt_sk", 512),
    "dense_causal_4_blocks": ("dense_causal", 4),
    "lengths_causal": ("lengths_causal", 512),
    "segments": ("segments", 512),
    "segments_lengths_causal": ("segments_lengths_causal", 512),
}
BF16_GRAD_CASES = ["dense_causal", "lengths_causal"]
# the cases of attention_lse_plain against the JAX package's logsumexp:
# dense, causal Sq < Sk, lengths with a 0, packed segments with pads
LSE_CASES = ["dense", "causal_sq_lt_sk", "lengths", "segments"]
PALLAS_CASES = ["dense_causal", "segments_lengths_causal"]
# (causal, Sq, Sk) of MultiHeadAttention
MHA_CASES = [(False, 6, 6), (True, 6, 6), (True, 4, 9), (True, 9, 4)]


def _grad_case(name, seed=11):
    """The inputs of GRAD_CASES[name] and an output cotangent."""
    case, block_k = GRAD_CASES[name]
    q, k, v, causal, lens, seg = _case(case, seed=seed)
    do = np.random.RandomState(seed + 1).normal(0, 1, q.shape).astype(
        np.float32)
    return q, k, v, do, causal, lens, seg, block_k


def _jax_grads(ref, q, k, v, do, causal, lens, seg, block_k, dtype=None):
    """jax.vjp of the JAX package's flash_attention; fp32 results."""
    import jax
    cast = (lambda a: a) if dtype is None else (lambda a: a.astype(dtype))
    _, vjp = jax.vjp(
        lambda q, k, v: ref.attention.flash_attention(
            q, k, v, causal=causal, block_k=block_k, lengths=lens,
            segment_ids=seg), cast(q), cast(k), cast(v))
    return [g.astype(ref.jnp.float32) for g in vjp(cast(do))]


def _jax_flash(ref, q, k, v, causal, lens, seg, dtype=None, **kw):
    cast = (lambda a: a) if dtype is None else (lambda a: a.astype(dtype))
    out = ref.attention.flash_attention(cast(q), cast(k), cast(v),
                                        causal=causal, lengths=lens,
                                        segment_ids=seg, **kw)
    return out.astype(ref.jnp.float32)


def _jax_lse(ref, q, k, v, causal, lens, seg):
    """Each row's logsumexp of the scaled scores (q * scale against k),
    masked where the JAX package's _combined_mask (the mask
    _masked_reference applies) is false."""
    import jax
    jnp = ref.jnp
    s = jnp.einsum("bhqd,bhkd->bhqk", q * (1.0 / q.shape[-1] ** 0.5), k)
    mask = ref.attention._combined_mask(q.shape[2], k.shape[2], causal, lens,
                                        seg)
    if mask is not None:
        s = jnp.where(mask, s, -1e30)
    return jax.nn.logsumexp(s, axis=-1)


@pytest.fixture(scope="module")
def jax_out(ref):
    """Every JAX reference output of this file, from one jit: one XLA
    compile instead of one per case and op."""
    import jax
    jnp = ref.jnp
    inputs = {
        "fp32": {n: _case(n) for n in CASES},
        "bf16": {n: _case(n, seed=3) for n in BF16_CASES},
        "pallas": {n: _case(n, seed=5) for n in PALLAS_CASES},
        "mha": {c: _mha_inputs(c[1], c[2], seed=c[1] * 10 + c[2])
                for c in MHA_CASES},
        "op": _case("causal_sq_lt_sk", seed=9)[:3],
        "grad": {n: _grad_case(n)[:4] for n in GRAD_CASES},
        "grad_bf16": {n: _grad_case(n, seed=13)[:4] for n in BF16_GRAD_CASES},
        "op_grad": _grad_case("causal_sq_lt_sk", seed=17)[:4],
        "lse": {n: _case(n, seed=19) for n in LSE_CASES},
    }

    def grads(arrays, name, dtype=None):
        causal, lens, seg, block_k = _grad_case(name)[4:]
        return _jax_grads(ref, *arrays[name], causal, lens, seg, block_k,
                          dtype=dtype)

    def run(arrays):
        out = {
            "fp32": {n: _jax_flash(ref, *arrays["fp32"][n][:3], CASES[n][5],
                                   *arrays["fp32"][n][4:])
                     for n in CASES},
            "bf16": {n: _jax_flash(ref, *arrays["bf16"][n][:3], CASES[n][5],
                                   *arrays["bf16"][n][4:],
                                   dtype=jnp.bfloat16)
                     for n in BF16_CASES},
            "pallas": {n: _jax_flash(ref, *arrays["pallas"][n][:3],
                                     CASES[n][5], *arrays["pallas"][n][4:],
                                     block_q=8, block_k=8, force_pallas=True)
                       for n in PALLAS_CASES},
            "mha": {c: ref.attention_ops._multi_head_attention(
                *arrays["mha"][c], num_heads=4, causal=c[0], seq_axis="seq")
                for c in MHA_CASES},
            "op": ref.attention._flash_attention_op(*arrays["op"],
                                                    causal=True, scale=0.25),
            "grad": {n: grads(arrays["grad"], n) for n in GRAD_CASES},
            "grad_bf16": {n: grads(arrays["grad_bf16"], n, jnp.bfloat16)
                          for n in BF16_GRAD_CASES},
            "op_grad": jax.vjp(
                lambda q, k, v: ref.attention._flash_attention_op(
                    q, k, v, causal=True, scale=0.25),
                *arrays["op_grad"][:3])[1](arrays["op_grad"][3]),
            "lse": {n: _jax_lse(ref, *arrays["lse"][n][:3], CASES[n][5],
                                *arrays["lse"][n][4:])
                    for n in LSE_CASES},
        }
        return out

    with jax.enable_x64(False):
        arrays = jax.tree.map(jnp.asarray, inputs)
        return jax.tree.map(np.asarray, jax.device_get(jax.jit(run)(arrays)))


def _port_flash(q, k, v, causal, lens, seg, dtype=torch.float32):
    out = flash_attention(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal=causal,
        lengths=None if lens is None else torch.from_numpy(lens),
        segment_ids=None if seg is None else torch.from_numpy(seg))
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax(jax_out, name):
    np.testing.assert_allclose(_port_flash(*_case(name)),
                               jax_out["fp32"][name], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", BF16_CASES)
def test_flash_attention_bf16_matches_jax(jax_out, name):
    np.testing.assert_allclose(
        _port_flash(*_case(name, seed=3), dtype=torch.bfloat16),
        jax_out["bf16"][name], rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_flash_attention_matches_pallas_interpret(jax_out, name):
    """The JAX package's Pallas kernels (B2, B3), run by the interpreter."""
    np.testing.assert_allclose(_port_flash(*_case(name, seed=5)),
                               jax_out["pallas"][name], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["lengths", "lengths_causal",
                                  "segments", "segments_lengths_causal"])
def test_fully_masked_rows_are_exact_zero(jax_out, name):
    """Rows of a batch element with length 0, and pad rows (segment 0),
    are exact 0 in both packages; no other row is."""
    q, k, v, causal, lens, seg = _case(name)
    dead = np.zeros(q.shape[:3], bool)
    if lens is not None:
        dead |= (lens == 0)[:, None, None]
    if seg is not None:
        dead |= (seg == 0)[:, None, :]
    assert dead.any() and not dead.all()
    for out in (_port_flash(q, k, v, causal, lens, seg),
                jax_out["fp32"][name]):
        assert np.all(out[dead] == 0.0)
        assert np.all(np.abs(out[~dead]).sum(-1) > 0.0)


@pytest.mark.parametrize("what", ["dense_causal", "masked_causal",
                                  "segments_cross"])
def test_flash_attention_value_errors_match_jax(ref, what):
    q, k, v = _qkv(1, 2, 9, 6, 8, seed=1)
    kw = {"dense_causal": dict(causal=True),
          "masked_causal": dict(causal=True,
                                lengths=np.asarray([4], np.int32)),
          "segments_cross": dict(segment_ids=np.ones((1, 6), np.int32))}[what]
    jnp = ref.jnp
    with pytest.raises(ValueError) as jax_err:
        ref.attention.flash_attention(
            *map(jnp.asarray, (q, k, v)),
            **{n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
               for n, a in kw.items()})
    with pytest.raises(ValueError) as port_err:
        flash_attention(*map(torch.from_numpy, (q, k, v)),
                        **{n: torch.from_numpy(a) if isinstance(a, np.ndarray)
                           else a for n, a in kw.items()})
    assert str(port_err.value) == str(jax_err.value)


def test_cpu_runs_plain_and_counts_no_launch():
    q, k, v, causal, lens, seg = _case("segments_lengths_causal")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    before = (flash_attention.launches, flash_attention.masked_launches,
              flash_attention.wgmma_launches)
    dense = flash_attention(*t, causal=True)
    masked = flash_attention(*t, causal=True, lengths=torch.from_numpy(lens),
                             segment_ids=torch.from_numpy(seg))
    assert (flash_attention.launches, flash_attention.masked_launches,
            flash_attention.wgmma_launches) == before
    assert torch.equal(dense, attention_plain(*t, causal=True))
    assert torch.equal(masked, masked_attention_plain(
        *t, torch.from_numpy(lens), torch.from_numpy(seg), causal=True))


def test_mma_sync_timing_route_takes_only_card_tensors():
    """The forced mma.sync route exists to time that variant beside the
    wgmma one on the card; it checks shapes like the public entry point
    and has no CPU path."""
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match="CUDA"):
        _mma_sync(q, q, q, causal=True)
    with pytest.raises(ValueError, match="seq_q <= seq_k"):
        _mma_sync(q, q[:, :, :4], q[:, :, :4], causal=True)


def test_meta_infers_shapes_and_keeps_layout():
    q = torch.empty(2, 7, 3, 16, dtype=torch.bfloat16,
                    device="meta").transpose(1, 2)  # (B, H, S, D) view
    out = flash_attention(q, q, q, causal=True)
    assert out.device.type == "meta" and out.shape == (2, 3, 7, 16)
    assert out.dtype == torch.bfloat16
    out = flash_attention(q, q, q, lengths=torch.tensor([7, 2]))
    assert out.shape == (2, 3, 7, 16)


def test_flash_attention_rejects_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 4, 4, 8, seed=2))
    with pytest.raises(MXNetError):
        flash_attention(q, k[..., :4], v)
    with pytest.raises(MXNetError):
        flash_attention(q, k, v, lengths=torch.tensor([1, 2]))
    with pytest.raises(MXNetError):
        flash_attention(q[0], k[0], v[0])


@pytest.mark.parametrize("case", MHA_CASES)
def test_multi_head_attention_matches_jax(jax_out, case):
    """The op's causal mask is ``kpos <= qpos``, with no (Sk - Sq) offset:
    causal with Sq != Sk is compared too."""
    causal, sq, sk = case
    op = mxt.ops.get_op("MultiHeadAttention")
    got = op.fn(*map(torch.from_numpy, _mha_inputs(sq, sk, sq * 10 + sk)),
                **op.parse_attrs({"num_heads": "4", "causal": str(causal),
                                  "seq_axis": "seq"}))
    np.testing.assert_allclose(got.numpy(), jax_out["mha"][case], rtol=RTOL,
                               atol=ATOL)


def test_multi_head_attention_rejects_bad_heads():
    x = torch.zeros(1, 3, 10)
    with pytest.raises(MXNetError):
        port_attention_ops._multi_head_attention(x, x, x, num_heads=4)


def test_contrib_flash_attention_infers_shapes():
    q, k, v = (mxt.sym.var(n) for n in ("q", "k", "v"))
    out = mxt.sym._contrib_flash_attention(q, k, v, causal=True, scale=0.5)
    _, out_shapes, _ = out.infer_shape(q=(2, 4, 5, 8), k=(2, 4, 9, 8),
                                       v=(2, 4, 9, 8))
    assert out_shapes == [(2, 4, 5, 8)]
    alias = mxt.sym.flash_attention_op(q, k, v)
    _, out_shapes, _ = alias.infer_shape(q=(1, 2, 3, 4), k=(1, 2, 3, 4),
                                         v=(1, 2, 3, 4))
    assert out_shapes == [(1, 2, 3, 4)]


def test_contrib_flash_attention_op_matches_jax(jax_out):
    q, k, v = _case("causal_sq_lt_sk", seed=9)[:3]
    got = mxt.ops.get_op("_contrib_flash_attention").fn(
        *map(torch.from_numpy, (q, k, v)), causal=True, scale=0.25)
    np.testing.assert_allclose(got.numpy(), jax_out["op"], rtol=RTOL,
                               atol=ATOL)


def _port_grads(q, k, v, do, causal, lens, seg, dtype=torch.float32):
    """dq, dk, dv through the port's autograd Function (on the CPU its
    plain backward), as fp32 numpy."""
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
    out = flash_attention(
        *leaves, causal=causal,
        lengths=None if lens is None else torch.from_numpy(lens),
        segment_ids=None if seg is None else torch.from_numpy(seg))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(dtype))
    assert all(g.dtype == dtype for g in grads)
    return [g.float().numpy() for g in grads]


def _assert_grads_close(got, want, tol):
    """Each gradient within ``tol`` of its reference's largest magnitude."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        bound = tol * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{name}: {err} > {bound}"


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_backward_matches_jax_vjp(jax_out, name):
    """The Function's CPU backward and the plain backward versions called
    directly (attention_backward_plain for the dense core, the written-out
    VJP of _masked_reference for the masked one) against jax.vjp of the
    JAX package's flash_attention, in fp32."""
    q, k, v, do, causal, lens, seg, _ = _grad_case(name)
    want = jax_out["grad"][name]
    _assert_grads_close(_port_grads(q, k, v, do, causal, lens, seg), want,
                        GRAD_TOL)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    if lens is None and seg is None:
        out = attention_plain(*t[:3], causal=causal)
        plain = attention_backward_plain(*t[:3], out, t[3], causal=causal)
    else:
        plain = masked_attention_backward_plain(
            *t, lengths=None if lens is None else torch.from_numpy(lens),
            segment_ids=None if seg is None else torch.from_numpy(seg),
            causal=causal)
    _assert_grads_close([g.numpy() for g in plain], want, GRAD_TOL)


@pytest.mark.parametrize("name", BF16_GRAD_CASES)
def test_backward_bf16_matches_jax_vjp(jax_out, name):
    q, k, v, do, causal, lens, seg, _ = _grad_case(name, seed=13)
    _assert_grads_close(
        _port_grads(q, k, v, do, causal, lens, seg, dtype=torch.bfloat16),
        jax_out["grad_bf16"][name], BF16_GRAD_TOL)


@pytest.mark.parametrize("name", ["lengths_causal", "segments",
                                  "segments_lengths_causal"])
def test_fully_masked_rows_get_exact_zero_gradients(jax_out, name):
    """A query row that sees no key (a length of 0, a pad token) has dq
    exact 0, and a key no row sees has dk and dv exact 0, in both
    packages."""
    q, k, v, do, causal, lens, seg, _ = _grad_case(name)
    dead_q = np.zeros(q.shape[:3], bool)
    dead_k = np.zeros(k.shape[:3], bool)
    if lens is not None:
        dead_q |= (lens == 0)[:, None, None]
        dead_k |= (np.arange(k.shape[2])[None] >= lens[:, None])[:, None]
    if seg is not None:
        dead_q |= (seg == 0)[:, None, :]
        dead_k |= (seg == 0)[:, None, :]
    assert dead_q.any() and dead_k.any()
    for dq, dk, dv in (_port_grads(q, k, v, do, causal, lens, seg),
                       jax_out["grad"][name]):
        assert np.all(dq[dead_q] == 0.0)
        assert np.all(dk[dead_k] == 0.0) and np.all(dv[dead_k] == 0.0)
        # (a causal row that sees one key has dq = 0 as well: no per-row
        # check of the live rows)
        assert np.abs(dq[~dead_q]).sum() > 0.0


def test_cpu_backward_runs_plain_and_counts_no_launch():
    q, k, v, do, causal, lens, seg, _ = _grad_case("segments_lengths_causal")
    counts = (flash_attention.backward_launches,
              flash_attention.masked_backward_launches)
    _port_grads(q, k, v, do, causal, None, None)
    _port_grads(q, k, v, do, causal, lens, seg)
    assert (flash_attention.backward_launches,
            flash_attention.masked_backward_launches) == counts


@pytest.mark.parametrize("name", LSE_CASES)
def test_lse_plain_matches_jax_logsumexp(jax_out, name):
    """attention_lse_plain (the values the forward kernel keeps for the
    backward) against jax.nn.logsumexp of the JAX package's masked scaled
    scores, fp32; rows that see no key are left out of the comparison and
    are finite."""
    q, k, v, causal, lens, seg = _case(name, seed=19)
    got = attention_lse_plain(
        *map(torch.from_numpy, (q, k, v)), causal,
        lengths=None if lens is None else torch.from_numpy(lens),
        segment_ids=None if seg is None else torch.from_numpy(seg)).numpy()
    want = jax_out["lse"][name]
    assert got.shape == q.shape[:3] and got.dtype == np.float32
    live = np.ones(q.shape[:3], bool)
    if lens is not None:
        live &= (lens > 0)[:, None, None]
    if seg is not None:
        live &= (seg > 0)[:, None, :]
    assert name in ("dense", "causal_sq_lt_sk") or not live.all()
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-6)
    assert np.isfinite(got).all()


def test_cpu_functions_keep_no_lse_and_launch_nothing():
    """On the CPU the autograd Functions save no lse (their backward
    recomputes it, as _blockwise_bwd does) and launch no kernel; without
    grad mode the forward builds no graph at all."""
    q, k, v, do, causal, lens, seg, _ = _grad_case("segments_lengths_causal")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    counts = (flash_attention.launches, flash_attention.masked_launches,
              flash_attention.backward_launches,
              flash_attention.masked_backward_launches,
              flash_attention.wgmma_backward_launches)
    for kw in ({}, {"lengths": torch.from_numpy(lens),
                    "segment_ids": torch.from_numpy(seg)}):
        out = flash_attention(*leaves, causal=causal, **kw)
        assert out.grad_fn.saved_tensors[-1] is None  # no lse
        torch.autograd.grad(out, leaves, torch.from_numpy(do))
        with torch.no_grad():
            assert flash_attention(*leaves, causal=causal, **kw).grad_fn is None
    assert (flash_attention.launches, flash_attention.masked_launches,
            flash_attention.backward_launches,
            flash_attention.masked_backward_launches,
            flash_attention.wgmma_backward_launches) == counts


def test_mma_sync_backward_timing_route_takes_only_card_tensors():
    """The forced mma.sync backward exists to time that variant beside
    the wgmma/TMA one on the card; it checks shapes like the public entry
    point and has no CPU path."""
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match="CUDA"):
        _mma_sync_backward(q, q, q, q, q, causal=True)
    with pytest.raises(ValueError, match="seq_q <= seq_k"):
        _mma_sync_backward(q, q[:, :, :4], q[:, :, :4], q, q, causal=True)


def test_library_name_hashes_included_headers(tmp_path, monkeypatch):
    """A library's file name hashes its source and the csrc/ headers the
    source includes (and theirs): an edited header builds anew instead of
    loading a stale library. Both attention sources include the shared
    Hopper header."""
    for name in ("flash_attention", "flash_attention_bwd"):
        assert _build.included_headers(_build.CSRC / _build.SOURCES[name]) \
            == [_build.CSRC / "hopper_tma.cuh"]
    (tmp_path / "a.cuh").write_text("// a\n")
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "b.cuh"\n'
                                   '#include "a.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setitem(_build.SOURCES, "probe", "k.cu")
    assert _build.included_headers(tmp_path / "k.cu") == [
        tmp_path / "b.cuh", tmp_path / "a.cuh"]
    first = _build.library_path("probe")
    assert _build.library_path("probe") == first
    (tmp_path / "a.cuh").write_text("// a, edited\n")
    assert _build.library_path("probe") != first
    assert _build.LINKS["flash_attention_bwd"] == ("-lcuda",)


def test_contrib_flash_attention_op_gradients_through_executor(jax_out):
    """The op's gradients through the port's executor (simple_bind,
    forward(is_train=True), backward with the head gradient) against
    jax.vjp of the JAX package's registered op, the program its executor
    differentiates."""
    q, k, v, do = _grad_case("causal_sq_lt_sk", seed=17)[:4]
    net = mxt.sym._contrib_flash_attention(
        *(mxt.sym.var(n) for n in "qkv"), causal=True, scale=0.25)
    ex = net.simple_bind(mxt.cpu(), grad_req="write", q=q.shape, k=k.shape,
                         v=v.shape)
    for name, arr in zip("qkv", (q, k, v)):
        ex.arg_dict[name][:] = mxt.nd.array(arr, ctx=mxt.cpu())
    ex.forward(is_train=True)
    ex.backward(mxt.nd.array(do, ctx=mxt.cpu()))
    for name, want in zip("qkv", jax_out["op_grad"]):
        np.testing.assert_allclose(ex.grad_dict[name].asnumpy(), want,
                                   rtol=RTOL, atol=ATOL, err_msg=name)


# (B, H, Sq, Sk, D, causal, lengths, segments) on the card
KERNEL_CASES = [
    (2, 8, 512, 512, 64, True, None, False),
    (2, 8, 512, 512, 64, False, None, False),
    (2, 3, 100, 100, 64, True, None, False),
    (2, 2, 77, 200, 128, True, None, False),
    (1, 4, 33, 33, 8, False, None, False),
    (3, 4, 256, 256, 64, True, [256, 130, 0], False),
    (2, 4, 256, 256, 64, False, None, True),
    (2, 4, 256, 256, 64, True, [200, 256], True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_kernel_matches_plain(card, case, dtype, tol):
    b, h, sq, sk, d, causal, lengths, segments = case
    q, k, v = (torch.tensor(a, dtype=dtype, device=card)
               for a in _qkv(b, h, sq, sk, d, seed=sq + d))
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=card))
    seg = (None if not segments
           else torch.tensor(_segments(b, sk), device=card))
    masked = lens is not None or seg is not None
    before = (flash_attention.launches, flash_attention.masked_launches)
    out = flash_attention(q, k, v, causal=causal, lengths=lens,
                          segment_ids=seg)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.masked_launches) == (
        before[0] + (not masked), before[1] + masked)
    if masked:
        want = masked_attention_plain(q, k, v, lens, seg, causal=causal)
    else:
        want = attention_plain(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == want.shape
    assert (out.float() - want.float()).abs().max().item() <= tol
    if masked:  # fully masked rows are exact 0, as in the plain version
        assert torch.equal(out[want == 0], want[want == 0])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_takes_strided_views_and_refuses_grad(card, offset):
    """(B, S, H, D) transposed views as the transformer makes them; with an
    offset no row is 16-byte aligned and the CUDA-core variants run. The
    gradients on the same views come from the backward kernels (the
    wgmma/TMA variant for aligned rows), each within two bf16 ulps of its
    largest magnitude of the plain backward; an fp32 head dim of 160
    (past the tensor-core variants, on the CUDA-core one's wide tiles)
    runs and matches its plain version."""
    x = torch.randn(2, 64, 8, 64 + offset, device=card,
                    dtype=torch.bfloat16)[..., offset:]
    q = x.transpose(1, 2)  # (B, H, S, D), not contiguous
    out = flash_attention(q, q, q, causal=True)
    want = attention_plain(q, q, q, causal=True)
    if offset == 0:  # the output keeps a dense input's layout
        assert out.stride() == q.stride()
    assert (out.float() - want.float()).abs().max().item() <= 1.6e-2
    leaves = [q.detach().requires_grad_() for _ in range(3)]
    # the cotangent as the transformer hands it back: a (B, H, S, D) view
    # of (B, S, H, D) memory
    do = torch.randn_like(want).transpose(1, 2).contiguous().transpose(1, 2)
    before = (flash_attention.backward_launches,
              flash_attention.mma_backward_launches,
              flash_attention.wgmma_backward_launches)
    grads = torch.autograd.grad(flash_attention(*leaves, causal=True),
                                leaves, do)
    torch.cuda.synchronize()
    assert (flash_attention.backward_launches,
            flash_attention.mma_backward_launches,
            flash_attention.wgmma_backward_launches) == (
        before[0] + 1, before[1], before[2] + (offset == 0))
    for g, p in zip(grads, attention_backward_plain(q, q, q, want, do,
                                                    causal=True)):
        assert g.shape == p.shape and g.dtype == torch.bfloat16
        assert (g.float() - p.float()).abs().max().item() <= \
            2.0 ** -6 * p.float().abs().max().item()
    wide = torch.randn(1, 1, 4, 160, device=card)
    got = flash_attention(wide, wide, wide)
    assert (got - attention_plain(wide, wide, wide)).abs().max().item() <= 2e-5


# (label, (B, H, Sq, Sk, D), causal, lengths, segments, layout, dtype) of
# the backward kernels' checks: the wgmma/TMA variant (bf16, D = 64 and
# 128, tile edges, Sq < Sk, (B, S, H, D) views, packed segments at both D)
# and the CUDA-core one (fp32, and bf16 at D = 48), dense and masked,
# lengths of 0
BACKWARD_CASES = [
    ("causal", (2, 4, 256, 256, 64), True, None, None, "bhsd",
     torch.bfloat16),
    ("ragged", (2, 3, 100, 100, 64), False, None, None, "bhsd",
     torch.bfloat16),
    ("causal Sq<Sk D=128", (2, 2, 77, 200, 128), True, None, None, "bhsd",
     torch.bfloat16),
    ("views", (2, 8, 100, 100, 64), True, None, None, "bshd",
     torch.bfloat16),
    ("fp32 D=40", (1, 2, 77, 77, 40), True, None, None, "bhsd",
     torch.float32),
    ("fp32 Sq<Sk D=128", (2, 2, 77, 200, 128), True, None, None, "bhsd",
     torch.float32),
    ("one token", (1, 1, 1, 1, 64), False, None, None, "bhsd",
     torch.bfloat16),
    ("lengths", (4, 2, 256, 256, 64), True, [256, 150, 70, 0], None, "bhsd",
     torch.bfloat16),
    ("segments", (2, 4, 256, 256, 64), True, None, _segments, "bhsd",
     torch.bfloat16),
    ("fp32 lengths segments", (2, 2, 50, 50, 32), False, [50, 31],
     _segments, "bhsd", torch.float32),
    ("D=128 lengths views", (2, 4, 333, 333, 128), True, [0, 300], None,
     "bshd", torch.bfloat16),
    ("causal Sq<Sk lengths", (2, 2, 77, 200, 64), True, [150, 0], None,
     "bhsd", torch.bfloat16),
    ("bf16 D=48 segments", (2, 2, 130, 130, 48), True, None, _segments,
     "bhsd", torch.bfloat16),
    ("D=128 segments", (2, 2, 300, 300, 128), True, None, _segments, "bhsd",
     torch.bfloat16),
    ("segments views", (2, 8, 200, 200, 64), False, None, _segments, "bshd",
     torch.bfloat16),
    ("D=128 segments lengths views", (2, 4, 333, 333, 128), False,
     [333, 200], _segments, "bshd", torch.bfloat16),
    ("ids out of order causal", (2, 2, 700, 700, 64), True, None,
     lambda b, s: _runs_of_ids(b, s, seed=6), "bhsd", torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BACKWARD_CASES, ids=lambda c: c[0])
def test_backward_kernel_matches_plain(card, case):
    """dq, dk and dv from the backward kernels against the plain backward
    versions on the same card tensors, each relative to its largest
    magnitude, at least 2**-10 (with one token dq is 0 by math: P = 1, so
    dS = dP - delta vanishes up to summation order): fp32 2e-5 (summation
    order), bf16 2**-6 (P and dS rounded to bf16 as mma operands). Rows
    that see no key have dq exact 0, keys no row sees dk and dv exact 0.
    Every bf16 case at D = 64 or 128 takes the wgmma/TMA variant, the
    others the CUDA-core one."""
    _, (b, h, sq, sk, d), causal, lengths, segments, layout, dtype = case
    rng = np.random.RandomState(sq + sk + d)

    def make(s):
        if layout == "bshd":
            return torch.tensor(rng.normal(0, 1, (b, s, h, d)), dtype=dtype,
                                device=card).transpose(1, 2)
        return torch.tensor(rng.normal(0, 1, (b, h, s, d)), dtype=dtype,
                            device=card)
    q, k, v, do = make(sq), make(sk), make(sk), make(sq)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=card))
    seg = (None if segments is None
           else torch.tensor(segments(b, sk), device=card))
    masked = lens is not None or seg is not None
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, lengths=lens,
                          segment_ids=seg)
    before = (flash_attention.backward_launches,
              flash_attention.masked_backward_launches,
              flash_attention.wgmma_backward_launches,
              flash_attention.mma_backward_launches)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    wgmma = dtype == torch.bfloat16 and d in (64, 128)
    assert (flash_attention.backward_launches,
            flash_attention.masked_backward_launches,
            flash_attention.wgmma_backward_launches,
            flash_attention.mma_backward_launches) == (
        before[0] + (not masked), before[1] + masked, before[2] + wgmma,
        before[3])
    if masked:
        want = masked_attention_backward_plain(q, k, v, do, lens, seg,
                                               causal=causal)
    else:
        want = attention_backward_plain(q, k, v, out.detach(), do,
                                        causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6
    for g, w in zip(grads, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= \
            tol * max(2.0 ** -10, w.float().abs().max().item())
    if masked:
        mask = _combined_mask(sq, sk, causal, lens, seg, card)
        mask = mask.expand(b, h, sq, sk)
        dead_q, dead_k = ~mask.any(-1), ~mask.any(-2)
        assert bool(dead_q.any())
        assert bool((grads[0][dead_q] == 0).all())
        assert bool((grads[1][dead_k] == 0).all())
        assert bool((grads[2][dead_k] == 0).all())


# (B, H, Sq, Sk, D, causal, layout) for the wgmma/TMA variant: tile edges
# (192-row query tiles, 128-key tiles at D = 64 and 64-key at D = 128),
# Sq < Sk causal, D = 128, and (B, H, S, D) views of (B, S, H, D) memory
WGMMA_CASES = [
    (2, 3, 1000, 1000, 64, True, "bhsd"),
    (2, 3, 1000, 1000, 64, False, "bhsd"),
    (2, 2, 129, 1000, 64, True, "bhsd"),
    (2, 2, 77, 200, 128, True, "bhsd"),
    (1, 2, 300, 300, 128, False, "bhsd"),
    (2, 8, 500, 500, 64, True, "bshd"),
    (2, 4, 333, 333, 128, True, "bshd"),
    (1, 1, 1, 1, 64, False, "bhsd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_wgmma_variant_matches_plain(card, case):
    """The dense bf16 core at D = 64 and 128 takes the wgmma/TMA variant,
    within two bf16 ulps of the plain version at the reference's
    magnitude (at least 1); the mma.sync variant agrees as well."""
    b, h, sq, sk, d, causal, layout = case
    rng = np.random.RandomState(sq + sk + d)

    def make(s):
        if layout == "bshd":
            return torch.tensor(rng.normal(0, 1, (b, s, h, d)),
                                dtype=torch.bfloat16,
                                device=card).transpose(1, 2)
        return torch.tensor(rng.normal(0, 1, (b, h, s, d)),
                            dtype=torch.bfloat16, device=card)
    q, k, v = make(sq), make(sk), make(sk)
    before = flash_attention.wgmma_launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.wgmma_launches == before + 1
    want = attention_plain(q, k, v, causal=causal).float()
    bound = 2.0 ** -6 * want.abs().clamp(min=1.0)
    assert out.dtype == torch.bfloat16 and out.stride() == q.stride()
    assert bool(((out.float() - want).abs() <= bound).all())
    mma = _mma_sync(q, k, v, causal=causal)
    assert flash_attention.wgmma_launches == before + 1
    assert bool(((mma.float() - want).abs() <= bound).all())


@pytest.mark.cuda
def test_wgmma_variant_routes_by_alignment(card):
    """A view no row of which is 16-byte aligned, and fp32, keep their
    earlier routes; the masked core in bf16 over aligned views takes the
    wgmma/TMA variant."""
    x = torch.randn(1, 4, 200, 65, device=card, dtype=torch.bfloat16)[..., 1:]
    before = flash_attention.wgmma_launches
    out = flash_attention(x, x, x, causal=True)
    f32 = flash_attention(x.float(), x.float(), x.float())
    torch.cuda.synchronize()
    assert flash_attention.wgmma_launches == before
    assert (out.float() - attention_plain(x, x, x, causal=True).float()
            ).abs().max().item() <= 1.6e-2
    assert f32.dtype == torch.float32
    y = x.contiguous()
    lens = torch.tensor([100], device=card)
    masked = flash_attention(y, y, y, lengths=lens)
    torch.cuda.synchronize()
    assert flash_attention.wgmma_launches == before + 1
    assert masked.shape == y.shape
    assert (masked.float() - masked_attention_plain(y, y, y, lens).float()
            ).abs().max().item() <= 1.6e-2


def _runs_of_ids(b, s, seed):
    """Segment ids in runs of 1 to 200 positions drawn from {0, 1, 2, 3}:
    ids that repeat out of order, with pads between them."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        pos = 0
        while pos < s:
            run = rng.randint(1, 201)
            seg[i, pos:pos + run] = rng.randint(0, 4)
            pos += run
    return seg


def _late_second_segment(b, s):
    """Segment 1 up to 600, segment 2 up to 950, pads after: a query tile
    across 600 has rows whose first K tiles all hold the other segment."""
    seg = np.zeros((b, s), np.int32)
    seg[:, :600], seg[:, 600:950] = 1, 2
    return seg


# (label, (B, H, Sq, Sk, D), causal, lengths, segments, layout) for the
# masked core on the wgmma/TMA variant: lengths of 0 and off a 128-key
# tile's edge, causal Sq < Sk with lengths, rows whose first K tiles are
# another segment's (the running max stays at its floor for those tiles),
# ids that repeat out of order, pad heads, (B, H, S, D) views of
# (B, S, H, D) memory, D = 128, and rows of more than 32 K tiles (the
# kernel tests tiles for skipping 32 at a time)
MASKED_WGMMA_CASES = [
    ("lengths", (3, 4, 300, 300, 64), False, [300, 0, 77], None, "bhsd"),
    ("causal lengths", (3, 2, 1000, 1000, 64), True, [1000, 513, 0], None,
     "bhsd"),
    ("causal Sq<Sk lengths", (2, 2, 77, 200, 128), True, [150, 0], None,
     "bhsd"),
    ("late second segment", (2, 2, 1000, 1000, 64), False, None,
     _late_second_segment, "bhsd"),
    ("ids out of order causal", (2, 4, 700, 700, 64), True, None,
     lambda b, s: _runs_of_ids(b, s, seed=3), "bhsd"),
    ("ids out of order lengths", (2, 2, 640, 640, 128), False, [640, 333],
     lambda b, s: _runs_of_ids(b, s, seed=4), "bhsd"),
    ("segments lengths views", (2, 8, 500, 500, 64), True, [500, 321],
     _segments, "bshd"),
    ("D=128 segments views", (2, 4, 333, 333, 128), False, None, _segments,
     "bshd"),
    ("D=128 causal lengths views", (2, 4, 333, 333, 128), True, [0, 300],
     None, "bshd"),
    ("over 32 K tiles ids out of order", (1, 2, 4500, 4500, 64), True,
     None, lambda b, s: _runs_of_ids(b, s, seed=5), "bhsd"),
    ("D=128 over 32 K tiles segments", (2, 1, 2600, 2600, 128), False,
     [2600, 2222], _segments, "bhsd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MASKED_WGMMA_CASES, ids=lambda c: c[0])
def test_masked_wgmma_variant_matches_plain(card, case):
    """The masked bf16 core at D = 64 and 128 takes the wgmma/TMA variant,
    within two bf16 ulps of the plain version at the reference's
    magnitude (at least 1), its fully masked rows exact 0."""
    _, (b, h, sq, sk, d), causal, lengths, segments, layout = case
    rng = np.random.RandomState(sq + sk + d)

    def make(s):
        if layout == "bshd":
            return torch.tensor(rng.normal(0, 1, (b, s, h, d)),
                                dtype=torch.bfloat16,
                                device=card).transpose(1, 2)
        return torch.tensor(rng.normal(0, 1, (b, h, s, d)),
                            dtype=torch.bfloat16, device=card)
    q, k, v = make(sq), make(sk), make(sk)
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=card))
    seg = (None if segments is None
           else torch.tensor(segments(b, sk), device=card))
    before = (flash_attention.masked_launches, flash_attention.wgmma_launches)
    out = flash_attention(q, k, v, causal=causal, lengths=lens,
                          segment_ids=seg)
    torch.cuda.synchronize()
    assert (flash_attention.masked_launches,
            flash_attention.wgmma_launches) == (before[0] + 1, before[1] + 1)
    want = masked_attention_plain(q, k, v, lens, seg, causal=causal).float()
    bound = 2.0 ** -6 * want.abs().clamp(min=1.0)
    assert out.dtype == torch.bfloat16 and out.stride() == q.stride()
    assert bool(((out.float() - want).abs() <= bound).all())
    dead = (want == 0).all(-1)
    assert bool(dead.any())  # every case has rows that see no key
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


# (label, (B, H, Sq, Sk, D), causal, lengths, segments) of the forward's
# row logsumexps: dense causal, Sq < Sk at D = 128, lengths with a 0,
# packed segments with pads
LSE_KERNEL_CASES = [
    ("causal", (2, 4, 300, 300, 64), True, None, None),
    ("causal Sq<Sk D=128", (2, 2, 77, 200, 128), True, None, None),
    ("lengths", (3, 2, 256, 256, 64), False, [256, 100, 0], None),
    ("segments", (2, 4, 256, 256, 64), True, None, _segments),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wgmma", "mma_sync", "cuda_cores"])
@pytest.mark.parametrize("case", LSE_KERNEL_CASES, ids=lambda c: c[0])
def test_forward_lse_matches_plain(card, case, variant):
    """Each forward variant (the Hopper one, mma.sync, the CUDA-core one in
    fp32) keeps every row's logsumexp when asked, within 1e-5 of
    attention_lse_plain on the rows that see a key (fp32 sums in another
    order; the tensor-core variants go through exp2 and log2); the
    output does not change."""
    _, (b, h, sq, sk, d), causal, lengths, segments = case
    dtype = torch.float32 if variant == "cuda_cores" else torch.bfloat16
    q, k, v = (torch.tensor(a, dtype=dtype, device=card)
               for a in _qkv(b, h, sq, sk, d, seed=sq + d))
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=card))
    seg = (None if segments is None
           else torch.tensor(segments(b, sk), device=card))
    route = 1 if variant == "mma_sync" else 0
    lse = torch.full((b, h, sq), float("nan"), device=card)
    scale = 1.0 / d ** 0.5
    before = flash_attention.wgmma_launches
    out = _launch(q, k, v, causal, scale, lens, seg, route=route, lse=lse)
    torch.cuda.synchronize()
    assert flash_attention.wgmma_launches == before + (variant == "wgmma")
    want = attention_lse_plain(q, k, v, causal, lengths=lens,
                               segment_ids=seg)
    live = want > -1e29
    assert bool(torch.isfinite(lse).all())
    assert (lse - want)[live].abs().max().item() <= 1e-5
    assert torch.equal(out, _launch(q, k, v, causal, scale, lens, seg,
                                    route=route))


@pytest.mark.cuda
def test_backward_routes_by_dtype_and_view(card):
    """bf16 at D = 64 over views TMA can describe takes the wgmma/TMA
    backward; a view TMA cannot take (k and v broadcast over the heads,
    stride 0) the mma.sync one; fp32 and unaligned rows the CUDA-core one.
    All agree with the plain backward."""
    rng = np.random.RandomState(5)
    base = [torch.tensor(rng.normal(0, 1, shape), dtype=torch.bfloat16,
                         device=card)
            for shape in ((2, 4, 200, 64), (2, 1, 200, 64), (2, 1, 200, 64))]
    unaligned = torch.tensor(rng.normal(0, 1, (2, 4, 200, 65)),
                             dtype=torch.bfloat16, device=card)[..., 1:]
    cases = [("wgmma", base[0], base[0], base[0]),
             ("mma", base[0], base[1].expand(2, 4, 200, 64),
              base[2].expand(2, 4, 200, 64)),
             ("cuda_cores", *(t.float() for t in (base[0],) * 3)),
             ("cuda_cores", unaligned, unaligned, unaligned)]
    for route, q, k, v in cases:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, causal=True)
        do = torch.randn_like(out)
        before = (flash_attention.wgmma_backward_launches,
                  flash_attention.mma_backward_launches)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        assert (flash_attention.wgmma_backward_launches,
                flash_attention.mma_backward_launches) == (
            before[0] + (route == "wgmma"), before[1] + (route == "mma"))
        tol = 2e-5 if q.dtype == torch.float32 else 2.0 ** -6
        for g, w in zip(grads, attention_backward_plain(
                q, k, v, out.detach(), do, causal=True)):
            assert (g.float() - w.float()).abs().max().item() <= \
                tol * w.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_wgmma_backward_repeats(card, masked):
    """Two backward calls on the same inputs: dk and dv are written once
    by one block each and repeat bit for bit; dq's partial sums arrive by
    atomics in an order that may change, so each element of dq repeats
    within one bf16 ulp of itself."""
    b, h, s, d = 2, 4, 512, 64
    rng = np.random.RandomState(8)
    q, k, v, do = (torch.tensor(rng.normal(0, 1, (b, h, s, d)),
                                dtype=torch.bfloat16, device=card)
                   for _ in range(4))
    kw = ({"lengths": torch.tensor([512, 300], device=card),
           "segment_ids": torch.tensor(_segments(b, s), device=card)}
          if masked else {})
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    runs = []
    for _ in range(2):
        before = flash_attention.wgmma_backward_launches
        runs.append(torch.autograd.grad(
            flash_attention(*leaves, causal=True, **kw), leaves, do))
        torch.cuda.synchronize()
        assert flash_attention.wgmma_backward_launches == before + 1
    (dq1, dk1, dv1), (dq2, dk2, dv2) = runs
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    _, exp = torch.frexp(torch.maximum(dq1.float().abs(), dq2.float().abs()))
    ulp = torch.ldexp(torch.ones_like(dq1, dtype=torch.float32), exp - 8)
    assert bool(((dq1.float() - dq2.float()).abs() <= ulp).all())


@pytest.mark.cuda
def test_mma_sync_backward_matches_plain(card):
    """The timing route to the mma.sync backward, dense and masked, given
    the rows' lse, agrees with the plain backward as the main route does;
    without an lse it raises."""
    b, h, s, d = 2, 2, 300, 64
    rng = np.random.RandomState(9)
    q, k, v, do = (torch.tensor(rng.normal(0, 1, (b, h, s, d)),
                                dtype=torch.bfloat16, device=card)
                   for _ in range(4))
    out = attention_plain(q, k, v, causal=True)
    lens = torch.tensor([300, 123], dtype=torch.int32, device=card)
    out_len = masked_attention_plain(q, k, v, lens, causal=True)
    before = flash_attention.mma_backward_launches
    with pytest.raises(MXNetError, match="lse"):
        _mma_sync_backward(q, k, v, out, do, causal=True)
    for got, want in (
            (_mma_sync_backward(q, k, v, out, do, causal=True,
                                lse=attention_lse_plain(q, k, v, True)),
             attention_backward_plain(q, k, v, out, do, causal=True)),
            (_mma_sync_backward(q, k, v, out_len, do, causal=True,
                                lengths=lens, lse=attention_lse_plain(
                                    q, k, v, True, lengths=lens)),
             masked_attention_backward_plain(q, k, v, do, lens,
                                             causal=True))):
        for g, w in zip(got, want):
            assert (g.float() - w.float()).abs().max().item() <= \
                2.0 ** -6 * w.float().abs().max().item()
    assert flash_attention.mma_backward_launches == before + 2

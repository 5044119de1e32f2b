"""Parity of the PyTorch port's attention with the JAX package.

The same numpy inputs, made from a seed, go through ``mxnet_tpu`` and
``mxnet_tpu_torch``: ``flash_attention`` dense and masked (the port's plain
versions on the CPU against the JAX package's jnp path, and against its
Pallas kernels in interpret mode), ``MultiHeadAttention`` and the
``_contrib_flash_attention`` op. Tests marked ``cuda`` hold the Hopper
kernel (``csrc/flash_attention.cu``) to its plain version and skip without
a card; they need neither JAX nor the JAX package, so on a card they run
with ``python -m pytest --noconftest -m cuda
tests/test_torch_port_attention.py``.
"""
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention_ops as port_attention_ops
from mxnet_tpu_torch.ops.cuda.attention import (_dense_mma_sync,
                                                attention_plain,
                                                flash_attention,
                                                masked_attention_plain)

# fp32 on both sides: only the summation order differs
RTOL, ATOL = 1e-5, 1e-6
# bf16 output: both round the same fp32 value, one bf16 ulp apart at most
BF16_ATOL = 1e-2


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
PALLAS_CASES = ["dense_causal", "segments_lengths_causal"]
# (causal, Sq, Sk) of MultiHeadAttention
MHA_CASES = [(False, 6, 6), (True, 6, 6), (True, 4, 9), (True, 9, 4)]


def _jax_flash(ref, q, k, v, causal, lens, seg, dtype=None, **kw):
    cast = (lambda a: a) if dtype is None else (lambda a: a.astype(dtype))
    out = ref.attention.flash_attention(cast(q), cast(k), cast(v),
                                        causal=causal, lengths=lens,
                                        segment_ids=seg, **kw)
    return out.astype(ref.jnp.float32)


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
    }

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
        }
        return out

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
        _dense_mma_sync(q, q, q, causal=True)
    with pytest.raises(ValueError, match="seq_q <= seq_k"):
        _dense_mma_sync(q, q[:, :, :4], q[:, :, :4], causal=True)


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
    offset no row is 16-byte aligned and the CUDA-core variant runs."""
    x = torch.randn(2, 64, 8, 64 + offset, device=card,
                    dtype=torch.bfloat16)[..., offset:]
    q = x.transpose(1, 2)  # (B, H, S, D), not contiguous
    out = flash_attention(q, q, q, causal=True)
    want = attention_plain(q, q, q, causal=True)
    if offset == 0:  # the output keeps a dense input's layout
        assert out.stride() == q.stride()
    assert (out.float() - want.float()).abs().max().item() <= 1.6e-2
    with pytest.raises(MXNetError):
        flash_attention(q.detach().requires_grad_(), q, q)
    with pytest.raises(MXNetError):
        flash_attention(*(torch.zeros(1, 1, 4, 160, device=card),) * 3)


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
    mma = _dense_mma_sync(q, k, v, causal=causal)
    assert flash_attention.wgmma_launches == before + 1
    assert bool(((mma.float() - want).abs() <= bound).all())


@pytest.mark.cuda
def test_wgmma_variant_routes_by_alignment(card):
    """A view no row of which is 16-byte aligned, and fp32, keep their
    earlier routes; so does the masked core."""
    x = torch.randn(1, 4, 200, 65, device=card, dtype=torch.bfloat16)[..., 1:]
    before = flash_attention.wgmma_launches
    out = flash_attention(x, x, x, causal=True)
    f32 = flash_attention(x.float(), x.float(), x.float())
    y = x.contiguous()
    masked = flash_attention(y, y, y, lengths=torch.tensor([100], device=card))
    torch.cuda.synchronize()
    assert flash_attention.wgmma_launches == before
    assert (out.float() - attention_plain(x, x, x, causal=True).float()
            ).abs().max().item() <= 1.6e-2
    assert f32.dtype == torch.float32 and masked.shape == y.shape

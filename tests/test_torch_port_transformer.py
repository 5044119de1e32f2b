"""Parity of the PyTorch port's transformer LM with the JAX package.

``mxnet_tpu_torch.models.transformer`` against ``mxnet_tpu.models.
transformer`` at a toy size (vocab 64, 2 layers, 4 heads, d_model 32):
bit-identical parameters from one seed, allclose logits in fp32 and bf16,
JAX's gather rule for out-of-range token ids, causality, and serving the
logits through ``CallableBackend``. The ``cuda``-marked test runs the model
on the card against its CPU path and skips without one.
"""
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import transformer_params_from_numpy
from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM, forward,
                                                init_params, token_rows)
from mxnet_tpu_torch.ops.cuda.attention import flash_attention
from mxnet_tpu_torch.serving import CallableBackend

V, S = 64, 16
# fp32 on both sides: only the summation order differs
RTOL, ATOL = 1e-5, 1e-5
# bf16 activations: the two frameworks round their bf16 products and sums
# at different places; measured 4e-3 on logits of magnitude 0.5
BF16_ATOL = 2e-2


def _cfg(mod, dtype="float32"):
    return mod.TransformerConfig(vocab_size=V, num_layers=2, num_heads=4,
                                 d_model=32, max_seq_len=256, dtype=dtype)


def _tokens():
    rng = np.random.RandomState(1)
    toks = rng.randint(0, V, (2, S))
    wild = toks.copy()
    wild[0, :4] = [V + 5, -1, -V - 7, 2 * V]  # wrap once, then clamp
    return {"toks": toks, "wild": wild}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX parameters and every JAX logits this file compares, from one
    jit: one XLA compile."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.models import transformer
    cfg32, cfg16 = _cfg(transformer), _cfg(transformer, "bfloat16")
    params = transformer.init_params(0, cfg32)

    def run(p, toks):
        return {"fp32": transformer.forward(p, toks["toks"], cfg32),
                "bf16": transformer.forward(p, toks["toks"], cfg16),
                "wild": transformer.forward(p, toks["wild"], cfg32)}

    toks = jax.tree.map(jnp.asarray, _tokens())
    out = jax.device_get(jax.jit(run)(params, toks))
    return types.SimpleNamespace(
        params=jax.tree.map(np.asarray, params),
        logits=jax.tree.map(np.asarray, out))


@pytest.fixture(scope="module")
def port_params(jax_ref):
    return transformer_params_from_numpy(jax_ref.params, ctx=mxt.cpu())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def test_init_params_bit_identical(jax_ref, port_params):
    mine = _flat(init_params(0, _cfg(mxt.models.transformer), ctx=mxt.cpu()))
    theirs = _flat(jax_ref.params)
    assert sorted(mine) == sorted(theirs)
    for name, arr in theirs.items():
        assert mine[name].dtype == torch.float32, name
        assert np.array_equal(mine[name].numpy(), arr), name
    converted = _flat(port_params)
    assert all(torch.equal(converted[n], mine[n]) for n in mine)


@pytest.mark.parametrize("dtype,tol", [("float32", ATOL),
                                       ("bfloat16", BF16_ATOL)])
def test_forward_matches_jax(jax_ref, port_params, dtype, tol):
    cfg = _cfg(mxt.models.transformer, dtype)
    got = forward(port_params, torch.from_numpy(_tokens()["toks"]), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, S, V)
    want = jax_ref.logits["fp32" if dtype == "float32" else "bf16"]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=tol)


def test_token_ids_wrap_then_clamp_like_jax(jax_ref, port_params):
    rows = token_rows(torch.tensor([5, -1, -7]), 4)
    assert rows.tolist() == [3, 3, 0]
    got = forward(port_params, torch.from_numpy(_tokens()["wild"]),
                  _cfg(mxt.models.transformer))
    np.testing.assert_allclose(got.numpy(), jax_ref.logits["wild"],
                               rtol=RTOL, atol=ATOL)


def test_causality(port_params):
    """Changing a future token must not affect earlier logits."""
    cfg = _cfg(mxt.models.transformer)
    toks = _tokens()["toks"][:1]
    toks2 = toks.copy()
    toks2[0, -1] = (toks2[0, -1] + 1) % V
    l1 = forward(port_params, torch.from_numpy(toks), cfg)
    l2 = forward(port_params, torch.from_numpy(toks2), cfg)
    np.testing.assert_allclose(l1[0, :-1].numpy(), l2[0, :-1].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert float((l1[0, -1] - l2[0, -1]).abs().max()) > 1e-4


def test_callable_backend_serves_logits(jax_ref):
    lm = TransformerLM(_cfg(mxt.models.transformer), seed=0, ctx=mxt.cpu())
    backend = CallableBackend(
        lambda arrays: lm.logits(arrays["data"]).cpu().numpy(),
        input_specs={"data": (S,)})
    backend.load()
    toks = _tokens()["toks"]
    (out,) = backend.infer({"data": toks.astype(np.float32)})
    assert out.shape == (2, S, V) and out.dtype == np.float32
    np.testing.assert_allclose(out, jax_ref.logits["fp32"], rtol=RTOL,
                               atol=ATOL)


def test_sequence_parallel_and_missing_card_raise():
    cfg = _cfg(mxt.models.transformer)
    with pytest.raises(MXNetError):
        TransformerLM(cfg, seq_axis="seq", ctx=mxt.cpu())
    with pytest.raises(MXNetError):
        forward({}, torch.zeros(1, 2, dtype=torch.long), cfg, seq_axis="s")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            TransformerLM(cfg)  # the default context is gpu(0)


@pytest.mark.cuda
def test_transformer_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_port_transformer.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=V, num_layers=2, num_heads=4,
                            d_model=256, dtype="float32")
    toks = np.random.RandomState(2).randint(0, V, (2, 100))
    card = TransformerLM(cfg, seed=0, ctx=mxt.gpu(0))
    cpu = TransformerLM(cfg, seed=0, ctx=mxt.cpu())
    before = flash_attention.launches
    got = card.logits(toks)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), cpu.logits(toks), rtol=1e-4,
                               atol=1e-4)

"""The body language of the port's ``rtc`` against the JAX package's.

Each form of the language (static values and folding, basic indexing on
reads and stores, views, reductions, products, static control flow, the
elementwise functions, bool/int8/uint8 and jnp's promotion, outputs of
several shapes) goes through ``mxnet_tpu.rtc.Rtc`` (Pallas in interpret
mode, x64 off as users run it) and the port's plain version on the CPU,
with numpy inputs from a seed. So does the JAX package's own LSTM-cell
Pallas body (``mxnet_tpu/ops/pallas/lstm.py:_lstm_kernel`` with
``_gates``), held against ``_cell_jnp`` too. Bodies that JAX refuses raise
MXNetError at ``Rtc(...)``, which both of the port's paths share.

Tolerances against JAX: ``bits`` bit for bit (NaN equal to NaN): bodies
of arithmetic, comparisons, casts, indexing, max/min/argmax/argmin, any
and all; ``ulp``: a product and a sum that XLA may fuse into one FMA,
within 2 fp32 ulps; ``fn``: library functions (exp, erf, tan, ...) within rtol 1e-5
(XLA's implementations and torch's differ by ulps); ``sum``: sums, means,
products and dots, which add in another order, within rtol 2e-6 times the
summed length and atol the same times the largest magnitude summed; 16-bit
outputs within one ulp of their type (2**-8 bf16, 2**-10 fp16, relative).

Tests marked ``cuda`` compile the same bodies with NVRTC on the card and
hold each stage kind's kernel to the plain version there, with the same
tolerances but for 16-bit outputs: one ulp of the type at the value
(2**-7 bf16, 2**-10 fp16, relative) plus the fp32 sum's 2e-6 times its
length of the largest magnitude, since the kernel's products and the
plain version's add in other orders before their one rounding.
"""
import inspect
import textwrap
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd as pnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.cuda import rtc_codegen as cg

F32, BF16, F16, I32 = "float32", "bfloat16", "float16", "int32"


@pytest.fixture(scope="module")
def ref():
    import jax
    import mxnet_tpu
    return types.SimpleNamespace(mx=mxnet_tpu, nd=mxnet_tpu.nd, jnp=jax.numpy,
                                 x32=lambda: jax.enable_x64(False))


def _port_arrays(specs):
    with mxt.cpu():
        return [(n, pnd.array(a, dtype=d)) for n, a, d in specs]


def _jax_arrays(ref, specs):
    out = []
    for n, a, d in specs:
        arr = ref.nd.array(a.astype(np.float32) if d == "bfloat16" else a)
        out.append((n, arr.astype(d) if d != str(arr.dtype) else arr))
    return out


def _push(pkg_rtc, name, ins, outs, body):
    k = pkg_rtc.Rtc(name, ins, outs, body)
    k.push([a for _, a in ins], [a for _, a in outs])
    return [np.asarray(a.asnumpy(), dtype=np.float32) if str(a.dtype) == "bfloat16"
            else a.asnumpy() for _, a in outs]


def _both(ref, name, ins, outs, body):
    got = _push(mxt.rtc, name, _port_arrays(ins), _port_arrays(outs), body)
    with ref.x32():
        want = _push(ref.mx.rtc, name, _jax_arrays(ref, ins),
                     _jax_arrays(ref, outs), body)
    return got, want


def _zeros(shape, dtype):
    return np.zeros(shape, np.float32 if dtype in (F32, BF16) else dtype)


def _check(got, want, tol, length=1, label=""):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (label, got.shape, want.shape, got.dtype, want.dtype)
    if tol == "bits":
        np.testing.assert_array_equal(got, want, err_msg=label)
        return
    g, w = got.astype(np.float64), want.astype(np.float64)
    if tol in ("fn", "ulp"):
        rtol = 1e-5 if tol == "fn" else 2.0 ** -22
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol, equal_nan=True,
                                   err_msg=label)
    elif tol == "sum":
        scale = max(float(np.nanmax(np.abs(w))) if w.size else 0.0, 1.0)
        np.testing.assert_allclose(g, w, rtol=2e-6 * length,
                                   atol=2e-6 * length * scale, equal_nan=True,
                                   err_msg=label)
    else:  # a 16-bit type: one ulp
        ulp = {BF16: 2.0 ** -8, F16: 2.0 ** -10}[tol]
        np.testing.assert_allclose(g, w, rtol=ulp, atol=ulp, equal_nan=True,
                                   err_msg=label)


RNG = np.random.RandomState(17)
X = RNG.normal(0, 1.5, (4, 8)).astype(np.float32)
Y = RNG.normal(0, 1.5, (4, 8)).astype(np.float32)
W = RNG.normal(0, 1, (8, 5)).astype(np.float32)
V8 = RNG.normal(0, 1, (8,)).astype(np.float32)
X3 = RNG.normal(0, 1, (2, 3, 4)).astype(np.float32)
B3 = RNG.normal(0, 1, (2, 4, 5)).astype(np.float32)
I = RNG.randint(-40, 40, (4, 8)).astype(np.int32)
NANS = np.array([[1.0, np.nan, 3.0, np.nan], [-np.inf, 2.0, 2.0, 0.5]],
                np.float32)

# (label, inputs [(name, array, dtype)], outputs [(name, shape, dtype,
# tolerance)], body, summed length for "sum")
CASES = [
    # 1. static values and folding
    ("static values", [("h", X, F32)],
     [("o", (4, 2), F32, "ulp"), ("p", (4, 8), BF16, "bits"),
      ("q", (4, 8), F32, "bits")],
     """
     H = h.shape[-1] // 4
     n = len(h) + h.ndim + h[:].ndim * 0 + (1 if h.dtype == jnp.float32 else 7)
     o[:] = h[:, 0 * H:1 * H] * n + jnp.pi
     p[:] = (h[:] * 2.0).astype(p.dtype)
     q[:] = jnp.where(h[:] > 0, jnp.inf, np.pi) + jnp.where(h[:] > 1.0, jnp.nan, 0.0)
     """, 1),
    # 2. basic indexing on reads, locals and stores
    ("reads", [("x", X, F32)],
     [("a", (2, 8), F32, "bits"), ("b", (8,), F32, "bits"),
      ("c", (2, 4), F32, "bits"), ("d", (3, 1, 3), F32, "bits"),
      ("e", (4,), F32, "bits")],
     """
     a[:] = x[1:3]
     b[:] = x[2] + x[-1]
     c[:] = x[::2, 1::2]
     t = x[:]
     d[:] = t[1:, None, ::3]
     e[:] = x[..., -2] * t[:, 0]
     """, 1),
    ("stores", [("x", X, F32), ("y", Y, F32)],
     [("o", (4, 8), F32, "bits"), ("p", (4, 8), F32, "bits"),
      ("s", (4, 8), F32, "bits")],
     """
     o[0:2, :] = x[1:3] * 2.0
     o[-1] = y[0]
     o[2, ::2] = o[0, 1::2] - 1.0
     p[:] = x[:]
     p[:] += y[:]
     p[1:3, 2:5] *= 3.0
     a = o[:] + 1.0
     a *= 2.0
     s[:, :] = a
     """, 1),
    # 3. views
    ("views", [("x", X, F32), ("x3", X3, F32), ("v", V8, F32)],
     [("a", (8, 4), F32, "bits"), ("b", (3, 2, 4), F32, "bits"),
      ("c", (32,), F32, "bits"), ("d", (8, 4), F32, "bits"),
      ("e", (1, 8, 1), F32, "bits"), ("f", (3, 8), F32, "bits"),
      ("g", (4, 2), F32, "bits")],
     """
     a[:] = x[:].T + jnp.transpose(x[:])
     b[:] = jnp.transpose(x3[:], (1, 0, 2)) * 2.0
     c[:] = x[:].reshape(32) - jnp.reshape(x[:].T, (32,))
     d[:] = jnp.reshape(x[:], (8, 4)) + x[:].reshape(-1, 4)
     e[:] = jnp.expand_dims(jnp.expand_dims(v[:], 0), -1)
     f[:] = jnp.broadcast_to(v[:], (3, 8)) + jnp.squeeze(e[:])
     g[:] = x3[:].reshape(2, 12).T.reshape(4, 6)[:, ::3]
     """, 1),
    # 4. reductions
    ("sums", [("x", X, F32)],
     [("s", (), F32, "sum"), ("r", (4,), F32, "sum"), ("c", (8,), F32, "sum"),
      ("k", (4, 1), F32, "sum"), ("t", (1, 1), F32, "sum"),
      ("m", (8,), F32, "sum"), ("p", (4,), F32, "sum")],
     """
     s[...] = jnp.sum(x[:])
     r[:] = jnp.sum(x[:], axis=1)
     c[:] = x[:].sum(axis=0)
     k[:] = jnp.sum(x[:], axis=-1, keepdims=True)
     t[:] = x[:].sum(axis=(0, 1), keepdims=True)
     m[:] = jnp.mean(x[:], axis=0) + x[:].mean(0)
     p[:] = jnp.prod(x[:] * 0.5 + 1.0, axis=1)
     """, 32),
    ("max min arg", [("x", X, F32), ("z", NANS, F32)],
     [("a", (4,), F32, "bits"), ("b", (), F32, "bits"), ("c", (4,), I32, "bits"),
      ("d", (8,), I32, "bits"), ("e", (2,), F32, "bits"),
      ("f", (2,), I32, "bits"), ("g", (2,), I32, "bits"),
      ("h", (), I32, "bits"), ("i", (1, 8), F32, "bits")],
     """
     a[:] = jnp.max(x[:], axis=1)
     b[...] = x[:].min()
     c[:] = jnp.argmax(x[:], axis=1)
     d[:] = x[:].argmin(axis=0)
     e[:] = jnp.max(z[:], axis=-1)
     f[:] = jnp.argmax(z[:], axis=1)
     g[:] = jnp.argmin(z[:], axis=1)
     h[...] = jnp.argmax(x[:])
     i[:] = jnp.min(x[:], axis=0, keepdims=True)
     """, 1),
    ("softmax", [("x", X, F32)],
     [("o", (4, 8), F32, "fn"), ("l", (4, 8), F32, "fn"),
      ("m", (4, 8), F32, "fn"), ("s", (4, 8), F32, "fn")],
     """
     m_ = jnp.max(x[:], axis=1, keepdims=True)
     e = jnp.exp(x[:] - m_)
     o[:] = e / jnp.sum(e, axis=1, keepdims=True)
     l[:] = jax.nn.log_softmax(x[:], axis=1)
     m[:] = jax.nn.softmax(x[:])
     s[:] = jax.nn.softmax(x[:], axis=0)
     """, 8),
    ("reduce dtypes", [("b", np.full((64, 64), 0.01, np.float32), BF16),
                       ("i", I, I32), ("big", np.full((4, 8), 2 ** 30, np.int32), I32),
                       ("q", (I % 3 == 0), "bool"), ("s8", (I % 100).astype(np.int8), "int8")],
     [("bs", (), BF16, "bits"), ("bm", (64,), BF16, "bits"),
      ("isum", (8,), I32, "bits"), ("wrap", (), I32, "bits"),
      ("imean", (4,), F32, "sum"), ("qa", (4,), "bool", "bits"),
      ("ql", (8,), "bool", "bits"), ("qs", (), I32, "bits"),
      ("s8s", (4,), I32, "bits"), ("qm", (4,), "bool", "bits")],
     """
     bs[...] = jnp.sum(b[:])
     bm[:] = jnp.mean(b[:], axis=1)
     isum[:] = jnp.sum(i[:], axis=0)
     wrap[...] = jnp.sum(big[:])
     imean[:] = jnp.mean(i[:], axis=1)
     qa[:] = jnp.any(q[:], axis=1)
     ql[:] = q[:].all(axis=0)
     qs[...] = jnp.sum(q[:])
     s8s[:] = s8[:].sum(axis=1)
     qm[:] = jnp.max(q[:], axis=1)
     """, 8),
    # 5. products
    ("products", [("x", X, F32), ("w", W, F32), ("v", V8, F32),
                  ("x3", X3, F32), ("b3", B3, F32), ("y", Y, F32)],
     [("mm", (4, 5), F32, "sum"), ("at", (4, 5), F32, "sum"),
      ("vv", (), F32, "sum"), ("vm", (5,), F32, "sum"), ("mv", (4,), F32, "sum"),
      ("bb", (2, 3, 5), F32, "sum"), ("bw", (2, 3, 5), F32, "sum"),
      ("g1", (4, 5), F32, "sum"), ("g2", (4, 4), F32, "sum")],
     """
     mm[:] = jnp.dot(x[:], w[:])
     at[:] = x[:] @ w[:]
     vv[...] = jnp.dot(v[:], v[:])
     vm[:] = v[:] @ w[:]
     mv[:] = jnp.matmul(x[:], v[:])
     bb[:] = jnp.matmul(x3[:], b3[:])
     bw[:] = x3[:] @ w[0:4]
     g1[:] = jax.lax.dot_general(x[:], w[:], (((1,), (0,)), ((), ())))
     g2[:] = jax.lax.dot_general(x[:], y[:], (((1,), (1,)), ((), ())),
                                 preferred_element_type=jnp.float32)
     """, 8),
    ("product dtypes", [("x", X, BF16), ("w", W, BF16), ("h", X, F16),
                        ("i", I, I32), ("j", I.T.copy() * 99999, I32)],
     [("b", (4, 5), BF16, BF16), ("f", (4, 5), F32, "sum"),
      ("h2", (4, 4), F16, F16), ("ii", (4, 4), I32, "bits")],
     """
     b[:] = jnp.dot(x[:], w[:])
     f[:] = jax.lax.dot_general(x[:], w[:], (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
     h2[:] = h[:] @ h[:].T
     ii[:] = i[:] @ j[:]
     """, 8),
    # 6. static control flow
    ("control flow", [("x", X, F32)],
     [("a", (4, 8), F32, "bits"), ("b", (4, 8), F32, "bits"),
      ("c", (4, 8), F32, "bits"), ("d", (8,), F32, "bits")],
     """
     t = x[:]
     for i in range(3):
         t = t * 2.0 + i
     a[:] = t
     b[:] = jax.lax.fori_loop(0, 3, lambda i, v: v + x[:] * i, x[:])
     def body(i, v):
         return v - x[i % 4]
     w = jax.lax.fori_loop(1, 5, body, x[0])
     N = x.shape[0]
     if N > 8:
         c[:] = x[:]
     elif 0 < N < 8:
         c[:] = x[:] * 3.0 if N == 4 else x[:]
     else:
         c[:] = x[:] * 0.0
     for r in range(N):
         d[:] = w + x[r] if r == 0 else d[:] + x[r]
     """, 1),
    # 7. more elementwise functions
    ("functions", [("x", X, F32), ("y", Y, F32)],
     [("a", (4, 8), F32, "fn"), ("b", (4, 8), F32, "fn"), ("c", (4, 8), F32, "fn"),
      ("d", (4, 8), F32, "fn"), ("e", (4, 8), F32, "fn"),
      ("f", (4, 8), "bool", "bits")],
     """
     z = x[:] * 0.3
     a[:] = jnp.log2(jnp.abs(x[:]) + 1.0) + jnp.log10(jnp.abs(y[:]) + 1.0) + jnp.exp2(z)
     b[:] = jnp.tan(z) + jnp.arcsin(z) + jnp.arccos(z) + jnp.arctan(x[:]) + jnp.arctan2(x[:], y[:])
     c[:] = jnp.sinh(z) + jnp.cosh(z) + jax.lax.rsqrt(jnp.abs(x[:]) + 0.5) + jax.lax.erf(x[:])
     d[:] = (jax.nn.gelu(x[:]) + jax.nn.silu(x[:]) + jax.nn.softplus(x[:])
             + jax.nn.log_sigmoid(y[:]) + jax.nn.leaky_relu(x[:]) + jax.nn.elu(y[:])
             + jax.nn.leaky_relu(y[:], 0.2) + jax.nn.elu(x[:], alpha=0.5))
     e[:] = (jnp.power(x[:], 2) + jnp.reciprocal(y[:]) + jnp.negative(x[:])
             + jnp.round(x[:] * 3.0) + jnp.trunc(y[:] * 2.0) + jnp.mod(x[:], 0.7)
             + jnp.floor_divide(y[:], 0.3) + jnp.power(jnp.abs(x[:]), y[:] * 0.0 + 2.0))
     w = jnp.where(x[:] > 1.0, jnp.inf, jnp.where(x[:] < -1.0, jnp.nan, x[:]))
     f[:] = (jnp.logical_and(jnp.isnan(w), y[:] > 0) | jnp.logical_or(jnp.isinf(w), x[:] < -2.0)) ^ jnp.logical_not(jnp.isfinite(w))
     """, 1),
    ("bitwise and integer powers",
     [("i", I, I32), ("j", (I % 7).astype(np.int32) - 2, I32),
      ("s", np.array([0, 1, 5, 31, 32, 40, -1, 3], np.int32), I32),
      ("q", (I % 2 == 0), "bool")],
     [("a", (4, 8), I32, "bits"), ("b", (4, 8), I32, "bits"),
      ("c", (8,), I32, "bits"), ("d", (4, 8), "bool", "bits"),
      ("e", (4, 8), F32, "bits")],
     """
     a[:] = (i[:] & 12) | (i[:] ^ j[:]) + ~i[:]
     b[:] = i[:] ** j[:] + jnp.power(j[:], 3) + (i[:] % 5) ** jnp.abs(j[:])
     c[:] = (i[0] << s[:]) + (i[1] >> s[:]) + (-7 >> s[:])
     d[:] = (q[:] & (i[:] > 0)) | ~q[:] ^ (j[:] == 0)
     e[:] = i[:] ** (j[:] * 1.0) + (i[:] > 0) * 1.5
     """, 1),
    # 8. dtypes: bool, int8, uint8, jnp's promotion
    ("small dtypes",
     [("u", (np.abs(I) * 7 % 256).astype(np.uint8), "uint8"),
      ("s", (I * 3).astype(np.int8), "int8"), ("q", I > 0, "bool"),
      ("x", X * 100.0, F32)],
     [("a", (4, 8), I32, "bits"), ("b", (4, 8), "uint8", "bits"),
      ("c", (4, 8), "int8", "bits"), ("d", (4, 8), "bool", "bits"),
      ("e", (4, 8), F32, "bits"), ("f", (4, 8), "int8", "bits"),
      ("g", (4, 8), "uint8", "bits"), ("h", (4, 8), "int8", "bits")],
     """
     a[:] = (u[:] + s[:]).astype(jnp.int32) + (u[:] * s[:]).astype(jnp.int32) * 1000
     b[:] = u[:] * 3 + u[:] // 7 + u[:] % 9 + (u[:] >> 2) + q[:].astype(jnp.uint8)
     c[:] = s[:] * s[:] - s[:] // 3 + s[:] % -5 + (s[:] << 3) + jnp.abs(s[:])
     d[:] = q[:] ^ (u[:] > 100) | (s[:] < 0)
     e[:] = u[:] / 2 + s[:] * 0.5 + q[:] + u[:].astype(jnp.bfloat16) + s[:].astype(jnp.float16)
     f[:] = x[:].astype(jnp.int8)
     g[:] = x[:].astype(jnp.uint8)
     h[:] = u[:].astype(jnp.int8) + (u[:] + s[:]).astype(jnp.int8)
     """, 1),
    # 9. outputs of several shapes
    ("shapes", [("x", X, F32)],
     [("o", (4, 8), F32, "bits"), ("r", (4,), F32, "sum"),
      ("p", (2, 2), F32, "bits"), ("n", (4, 8), F32, "bits")],
     """
     o[:] = x[:] * 2.0
     r[:] = jnp.sum(o[:], axis=1)
     p[:] = x[0:2, 0:2]
     """, 8),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_language_matches_jax(ref, case):
    label, ins, outs, body, length = case
    body = textwrap.dedent(body)
    got, want = _both(ref, label.split()[0], ins,
                      [(n, _zeros(s, dt), dt) for n, s, dt, _ in outs], body)
    for (n, s, dt, tol), g, w in zip(outs, got, want):
        _check(g, w, tol, length, f"{label}: {n}")


def test_bf16_sum_rounds_once(ref):
    """4096 x bf16(0.01) sums to 41.0 in fp32 rounded once; per-element
    bf16 rounding would stop far below."""
    ins = [("b", np.full((4096,), 0.01, np.float32), BF16)]
    got, want = _both(ref, "bsum", ins, [("s", _zeros((), BF16), BF16)],
                      "s[...] = jnp.sum(b[:])")
    assert got[0] == want[0] == 41.0


def test_argmax_nan_and_first_index(ref):
    ins = [("z", np.array([1, np.nan, 3, np.nan], np.float32), F32),
           ("t", np.array([2, 5, 5, 1], np.float32), F32)]
    got, want = _both(ref, "am", ins, [("a", _zeros((), I32), I32),
                                       ("b", _zeros((), I32), I32),
                                       ("m", _zeros((), F32), F32)],
                      "a[...] = jnp.argmax(z[:])\nb[...] = jnp.argmax(t[:])\n"
                      "m[...] = jnp.max(z[:])")
    assert got[0] == want[0] == 1 and got[1] == want[1] == 1
    assert np.isnan(got[2]) and np.isnan(want[2])


def test_fill_of_small_dtypes(ref):
    """Unwritten regions hold the JAX interpreter's fill: NaN, the least
    integer, False."""
    outs = [(n, _zeros((2, 3), dt), dt) for n, dt in
            (("a", "bool"), ("b", "int8"), ("c", "uint8"), ("d", I32),
             ("e", BF16), ("f", F16))]
    body = "a[0] = x[0] > 0\nb[0, 0] = x[0, 0].astype(jnp.int8)\nc[1] = x[1].astype(jnp.uint8)"
    got, want = _both(ref, "fill", [("x", X[:2, :3] * 10, F32)], outs, body)
    for g, w in zip(got, want):
        _check(g, w, "bits")


def test_outputs_are_new_tensors():
    """An output whose value is a view of an input gets its own memory,
    as the JAX interpreter's fresh output buffers do."""
    with mxt.cpu():
        x = pnd.array(X)
        o, t = pnd.zeros((2, 8)), pnd.zeros((8, 4))
        mxt.rtc.Rtc("v", [("x", x)], [("o", o), ("t", t)],
                    "o[:] = x[1:3]\nt[:] = x[:].T").push([x], [o, t])
    ptr = x._data.untyped_storage().data_ptr()
    for out, want in ((o, X[1:3]), (t, X.T)):
        assert out._data.untyped_storage().data_ptr() != ptr
        assert out._data.is_contiguous()
        np.testing.assert_array_equal(out.asnumpy(), want)


# -- B1's own Pallas body --------------------------------------------------------


def lstm_body():
    """``_lstm_kernel``'s text with ``_gates`` defined before it, from the
    JAX package's source."""
    from mxnet_tpu.ops.pallas import lstm
    gates = inspect.getsource(lstm._gates)
    kernel = inspect.getsource(lstm._lstm_kernel).split("\n", 1)[1]
    return gates + textwrap.dedent(kernel)


@pytest.mark.parametrize("state", [F32, BF16])
def test_b1_lstm_body_matches_cell_jnp(ref, state):
    n, h = 3, 8
    rng = np.random.RandomState(3)
    xp = rng.normal(0, 1, (n, 4 * h)).astype(np.float32)
    h0 = rng.normal(0, 1, (n, h)).astype(np.float32)
    c0 = rng.normal(0, 1, (n, h)).astype(np.float32)
    w = rng.normal(0, 0.3, (4 * h, h)).astype(np.float32)
    ins = [("xproj_ref", xp, F32), ("h_ref", h0, state), ("c_ref", c0, state),
           ("w_ref", w, F32)]
    outs = [("hn_ref", _zeros((n, h), state), state),
            ("cn_ref", _zeros((n, h), state), state)]
    got, want = _both(ref, "lstm", ins, outs, lstm_body())
    from mxnet_tpu.ops.pallas.lstm import _cell_jnp
    with ref.x32():
        cast = lambda a: ref.jnp.asarray(a).astype(state)
        cell = [np.asarray(t.astype(ref.jnp.float32)) for t in _cell_jnp(
            ref.jnp.asarray(xp), cast(h0), cast(c0), ref.jnp.asarray(w))]
    tol = "sum" if state == F32 else BF16
    for g, w_, c in zip(got, want, cell):
        _check(g, w_, tol, 4 * h)
        _check(g, c, tol, 4 * h)


# -- jnp's promotion lattice ----------------------------------------------------

STRONG = ("bool", "uint8", "int8", "int16", "int32", "bfloat16", "float16",
          "float32")


@pytest.mark.parametrize("a", STRONG)
def test_promote_matches_promote_types(ref, a):
    for b in STRONG:
        assert cg.promote(a, b) == str(ref.jnp.promote_types(a, b)), (a, b)
    with ref.x32():
        for w, lit in (("weak_int", 3), ("weak_float", 1.5)):
            want = ref.jnp.result_type(ref.jnp.ones((2,), a), lit)
            got = cg.promote(a, w)
            assert got == str(want), (a, w)


# -- what stays refused ----------------------------------------------------------

REFUSED = [
    ("if x[:] > 0:\n    o[:] = x[:]", "truth value"),
    ("o[:] = jnp.where(x[:] < y[:] < 1.0, x[:], y[:])", "chained comparison"),
    ("o[:] = x[:] if jnp.sum(x[:]) > 0 else y[:]", "truth value"),
    ("o[:] = np.exp(x[:])", "function outside"),
    ("o[:] = 2.0", "Invalid shape"),
    ("o[:] = x[jnp.argmax(y[:], axis=0)]", "gathers"),
    ("o[:] = jnp.take(x[:], 0)", "gathers"),
    ("o[:] = jnp.cumsum(x[:], axis=0)", "scans"),
    ("o[:] = jax.lax.cond(True, lambda: x[:], lambda: y[:])", "lax control flow"),
    ("o[:] = jnp.sort(x[:])", "sorting"),
    ("o[:] = jnp.einsum('ij,ij->ij', x[:], y[:])", "einsum"),
    ("o[:] = x[:].astype(jnp.float64)", "fp64"),
    ("o[:] = x[:] + jax.random.normal(0, (4, 3))", "random"),
    ("i = 0\nwhile i < 3:\n    i += 1\no[:] = x[:]", "while"),
    ("for i in range(5000):\n    o[:] = x[:]", "unrolls past 4096"),
    ("o[:] = jnp.dot(x[:].reshape(1, 1, 1, 12), y[:].reshape(1, 1, 12, 1)).reshape(4, 3) * 0.0 + x[:]",
     "rank above 3"),
]


@pytest.mark.parametrize("body,why", REFUSED, ids=[w for _, w in REFUSED])
def test_refused_in_both_paths(body, why):
    """Both paths share ``Rtc(...)``'s check: the CPU Rtc and the analysis
    the card's module is compiled from raise alike."""
    ins = [("x", (4, 3), F32), ("y", (4, 3), F32)]
    with pytest.raises(MXNetError, match=why) as e:
        cg.analyze("t", ins, [("o", (4, 3), F32)], body)
    assert cg.QUEUE_ENTRY in str(e.value)
    with mxt.cpu():
        arrays = [(n, pnd.zeros(s)) for n, s, _ in ins]
        with pytest.raises(MXNetError, match=why):
            mxt.rtc.Rtc("t", arrays, [("o", pnd.zeros((4, 3)))], body)


def test_jax_refuses_what_the_port_refuses(ref):
    """`if` on an array and a chained comparison of arrays fail in JAX too."""
    x = ref.nd.array(X[:, :3])
    for body in ("if x[:] > 0:\n    o[:] = x[:]",
                 "o[:] = jnp.where(x[:] < x[:] < 1.0, x[:], x[:])"):
        with ref.x32(), pytest.raises(Exception,
                                      match="truth value|Tracer|bool"):
            o = ref.nd.zeros((4, 3))
            ref.mx.rtc.Rtc("t", [("x", x)], [("o", o)], body).push([x], [o])


# -- the stage plan ----------------------------------------------------------------


@pytest.mark.parametrize("body,outs,kinds", [
    ("o[:] = x[:] * 2.0", [("o", (4, 8), F32)], None),  # the simple kernel
    ("o[:] = x[1:3].sum(axis=0) + 1.0", [("o", (8,), F32)], ["reduce", "map"]),
    ("s[...] = jnp.sum(x[:] * x[:])", [("s", (), F32)], ["reduce"]),
    ("o[:] = jax.nn.log_softmax(x[:], axis=1)\nl[:] = jnp.max(x[:], axis=1)",
     [("o", (4, 8), F32), ("l", (4,), F32)], ["reduce", "reduce", "reduce", "map"]),
    ("o[:] = x[:] @ w[:]", [("o", (4, 5), F32)], ["product"]),
    ("g = x[:] @ w[:] + 1.0\no[:] = g[:, 0:2] * g[:, 3:5] + g[:, 1:3]",
     [("o", (4, 2), F32)], ["product", "map"]),
    # a value of 4 operations read through three views: materialized once
    ("g = jnp.tanh(x[:] @ w[:] + 1.0) * 2.0 - 1.0\n"
     "o[:] = g[:, 0:2] * g[:, 3:5] + g[:, 1:3]",
     [("o", (4, 2), F32)], ["product", "map", "map"]),
])
def test_stage_plan(body, outs, kinds):
    prog = cg.analyze("t", [("x", (4, 8), F32), ("w", (8, 5), F32)], outs, body)
    if kinds is None:
        assert prog.simple
        return
    assert not prog.simple
    plan = cg.plan_stages(prog)
    assert [s.kind for s in plan.stages] == kinds
    src, launches, _ = cg.emit_stages(prog, plan, False, 132)
    assert "atomic" not in src and src.count("__global__") == len(launches)
    assert all(name in src for name, *_ in launches)
    # the source is the compile cache's key: the same program writes it again
    assert cg.emit_stages(prog, cg.plan_stages(prog), False, 132)[0] == src


def test_split_reduction_folds_in_a_second_kernel():
    prog = cg.analyze("t", [("g", (4_000_000,), F32)], [("s", (), F32)],
                      "s[...] = jnp.sum(g[:] * g[:])")
    src, launches, slots = cg.emit_stages(prog, cg.plan_stages(prog), False, 132)
    assert [k for *_, k in launches] == ["reduce", "reduce"]
    parts = launches[0][1][1]
    assert parts > 1 and slots == parts and launches[1][1][1] == 1
    assert "__shfl_down_sync" in src and "part_f" in src


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run "
                    "`python -m pytest --noconftest -m cuda "
                    "tests/test_torch_port_rtc_language.py`")
    return mxt.gpu(0)


def _card_tol(got, want, tol, length):
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    if tol == "bits":
        if got.is_floating_point():
            same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        else:
            same = got == want
        return bool(same.all())
    g, w = got.double(), want.double()
    scale = max(float(w.abs().nan_to_num(0.0).max()), 1.0)
    if tol in (BF16, F16):
        # one ulp of the type at the value, plus what the fp32 sum of
        # ``length`` terms before the one rounding may differ by
        ulp = {BF16: 2.0 ** -7, F16: 2.0 ** -10}[tol]
        return bool(((g - w).abs() <= ulp * w.abs() + 2e-6 * length * scale)
                    .all())
    rtol = {"fn": 1e-5, "ulp": 2.0 ** -22}.get(tol, 2e-6 * length)
    close = ((g - w).abs() <= rtol * w.abs() + rtol * scale) | (
        torch.isnan(g) & torch.isnan(w))
    return bool(close.all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_card(card, case):
    from mxnet_tpu_torch.ops.cuda.rtc import rtc_launch
    label, ins, outs, body, length = case
    body = textwrap.dedent(body)
    with card:
        arrays = [(n, pnd.array(a, dtype=d)) for n, a, d in ins]
        targets = [(n, pnd.zeros(s, dtype=dt)) for n, s, dt, _ in outs]
    k = mxt.rtc.Rtc(label.split()[0], arrays, targets, body)
    tensors = [a._data for _, a in arrays]
    plain = k._run_plain(tensors, tensors[0].device)
    before = dict(rtc_launch.stage_launches)
    k.push([a for _, a in arrays], [a for _, a in targets])
    torch.cuda.synchronize()
    moved = {s: rtc_launch.stage_launches[s] - before[s] for s in before}
    assert sum(moved.values()) >= 1
    if not k._program.simple:
        plan = k._program.stages
        kinds = [s.kind for s in plan.stages]
        for kind in ("map", "product"):
            assert moved[kind] == kinds.count(kind), (moved, kinds)
        assert moved["reduce"] >= kinds.count("reduce")
    for (n, s, dt, tol), (_, t), p in zip(outs, targets, plain):
        assert _card_tol(t._data, p, tol, length), f"{label}: {n}"


@pytest.mark.cuda
def test_large_reductions_and_products_on_card(card):
    """A split full reduction, row and column reductions, argmax with NaN,
    and the tiled product at both tile sizes, fp32 and bf16, against the
    plain version on the same card tensors."""
    from mxnet_tpu_torch.ops.cuda.rtc import rtc_launch
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(3_000_001, generator=g, device="cuda")
    m = torch.randn(300, 1000, generator=g, device="cuda")
    m[7, 13] = float("nan")
    a = torch.randn(300, 200, generator=g, device="cuda")
    b = torch.randn(200, 700, generator=g, device="cuda")
    cases = [
        ("s[...] = jnp.sum(x[:] * x[:])", [("x", x)], [("s", (), F32)], 3e6),
        ("r[:] = jnp.max(m[:], axis=1)\nc[:] = jnp.sum(m[:], axis=0)\n"
         "i[:] = jnp.argmax(m[:], axis=1)", [("m", m)],
         [("r", (300,), F32), ("c", (1000,), F32), ("i", (300,), I32)], 300),
        ("o[:] = a[:] @ b[:]", [("a", a), ("b", b)], [("o", (300, 700), F32)], 200),
        ("o[:] = jnp.dot(a[:].astype(jnp.bfloat16), b[:].astype(jnp.bfloat16))",
         [("a", a), ("b", b)], [("o", (300, 700), BF16)], 200),
        ("o[:] = jax.lax.dot_general(b[:], b[0:100], (((1,), (1,)), ((), ())))",
         [("b", b)], [("o", (200, 100), F32)], 700),
    ]
    cases += [  # a transposed (strided) input view, into two stage kinds
        ("r[:] = jnp.sum(t[:], axis=0)\no[:] = t[:] * 2.0 + r[:]",
         [("t", m.t())], [("r", (300,), F32), ("o", (1000, 300), F32)], 1000),
    ]
    for body, ins, outs, length in cases:
        arrays = [(n, pnd.NDArray(t)) for n, t in ins]
        with card:
            targets = [(n, pnd.zeros(s, dtype=dt)) for n, s, dt in outs]
        k = mxt.rtc.Rtc("big", arrays, targets, body)
        plain = k._run_plain([t for _, t in ins], x.device)
        before = rtc_launch.launches
        k.push([a_ for _, a_ in arrays], [t for _, t in targets])
        torch.cuda.synchronize()
        assert rtc_launch.launches > before
        for (n, s, dt), (_, t), p in zip(outs, targets, plain):
            tol = "bits" if n in ("r", "i") and "max" in body else (
                BF16 if dt == BF16 else "sum")
            assert _card_tol(t._data, p, tol, length), (body, n)
    # map stages take the caller's launch shape, and give the same bits
    arrays = [("t", pnd.NDArray(m.t()))]
    with card:
        runs = [[pnd.zeros((300,)), pnd.zeros((1000, 300))] for _ in range(2)]
    k = mxt.rtc.Rtc("dims", arrays, [("r", runs[0][0]), ("o", runs[0][1])],
                    "r[:] = jnp.max(t[:], axis=0)\no[:] = t[:] - r[:]")
    k.push([a_ for _, a_ in arrays], runs[0])
    k.push([a_ for _, a_ in arrays], runs[1], grid_dims=(3, 1, 1),
           block_dims=(64, 1, 1))
    torch.cuda.synchronize()
    for a_, b_ in zip(*runs):
        assert _card_tol(a_._data, b_._data, "bits", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["reads", "stores", "sums", "max min arg",
                                   "products", "product dtypes", "small dtypes",
                                   "functions"])
def test_wide_index_kernels_on_card(card, label, monkeypatch):
    """The 64-bit index variant of each stage kind (taken for a value of
    2**31 elements or more), forced here at small sizes by reporting every
    input's span as 2**31, against the plain version."""
    from mxnet_tpu_torch.ops.cuda import rtc as rtc_mod
    monkeypatch.setattr(rtc_mod, "_span", lambda t: 2 ** 31)
    _, ins, outs, body, length = next(c for c in CASES if c[0] == label)
    with card:
        arrays = [(n, pnd.array(a, dtype=d)) for n, a, d in ins]
        targets = [(n, pnd.zeros(s, dtype=dt)) for n, s, dt, _ in outs]
    k = mxt.rtc.Rtc("wide", arrays, targets, textwrap.dedent(body))
    tensors = [a._data for _, a in arrays]
    plain = k._run_plain(tensors, tensors[0].device)
    k.push([a for _, a in arrays], [t for _, t in targets])
    torch.cuda.synchronize()
    (plan,) = k._program.plans.values()
    (source,) = [src for (src, _), ck in rtc_mod._CACHE.items()
                 if ck is plan.kernel]
    assert "index long long" in source
    for (n, s, dt, tol), (_, t), p in zip(outs, targets, plain):
        assert _card_tol(t._data, p, tol, length), f"{label}: {n}"

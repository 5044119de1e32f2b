"""Parity of the PyTorch port's ``rtc`` with the JAX package's, and the
translator of Rtc bodies into CUDA C.

Every Rtc body in the repo (``tests/test_model_rtc.py``,
``tests/test_c_api_train.py``) and bodies that pin the semantics the port
must keep (broadcasting, aliasing, jnp's type promotion with weak Python
numbers, floor ``//`` and ``%``, bf16 and fp16, the NaN/INT_MIN fill of an
output never written) go through the JAX package's ``Rtc`` (Pallas in
interpret mode, x64 off as users run it) and the port's plain version on
the CPU. Each JAX ``Rtc`` compiles once, so the semantics share a few
bodies. The translator (``ops/cuda/rtc_codegen.py``) is a pure function and
is tested here: what it accepts and rejects, and the kernel source it
writes. Tests marked ``cuda`` hold the NVRTC kernel to the plain version
on the card and skip without one.

Tolerances against JAX: arithmetic bit for bit, but a division by a
constant to 1 fp32 ulp (XLA turns it into a product by the reciprocal);
library functions (exp, tanh, sigmoid, ...) to rtol 1e-5; bf16 to one bf16
ulp (2**-8 relative: XLA may keep bf16 intermediates in fp32).
"""
import math
import pathlib
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd as pnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.cuda import rtc_codegen as cg
from mxnet_tpu_torch.ops.cuda.rtc import check_launch_dims

BF16_ULP = 2.0 ** -8


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
        out.append((n, arr.astype(d) if d == "bfloat16" else arr))
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


# -- the repo's bodies ------------------------------------------------------

def test_repo_bodies_match_jax(ref):
    x8 = np.arange(8, dtype=np.float32)
    cases = [  # test_model_rtc.py:50-108, test_c_api_train.py:963
        ("axpy", [("x", x8, "float32"), ("y", np.ones(8, np.float32), "float32")],
         [("out", np.zeros(8, np.float32), "float32")], "out[:] = x[:] * 2.0 + y[:]"),
        ("split", [("x", np.arange(4, dtype=np.float32), "float32")],
         [("a", np.zeros(4, np.float32), "float32"),
          ("b", np.zeros(4, np.float32), "float32")],
         """
         a[:] = x[:] + 1.0
         b[:] = x[:] * x[:]
         """),
        ("k", [("x", x8, "float32")], [("out", np.zeros(8, np.float32), "float32")],
         "out[:] = x[:]"),
        ("axpy2", [("x", np.array([1, 2, 3, 4], np.float32), "float32")],
         [("out", np.zeros(4, np.float32), "float32")], "out[:] = x[:] * 2.0"),
    ]
    for name, ins, outs, body in cases:
        got, want = _both(ref, name, ins, outs, body)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)


# -- semantics --------------------------------------------------------------

def test_fp32_broadcast_transcendental_and_fill(ref):
    rng = np.random.RandomState(0)
    m = rng.normal(0, 2, (3, 4)).astype(np.float32)
    v = rng.normal(0, 2, (4,)).astype(np.float32)
    zeros = np.zeros((3, 4), np.float32)
    body = """
    t = jnp.exp(m[:] * 0.5) - jnp.tanh(v[:])
    a[:] = jnp.where(t > 1.0, jax.nn.sigmoid(t), jnp.maximum(m[:], v[:]))
    b[:] = a[:] * 2.0 + jnp.clip(m[:], -1.0, 1.0) + jnp.log1p(jnp.abs(v[:]))
    b[:] = b[:] + jnp.sqrt(jnp.square(m[:])) + jnp.sin(m[:]) * jnp.cos(v[:])
    b[:] = b[:] + jnp.expm1(v[:] * 0.1) + jnp.floor(m[:]) - jnp.ceil(v[:])
    b[:] = b[:] + jnp.sign(m[:]) + jax.nn.relu(m[:]) + jnp.log(jnp.abs(m[:]) + 1.0)
    e[:] = m[...] - v[...] + m[:] % 1.5 + m[:] // 0.7 - -m[:]
    """
    got, want = _both(ref, "fp32", [("m", m, "float32"), ("v", v, "float32")],
                      [("a", zeros, "float32"), ("b", zeros, "float32"),
                       ("c", zeros, "float32"), ("e", zeros, "float32")], body)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert np.isnan(got[2]).all() and np.isnan(want[2]).all()  # never written
    np.testing.assert_array_equal(got[3], want[3])  # arithmetic: bit for bit


def test_int32_floor_ops_and_promotion(ref):
    x = np.array([[-7, -3, -1, 0, 2, 5], [9, -8, 6, -2147483647 - 1, 1, -4]],
                 np.int32)
    zi, zf = np.zeros_like(x), np.zeros(x.shape, np.float32)
    body = """
    o[:] = x[:] // 2 + x[:] % 3 * 100 + (x[:] // -3) * 10000 + x[:] ** 2
    o[:] = o[:] + jnp.abs(x[:]) - jnp.maximum(x[:], 0) + (x[:] > 0)
    o[:] = o[:] + x[:] % 0 + x[:] // 0 + jnp.sign(x[:]) + jnp.floor(x[:])
    f[:] = x[:] * 2.0 + x[:] / 4 + (x[:] >= 2) * 1.5
    """
    got, want = _both(ref, "ints", [("x", x, "int32")],
                      [("o", zi, "int32"), ("f", zf, "float32"),
                       ("u", zi, "int32")], body)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[2] == -2 ** 31).all() and (want[2] == -2 ** 31).all()
    # [-3, -1, 2, 5] // 2 and % 2 are floor operations
    with mxt.cpu():
        xi = pnd.array([-3, -1, 2, 5], dtype="int32")
        q, r = pnd.zeros((4,), dtype="int32"), pnd.zeros((4,), dtype="int32")
        mxt.rtc.Rtc("fl", [("x", xi)], [("q", q), ("r", r)],
                    "q[:] = x[:] // 2\nr[:] = x[:] % 2").push([xi], [q, r])
    assert q.asnumpy().tolist() == [-2, -1, 1, 2]
    assert r.asnumpy().tolist() == [1, 1, 0, 1]


def test_bf16_fp16_and_casts(ref):
    rng = np.random.RandomState(1)
    x = rng.normal(0, 2, (4, 8)).astype(np.float32)
    h = rng.normal(0, 2, (4, 8)).astype(np.float16)
    zb, zf = np.zeros(x.shape, np.float32), np.zeros(x.shape, np.float32)
    body = """
    b[:] = (x[:] * 0.1 + h[:].astype(jnp.bfloat16)) ** 3 - jax.nn.sigmoid(x[:])
    f[:] = x[:] + h[:]
    g[:] = (y[:] * 3.7).astype(jnp.int32).astype(jnp.float32) + y[:].astype(jnp.bfloat16).astype(jnp.float32)
    """
    ins = [("x", x, "bfloat16"), ("h", h, "float16"), ("y", x, "float32")]
    got, want = _both(ref, "bf16", ins,
                      [("b", zb, "bfloat16"), ("f", zf, "float32"),
                       ("g", zf, "float32")], body)
    np.testing.assert_allclose(got[0], want[0], rtol=BF16_ULP, atol=BF16_ULP)
    np.testing.assert_array_equal(got[1], want[1])  # bf16 + f16 is f32
    np.testing.assert_array_equal(got[2], want[2])


def test_aliased_push_reads_inputs_as_they_were(ref):
    body = "a[:] = x[:] + 1.0\nb[:] = x[:] * 2.0"
    xs = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    with mxt.cpu():
        x, b = pnd.array(xs), pnd.zeros((4,))
        v = x.version
        mxt.rtc.Rtc("alias", [("x", x)], [("a", x), ("b", b)], body).push([x], [x, b])
    with ref.x32():
        jx, jb = ref.nd.array(xs), ref.nd.zeros((4,))
        ref.mx.rtc.Rtc("alias", [("x", jx)], [("a", jx), ("b", jb)], body).push([jx], [jx, jb])
    assert x.asnumpy().tolist() == jx.asnumpy().tolist() == [2, 3, 4, 5]
    assert b.asnumpy().tolist() == jb.asnumpy().tolist() == [2, 4, 6, 8]
    assert x.version == v + 1


@pytest.mark.parametrize("a,b", [
    ("float32", "weak_float"), ("bfloat16", "weak_float"), ("int32", "weak_float"),
    ("int32", "weak_int"), ("bfloat16", "weak_int"), ("float16", "bfloat16"),
    ("int32", "bfloat16"), ("int32", "float16"), ("float32", "bfloat16"),
    ("bool", "weak_float"), ("bool", "weak_int"), ("bool", "int32"),
    ("bool", "bfloat16"), ("weak_int", "weak_float"),
])
def test_promotion_matches_jnp(ref, a, b):
    jnp = ref.jnp
    def val(t):
        return {"weak_float": 1.5, "weak_int": 2}.get(t, None) \
            if t.startswith("weak") else jnp.ones((2,), dtype=t)
    with ref.x32():
        want = jnp.result_type(val(a), val(b))
    got = cg.promote(a, b)
    if got.startswith("weak"):
        got = {"weak_float": "float32", "weak_int": "int32"}[got]
    assert got == str(want)


# -- the plain path's checks ------------------------------------------------

def test_checks_and_messages():
    with mxt.cpu():
        x, out = pnd.array(np.arange(8, dtype=np.float32)), pnd.zeros((8,))
        k = mxt.rtc.Rtc("k", [("x", x)], [("out", out)], "out[:] = x[:]")
        with pytest.raises(MXNetError, match="expects 1 inputs"):
            k.push([x, x], [out])
        with pytest.raises(MXNetError, match="compiled for"):
            k.push([pnd.zeros((1,))], [out])
        with pytest.raises(MXNetError, match="failed to parse"):
            mxt.rtc.Rtc("bad", [("x", x)], [("a", out)], "a[:] = = x")
        with pytest.raises(MXNetError, match="at least one output"):
            mxt.rtc.Rtc("none", [("x", x)], [], "pass")
        for grid, block in (((0, 1, 1), (32, 1, 1)), ((1, 1, 1), (1025, 1, 1)),
                            ((1,), (8, 8, 65))):
            with pytest.raises(MXNetError):
                k.push([x], [out], grid_dims=grid, block_dims=block)
        v = out.version
        # a host array is an input too; the launch shape is checked, then
        # ignored on the CPU
        k.push([np.arange(8, dtype=np.float32)], [out], grid_dims=(4, 1, 1),
               block_dims=(128, 1, 1))
        assert out.version == v + 1
        assert out.asnumpy().tolist() == list(range(8))


def test_launch_dims():
    assert check_launch_dims(None, None) == (None, None)
    assert check_launch_dims((4,), [128, 2]) == ((4, 1, 1), (128, 2, 1))
    for grid, block in (((0,), None), (None, (2048,)), (None, (0, 1, 1)),
                        ((1, 70000, 1), None), (None, (4, 4, 128))):
        with pytest.raises(MXNetError):
            check_launch_dims(grid, block)


def test_sgd_body_equals_the_updater_on_the_cpu():
    """The chip check's reference: three SGD-momentum steps as one Rtc body
    per shape equal get_updater(create('sgd', ...)) bit for bit."""
    rng = np.random.RandomState(5)
    shapes = [(6, 4), (4,), (2, 3, 5)]
    kw = dict(learning_rate=0.01, momentum=0.9, wd=1e-4, rescale_grad=0.125)
    body = ("mom[:] = 0.9 * m[:] - 0.01 * (g[:] * 0.125 + 0.0001 * w[:])\n"
            "wout[:] = w[:] + mom[:]")
    with mxt.cpu():
        w0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
        upd = mxt.optimizer.get_updater(mxt.optimizer.create("sgd", **kw))
        wa = [pnd.array(w) for w in w0]
        wb = [pnd.array(w) for w in w0]
        mb = [pnd.zeros(s) for s in shapes]
        kernels = [mxt.rtc.Rtc("sgd", [("w", w), ("g", w), ("m", m)],
                               [("wout", w), ("mom", m)], body)
                   for w, m in zip(wb, mb)]
        for _ in range(3):
            grads = [pnd.array(rng.normal(0, 3, s).astype(np.float32)) for s in shapes]
            for i, (w, g) in enumerate(zip(wa, grads)):
                upd(i, g, w)
            for k, w, g, m in zip(kernels, wb, grads, mb):
                k.push([w, g, m], [w, m])
        for i in range(len(shapes)):
            np.testing.assert_array_equal(wa[i].asnumpy(), wb[i].asnumpy())
            np.testing.assert_array_equal(upd.states[i].asnumpy(), mb[i].asnumpy())


def test_mixed_precision_body_equals_mp_sgd_mom_update():
    rng = np.random.RandomState(6)
    w32 = rng.normal(0, 1, (5, 7)).astype(np.float32)
    body = ("mom[:] = 0.9 * m[:] - 0.01 * (g[:].astype(jnp.float32) * 0.125 "
            "+ 0.0001 * w32[:])\n"
            "w32out[:] = w32[:] + mom[:]\n"
            "wout[:] = w32out[:].astype(jnp.bfloat16)")
    with mxt.cpu():
        w, g = pnd.array(w32, dtype="bfloat16"), pnd.array(rng.normal(0, 3, w32.shape), dtype="bfloat16")
        m, master = pnd.zeros(w32.shape), pnd.array(w32)
        want = pnd.mp_sgd_mom_update(w, g, m, master, lr=0.01, momentum=0.9,
                                     wd=1e-4, rescale_grad=0.125)
        mxt.rtc.Rtc("mp", [("w", w), ("g", g), ("m", m), ("w32", master)],
                    [("wout", w), ("mom", m), ("w32out", master)], body).push(
            [w, g, m, master], [w, m, master])
    for got, exp in zip((w, m, master), want):
        assert got.dtype == exp.dtype
        assert torch.equal(got._data, exp._data)


# -- the translator ---------------------------------------------------------

F32 = "float32"


def _prog(body, ins=(("x", (4, 3), F32), ("y", (4, 3), F32)),
          outs=(("o", (4, 3), F32),)):
    return cg.analyze("t", list(ins), list(outs), body)


REJECTED = [
    ("o[:] = x[0:2] * 2.0", "whole"),
    ("o[:] = x[1] * 2.0", "whole"),
    ("o[:] = x[:].sum()", "function outside"),
    ("o[:] = jnp.dot(x[:], y[:])", "function outside"),
    ("o[:] = jnp.sum(x[:])", "function outside"),
    ("o[:] = np.exp(x[:])", "function outside"),
    ("for i in range(3):\n    o[:] = x[:]", "statements are assignments"),
    ("if True:\n    o[:] = x[:]", "statements are assignments"),
    ("o[:] = x[:] if 1 else y[:]", "outside the compiled subset"),
    ("o[:] += x[:]", "statements are assignments"),
    ("print(x)", "statements are assignments"),
    ("o[:] = 2.0", "Invalid shape"),
    ("o[:] = x[:] > y[:]", "Invalid dtype"),
    ("x[:] = y[:]", "only output Refs"),
    ("o[:] = x[:] < y[:] < 1.0", "one comparison"),
    ("o[:] = jnp.exp(1.0) + x[:]", "literals only"),
    ("o[:] = (x[:] > 0) * (y[:] > 0)", "bool"),
    ("o[:] = z", "unknown name"),
    ("jnp = x[:]\no[:] = x[:]", "Ref or a module"),
    ("o[:] = x[:] * True", "literals are numbers"),
    ("o[:] = x[:] * 2 ** 40", "outside int32"),
    ("o[:] = x[:] @ y[:]", "outside the compiled subset"),
    ("o[:] = jnp.where(x[:] > 0, x[:])", "takes 3"),
    ("o[:] = x[:].astype(jnp.float64)", "astype takes"),
    ("o[:] = x[:].astype('float32')", "astype takes"),
    ("o[:] = jnp.exp(x=x[:])", "keyword"),
]


@pytest.mark.parametrize("body,why", REJECTED)
def test_translator_rejects(body, why):
    with pytest.raises(MXNetError, match=why) as e:
        _prog(body)
    assert cg.QUEUE_ENTRY in str(e.value) or "parse" in str(e.value)


@pytest.mark.parametrize("body,ins,outs,why", [
    ("o[:] = i[:] ** j[:]", (("i", (3,), "int32"), ("j", (3,), "int32")),
     (("o", (3,), "int32"),), "integer exponent"),
    ("o[:] = x[:] ** j[:]", (("x", (3,), F32), ("j", (3,), "int32")),
     (("o", (3,), F32),), "integer exponent"),
    ("o[:] = i[:] ** -1", (("i", (3,), "int32"),), (("o", (3,), "int32"),),
     "negative integer power"),
    ("o[:] = jax.nn.sigmoid(i[:])", (("i", (3,), "int32"),),
     (("o", (3,), F32),), "sigmoid of an integer"),
    ("o[:] = x[:]", (("x", (3,), "float64"),), (("o", (3,), F32),), "dtype"),
    ("o[:] = x[:]\np[:] = x[:]", (("x", (3,), F32),),
     (("o", (3,), F32), ("p", (2,), F32)), "share one shape"),
    ("o[:] = x[:] + y[:]", (("x", (2, 3), F32), ("y", (3, 2), F32)),
     (("o", (2, 3), F32),), "broadcast"),
    ("o[:] = v[:]", (("v", (3,), F32),), (("o", (2, 3), F32),), "Invalid shape"),
    ("o[:] = s[:]", (("s", (), F32),), (("o", (), F32),), r"x\[\.\.\.\]"),
])
def test_translator_rejects_by_type_and_shape(body, ins, outs, why):
    with pytest.raises(MXNetError, match=why):
        cg.analyze("t", list(ins), list(outs), body)


def test_queue_entry_points_at_b4():
    path, heading = cg.QUEUE_ENTRY.split(": ")
    text = (pathlib.Path(__file__).resolve().parents[1] / path).read_text()
    assert heading.startswith("B4") and heading in text


def test_loads_come_before_stores_and_once_each():
    prog = _prog("a[:] = x[:] + 1.0\nb[:] = x[:] * 2.0 + a[:]\n",
                 ins=(("x", (8,), F32),),
                 outs=(("a", (8,), F32), ("b", (8,), F32)))
    src, name = cg.emit(prog, 1, ["flat"], False)
    body = src[src.index(name):]
    loads = [i for i, line in enumerate(body.splitlines()) if "v_x =" in line]
    stores = [i for i, line in enumerate(body.splitlines()) if "out_" in line
              and "] =" in line]
    assert len(loads) == 1 and stores and loads[0] < min(stores)
    assert body.count("out_a[") == 1 and body.count("out_b[") == 1
    assert "__restrict__" in body and 'extern "C"' in src


def test_layout_strides_and_kinds():
    # (4096, 1024) + (1024,): the vector steps 0 along rows
    dims, st, kinds = cg.layout((4096, 1024), [((4096, 1024), (1024, 1)),
                                               ((1024,), (1,))])
    assert dims == [4096, 1024] and st == [[1024, 1], [0, 1]]
    assert kinds == ["flat", "strided"]
    # contiguous operands collapse to one dim; size-1 dims drop out
    dims, st, kinds = cg.layout((4, 1, 3, 5), [((4, 1, 3, 5), (15, 15, 5, 1)),
                                               ((1,), (1,))])
    assert dims == [60] and st == [[1], [0]] and kinds == ["flat", "zero"]
    # a transposed view keeps its strides
    t = torch.zeros(3, 4).t()
    dims, st, kinds = cg.layout((4, 3), [(t.shape, t.stride())])
    assert dims == [4, 3] and st == [[1, 4]] and kinds == ["strided"]
    prog = _prog("o[:] = m[:] + v[:]", ins=(("m", (4, 3), F32), ("v", (3,), F32)))
    src, _ = cg.emit(prog, 2, ["flat", "strided"], False)
    assert "c0 * (int)p.st[1][0] + c1 * (int)p.st[1][1]" in src
    assert "long long st[2][2]" in src


def test_module_key_holds_dtypes_not_sizes():
    body = "o[:] = x[:] * 2.0 + 1.0"
    srcs = {}
    for dt in ("float32", "bfloat16", "float16"):
        for shape in ((7,), (3, 5), (2, 2, 2)):
            prog = cg.analyze("k", [("x", shape, dt)], [("o", shape, dt)], body)
            dims, _, kinds = cg.layout(shape, [(shape, [math.prod(shape[i + 1:])
                                                        for i in range(len(shape))])])
            srcs.setdefault(dt, set()).add(cg.emit(prog, len(dims), kinds, False))
    assert all(len(v) == 1 for v in srcs.values())  # one module per dtype
    assert len({next(iter(v)) for v in srcs.values()}) == 3
    f32 = next(iter(srcs["float32"]))[0]
    bf16 = next(iter(srcs["bfloat16"]))[0]
    assert "rnd_bf16" not in f32[f32.index("__global__"):]
    assert "rnd_bf16(" in bf16[bf16.index("__global__"):]


def test_literals_convert_as_torch_converts():
    """A Python number meets a bf16/f16/f32 operand as torch converts it
    (double -> float -> half), in the kernel and in the plain version."""
    for v, dt in ((0.1, "bfloat16"), (0.1, "float16"), (1e39, "float32"),
                  (-3, "int32"), (2.5, "float32"), (1 / 3, "bfloat16")):
        code = cg._literal(v, dt)
        want = torch.tensor(v, dtype=getattr(torch, dt)).item()
        if dt == "int32":
            assert code == f"({want})"
        elif math.isinf(want):
            assert "0x7f800000" in code
        else:
            f32 = float.fromhex(code.split("(float)")[1].rstrip(")"))
            got = torch.tensor(f32).to(getattr(torch, dt)).item()
            assert got == want and code.startswith("rnd_") == (dt != "float32")


def test_vector_kernel_only_for_flat_and_zero_reads():
    """The module holds the vector kernel (16-byte accesses, before the
    scalar one) only where every read is flat or zero; its tail is the
    scalar loop started past the last whole vector."""
    body = "o[:] = x[:] * 2.0 + y[:]"
    prog = _prog(body, ins=(("x", (4, 3), F32), ("y", (3,), F32)))
    for kinds, vec in ((["flat", "flat"], 4), (["flat", "zero"], 4),
                       (["flat", "strided"], None)):
        assert cg.vector_width(prog, kinds) == vec
        src, name = cg.emit(prog, 1 if vec else 2, kinds, False)
        vname = cg.vector_kernel_name(name)
        assert (vname in src) == (vec is not None)
        if vec is None:
            continue
        vec_src = src[src.index(vname):src.index(name + "(")]
        assert "reinterpret_cast<const uint4*>(in_x)" in vec_src
        assert ("reinterpret_cast<const uint4*>(in_y)" in vec_src) == \
            (kinds[1] == "flat")
        assert "reinterpret_cast<uint4*>(out_o)" in vec_src
        # the tail: the scalar loop body, from the first element past the
        # vectors
        tail = vec_src[vec_src.index("for (long long i = nvec * 4 + tid;"):]
        scalar = src[src.index(name + "("):]
        loop = scalar[scalar.index("for (long long i = tid;"):]
        def body_of(text):  # the loop's statements
            return text.split("\n", 1)[1].split("\n  }\n", 1)[0]
        assert body_of(tail) == body_of(loop) and "out_o[" in body_of(loop)
    # 2-byte types only: 8 a vector; a 4-byte operand makes it 4
    bf = _prog("o[:] = x[:] * 0.5", ins=(("x", (9,), "bfloat16"),),
               outs=(("o", (9,), "bfloat16"),))
    assert cg.vector_width(bf, ["flat"]) == 8
    mixed = _prog("o[:] = x[:].astype(jnp.float32)",
                  ins=(("x", (9,), "bfloat16"),), outs=(("o", (9,), F32),))
    assert cg.vector_width(mixed, ["flat"]) == 4
    src, name = cg.emit(mixed, 1, ["flat"], False)
    assert "reinterpret_cast<const uint2*>(in_x)" in src  # 4 bf16: 8 bytes


def test_vector_alignment_choice():
    """A push takes the vector kernel only when every vector pointer sits
    on its vector's width: an address and its access bytes, in pairs."""
    assert cg.vector_aligned([0x7f0000000000, 0x7f0000000100], [16, 16])
    assert not cg.vector_aligned([0x7f0000000004, 0x7f0000000100], [16, 16])
    assert cg.vector_aligned([0x7f0000000008], [8])  # 4 bf16 of a mixed body
    assert not cg.vector_aligned([0x7f0000000002], [8])
    assert cg.vector_aligned([], [])  # nothing read in vectors
    assert cg.vector_kernel_name("rtc_0123456789abcdef") == \
        "rtcv_0123456789abcdef"


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run "
                    "`python -m pytest --noconftest -m cuda "
                    "tests/test_torch_port_rtc.py`")
    return mxt.gpu(0)


def _bits_equal(a, b):
    a, b = a.cpu(), b.cpu()
    view = torch.int32 if a.element_size() == 4 else torch.int16
    nan = (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else False
    return bool(((a.view(view) == b.view(view)) | nan).all())


CARD_BODIES = [
    ("axpy", [("x", (1000, 37), F32), ("y", (1000, 37), F32)], [("o", F32)],
     "o[:] = x[:] * 2.0 + y[:]", "bits"),
    ("bcast", [("m", (64, 33), F32), ("v", (33,), F32)], [("o", F32)],
     "o[:] = m[:] + v[:]", "bits"),
    ("trans", [("x", (300, 7), F32), ("y", (300, 7), F32)], [("o", F32)],
     "t = jnp.exp(x[:]) - jnp.tanh(y[:])\n"
     "o[:] = jnp.where(t > 1.0, jax.nn.sigmoid(t), jnp.maximum(x[:], y[:]))",
     "ulp2"),
    ("bf16", [("x", (300, 7), "bfloat16"), ("y", (300, 7), F32)],
     [("o", "bfloat16")], "o[:] = (x[:] * 0.1 + y[:].astype(jnp.bfloat16)) ** 2",
     "bits"),
    ("ints", [("x", (300, 7), "int32")], [("o", "int32")],
     "o[:] = x[:] // 7 + x[:] % -3 + x[:] // 0 + (x[:] * 2.5).astype(jnp.int32)",
     "bits"),
    ("fill", [("x", (300, 7), F32)], [("a", F32), ("b", F32)],
     "b[:] = x[:] // 0.7 + x[:] % 1.3", "bits"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CARD_BODIES)))
def test_kernel_matches_plain_on_card(card, case):
    from mxnet_tpu_torch.ops.cuda.rtc import rtc_launch
    name, ins, outs, body, tol = CARD_BODIES[case]
    rng = np.random.RandomState(case)
    shape = max((s for _, s, _ in ins), key=len)
    host = [(n, (rng.normal(0, 3, s) if dt != "int32"
                 else rng.randint(-50, 50, s)), dt) for n, s, dt in ins]
    res = {}
    for ctx in (mxt.cpu(), card):
        with ctx:
            I = [(n, pnd.array(a, dtype=dt)) for n, a, dt in host]
            O = [(n, pnd.zeros(shape, dtype=dt)) for n, dt in outs]
            before = rtc_launch.launches
            mxt.rtc.Rtc(name, I, O, body).push([a for _, a in I],
                                               [a for _, a in O])
            assert rtc_launch.launches == before + (ctx is card)
            res[ctx.device_type] = [a._data for _, a in O]
    torch.cuda.synchronize()
    for k, p in zip(res["gpu"], res["cpu"]):
        if tol == "bits":
            assert _bits_equal(k, p), name
        else:
            np.testing.assert_array_max_ulp(k.cpu().numpy(), p.numpy(), maxulp=2)


@pytest.mark.cuda
def test_launch_shape_and_aliasing_on_card(card):
    with card:
        x = pnd.array(np.arange(5000, dtype=np.float32))
        b = pnd.zeros((5000,))
        k = mxt.rtc.Rtc("alias", [("x", x)], [("a", x), ("b", b)],
                        "a[:] = x[:] + 1.0\nb[:] = x[:] * 2.0")
        k.push([x], [x, b], grid_dims=(4, 1, 1), block_dims=(128, 1, 1))
        assert x.asnumpy()[-1] == 5000.0 and b.asnumpy()[-1] == 9998.0
        with pytest.raises(MXNetError):
            k.push([x], [x, b], block_dims=(2048, 1, 1))


@pytest.mark.cuda
def test_vector_kernel_per_push_on_card(card):
    """The vector kernel at n % 4 != 0, the scalar kernel for a view one
    element into a tensor with the same layout (so the same launch plan),
    a zero (broadcast) operand, and an aliased push: all bit for bit
    equal to the plain version."""
    from mxnet_tpu_torch.ops.cuda.rtc import rtc_launch
    n = 4 * 1000 + 3
    rng = np.random.RandomState(3)
    base = torch.tensor(rng.normal(0, 2, n + 1), dtype=torch.float32)
    y = torch.tensor(rng.normal(0, 2, n), dtype=torch.float32)
    a = torch.tensor([1.5])
    body = "o[:] = x[:] * a[:] + y[:]"
    on_card = base.to("cuda")
    # aligned, then one element in: views of one card tensor
    cases = [(base[:n], on_card[:n], True), (base[1:], on_card[1:], False)]
    k = None
    for x, x_card, vector in cases:
        with card:
            Y, A = (pnd.NDArray(t.to("cuda")) for t in (y, a))
            X = pnd.NDArray(x_card)
            O = pnd.zeros((n,))
        if k is None:
            k = mxt.rtc.Rtc("axpb", [("x", X), ("a", A), ("y", Y)],
                            [("o", O)], body)
        before = (rtc_launch.launches, rtc_launch.vector_launches)
        k.push([X, A, Y], [O])
        torch.cuda.synchronize()
        assert (rtc_launch.launches, rtc_launch.vector_launches) == (
            before[0] + 1, before[1] + vector)
        want = k._run_plain([x, a, y], torch.device("cpu"))[0]
        assert _bits_equal(O._data, want)
    with card:  # aliased: a and b read x as it was
        x = pnd.array(np.arange(n, dtype=np.float32))
        b = pnd.zeros((n,))
        k2 = mxt.rtc.Rtc("alias", [("x", x)], [("a", x), ("b", b)],
                         "a[:] = x[:] + 1.0\nb[:] = x[:] * 2.0")
        before = rtc_launch.vector_launches
        k2.push([x], [x, b])
        assert rtc_launch.vector_launches == before + 1
        assert x.asnumpy()[-1] == n and b.asnumpy()[-1] == 2 * (n - 1)

"""Parity of the PyTorch port's CNN layer ops with the JAX package.

Convolution, Pooling, BatchNorm, LRN, Activation and Dropout
(``mxnet_tpu_torch/ops/nn_ops.py``) against ``mxnet_tpu/ops/nn_ops.py``:
the same numpy inputs, made from a seed, go through both ops' ``fn``
with the same attributes, forward and gradients (``jax.vjp`` against
``torch.autograd``) under the same seeded cotangent. The cases cover
1-, 2- and 3-D convolutions in channel-first and channel-last layouts
with groups, dilation and stride; avg pooling at padded edges under both
conventions and max pooling over tied windows; BatchNorm in train and
eval mode, with and without ``fix_gamma`` and ``use_global_stats``, in
fp32 and bf16, with its moving updates; LRN and the five activations.
Every JAX reference is computed once, in one jit, with x64 off as users
run the JAX package. Dropout's mask is random in both packages: its
statistics are held, not its bits. Tests marked ``cuda`` run each case
on the card against the port's CPU path and skip without one
(``python -m pytest --noconftest -m cuda tests/test_torch_port_nn.py``).
"""
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn_ops as port_nn

# fp32 on both sides: summation order differs only (measured <= 4.7e-7 of
# each output's largest magnitude); held at 1e-5 of it
FP32_REL = 1e-5
# bf16: the JAX package rounds BatchNorm's normalisation at each of its
# three steps and sums pooling windows in bf16, the port rounds once
# after fp32 arithmetic; measured up to 1.6 bf16 ulps at an output's
# largest magnitude; the bound is 4
BF16_ULPS = 4
# the ops of this file, with the nn ops ported before (the op-table count:
# 196 ported names before these six, and the four of
# tests/test_torch_port_autograd.py: Deconvolution, InstanceNorm,
# LeakyReLU and log_softmax)
NN_OPS = ("Activation", "BatchNorm", "Convolution", "Dropout",
          "FullyConnected", "LRN", "Pooling", "SoftmaxOutput", "softmax")
PORTED_OPS = 206


def _conv(layout, kernel, nf, **kw):
    return {"kernel": kernel, "num_filter": nf, "layout": layout, **kw}


def _bn(**kw):
    return {"eps": 2e-5, "momentum": 0.9, **kw}


# id -> (op, [(shape, kind, differentiable)], attrs, is_train, dtype)
CASES = {
    # Convolution: data, weight[, bias]
    "conv_nchw_s2p1_bias": ("Convolution", [((2, 4, 9, 9), "normal", True),
                                            ((6, 4, 3, 3), "w", True),
                                            ((6,), "normal", True)],
                            _conv("NCHW", (3, 3), 6, stride=(2, 2),
                                  pad=(1, 1)), False, "float32"),
    "conv_nhwc_group2_dilate2": ("Convolution",
                                 [((2, 9, 9, 4), "normal", True),
                                  ((6, 3, 3, 2), "w", True)],
                                 _conv("NHWC", (3, 3), 6, num_group=2,
                                       dilate=(2, 2), no_bias=True),
                                 False, "float32"),
    "conv_nhwc_depthwise_s2": ("Convolution",
                               [((2, 8, 8, 4), "normal", True),
                                ((4, 3, 3, 1), "w", True),
                                ((4,), "normal", True)],
                               _conv("NHWC", (3, 3), 4, num_group=4,
                                     stride=(2, 2), pad=(1, 1)),
                               False, "float32"),
    "conv_ncw_1d": ("Convolution", [((2, 3, 11), "normal", True),
                                    ((5, 3, 3), "w", True),
                                    ((5,), "normal", True)],
                    _conv(None, (3,), 5, stride=(2,), pad=(1,),
                          dilate=(2,)), False, "float32"),
    "conv_nwc_1d_group": ("Convolution", [((2, 10, 4), "normal", True),
                                          ((6, 2, 2), "w", True)],
                          _conv("NWC", (2,), 6, num_group=2, no_bias=True),
                          False, "float32"),
    "conv_ncdhw_3d": ("Convolution", [((1, 2, 5, 6, 5), "normal", True),
                                      ((3, 2, 3, 3, 3), "w", True),
                                      ((3,), "normal", True)],
                      _conv("NCDHW", (3, 3, 3), 3, pad=(1, 1, 1)),
                      False, "float32"),
    "conv_ndhwc_3d_group": ("Convolution",
                            [((1, 5, 4, 6, 4), "normal", True),
                             ((4, 2, 3, 2, 2), "w", True)],
                            _conv("NDHWC", (2, 3, 2), 4, num_group=2,
                                  stride=(1, 2, 1), no_bias=True),
                            False, "float32"),
    "conv_nhwc_stem_bf16": ("Convolution", [((2, 12, 12, 3), "normal", True),
                                            ((8, 7, 7, 3), "w", True)],
                            _conv("NHWC", (7, 7), 8, stride=(2, 2),
                                  pad=(3, 3), no_bias=True),
                            False, "bfloat16"),
    # Pooling
    "maxpool_nhwc_ties": ("Pooling", [((2, 9, 9, 3), "ties", True)],
                          {"kernel": (3, 3), "stride": (2, 2),
                           "pad": (1, 1), "pool_type": "max",
                           "layout": "NHWC"}, False, "float32"),
    "maxpool_nchw_full_ties": ("Pooling", [((2, 3, 8, 8), "ties", True)],
                               {"kernel": (3, 3), "stride": (2, 2),
                                "pool_type": "max",
                                "pooling_convention": "full"},
                               False, "float32"),
    "avgpool_nchw_pad_valid": ("Pooling", [((2, 3, 7, 7), "normal", True)],
                               {"kernel": (3, 3), "stride": (2, 2),
                                "pad": (1, 1), "pool_type": "avg"},
                               False, "float32"),
    "avgpool_nhwc_pad_valid": ("Pooling", [((2, 12, 12, 64), "normal", True)],
                               {"kernel": (3, 3), "stride": (2, 2),
                                "pad": (1, 1), "pool_type": "avg",
                                "layout": "NHWC"}, False, "float32"),
    "avgpool_nhwc_pad_full": ("Pooling", [((2, 8, 8, 3), "normal", True)],
                              {"kernel": (3, 3), "stride": (2, 2),
                               "pad": (1, 1), "pool_type": "avg",
                               "pooling_convention": "full",
                               "layout": "NHWC"}, False, "float32"),
    "avgpool_nchw_full_last_window_in_pad": (
        "Pooling", [((1, 2, 5, 5), "normal", True)],
        {"kernel": (2, 2), "stride": (2, 2), "pad": (1, 1),
         "pool_type": "avg", "pooling_convention": "full"},
        False, "float32"),
    "avgpool_nchw_pad_over_half": ("Pooling", [((1, 2, 6, 6), "normal", True)],
                                   {"kernel": (3, 3), "stride": (1, 1),
                                    "pad": (2, 2), "pool_type": "avg"},
                                   False, "float32"),
    "sumpool_nchw_full": ("Pooling", [((2, 3, 7, 7), "normal", True)],
                          {"kernel": (2, 2), "stride": (2, 2),
                           "pool_type": "sum",
                           "pooling_convention": "full"}, False, "float32"),
    "avgpool_ncw_1d": ("Pooling", [((2, 3, 9), "normal", True)],
                       {"kernel": (3,), "stride": (2,), "pad": (1,),
                        "pool_type": "avg"}, False, "float32"),
    "maxpool_ndhwc_3d": ("Pooling", [((1, 4, 5, 4, 2), "normal", True)],
                         {"kernel": (2, 2, 2), "stride": (2, 1, 2),
                          "pool_type": "max", "layout": "NDHWC"},
                         False, "float32"),
    "globalavg_nhwc": ("Pooling", [((2, 7, 7, 4), "normal", True)],
                       {"kernel": (7, 7), "global_pool": True,
                        "pool_type": "avg", "layout": "NHWC"},
                       False, "float32"),
    "globalmax_nchw_ties": ("Pooling", [((2, 3, 5, 5), "ties", True)],
                            {"kernel": (1, 1), "global_pool": True,
                             "pool_type": "max"}, False, "float32"),
    "avgpool_nhwc_bf16": ("Pooling", [((2, 9, 9, 4), "normal", True)],
                          {"kernel": (3, 3), "stride": (2, 2),
                           "pad": (1, 1), "pool_type": "avg",
                           "layout": "NHWC"}, False, "bfloat16"),
    # BatchNorm: data, gamma, beta, moving_mean, moving_var
    "bn_train_nchw": ("BatchNorm", None, _bn(fix_gamma=False, axis=1),
                      True, "float32"),
    "bn_train_nhwc_fix_gamma": ("BatchNorm", None,
                                _bn(fix_gamma=True, axis=3), True, "float32"),
    "bn_train_nhwc_bf16": ("BatchNorm", None, _bn(fix_gamma=False, axis=-1),
                           True, "bfloat16"),
    "bn_eval_nhwc": ("BatchNorm", None, _bn(fix_gamma=False, axis=3),
                     False, "float32"),
    "bn_eval_nchw_bf16_defaults": ("BatchNorm", None, {}, False, "bfloat16"),
    "bn_train_use_global_stats": ("BatchNorm", None,
                                  _bn(fix_gamma=False, axis=3,
                                      use_global_stats=True),
                                  True, "float32"),
    "bn_train_axis2_output_mean_var": ("BatchNorm", None,
                                       _bn(fix_gamma=False, axis=2,
                                           output_mean_var=True, eps=1e-3,
                                           momentum=0.7),
                                       True, "float32"),
    "bn_train_2d_defaults": ("BatchNorm", None, {}, True, "float32"),
    # LRN
    "lrn_nchw": ("LRN", [((2, 7, 4, 4), "normal", True)],
                 {"nsize": 5, "alpha": 1e-2, "beta": 0.75, "knorm": 2.0},
                 False, "float32"),
    "lrn_nhwc_axis": ("LRN", [((2, 4, 4, 6), "normal", True)],
                      {"nsize": 3, "alpha": 0.1, "beta": 0.5, "knorm": 1.0,
                       "axis": -1}, False, "float32"),
}
for _act in ("relu", "sigmoid", "tanh", "softrelu", "softsign"):
    CASES[f"act_{_act}"] = ("Activation", [((3, 17), "normal", True)],
                            {"act_type": _act}, False, "float32")
CASES["act_relu_bf16"] = ("Activation", [((3, 17), "normal", True)],
                          {"act_type": "relu"}, False, "bfloat16")

_BN_SHAPES = {"bn_train_nchw": (4, 3, 5, 5), "bn_train_nhwc_fix_gamma":
              (4, 5, 5, 3), "bn_train_nhwc_bf16": (4, 5, 5, 6),
              "bn_eval_nhwc": (2, 3, 3, 4), "bn_eval_nchw_bf16_defaults":
              (2, 4, 3, 3), "bn_train_use_global_stats": (2, 3, 3, 4),
              "bn_train_axis2_output_mean_var": (2, 3, 5, 4),
              "bn_train_2d_defaults": (8, 5)}
# the graph's dropout case: kept share and scale over many elements
DROP_SHAPE, DROP_P = (512, 512), 0.3


def _bn_axis_len(case_id):
    shape = _BN_SHAPES[case_id]
    axis = CASES[case_id][2].get("axis", 1) % len(shape)
    return shape, shape[axis]


def _case_arrays(case_id):
    """The case's inputs and cotangent, from its own seed: (inputs,
    differentiable flags, cotangent shape is the first output's)."""
    op, spec, attrs, _, _ = CASES[case_id]
    rng = np.random.RandomState(sorted(CASES).index(case_id))
    if op == "BatchNorm":
        shape, c = _bn_axis_len(case_id)
        # a nonzero mean per channel, so centering matters
        data = (rng.normal(0, 1.5, shape)
                + rng.normal(0, 2, c).reshape(
                    [c if s == c and i == (attrs.get("axis", 1) % len(shape))
                     else 1 for i, s in enumerate(shape)]))
        arrays = [data, rng.uniform(0.5, 1.5, c), rng.normal(0, 0.5, c),
                  rng.normal(0, 0.5, c), rng.uniform(0.5, 2.0, c)]
        diff = [True, True, True, False, False]
        return [a.astype(np.float32) for a in arrays], diff
    arrays, diff = [], []
    for shape, kind, d in spec:
        if kind == "ties":
            # small integers after a ReLU: windows full of zeros and of
            # equal maxima, as after ResNet's stem
            a = np.maximum(rng.randint(-2, 3, shape), 0).astype(np.float32)
        elif kind == "w":
            a = rng.normal(0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        else:
            a = rng.normal(0, 1, shape)
        arrays.append(a.astype(np.float32))
        diff.append(d)
    return arrays, diff


def _cotangent(case_id, shape):
    rng = np.random.RandomState(1000 + sorted(CASES).index(case_id))
    return rng.normal(0, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.registry import OP_TABLE
    return types.SimpleNamespace(jax=jax, jnp=jnp, table=OP_TABLE)


@pytest.fixture(scope="module")
def jax_ref(ref):
    """Every case's JAX outputs and input gradients, and the dropout
    case's output and gradient, from one jit."""
    jax, jnp = ref.jax, ref.jnp
    arrays = {cid: _case_arrays(cid)[0] for cid in CASES}
    shapes = {}
    with jax.enable_x64(False):
        for cid, (op, _, attrs, train, dtype) in CASES.items():
            parsed = ref.table[op].parse_attrs(attrs)
            if ref.table[op].needs_is_train:
                parsed["_is_train"] = train
            ins = [jax.ShapeDtypeStruct(
                a.shape, dtype if i == 0 or op != "BatchNorm" else a.dtype)
                for i, a in enumerate(arrays[cid])]
            out = jax.eval_shape(
                lambda *v, fn=ref.table[op].fn, kw=parsed: fn(*v, **kw),
                *ins)
            out = out if isinstance(out, tuple) else (out,)
            shapes[cid] = out[0].shape
        cots = {cid: _cotangent(cid, shapes[cid]) for cid in CASES}

        def run(arrays, cots):
            res = {}
            for cid, (op, _, attrs, train, dtype) in CASES.items():
                opdef = ref.table[op]
                parsed = opdef.parse_attrs(attrs)
                if opdef.needs_is_train:
                    parsed["_is_train"] = train
                _, diff = _case_arrays(cid)
                ins = [jnp.asarray(a).astype(dtype)
                       if i == 0 or op != "BatchNorm" else a
                       for i, a in enumerate(arrays[cid])]
                idx = [i for i, d in enumerate(diff) if d]

                def f(*d_ins, ins=ins, idx=idx, opdef=opdef, parsed=parsed):
                    full = list(ins)
                    for i, v in zip(idx, d_ins):
                        full[i] = v
                    out = opdef.fn(*full, **parsed)
                    out = out if isinstance(out, tuple) else (out,)
                    return out[0], out[1:]

                (out, extra), vjp = jax.vjp(f, *[ins[i] for i in idx])
                zeros = jax.tree.map(jnp.zeros_like, extra)
                grads = vjp((cots[cid].astype(out.dtype), zeros))
                res[cid] = ([out.astype(jnp.float32)]
                            + [e.astype(jnp.float32) for e in extra],
                            [g.astype(jnp.float32) for g in grads])
            drop = ref.table["Dropout"]
            x = jnp.ones(DROP_SHAPE, jnp.float32)
            y, dvjp = jax.vjp(lambda v: drop.fn(
                jax.random.PRNGKey(0), v, p=DROP_P, _is_train=True), x)
            res["dropout"] = ([y], list(dvjp(jnp.ones_like(y))))
            return res

        out = jax.jit(run)(arrays, cots)
        return {k: jax.tree.map(np.asarray, v) for k, v in out.items()}


def _port_run(case_id, device="cpu"):
    """The port's outputs and input gradients of a case on ``device``."""
    op, _, attrs, train, dtype = CASES[case_id]
    opdef = mxt.OP_TABLE[op]
    parsed = opdef.parse_attrs(attrs)
    if opdef.needs_is_train:
        parsed["_is_train"] = train
    arrays, diff = _case_arrays(case_id)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ins = [torch.tensor(a, device=device).to(
        td if i == 0 or op != "BatchNorm" else torch.float32)
        for i, a in enumerate(arrays)]
    leaves = [t.requires_grad_() if d else t for t, d in zip(ins, diff)]
    out = opdef.fn(*leaves, **parsed)
    out = out if isinstance(out, tuple) else (out,)
    cot = torch.tensor(_cotangent(case_id, tuple(out[0].shape)),
                       device=device).to(out[0].dtype)
    wrt = [t for t, d in zip(leaves, diff) if d]
    grads = torch.autograd.grad(out[0], wrt, cot, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, wrt)]
    return ([o.detach().float().cpu().numpy() for o in out],
            [g.float().cpu().numpy() for g in grads])


def _ulp_tol(want, ulps):
    mag = float(np.abs(want).max())
    return ulps * 2.0 ** (np.floor(np.log2(mag)) - 7) if mag else 0.0


def _assert_close(got, want, dtype, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    mag = float(np.abs(want).max()) if want.size else 0.0
    tol = (FP32_REL * max(mag, 1e-6) if dtype == "float32"
           else _ulp_tol(want, BF16_ULPS))
    assert err <= tol, f"{what}: max |err| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("case_id", sorted(CASES))
def test_op_matches_jax(jax_ref, case_id):
    """Forward outputs (BatchNorm's moving updates included) and every
    input gradient against the JAX op's, at the stated tolerance."""
    dtype = CASES[case_id][4]
    outs_j, grads_j = jax_ref[case_id]
    outs_t, grads_t = _port_run(case_id)
    assert len(outs_t) == len(outs_j) and len(grads_t) == len(grads_j)
    for i, (got, want) in enumerate(zip(outs_t, outs_j)):
        # the moving statistics are fp32 in both packages
        _assert_close(got, want, dtype if i == 0 else "float32",
                      f"{case_id} output {i}")
    for i, (got, want) in enumerate(zip(grads_t, grads_j)):
        _assert_close(got, want, dtype, f"{case_id} gradient {i}")


@pytest.mark.parametrize("case_id", [c for c in sorted(CASES)
                                     if "ties" in c])
def test_max_pool_ties_pick_the_jax_element(jax_ref, case_id):
    """Over windows of equal maxima the gradient lands on the same element
    as the JAX op's, bit for bit: the first in row-major window order."""
    _, grads_j = jax_ref[case_id]
    _, grads_t = _port_run(case_id)
    arrays, _ = _case_arrays(case_id)
    assert (arrays[0] == 0).mean() > 0.3  # the windows do tie
    np.testing.assert_array_equal(grads_t[0], grads_j[0])


def test_batch_norm_moving_update_convention(jax_ref):
    """The moving statistics move by m*old + (1-m)*batch over the biased
    batch variance, and the JAX op agrees."""
    case_id = "bn_train_nchw"
    arrays, _ = _case_arrays(case_id)
    data, mm, mv = arrays[0], arrays[3], arrays[4]
    mean = data.mean(axis=(0, 2, 3), dtype=np.float64)
    var = data.var(axis=(0, 2, 3), dtype=np.float64)  # biased
    outs_t, _ = _port_run(case_id)
    np.testing.assert_allclose(outs_t[1], 0.9 * mm + 0.1 * mean, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(outs_t[2], 0.9 * mv + 0.1 * var, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(jax_ref[case_id][0][2], outs_t[2], rtol=1e-6)


def test_batch_norm_fix_gamma_gradient_is_zero_in_the_executor():
    """With fix_gamma (the default) gamma reads as ones and its gradient
    is written as exactly 0, not left from an earlier backward; the
    moving statistics are written back in training only."""
    net = mxt.sym.BatchNorm(mxt.sym.var("data"), name="bn", axis=3)
    exe = net.simple_bind(ctx=mxt.cpu(), data=(3, 2, 2, 4))
    rng = np.random.RandomState(0)
    exe.arg_dict["data"][:] = rng.normal(1, 2, (3, 2, 2, 4))
    exe.arg_dict["bn_gamma"][:] = 3.0
    exe.aux_dict["bn_moving_var"][:] = 1.0
    exe.grad_dict["bn_gamma"][:] = 7.0
    exe.forward(is_train=False)
    assert float(exe.aux_dict["bn_moving_mean"].asnumpy().max()) == 0.0
    exe.forward(is_train=True)
    exe.backward(mxt.nd.array(rng.normal(0, 1, (3, 2, 2, 4)), ctx=mxt.cpu()))
    assert np.array_equal(exe.grad_dict["bn_gamma"].asnumpy(), np.zeros(4))
    assert np.abs(exe.grad_dict["bn_beta"].asnumpy()).max() > 0
    np.testing.assert_allclose(
        exe.aux_dict["bn_moving_mean"].asnumpy(),
        0.1 * exe.arg_dict["data"].asnumpy().mean(axis=(0, 1, 2)),
        rtol=1e-5)


def test_dropout_statistics_match_jax(jax_ref):
    """The kept share (within 5 binomial sigmas of 1 - p in both
    packages), the kept values' scale 1/(1 - p) and the gradient's mask
    equal to the output's; the identity in eval, for p = 0, and a draw in
    eval with mode='always'."""
    y_j, g_j = jax_ref["dropout"][0][0], jax_ref["dropout"][1][0]
    keep = 1.0 - DROP_P
    n = np.prod(DROP_SHAPE)
    sigma = np.sqrt(keep * DROP_P / n)
    mxt.random.seed(3)
    gen = mxt.random.generator("cpu")
    x = torch.ones(DROP_SHAPE, requires_grad=True)
    y_t = port_nn._dropout(gen, x, p=DROP_P, _is_train=True)
    (g_t,) = torch.autograd.grad(y_t, x, torch.ones_like(y_t))
    y_t, g_t = y_t.detach().numpy(), g_t.numpy()
    for y, g in ((y_j, g_j), (y_t, g_t)):
        kept = y != 0
        assert abs(kept.mean() - keep) < 5 * sigma
        np.testing.assert_allclose(y[kept], 1 / keep, rtol=1e-6)
        np.testing.assert_array_equal(g, y)
    assert abs((y_t != 0).mean() - (y_j != 0).mean()) < 10 * sigma
    for kw in ({"_is_train": False}, {"_is_train": True, "p": 0.0}):
        assert port_nn._dropout(gen, x, **{"p": DROP_P, **kw}) is x
    always = port_nn._dropout(None, x.detach(), p=DROP_P, mode="always")
    assert 0 < (always == 0).float().mean() < 1


def test_dropout_in_module_draws_from_the_seeded_generator():
    """The symbol path draws dropout from the device's generator: the
    same seed gives the same mask, and eval is the identity."""
    net = mxt.sym.Dropout(mxt.sym.var("data"), p=0.5, name="drop")
    outs = []
    for _ in range(2):
        mxt.random.seed(11)
        exe = net.simple_bind(ctx=mxt.cpu(), data=(64, 64))
        exe.arg_dict["data"][:] = 1.0
        outs.append(exe.forward(is_train=True)[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert set(np.unique(outs[0])) == {0.0, 2.0}
    assert np.array_equal(exe.forward(is_train=False)[0].asnumpy(),
                          np.ones((64, 64), np.float32))


@pytest.mark.parametrize("op,attrs", [
    ("Activation", {"act_type": "gelu"}),
    ("Pooling", {"kernel": (2, 2), "pool_type": "lp"}),
    ("Convolution", {"kernel": (3, 3), "num_filter": 2, "layout": "HWCN"}),
])
def test_unknown_attribute_values_raise(op, attrs):
    opdef = mxt.OP_TABLE[op]
    x = torch.ones(1, 4, 4, 2)
    ins = [x, torch.ones(2, 2, 3, 3), torch.ones(2)] if op == "Convolution" \
        else [x]
    with pytest.raises(MXNetError):
        opdef.fn(*ins, **opdef.parse_attrs(attrs))


def test_channel_last_convolution_makes_no_layout_copy():
    """NHWC data and OHWI weights reach the convolution as channels_last
    views of the same memory, and its output returns as an NHWC view."""
    x = torch.randn(2, 6, 6, 4)
    w = torch.randn(8, 3, 3, 4)
    xv, wv = port_nn._to_channel_first(x), port_nn._to_channel_first(w)
    assert xv.data_ptr() == x.data_ptr() and wv.data_ptr() == w.data_ptr()
    assert xv.is_contiguous(memory_format=torch.channels_last)
    assert wv.is_contiguous(memory_format=torch.channels_last)
    out = mxt.OP_TABLE["Convolution"].fn(
        x, w, kernel=(3, 3), num_filter=8, pad=(1, 1), no_bias=True,
        layout="NHWC")
    assert out.shape == (2, 6, 6, 8) and out.is_contiguous()


def test_op_table_matches_jax(ref):
    """The nn ops' records against the JAX table's: inputs, attributes
    and their defaults, auxiliary inputs and updates, train and rng flags,
    output counts, parameter shapes; and the port's op count."""
    for name in NN_OPS:
        j, p = ref.table[name], mxt.OP_TABLE[name]
        assert p.input_names == j.input_names, name
        assert p.num_inputs == j.num_inputs, name
        assert p.aux_inputs == j.aux_inputs, name
        assert p.aux_update == j.aux_update, name
        assert p.needs_is_train == j.needs_is_train, name
        assert bool(p.needs_rng) == bool(j.needs_rng), name
        assert sorted(p.attr_spec.fields) == sorted(j.attr_spec.fields), name
        for field, (typ, default) in j.attr_spec.fields.items():
            ptyp, pdefault = p.attr_spec.fields[field]
            assert ptyp == typ, (name, field)
            if default is not j.attr_spec._REQUIRED:
                assert pdefault == default, (name, field)
        for attrs in ({}, {"output_mean_var": True}):
            assert p.num_outputs(attrs) == j.num_outputs(attrs), name
    for name, attrs, shapes in (
            ("Convolution", {"kernel": (3, 3), "num_filter": 8,
                             "layout": "NHWC", "num_group": 2},
             [(2, 9, 9, 4), None]),
            ("Convolution", {"kernel": (3,), "num_filter": 8},
             [(2, 4, 9), None, None]),
            ("BatchNorm", {"axis": -1}, [(2, 3, 3, 5)] + [None] * 4)):
        assert (mxt.OP_TABLE[name].param_shapes(attrs, shapes)
                == ref.table[name].param_shapes(attrs, shapes)), name
    assert len(mxt.OP_TABLE) == PORTED_OPS


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_port_nn.py`")
    mxt.gpu(0).torch_device()  # TF32 off, as the port runs
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case_id", sorted(CASES))
def test_op_on_card_matches_cpu(card, case_id):
    """Each case through cuDNN and torch's CUDA kernels against the port's
    CPU path on the same inputs, at the CPU tests' tolerance; max
    pooling's tied windows send the gradient to the same elements. The padded
    channels_last avg pools pin the explicit padding that keeps torch's
    CUDA avg-pool backward off its padded channels_last path."""
    dtype = CASES[case_id][4]
    outs_c, grads_c = _port_run(case_id)
    outs_g, grads_g = _port_run(case_id, device=card)
    for i, (got, want) in enumerate(zip(outs_g, outs_c, strict=True)):
        _assert_close(got, want, dtype if i == 0 else "float32",
                      f"{case_id} output {i}")
    for i, (got, want) in enumerate(zip(grads_g, grads_c, strict=True)):
        if "ties" in case_id:  # fp32 cases: no sum rounds to exactly 0
            np.testing.assert_array_equal(got != 0, want != 0)
        _assert_close(got, want, dtype, f"{case_id} gradient {i}")

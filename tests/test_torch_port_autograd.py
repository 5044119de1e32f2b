"""Parity of the PyTorch port's imperative autograd with the JAX package.

The cases of ``tests/test_autograd.py`` (simple, chain and shared input,
several variables, head gradients, write/add/null, detach and
``BlockGrad``, scopes, through nn ops, ``SoftmaxOutput``, ``grad``,
``mark_variables``, ``Function``), a second ``backward()`` on the same
heads, indexing inside ``record()`` and the ops' train mode run through
``mxnet_tpu`` and ``mxnet_tpu_torch`` on the CPU from the same numpy
inputs, and their gradients are held to each other. The four nn ops this
slice adds (``log_softmax``, ``LeakyReLU``, ``InstanceNorm``,
``Deconvolution``) are held to the JAX ops forward and backward over their
attributes, every JAX reference from one jit with x64 off, as users run
the JAX package; rrelu's slopes are random in both packages, so their
range is held, not their bits.
"""
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError

# fp32 on both sides, only summation order differs: held at 1e-5 of each
# result's largest magnitude
REL = 1e-5


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    import mxnet_tpu
    return types.SimpleNamespace(jax=jax, jnp=jnp, mx=mxnet_tpu)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = REL * max(float(np.abs(want).max()) if want.size else 0.0, 1e-6)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, f"{what}: max |err| {err:.3g} > {tol:.3g}"


# -- autograd cases: each takes a package and returns named numpy results


def _simple(mx):
    x = mx.nd.array(np.array([1.0, 2.0, 3.0]))
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()
    return {"x.grad": x.grad.asnumpy()}


def _chain_and_shared_input(mx):
    x = mx.nd.array(np.array([2.0]))
    x.attach_grad()
    with mx.autograd.record():
        y = x * x + x
    y.backward()
    return {"x.grad": x.grad.asnumpy()}


def _multi_variable(mx):
    a = mx.nd.array(np.array([1.0, 2.0]))
    b = mx.nd.array(np.array([3.0, 4.0]))
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        y = (a * b).sum()
    y.backward()
    return {"a.grad": a.grad.asnumpy(), "b.grad": b.grad.asnumpy()}


def _head_grad(mx):
    x = mx.nd.array(np.array([1.0, 2.0]))
    x.attach_grad()
    with mx.autograd.record():
        y = 3 * x
    y.backward(mx.nd.array(np.array([10.0, 100.0])))
    return {"x.grad": x.grad.asnumpy()}


def _grad_req_modes(mx):
    x = mx.nd.array(np.array([1.0]))
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with mx.autograd.record():
            y = 2 * x
        y.backward()
    z = mx.nd.array(np.array([1.0]))
    z.attach_grad(grad_req="null")
    with mx.autograd.record():
        y = 2 * z
    y.backward()
    return {"add": x.grad.asnumpy(), "null": z.grad.asnumpy()}


def _detach(mx):
    x = mx.nd.array(np.array([3.0]))
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
        z = y.detach() * x
    z.backward()
    return {"x.grad": x.grad.asnumpy()}


def _block_grad(mx):
    x = mx.nd.array(np.array([3.0]))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.BlockGrad(x * x) + x
    y.backward()
    return {"x.grad": x.grad.asnumpy()}


def _through_nn_ops(mx):
    rng = np.random.RandomState(3)
    x = mx.nd.array(rng.randn(4, 10).astype(np.float32))
    w = mx.nd.array(rng.randn(3, 10).astype(np.float32) * 0.1)
    b = mx.nd.array(rng.randn(3).astype(np.float32))
    for v in (x, w, b):
        v.attach_grad()
    with mx.autograd.record():
        out = mx.nd.FullyConnected(x, w, b, num_hidden=3)
        loss = (out * out).mean()
    loss.backward()
    return {"x": x.grad.asnumpy(), "w": w.grad.asnumpy(),
            "b": b.grad.asnumpy(), "loss": loss.asnumpy()}


def _softmax_output(mx):
    rng = np.random.RandomState(4)
    x = mx.nd.array(rng.randn(4, 5).astype(np.float32))
    label = mx.nd.array(np.array([0, 1, 2, 3], dtype=np.float32))
    x.attach_grad()
    with mx.autograd.record():
        out = mx.nd.SoftmaxOutput(x, label)
    out.backward()
    return {"out": out.asnumpy(), "x.grad": x.grad.asnumpy()}


def _grad_function(mx):
    x = mx.nd.array(np.array([2.0]))
    with mx.autograd.record():
        y = x * x * x
    g = mx.autograd.grad(y, x)
    return {"grad": g.asnumpy()}


def _mark_variables(mx):
    x = mx.nd.array(np.array([1.0, 2.0]))
    g = mx.nd.zeros((2,))
    mx.autograd.mark_variables([x], [g])
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()
    return {"g": g.asnumpy()}


def _function(mx):
    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + mx.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    x = mx.nd.array(np.array([0.5, -1.0, 2.0]))
    x.attach_grad()
    with mx.autograd.record():
        y = Sigmoid()(x) * 3
    y.backward()
    return {"y": y.asnumpy(), "x.grad": x.grad.asnumpy(),
            "unrecorded": Sigmoid()(x).asnumpy()}


def _second_backward(mx):
    """A second backward on the same heads: the JAX package's tape lives
    as long as the heads, so it gives the same gradient again (written,
    or added to the first under grad_req='add')."""
    x = mx.nd.array(np.array([1.0, -2.0, 3.0]))
    w = mx.nd.array(np.array([0.5, 0.25, -1.0]))
    x.attach_grad()
    w.attach_grad(grad_req="add")
    with mx.autograd.record():
        y = (mx.nd.tanh(x * w) * x).sum()
    y.backward()
    first = (x.grad.asnumpy().copy(), w.grad.asnumpy().copy())
    y.backward()
    return {"x first": first[0], "x second": x.grad.asnumpy(),
            "w first": first[1], "w second": w.grad.asnumpy()}


def _indexing(mx):
    x = mx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4) / 7)
    x.attach_grad()
    with mx.autograd.record():
        y = (x[1:3] * x[1:3]).sum() + x[0, 1] * 5
    y.backward()
    return {"x.grad": x.grad.asnumpy()}


def _train_mode(mx):
    """Recording is train mode unless told otherwise: BatchNorm reads the
    batch's statistics and moves its moving ones; predict mode reads the
    moving ones; record(train_mode=False) too."""
    rng = np.random.RandomState(5)
    x = mx.nd.array(rng.randn(4, 3).astype(np.float32) + 2)
    gamma, beta = mx.nd.ones((3,)), mx.nd.zeros((3,))
    mean, var = mx.nd.zeros((3,)), mx.nd.ones((3,))
    x.attach_grad()
    out = {}
    with mx.autograd.record():
        y = mx.nd.BatchNorm(x, gamma, beta, mean, var, fix_gamma=False)
    y.backward(mx.nd.array(rng.randn(4, 3).astype(np.float32)))
    out["train y"], out["moved mean"] = y.asnumpy(), mean.asnumpy()
    out["x.grad"] = x.grad.asnumpy()
    with mx.autograd.record(train_mode=False):
        y = mx.nd.BatchNorm(x, gamma, beta, mean, var, fix_gamma=False)
    out["record eval y"] = y.asnumpy()
    out["eval y"] = mx.nd.BatchNorm(x, gamma, beta, mean, var,
                                    fix_gamma=False).asnumpy()
    out["mean after eval"] = mean.asnumpy()
    return out


def _scopes(mx):
    ag = mx.autograd
    flags = [ag.is_recording(), ag.is_training()]
    with ag.record():
        flags += [ag.is_recording(), ag.is_training()]
        with ag.pause():
            flags += [ag.is_recording(), ag.is_training()]
        with ag.predict_mode():
            flags.append(ag.is_training())
    with ag.record(train_mode=False):
        flags += [ag.is_recording(), ag.is_training()]
    with ag.train_mode():
        flags += [ag.is_recording(), ag.is_training()]
    prev = ag.set_recording(True)
    flags += [prev, ag.is_recording(), ag.set_recording(False)]
    return {"flags": np.array(flags, dtype=np.float32)}


CASES = {f.__name__[1:]: f for f in (
    _simple, _chain_and_shared_input, _multi_variable, _head_grad,
    _grad_req_modes, _detach, _block_grad, _through_nn_ops,
    _softmax_output, _grad_function, _mark_variables, _function,
    _second_backward, _indexing, _train_mode, _scopes)}


@pytest.fixture(scope="module")
def jax_cases(ref):
    with ref.jax.enable_x64(False), ref.mx.cpu():
        return {name: case(ref.mx) for name, case in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_matches_jax(jax_cases, name):
    with mxt.cpu():
        got = CASES[name](mxt)
    want = jax_cases[name]
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], f"{name}: {key}")


def test_second_backward_gives_the_same_gradient():
    """The graph outlives a backward (it is freed with the heads): the
    second write repeats the first, the second add doubles it."""
    with mxt.cpu():
        got = _second_backward(mxt)
    np.testing.assert_array_equal(got["x second"], got["x first"])
    np.testing.assert_array_equal(got["w second"], 2 * got["w first"])


def test_head_neither_recorded_nor_marked_raises(ref):
    for mx, err in ((ref.mx, ref.mx.base.MXNetError), (mxt, MXNetError)):
        with mx.cpu():
            y = mx.nd.array(np.ones(3)) * 2
            with pytest.raises(err):
                y.backward()


def test_no_graph_outside_record():
    """Outside record() an op on a marked array builds no graph, so the
    array's tensor can be written in place; inside, the op's output
    carries one and a later step's in-place update of the parameter
    leaves the recorded values alone only through a new record."""
    with mxt.cpu():
        w = mxt.nd.array(np.array([1.0, 2.0]))
        w.attach_grad()
        y = w * 3
        assert not y._data.requires_grad and y._data.grad_fn is None
        w._data.mul_(2)  # what a fused update does to a parameter
        with mxt.autograd.record():
            z = (w * w).sum()
        assert z._data.grad_fn is not None
        z.backward()
        np.testing.assert_array_equal(w.grad.asnumpy(), [4.0, 8.0])
        assert w.grad.version == 1
        z.backward()
        assert w.grad.version == 2


def test_dropout_draws_only_in_train_mode():
    with mxt.cpu():
        x = mxt.nd.ones((64, 64))
        assert (mxt.nd.Dropout(x, p=0.5).asnumpy() == 1).all()
        with mxt.autograd.record():
            y = mxt.nd.Dropout(x, p=0.5)
        kept = y.asnumpy() != 0
        assert 0.3 < kept.mean() < 0.7
        np.testing.assert_allclose(y.asnumpy()[kept], 2.0)


# -- the four nn ops of this slice ------------------------------------------

def _deconv(layout, kernel, nf, **kw):
    return {"kernel": kernel, "num_filter": nf, "layout": layout, **kw}


# id -> (op, [(shape, kind, differentiable)], attrs, is_train)
OP_CASES = {
    "log_softmax_last": ("log_softmax", [((3, 4, 6), "normal", True)],
                         {}, False),
    "log_softmax_axis1_temperature": ("log_softmax",
                                      [((3, 4, 6), "normal", True)],
                                      {"axis": 1, "temperature": 2.5},
                                      False),
    "leaky": ("LeakyReLU", [((3, 4, 5), "normal", True)],
              {"act_type": "leaky", "slope": 0.1}, True),
    "leaky_defaults": ("LeakyReLU", [((7, 9), "normal", True)], {}, False),
    "elu": ("LeakyReLU", [((3, 4, 5), "normal", True)],
            {"act_type": "elu", "slope": 0.7}, False),
    "prelu": ("LeakyReLU", [((2, 3, 4, 4), "normal", True),
                            ((3,), "slope", True)],
              {"act_type": "prelu"}, True),
    "rrelu_eval": ("LeakyReLU", [((3, 4, 5), "normal", True)],
                   {"act_type": "rrelu", "lower_bound": 0.1,
                    "upper_bound": 0.4}, False),
    "instance_norm_2d": ("InstanceNorm", [((2, 3, 5, 5), "shifted", True),
                                          ((3,), "gamma", True),
                                          ((3,), "normal", True)],
                         {}, False),
    "instance_norm_1d_eps": ("InstanceNorm", [((2, 4, 7), "shifted", True),
                                              ((4,), "gamma", True),
                                              ((4,), "normal", True)],
                             {"eps": 1e-5}, False),
    "deconv_nchw_s2_p1_adj1": ("Deconvolution",
                               [((2, 4, 5, 5), "normal", True),
                                ((4, 3, 3, 3), "w", True),
                                ((3,), "normal", True)],
                               _deconv("NCHW", (3, 3), 3, stride=(2, 2),
                                       pad=(1, 1), adj=(1, 1)), False),
    "deconv_ncw_group2_dilate2": ("Deconvolution",
                                  [((2, 4, 6), "normal", True),
                                   ((4, 3, 3), "w", True)],
                                  _deconv(None, (3,), 6, num_group=2,
                                          dilate=(2,), no_bias=True),
                                  False),
    "deconv_ncdhw_3d": ("Deconvolution", [((1, 2, 3, 4, 3), "normal", True),
                                          ((2, 3, 2, 2, 2), "w", True),
                                          ((3,), "normal", True)],
                        _deconv("NCDHW", (2, 2, 2), 3,
                                stride=(2, 1, 2)), False),
    "deconv_nchw_depthwise": ("Deconvolution",
                              [((1, 4, 4, 6), "normal", True),
                               ((4, 1, 3, 3), "w", True)],
                              _deconv("NCHW", (3, 3), 4, num_group=4,
                                      stride=(1, 2), pad=(0, 1),
                                      no_bias=True), False),
}
NEW_OPS = ("Deconvolution", "InstanceNorm", "LeakyReLU", "log_softmax")


def _op_arrays(case_id):
    _, spec, _, _ = OP_CASES[case_id]
    rng = np.random.RandomState(sorted(OP_CASES).index(case_id))
    arrays, diff = [], []
    for shape, kind, d in spec:
        if kind == "w":
            a = rng.normal(0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        elif kind == "slope":
            a = rng.uniform(0.05, 0.5, shape)
        elif kind == "gamma":
            a = rng.uniform(0.5, 1.5, shape)
        elif kind == "shifted":
            a = rng.normal(0, 1.5, shape) + rng.normal(0, 2, shape[:2]
                                                       + (1,) * (len(shape)
                                                                 - 2))
        else:
            a = rng.normal(0, 1, shape)
        arrays.append(a.astype(np.float32))
        diff.append(d)
    return arrays, diff


def _op_cotangent(case_id, shape):
    rng = np.random.RandomState(500 + sorted(OP_CASES).index(case_id))
    return rng.normal(0, 1, shape).astype(np.float32)


def _op_attrs(table, case_id):
    op, _, attrs, train = OP_CASES[case_id]
    parsed = table[op].parse_attrs(attrs)
    if table[op].needs_is_train:
        parsed["_is_train"] = train
    return parsed


@pytest.fixture(scope="module")
def jax_ops(ref):
    """Every op case's JAX output and input gradients, from one jit."""
    jax, jnp = ref.jax, ref.jnp
    from mxnet_tpu.ops.registry import OP_TABLE
    arrays = {cid: _op_arrays(cid)[0] for cid in OP_CASES}
    with jax.enable_x64(False):
        shapes = {}
        for cid, (op, _, _, _) in OP_CASES.items():
            fn, parsed = OP_TABLE[op].fn, _op_attrs(OP_TABLE, cid)
            pre = (jax.random.PRNGKey(0),) if OP_TABLE[op].needs_rng else ()
            shapes[cid] = jax.eval_shape(
                lambda *v, fn=fn, kw=parsed, pre=pre: fn(*pre, *v, **kw),
                *arrays[cid]).shape
        cots = {cid: _op_cotangent(cid, shapes[cid]) for cid in OP_CASES}

        def run(arrays, cots):
            res = {}
            for cid, (op, _, _, _) in OP_CASES.items():
                fn, parsed = OP_TABLE[op].fn, _op_attrs(OP_TABLE, cid)
                pre = ((jax.random.PRNGKey(0),) if OP_TABLE[op].needs_rng
                       else ())
                out, vjp = jax.vjp(
                    lambda *v, fn=fn, kw=parsed, pre=pre: fn(*pre, *v, **kw),
                    *[jnp.asarray(a) for a in arrays[cid]])
                res[cid] = (out, list(vjp(cots[cid])))
            return res

        out = jax.jit(run)(arrays, cots)
        return {k: jax.tree.map(np.asarray, v) for k, v in out.items()}


def _port_op(case_id, arrays=None, attrs=None):
    op = OP_CASES[case_id][0]
    opdef = mxt.OP_TABLE[op]
    parsed = _op_attrs(mxt.OP_TABLE, case_id)
    parsed.update(attrs or {})
    arrays = arrays if arrays is not None else _op_arrays(case_id)[0]
    ins = [torch.tensor(a).requires_grad_() for a in arrays]
    pre = (mxt.random.generator("cpu"),) if opdef.needs_rng else ()
    out = opdef.fn(*pre, *ins, **parsed)
    cot = torch.tensor(_op_cotangent(case_id, tuple(out.shape)))
    grads = torch.autograd.grad(out, ins, cot)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("case_id", sorted(OP_CASES))
def test_new_op_matches_jax(jax_ops, case_id):
    """Forward output and every input gradient against the JAX op's."""
    out_j, grads_j = jax_ops[case_id]
    out_t, grads_t = _port_op(case_id)
    _close(out_t, out_j, f"{case_id} output")
    assert len(grads_t) == len(grads_j)
    for i, (got, want) in enumerate(zip(grads_t, grads_j)):
        _close(got, want, f"{case_id} gradient {i}")


def test_deconvolution_channel_last_is_the_channel_first_op():
    """NHWC runs the NCHW op on a channels_last view: the same output and
    data gradient, permuted (the JAX op reads every layout as NC*)."""
    arrays, _ = _op_arrays("deconv_nchw_s2_p1_adj1")
    data, w, b = arrays
    ins = [torch.tensor(data.transpose(0, 2, 3, 1)).requires_grad_(),
           torch.tensor(w).requires_grad_(), torch.tensor(b)]
    opdef = mxt.OP_TABLE["Deconvolution"]
    attrs = opdef.parse_attrs(dict(OP_CASES["deconv_nchw_s2_p1_adj1"][2],
                                   layout="NHWC"))
    out = opdef.fn(*ins, **attrs)
    want_out, want_grads = _port_op("deconv_nchw_s2_p1_adj1")
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 3, 1, 2),
                               want_out, rtol=1e-6, atol=1e-6)
    cot = torch.tensor(_op_cotangent("deconv_nchw_s2_p1_adj1",
                                     want_out.shape).transpose(0, 2, 3, 1))
    gd, gw = torch.autograd.grad(out, ins[:2], cot)
    np.testing.assert_allclose(gd.numpy().transpose(0, 3, 1, 2),
                               want_grads[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), want_grads[1], rtol=1e-5,
                               atol=1e-6)
    assert mxt.OP_TABLE["Deconvolution"].param_shapes(
        attrs, [(2, 5, 5, 4), None, None]) == [(2, 5, 5, 4), (4, 3, 3, 3),
                                                (3,)]
    with pytest.raises(MXNetError):
        opdef.fn(*ins, **opdef.parse_attrs(dict(
            OP_CASES["deconv_nchw_s2_p1_adj1"][2], adj=(2, 2))))


def test_rrelu_draws_slopes_in_training():
    """In training each negative element takes its own slope in [lower,
    upper) from the device's generator, and its gradient is that slope;
    the same seed draws the same slopes; eval takes the mean slope."""
    x = torch.tensor(-np.linspace(0.5, 2.0, 4096, dtype=np.float32))
    attrs = {"act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.4,
             "_is_train": True}
    fn = mxt.OP_TABLE["LeakyReLU"].fn
    runs = []
    for _ in range(2):
        mxt.random.seed(7)
        xl = x.clone().requires_grad_()
        y = fn(mxt.random.generator("cpu"), xl, **attrs)
        (g,) = torch.autograd.grad(y.sum(), xl)
        runs.append((y.detach().numpy(), g.numpy()))
    slope = runs[0][0] / x.numpy()
    assert slope.min() >= 0.1 and slope.max() < 0.4
    assert slope.std() > 0.05  # per element, not one slope
    np.testing.assert_allclose(runs[0][1], slope, rtol=1e-5)
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    y_eval = fn(None, x, **dict(attrs, _is_train=False))
    np.testing.assert_allclose(y_eval.numpy(), 0.25 * x.numpy(), rtol=1e-6)


def test_new_op_records_match_jax(ref):
    """The four ops' records against the JAX table's: inputs, attributes
    and defaults, train and rng flags, parameter shapes."""
    from mxnet_tpu.ops.registry import OP_TABLE
    for name in NEW_OPS:
        j, p = OP_TABLE[name], mxt.OP_TABLE[name]
        assert p.input_names == j.input_names, name
        assert p.num_inputs == j.num_inputs, name
        assert p.needs_is_train == j.needs_is_train, name
        assert bool(p.needs_rng) == bool(j.needs_rng), name
        assert sorted(p.attr_spec.fields) == sorted(j.attr_spec.fields), name
        for field, (typ, default) in j.attr_spec.fields.items():
            ptyp, pdefault = p.attr_spec.fields[field]
            assert ptyp == typ, (name, field)
            if default is not j.attr_spec._REQUIRED:
                assert pdefault == default, (name, field)
    for name, attrs, shapes in (
            ("Deconvolution", {"kernel": (3, 3), "num_filter": 8,
                               "num_group": 2}, [(2, 4, 9, 9), None, None]),
            ("InstanceNorm", {}, [(2, 5, 3, 3), None, None]),
            ("LeakyReLU", {"act_type": "prelu"}, [(2, 6, 3), None]),
            ("LeakyReLU", {}, [(2, 6, 3)])):
        assert (mxt.OP_TABLE[name].param_shapes(attrs, shapes)
                == OP_TABLE[name].param_shapes(attrs, shapes)), name
    assert mxt.OP_TABLE["LeakyReLU"].uses_rng({"act_type": "rrelu"})
    assert not mxt.OP_TABLE["LeakyReLU"].uses_rng({"act_type": "leaky"})

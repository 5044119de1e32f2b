"""Parity of the PyTorch port's optimizers, update ops and lr schedulers
with the JAX package.

The same numpy weights and gradients, made from a seed, go through both
packages' ``get_updater(create(...))`` for 3 steps at toy shapes, on the
CPU, with the JAX package run as its users run it (x64 off). Tolerances:
the fp32 update ops, whose formulas keep the JAX package's operation
order, agree to 1 fp32 ulp (bit for bit but where XLA contracts a
multiply-add); the optimizers written as NDArray arithmetic (NAG, DCASGD,
AdaGrad, AdaDelta, Ftrl) to 4 ulps over the 3 steps; the centered
RMSProp to 64 ulps (its rsqrt(n - g^2 + eps) cancels and magnifies a 1-ulp
difference); fp16 weights of the multi-precision SGD exactly.
"""
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import lr_scheduler as plrs
from mxnet_tpu_torch import nd as pnd
from mxnet_tpu_torch import optimizer as popt
from mxnet_tpu_torch.base import MXNetError

SHAPES = [(4, 3), (5,)]


@pytest.fixture(scope="module")
def ref():
    import jax
    import mxnet_tpu
    return types.SimpleNamespace(mx=mxnet_tpu, nd=mxnet_tpu.nd,
                                 opt=mxnet_tpu.optimizer,
                                 lrs=mxnet_tpu.lr_scheduler,
                                 x32=lambda: jax.enable_x64(False))


def _data(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    weights = [rng.normal(0, 1, s).astype(dtype) for s in SHAPES]
    grads = [[rng.normal(0, 3, s).astype(dtype) for s in SHAPES]
             for _ in range(3)]
    return weights, grads


def _train(nd, opt_mod, name, kwargs, weights, grads):
    opt = opt_mod.create(name, **kwargs)
    upd = opt_mod.get_updater(opt)
    ws = [nd.array(w, dtype=w.dtype) for w in weights]
    for step in grads:
        for i, (w, g) in enumerate(zip(ws, step)):
            upd(i, nd.array(g, dtype=g.dtype), w)
    states = []
    for i in range(len(ws)):
        st = upd.states[i]
        st = st if isinstance(st, tuple) else (st,)
        states += [s.asnumpy() for s in st if s is not None]
    return [w.asnumpy() for w in ws], states


OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}, 1),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
             "rescale_grad": 0.125}, 1),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "clip_gradient": 0.5}, 1),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}, 4),
    ("nag", {"learning_rate": 0.1}, 4),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}, 4),
    ("dcasgd", {"learning_rate": 0.1}, 4),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3, "rescale_grad": 0.5}, 1),
    ("adam", {"learning_rate": 0.01, "clip_gradient": 1.0}, 1),
    ("adagrad", {"learning_rate": 0.1, "wd": 1e-3}, 4),
    ("rmsprop", {"learning_rate": 0.01}, 1),
    # centered: rsqrt(n - g^2 + eps) cancels, so a 1-ulp difference in n or
    # g (XLA contracts multiply-adds) grows to tens of ulps
    ("rmsprop", {"learning_rate": 0.01, "centered": True, "clip_weights": 0.8}, 64),
    ("adadelta", {"wd": 1e-3}, 4),
    ("ftrl", {"learning_rate": 0.1, "wd": 1e-3}, 4),
    ("test", {"rescale_grad": 0.5}, 1),
]


@pytest.mark.parametrize("case", range(len(OPTIMIZERS)))
def test_three_steps_match_jax(ref, case):
    name, kwargs, maxulp = OPTIMIZERS[case]
    weights, grads = _data(case)
    with mxt.cpu():
        got = _train(pnd, popt, name, kwargs, weights, grads)
    with ref.x32():
        want = _train(ref.nd, ref.opt, name, kwargs, weights, grads)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_max_ulp(g, w, maxulp=maxulp)


def test_sgd_multi_precision_fp16(ref):
    weights, grads = _data(7, np.float16)
    kwargs = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
              "multi_precision": True}
    with mxt.cpu():
        got = _train(pnd, popt, "sgd", kwargs, weights, grads)
    with ref.x32():
        want = _train(ref.nd, ref.opt, "sgd", kwargs, weights, grads)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == np.float16
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[1], want[1]):  # mom and the fp32 master
        assert g.dtype == np.float32
        np.testing.assert_array_max_ulp(g, w, maxulp=1)
    # multi_precision is for float16 weights only, as in the JAX package
    opt = popt.create("sgd", momentum=0.9, multi_precision=True)
    with mxt.cpu():
        assert not isinstance(opt.create_state(0, pnd.zeros((2,))), tuple)
        assert not isinstance(
            opt.create_state(0, pnd.zeros((2,), dtype="bfloat16")), tuple)


UPDATE_OPS = [
    ("sgd_update", 2, {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5}),
    ("sgd_mom_update", 3, {"lr": 0.1, "momentum": 0.9, "wd": 0.01,
                           "clip_gradient": 1.0}),
    ("mp_sgd_update", 3, {"lr": 0.1, "wd": 0.01}),
    ("mp_sgd_mom_update", 4, {"lr": 0.1, "momentum": 0.9, "rescale_grad": 0.25}),
    ("adam_update", 4, {"lr": 0.01, "wd": 0.01, "clip_gradient": 2.0}),
    ("rmsprop_update", 3, {"lr": 0.01, "clip_weights": 0.5}),
    ("rmspropalex_update", 5, {"lr": 0.01, "wd": 0.01}),
]


@pytest.mark.parametrize("name,n_in,attrs", UPDATE_OPS)
def test_update_ops_match_jax(ref, name, n_in, attrs):
    rng = np.random.RandomState(n_in)
    arrays = [rng.normal(0, 1, (3, 4)).astype(np.float32) for _ in range(n_in)]
    if name.startswith("rmsprop"):
        arrays[2] = np.abs(arrays[2]) + 1.0  # n: a mean square
    if name.startswith("mp_"):
        arrays[0] = arrays[0].astype(np.float16)
        arrays[1] = arrays[1].astype(np.float16)
    with mxt.cpu():
        got = getattr(pnd, name)(*[pnd.array(a, dtype=a.dtype) for a in arrays],
                                 **attrs)
        got = [o.asnumpy() for o in (got if isinstance(got, list) else [got])]
    with ref.x32():
        want = getattr(ref.nd, name)(*[ref.nd.array(a, dtype=a.dtype)
                                       for a in arrays], **attrs)
        want = [o.asnumpy() for o in (want if isinstance(want, list) else [want])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_max_ulp(g, w, maxulp=1)


def test_updater_states_and_registry():
    opt = popt.create("sgd", learning_rate=0.1, momentum=0.9)
    assert popt.create(opt) is opt and isinstance(opt, popt.SGD)
    upd = popt.get_updater(opt)
    with mxt.cpu():
        w = pnd.array(np.ones(3, np.float32))
        upd(0, pnd.array(np.full(3, 2.0, np.float32)), w)
        v = w.version
        blob = upd.get_states(dump_optimizer=True)
        fresh = popt.get_updater(popt.create("sgd", learning_rate=0.1,
                                             momentum=0.9))
        fresh.set_states(blob)
        assert fresh.optimizer.num_update == 1
        np.testing.assert_array_equal(fresh.states[0].asnumpy(),
                                      upd.states[0].asnumpy())
        upd(0, pnd.array(np.full(3, 2.0, np.float32)), w)
        assert w.version == v + 1  # the update writes behind the handle
    with pytest.raises(MXNetError):
        popt.create("no_such_optimizer")
    with pytest.raises(MXNetError, match="A9"):
        with mxt.cpu():
            popt.create("sgld").update(0, pnd.zeros((2,)), pnd.zeros((2,)), None)

    @popt.register
    class Halve(popt.Optimizer):
        def update(self, index, weight, grad, state):
            weight._set_data((weight * 0.5)._data)
    with mxt.cpu():
        w = pnd.ones((2,))
        popt.get_updater(popt.create("halve"))(0, w, w)
    assert w.asnumpy().tolist() == [0.5, 0.5]


def test_lr_mult_wd_mult_and_scheduler(ref):
    weights, grads = _data(3)
    def run(nd, opt_mod, lrs):
        sched = lrs.FactorScheduler(step=2, factor=0.5)
        opt = opt_mod.create("sgd", learning_rate=0.2, momentum=0.5, wd=0.1,
                             lr_scheduler=sched,
                             param_idx2name={0: "fc_weight", 1: "fc_bias"})
        opt.set_lr_mult({0: 0.5})
        upd = opt_mod.get_updater(opt)
        ws = [nd.array(w) for w in weights]
        for step in grads:
            for i, (w, g) in enumerate(zip(ws, step)):
                upd(i, nd.array(g), w)
        return [w.asnumpy() for w in ws]
    with mxt.cpu():
        got = run(pnd, popt, plrs)
    with ref.x32():
        want = run(ref.nd, ref.opt, ref.lrs)
    for g, w in zip(got, want):
        np.testing.assert_array_max_ulp(g, w, maxulp=1)


@pytest.mark.parametrize("kind,kwargs", [
    ("FactorScheduler", {"step": 3, "factor": 0.7, "stop_factor_lr": 1e-3}),
    ("MultiFactorScheduler", {"step": [2, 5, 9], "factor": 0.3}),
    ("PolyScheduler", {"max_update": 7, "pwr": 2}),
])
def test_lr_schedulers_match_jax(ref, kind, kwargs):
    mine = getattr(plrs, kind)(base_lr=0.5, **kwargs)
    theirs = getattr(ref.lrs, kind)(base_lr=0.5, **kwargs)
    for t in (12, 0, 1, 2, 3, 5, 6, 9, 10, 30):  # out of order on purpose
        assert mine(t) == theirs(t), (kind, t)
    with pytest.raises(ValueError):
        plrs.FactorScheduler(step=0)
    with pytest.raises(MXNetError):
        popt.create("sgd", lr_scheduler=plrs.FactorScheduler(step=2)) \
            .set_learning_rate(0.1)

"""Parity of the PyTorch port's Gluon Trainer with the JAX package.

A Dense network trained by ``gluon.Trainer`` (SGD with momentum, two
steps, imperative and hybridized), the dynamic loss scale's skipped step
(``Trainer(loss_scale=...)``: a step with a non-finite gradient leaves
every weight as it was and halves the scale), ``.params`` files and
Trainer states written by one package and read by the other, the
stale-gradient check, ``set_learning_rate`` and the per-parameter path
(``MXTPU_FUSED_STEP=0``), run through ``mxnet_tpu`` and
``mxnet_tpu_torch`` on the CPU from the same seeded inputs and
initializers, and held to each other. Every JAX run happens once, in a
module-scope fixture, or in the test that reads a file the other package
wrote, with x64 off as users run the JAX package. The ``cuda`` test runs
the Trainer's update captured in a CUDA graph against the CPU.
"""
import contextlib
import os
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError

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


def _mlp(mx, hybrid):
    mx.random.seed(0)
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=8),
                nn.Dense(4, in_units=16))
    net.initialize(mx.init.Xavier())
    if hybrid:
        net.hybridize()
    x, y = mx.nd.array(_data((6, 8), 1)), mx.nd.array(_data((6, 4), 2))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = mx.gluon.loss.L2Loss()
    out = {"init " + k: v for k, v in _params(net).items()}
    for step in range(2):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        out[f"loss{step}"] = loss.asnumpy()
        if step == 0:
            out.update(_params(net, grads=True))
        trainer.step(6)
    out.update(_params(net))
    out["eval"] = net(x).asnumpy()
    return out


def _loss_scale(mx, hybrid):
    """A dynamic loss scale: a finite step applies, a step whose gradient
    is not finite leaves every weight and state as it was and halves the
    scale, the next finite step applies again."""
    from_q = mx.quant.loss_scale
    mx.random.seed(7)
    net = mx.gluon.nn.Dense(4, in_units=4, prefix="ls_")
    net.initialize(mx.init.Xavier())
    if hybrid:
        net.hybridize()
    trainer = mx.gluon.Trainer(
        net.collect_params(), "sgd", {"learning_rate": 0.1,
                                      "momentum": 0.9},
        loss_scale=from_q.LossScaleConfig(init_scale=2.0 ** 4,
                                          growth_interval=100))
    x = mx.nd.array(_data((2, 4), 25))
    out = {}
    for step, poison in enumerate((False, True, False)):
        xs = x * float("inf") if poison else x
        with mx.autograd.record():
            loss = (net(xs) * net(xs)).sum() * trainer.loss_scale.scale
        loss.backward()
        trainer.step(2)
        out[f"weight{step}"] = net.weight.data().asnumpy()
        out[f"scale{step}"] = np.array(trainer.loss_scale.scale)
    out["skipped"] = np.array(trainer.loss_scale.steps_skipped)
    return out


SCENARIOS = {f.__name__[1:]: f for f in (_mlp, _loss_scale)}


@pytest.fixture(scope="module")
def jax_runs(ref):
    """Both scenarios through the JAX package, hybridized (its imperative
    path gives the same numbers, tests/test_gluon.py:
    test_hybridize_grad_consistency)."""
    with _jax_package():
        return {name: f(ref.mx, True) for name, f in SCENARIOS.items()}


@pytest.mark.parametrize("hybrid", [False, True],
                         ids=["imperative", "hybridized"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_trainer_matches_jax(jax_runs, name, hybrid):
    with mxt.cpu():
        got = SCENARIOS[name](mxt, hybrid)
    want = jax_runs[name]
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], f"{name}: {key}")


def test_params_files_cross_packages(ref, tmp_path):
    """A ParameterDict / block saved by either package loads in the
    other and gives the same outputs."""
    def make(mx):
        nn = mx.gluon.nn
        net = nn.HybridSequential(prefix="slp_")
        with net.name_scope():
            net.add(nn.Dense(16, in_units=8), nn.Dense(4, in_units=16))
        return net

    x = _data((2, 8), 26)
    with _jax_package():
        ref.mx.random.seed(8)
        jnet = make(ref.mx)
        jnet.initialize(ref.mx.init.Xavier())
        jnet.save_params(str(tmp_path / "jax.params"))
        want = jnet(ref.mx.nd.array(x)).asnumpy()
    with mxt.cpu():
        pnet = make(mxt)
        pnet.load_params(str(tmp_path / "jax.params"), ctx=mxt.cpu())
        _close(pnet(mxt.nd.array(x)).asnumpy(), want, "port loads jax")
        pnet.collect_params().save(str(tmp_path / "port.params"))
    with _jax_package():
        jnet2 = make(ref.mx)
        jnet2.collect_params().load(str(tmp_path / "port.params"))
        _close(jnet2(ref.mx.nd.array(x)).asnumpy(), want, "jax loads port")


def test_trainer_states_cross_packages(ref, tmp_path):
    """Momentum saved by the port's Trainer resumes the JAX package's
    training where the port's own resumes it, and back."""
    def run(mx, load=None, save=None):
        mx.random.seed(9)
        net = mx.gluon.nn.Dense(4, in_units=4, prefix="tr_")
        net.initialize(mx.init.Xavier())
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        x = mx.nd.array(_data((2, 4), 27))
        for step in range(2):
            if step == 1 and load is not None:
                tr.load_states(load)
            with mx.autograd.record():
                loss = (net(x) * net(x)).sum()
            loss.backward()
            tr.step(2)
            if step == 0 and save is not None:
                tr.save_states(save)
        return net.weight.data().asnumpy()

    jax_file, port_file = str(tmp_path / "jax.states"), str(tmp_path /
                                                           "port.states")
    with _jax_package():
        want = run(ref.mx, save=jax_file)
    with mxt.cpu():
        _close(run(mxt, save=port_file), want, "port")
        _close(run(mxt, load=jax_file), want, "port resumes jax")
    with _jax_package():
        _close(run(ref.mx, load=port_file), want, "jax resumes port")


def test_stale_gradient_raises(ref):
    for mx, err in ((ref.mx, ref.mx.base.MXNetError), (mxt, MXNetError)):
        with mx.cpu():
            net = mx.gluon.nn.Dense(2, in_units=3)
            net.initialize()
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1})
            with mx.autograd.record():
                loss = net(mx.nd.ones((1, 3))).sum()
            loss.backward()
            tr.step(1)
            with pytest.raises(err):
                tr.step(1)
            tr.step(1, ignore_stale_grad=True)


def test_trainer_learning_rate_and_imperative_path(monkeypatch):
    """set_learning_rate moves the next update; MXTPU_FUSED_STEP=0 takes
    the per-parameter updater, with the same result; a loss scale there
    raises, as the JAX Trainer's does."""
    def run():
        mxt.random.seed(10)
        net = mxt.gluon.nn.Dense(3, in_units=3, prefix="lr_")
        net.initialize(mxt.init.Xavier())
        tr = mxt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        tr.set_learning_rate(0.25)
        assert tr.learning_rate == 0.25
        with mxt.autograd.record():
            loss = (net(mxt.nd.ones((2, 3))) ** 2).sum()
        loss.backward()
        tr.step(2)
        return tr, net.weight.data().asnumpy()

    with mxt.cpu():
        fused_tr, fused = run()
        assert fused_tr._fused_apply.guard.count == 1
        monkeypatch.setenv("MXTPU_FUSED_STEP", "0")
        loop_tr, loop = run()
        assert loop_tr._fused_apply is None
        np.testing.assert_allclose(loop, fused, rtol=1e-6)
        net = mxt.gluon.nn.Dense(2, in_units=2)
        net.initialize()
        tr = mxt.gluon.Trainer(net.collect_params(), "sgd",
                               loss_scale=True)
        with mxt.autograd.record():
            loss = net(mxt.nd.ones((1, 2))).sum()
        loss.backward()
        with pytest.raises(MXNetError):
            tr.step(1)


def test_trainer_save_states_checkpointer_raises(tmp_path):
    with mxt.cpu():
        net = mxt.gluon.nn.Dense(2, in_units=2)
        net.initialize()
        tr = mxt.gluon.Trainer(net.collect_params(), "sgd")
        with pytest.raises(MXNetError):
            tr.save_states(str(tmp_path / "s"), checkpointer=object())


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_port_gluon_trainer.py`")
    mxt.gpu(0).torch_device()  # TF32 off, as the port runs
    return mxt.gpu(0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mlp", "loss_scale"])
def test_trainer_on_card_matches_cpu(card, name):
    """The Trainer's fused update captured in a CUDA graph (once) and
    replayed, with the loss-scale guard and its flag inside the graph:
    the same weights, scales and skipped step as on the CPU."""
    with mxt.cpu():
        want = SCENARIOS[name](mxt, True)
    with card:
        got = SCENARIOS[name](mxt, True)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], f"{name}: {key}")


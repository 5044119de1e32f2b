"""Parity of the PyTorch port's Gluon ResNet-18 v1 with the JAX package.

``get_model('resnet18_v1', thumbnail=True, classes=10)`` at 32x32, batch
2, fp32, as ``tests/test_torch_port_gluon_zoo.py`` holds v2: from the
same weights (seeded Xavier in the JAX package, carried by
``convert.gluon_params_from_numpy``), one training forward and backward
of the softmax cross entropy, imperative and hybridized, against the JAX
package's hybridized block: the logits, the loss, BatchNorm's moving
statistics and the gradients. At this batch some ReLU inputs lie within
fp32 rounding of 0, and the two packages' fp32 forwards put a few of them
on opposite sides: the loss has a kink within 1e-5 of the seeded weights,
and the gradients upstream of it are different one-sided gradients in
the two packages. The finite-difference test pins one such kink (``TIE``,
in the third stage's second block) in each package's own gradients.
Upstream of that block v1 is held to the port's own fp64 gradients, which
take the same side; downstream of it, to the JAX package's. The JAX run
happens once, in a module-scope fixture, with x64 off as users run the
JAX package.
"""
import contextlib
import os
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt

MODEL = "resnet18_v1"
BATCH, SIZE, CLASSES = 2, 32, 10
# fp32 on both sides, summation order only: logits, loss and gradients are
# held at 1e-5 of their own largest magnitude, the moving means at 1e-5 of
# their BatchNorm's largest moving standard deviation (a mean near 0 has
# no scale of its own)
REL = 1e-5
# the element of the pinned kink (a beta: its seeded value is 0), and a
# move of it that crosses the kink in each package: the JAX package's lies
# below the seeded value, the port's above it, each within TIE_STEP
TIE, TIE_STEP = ("resnet18_v1_stage3_batchnorm3_beta", 164), 2e-5


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


def _batch():
    rng = np.random.RandomState(0)
    return (rng.rand(BATCH, 3, SIZE, SIZE).astype(np.float32),
            rng.randint(0, CLASSES, (BATCH,)).astype(np.float32))


def _step(mx, name, hybrid, init=None, dtype="float32"):
    """One recorded forward and backward; ``init`` sets every
    parameter."""
    mx.random.seed(0)
    net = mx.gluon.model_zoo.vision.get_model(name, thumbnail=True,
                                              classes=CLASSES,
                                              prefix=name + "_")
    net.initialize(mx.init.Xavier())
    data, label = _batch()
    x, y = mx.nd.array(data), mx.nd.array(label)
    net.infer_shape(x)  # fixes the deferred shapes
    if init is not None:
        mx.convert.gluon_params_from_numpy(net, init)
    if dtype != "float32":
        net.cast(dtype)
        x, y = x.astype(dtype), y.astype(dtype)
    if hybrid:
        net.hybridize()
    params = net.collect_params()
    out = {"init": {k: p.data().asnumpy() for k, p in params.items()}}
    with mx.autograd.record():
        logits = net(x)
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(logits, y)
    loss.backward()
    out["logits"], out["loss"] = logits.asnumpy(), loss.asnumpy()
    out["grads"] = {k: p.grad().asnumpy() for k, p in params.items()
                    if p.grad_req != "null"}
    out["moving"] = {k: p.data().asnumpy() for k, p in params.items()
                     if "running" in k}
    out["cached_ops"] = len(net._cached_ops)
    out["block"] = (net, x, y)
    return out


@pytest.fixture(scope="module")
def jax_run(ref):
    with _jax_package():
        return _step(ref.mx, MODEL, True)


def _close(got, want, what, scale=None, extra=0.0):
    mag = float(np.abs(want).max()) if scale is None else scale
    tol = REL * max(mag, 1e-6) + extra
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= tol, \
        f"{what}: max |err| {err:.3g} > {tol:.3g} (scale {mag:.3g})"


# v1's gradients held to the JAX package's: downstream of the pinned kink
# (stage 3's second block's second half, stage 4 and the dense layer). Its
# last stage's BatchNorms normalise 2 x 4 x 4 values a channel, and their
# gradients sit up to 3.6e-6 (the port) and 6.6e-6 (the JAX package) of
# their largest magnitude from fp64: each is held at 1e-5 of it plus twice
# the port's own distance from its fp64 gradient
V1_DOWNSTREAM = ("stage3_conv2d4", "stage3_batchnorm4", "stage4", "dense0")


@pytest.fixture(scope="module")
def v1_fp64(jax_run):
    """v1's step through the port in fp64 from the JAX package's weights."""
    with mxt.cpu():
        return _step(mxt, MODEL, False, init=jax_run["init"],
                     dtype="float64")


@pytest.mark.parametrize("hybrid", [False, True],
                         ids=["imperative", "hybridized"])
def test_resnet_v1_step_matches_jax(jax_run, v1_fp64, hybrid):
    want, own64 = jax_run, v1_fp64
    with mxt.cpu():
        got = _step(mxt, MODEL, hybrid, init=want["init"])
    _close(got["logits"], want["logits"], "logits")
    _close(got["loss"], want["loss"], "loss")
    assert sorted(got["moving"]) == sorted(want["moving"])
    for k in want["moving"]:
        std = np.sqrt(want["moving"][k.replace("_mean", "_var")]).max()
        _close(got["moving"][k], want["moving"][k], k,
               float(std) if k.endswith("running_mean") else None)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k in want["grads"]:
        if any(part in k for part in V1_DOWNSTREAM):
            own_err = np.abs(got["grads"][k] - own64["grads"][k]).max()
            _close(got["grads"][k], want["grads"][k], f"gradient {k}",
                   extra=2 * float(own_err))
        else:
            _close(got["grads"][k], own64["grads"][k],
                   f"gradient {k} (fp64)")
    assert got["cached_ops"] == (1 if hybrid else 0)
    assert want["cached_ops"] == 1


def _set_params(mx, net, init, offset, dtype):
    """Every parameter of ``net`` from ``init``, TIE's element moved by
    ``offset``."""
    for k, p in net.collect_params().items():
        v = np.array(init[k], dtype=dtype)
        if k == TIE[0]:
            v[TIE[1]] += offset
        p.set_data(mx.nd.array(v, dtype=dtype))


def _tie_grad(mx, block, init, offset, dtype="float32"):
    """TIE's gradient on a package's ``block`` (net, x, y) with the
    parameters set by :func:`_set_params`."""
    net, x, y = block
    _set_params(mx, net, init, offset, dtype)
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    return float(net.collect_params()[TIE[0]].grad().asnumpy()[TIE[1]])


def test_resnet_v1_gradient_by_finite_differences(ref, jax_run, v1_fp64):
    """The kink at TIE. Each package's own gradient of TIE's element jumps
    by over 10% when the element moves by TIE_STEP, the JAX package's
    downwards and the port's upwards: each package's loss has a kink
    within TIE_STEP of the seeded weights. Past it each package's gradient
    is the other's at the seeded weights (within 1e-5: fp32 summation
    order), so the two packages compute the two one-sided gradients of one
    loss. A central difference of the port's loss in fp64 (step 1e-6)
    gives the port's gradient."""
    init, c = jax_run["init"], TIE[1]
    jax_at_seed = float(jax_run["grads"][TIE[0]][c])
    with _jax_package():
        jax_past = _tie_grad(ref.mx, jax_run["block"], init, -TIE_STEP)
    with mxt.cpu():
        block = v1_fp64["block"]
        port_at_seed = _tie_grad(mxt, block, init, 0.0, "float64")
        port_past = _tie_grad(mxt, block, init, TIE_STEP, "float64")

        def loss(delta):
            net, x, y = block
            _set_params(mxt, net, init, delta, "float64")
            with mxt.autograd.train_mode():
                out = mxt.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
            return float(out.asnumpy().sum())

        step = float(np.float32(1e-6))  # as the fp32 weights hold it
        fd = (loss(step) - loss(-step)) / (2 * step)
    assert abs(jax_past - jax_at_seed) > 0.1 * abs(jax_at_seed)
    assert abs(port_past - port_at_seed) > 0.1 * abs(port_at_seed)
    np.testing.assert_allclose(jax_past, port_at_seed, rtol=1e-5)
    np.testing.assert_allclose(port_past, jax_at_seed, rtol=1e-5)
    np.testing.assert_allclose(port_at_seed, fd, rtol=1e-6)

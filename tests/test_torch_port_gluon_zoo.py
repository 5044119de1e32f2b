"""Parity of the PyTorch port's Gluon model zoo (ResNet v2) with the JAX
package, and its local weight cache.

``get_model('resnet18_v2', thumbnail=True, classes=10)`` at 32x32, batch
2, fp32: from the same weights (seeded Xavier in the JAX package, carried
by ``convert.gluon_params_from_numpy``), one training forward and
backward of the softmax cross entropy, imperative and hybridized, against
the JAX package's hybridized block (its imperative path gives the same
numbers): the logits, the loss, every parameter's gradient and
BatchNorm's moving statistics. v1 is held in
``tests/test_torch_port_gluon_zoo_v1.py``. The JAX run happens once, in a
module-scope fixture, with x64 off as users run the JAX package.
"""
import contextlib
import os
import types

import numpy as np
import pytest

import mxnet_tpu_torch as mxt

MODEL = "resnet18_v2"
BATCH, SIZE, CLASSES = 2, 32, 10
# fp32 on both sides, summation order only: logits, loss and gradients are
# held at 1e-5 of their own largest magnitude, the moving means at 1e-5 of
# their BatchNorm's largest moving standard deviation (a mean near 0 has
# no scale of its own)
REL = 1e-5


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


def _step(mx, name, hybrid, init=None):
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
    return out


@pytest.fixture(scope="module")
def jax_run(ref):
    with _jax_package():
        return _step(ref.mx, MODEL, True)


def _close(got, want, what, scale=None):
    mag = float(np.abs(want).max()) if scale is None else scale
    tol = REL * max(mag, 1e-6)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= tol, \
        f"{what}: max |err| {err:.3g} > {tol:.3g} (scale {mag:.3g})"


@pytest.mark.parametrize("hybrid", [False, True],
                         ids=["imperative", "hybridized"])
def test_resnet_v2_step_matches_jax(jax_run, hybrid):
    want = jax_run
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
        _close(got["grads"][k], want["grads"][k], f"gradient {k}")
    assert got["cached_ops"] == (1 if hybrid else 0)
    assert want["cached_ops"] == 1


def test_model_store_reads_a_local_file(tmp_path, monkeypatch):
    """pretrained=True loads <root>/<name>.params (never downloads); a
    missing file raises with the cache path."""
    with mxt.cpu():
        mxt.random.seed(1)
        net = mxt.gluon.model_zoo.vision.resnet18_v2(thumbnail=True,
                                                     classes=CLASSES)
        net.initialize(mxt.init.Xavier())
        x = mxt.nd.array(_batch()[0])
        want = net(x).asnumpy()
        net.save_params(str(tmp_path / "resnet18_v2.params"))
        monkeypatch.setenv("MXTPU_MODEL_ZOO_DIR", str(tmp_path))
        loaded = mxt.gluon.model_zoo.vision.get_model(
            "resnet18_v2", pretrained=True, thumbnail=True, classes=CLASSES)
        np.testing.assert_allclose(loaded(x).asnumpy(), want, rtol=1e-6)
        with pytest.raises(FileNotFoundError):
            mxt.gluon.model_zoo.vision.get_model("resnet34_v1",
                                                 pretrained=True)

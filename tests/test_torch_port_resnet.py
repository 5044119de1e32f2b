"""Parity of the PyTorch port's ResNet training with the JAX package.

Three ``Module`` steps (one ``fit`` epoch of three batches) of ResNet-18 v2 (imagenet stem,
40x40, batch 2, fp32, seeded ``Xavier``, SGD with momentum 0.9) leave the
outputs, parameters and moving statistics allclose to ``mxnet_tpu``'s;
a checkpoint with auxiliary states written by either package loads in
the other. JAX runs happen once, in module-scope fixtures, with x64 off as
users run the JAX package. Tests marked ``cuda`` train on the card and
skip without one (``python -m pytest --noconftest -m cuda
tests/test_torch_port_resnet.py``).
"""
import contextlib
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError

# ResNet-18 v2 with the imagenet stem (height > 32), as the tests train it
R18 = dict(num_layers=18, num_classes=10, image_shape="40,40,3")
BATCH, SIZE, STEPS = 2, 40, 3
# at batch 2 the last stage's BatchNorms see 8 values a channel, and the
# training is chaotic at larger rates: at lr 0.01 a 1e-6 relative
# perturbation of the init moves the port's own third update by 7% (in
# norm), past any parity tolerance; at lr 0.001 by 0.026%
SGD = {"learning_rate": 0.001, "momentum": 0.9}
# fp32 on both sides, summation order differs only: each parameter's and
# moving statistic's change over the three steps against the JAX
# package's (measured <= 4.7e-5 of the largest change), held at 5e-4 of
# the largest change of its kind; the softmax outputs at 1e-5
TRAIN_REL = 5e-4
OUT_ATOL = 1e-5


@contextlib.contextmanager
def _no_disk_cache():
    """The JAX package's programs compiled in this process only: its
    persistent compile cache stays off for the reference runs."""
    old = os.environ.get("MXTPU_COMPILE_CACHE")
    os.environ["MXTPU_COMPILE_CACHE"] = "0"
    try:
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
    import mxnet_tpu.models  # noqa: F401
    return types.SimpleNamespace(jax=jax, mx=mxnet_tpu)


def _batches():
    rng = np.random.RandomState(0)
    return [(rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
             rng.randint(0, R18["num_classes"], BATCH).astype(np.float32))
            for _ in range(STEPS)]


def _train(mx, ctx, prefix):
    """Seeded Xavier init, then one ``fit`` epoch of STEPS batches (the
    JAX package's fit runs its fused step, one program); the outputs of
    the last step, the parameters and auxiliary states, and a checkpoint
    at ``prefix``."""
    mx.random.seed(0)
    with mx.sym.NameManager():
        net = mx.models.get_symbol("resnet", **R18)
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (BATCH, SIZE, SIZE, 3))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(mx.init.Xavier())
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    data, label = (np.concatenate(a) for a in zip(*_batches()))
    mod.fit(mx.io.NDArrayIter(data, label, batch_size=BATCH), num_epoch=1,
            optimizer="sgd", optimizer_params=SGD)
    args, auxs = mod.get_params()
    mod.save_checkpoint(prefix, 3)
    return types.SimpleNamespace(
        init=init, output=mod.get_outputs()[0].asnumpy(),
        args={k: v.asnumpy() for k, v in args.items()},
        auxs={k: v.asnumpy() for k, v in auxs.items()})


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    root = tmp_path_factory.mktemp("resnet")
    with ref.jax.enable_x64(False), _no_disk_cache():
        jax_run = _train(ref.mx, ref.mx.cpu(), str(root / "jax"))
    port_run = _train(mxt, mxt.cpu(), str(root / "port"))
    return root, jax_run, port_run


def _assert_changes(got, want, start, what):
    """Each array's change from ``start`` against the reference's, within
    TRAIN_REL of the largest reference change among them."""
    scale = max(float(np.abs(want[n] - start[n]).max()) for n in want)
    assert scale > 0
    for name, value in want.items():
        err = float(np.abs(got[name] - value).max())
        assert err <= TRAIN_REL * scale, \
            f"{what} {name}: max |err| {err:.3g}, largest change {scale:.3g}"


def test_resnet18_module_steps_match_jax(runs):
    _, jax_run, port_run = runs
    for name, value in jax_run.init.items():
        np.testing.assert_array_equal(port_run.init[name], value,
                                      err_msg=name)
    np.testing.assert_allclose(port_run.output, jax_run.output, rtol=0,
                               atol=OUT_ATOL)
    assert sorted(port_run.args) == sorted(jax_run.args)
    for name, value in jax_run.args.items():
        # every weight moved (a gamma's step may stay under its ulp)
        if name.endswith("weight"):
            assert not np.array_equal(value, jax_run.init[name]), name
    _assert_changes(port_run.args, jax_run.args, jax_run.init, "parameter")
    assert sorted(port_run.auxs) == sorted(jax_run.auxs)
    # the moving statistics start at 0 (means) and 1 (variances)
    aux_init = {n: np.full_like(v, 1.0 if "var" in n else 0.0)
                for n, v in jax_run.auxs.items()}
    for name, value in jax_run.auxs.items():
        assert np.abs(value - aux_init[name]).max() > 0, name
    _assert_changes(port_run.auxs, jax_run.auxs, aux_init, "aux")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_with_aux_loads_in_the_other_package(ref, runs, writer):
    root, jax_run, port_run = runs
    written = {"jax": jax_run, "port": port_run}[writer]
    if writer == "jax":
        sym, args, auxs = mxt.model.load_checkpoint(str(root / "jax"), 3)
    else:
        with ref.jax.enable_x64(False):
            sym, args, auxs = ref.mx.model.load_checkpoint(
                str(root / "port"), 3)
    assert sorted(sym.list_auxiliary_states()) == sorted(written.auxs)
    for got, want in ((args, written.args), (auxs, written.auxs)):
        assert sorted(got) == sorted(want)
        for name, value in want.items():
            np.testing.assert_array_equal(got[name].asnumpy(), value)


def test_module_defaults_to_the_card():
    """Without a context the Module binds on gpu(0); on a machine without
    a card that raises, with no fall back to the CPU."""
    with mxt.sym.NameManager():
        net = mxt.models.get_symbol("resnet", **R18)
    mod = mxt.mod.Module(net)
    assert mod._context == mxt.gpu(0)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA"):
            mod.bind(data_shapes=[("data", (BATCH, SIZE, SIZE, 3))],
                     label_shapes=[("softmax_label", (BATCH,))])


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_port_resnet.py`")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_resnet18_module_steps_on_card_match_cpu(card, tmp_path):
    """The three Module steps on the default context (the card) against
    the port's CPU path, at the CPU parity tolerance."""
    on_card = _train(mxt, mxt.gpu(0), str(tmp_path / "card"))
    on_cpu = _train(mxt, mxt.cpu(), str(tmp_path / "cpu"))
    np.testing.assert_allclose(on_card.output, on_cpu.output, rtol=0,
                               atol=OUT_ATOL)
    _assert_changes(on_card.args, on_cpu.args, on_cpu.init, "parameter")
    aux_init = {n: np.full_like(v, 1.0 if "var" in n else 0.0)
                for n, v in on_cpu.auxs.items()}
    _assert_changes(on_card.auxs, on_cpu.auxs, aux_init, "aux")


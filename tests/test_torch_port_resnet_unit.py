"""Parity of the PyTorch port's ResNet units with the JAX package.

One bottleneck unit of each ResNet version (``residual_unit_v1`` and
``residual_unit_v2`` of ``models/resnet.py``: stride 2, projection
shortcut, 16 filters, NHWC, fp32) over one (2, 12, 12, 8) input, seeded
arguments, moving statistics and head gradients: one training forward and
backward through each package's executor, outputs, every gradient and
the moving statistics compared. The JAX run happens once, in a
module-scope fixture, with x64 off as users run the JAX package. The test
marked ``cuda`` runs the units on the card against the port's CPU path
and skips without one (``python -m pytest --noconftest -m cuda
tests/test_torch_port_resnet_unit.py``).
"""
import contextlib
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt

# fp32 forward and gradients through three convolutions and BatchNorms:
# summation order differs only (measured <= 1e-6 of each array's largest
# magnitude); held at 1e-5 of it
UNIT_REL = 1e-5


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


def _units(mx):
    """A bottleneck unit of each version (stride 2, projection shortcut,
    16 filters) over one NHWC input, as one grouped symbol: one JAX
    program for both."""
    with mx.sym.NameManager():
        data = mx.sym.var("data")
        return mx.sym.Group([
            unit(data, 16, (2, 2), False, f"v{v}", True, "NHWC")
            for v, unit in ((1, mx.models.resnet.residual_unit_v1),
                            (2, mx.models.resnet.residual_unit_v2))])


def _unit_run(mx, ctx, seed=7):
    """One training forward and backward of both units on (2, 12, 12, 8):
    outputs, gradients and auxiliary states by name."""
    net = _units(mx)
    exe = net.simple_bind(ctx=ctx, data=(2, 12, 12, 8))
    rng = np.random.RandomState(seed)
    for name in net.list_arguments():
        exe.arg_dict[name][:] = rng.normal(0, 0.5, exe.arg_dict[name].shape)
    for name in net.list_auxiliary_states():
        shape = exe.aux_dict[name].shape
        exe.aux_dict[name][:] = (rng.uniform(0.5, 1.5, shape) if "var" in name
                                 else rng.normal(0, 0.1, shape))
    exe.forward(is_train=True)
    heads = [rng.normal(0, 1, o.shape).astype(np.float32)
             for o in exe.outputs]
    exe.backward([mx.nd.array(h, ctx=ctx) for h in heads])
    return ({f"v{i + 1}": o.asnumpy() for i, o in enumerate(exe.outputs)},
            {n: g.asnumpy() for n, g in exe.grad_dict.items()},
            {n: a.asnumpy() for n, a in exe.aux_dict.items()})


def _assert_rel(got, want, rel, what):
    for name, value in want.items():
        err = float(np.abs(got[name] - value).max())
        mag = float(np.abs(value).max())
        assert err <= rel * max(mag, 1e-6), \
            f"{what} {name}: max |err| {err:.3g} at magnitude {mag:.3g}"


def _of_version(results, version):
    """The outputs, gradients and aux of one unit (the data's gradient
    sums both units')."""
    return [{n: v for n, v in r.items()
             if n.startswith(f"v{version}") or n == "data"} for r in results]


@pytest.fixture(scope="module")
def unit_runs(ref):
    with ref.jax.enable_x64(False), _no_disk_cache():
        want = _unit_run(ref.mx, ref.mx.cpu())
    return want, _unit_run(mxt, mxt.cpu())


@pytest.mark.parametrize("version", [1, 2])
def test_bottleneck_unit_matches_jax(unit_runs, version):
    want, got = (_of_version(r, version) for r in unit_runs)
    for g, w, what in zip(got, want, ("output", "gradient", "aux")):
        assert sorted(g) == sorted(w) and w
        _assert_rel(g, w, UNIT_REL, f"v{version} {what}")


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs, so that every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the chip run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_port_resnet_unit.py`")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_bottleneck_units_on_card_match_cpu(card):
    got = _unit_run(mxt, mxt.gpu(0))
    want = _unit_run(mxt, mxt.cpu())
    for g, w, what in zip(got, want, ("output", "gradient", "aux")):
        _assert_rel(g, w, UNIT_REL, what)

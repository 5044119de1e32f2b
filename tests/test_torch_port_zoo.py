"""Parity of the PyTorch port's CNN model zoo with the JAX package.

The builders of ``mxnet_tpu_torch/models/`` are copies of
``mxnet_tpu/models/``'s, host logic held bit for bit: every one at its
defaults, and ResNet-50 v1 and v2 in NHWC bf16 (as ``bench.py`` builds
it), in NCHW fp32 and with ``pipe_stages=4``, gives the same symbol JSON
(parsed), the same ``infer_shape`` and the same auxiliary states.
"""
import json
import types

import pytest

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError

# the zoo at its defaults, then ResNet-50 as bench.py builds it and in the
# reference's layout, and annotated for a 4-stage pipeline
BUILDERS = {
    "resnet": {}, "resnet-v1": {}, "alexnet": {}, "vgg": {}, "lenet": {},
    "mlp": {}, "googlenet": {}, "inception-bn": {}, "inception-v3": {},
    "inception-v4": {}, "inception-resnet-v2": {}, "mobilenet": {},
    "resnext": {},
    "resnet50_v2_nhwc_bf16": {"num_layers": 50, "version": 2,
                              "image_shape": "224,224,3",
                              "dtype": "bfloat16"},
    "resnet50_v1_nhwc_bf16": {"num_layers": 50, "version": 1,
                              "dtype": "bfloat16"},
    "resnet50_v2_nchw_fp32": {"num_layers": 50, "layout": "NCHW"},
    "resnet50_v1_nchw_fp32": {"num_layers": 50, "version": 1,
                              "layout": "NCHW"},
    "resnet50_v2_pipe4": {"num_layers": 50, "pipe_stages": 4},
}
# the data shape infer_shape starts from (NHWC unless the layout says)
IMAGE = {"lenet": (2, 28, 28, 1), "mlp": (2, 28, 28, 1),
         "inception-v3": (1, 299, 299, 3), "inception-v4": (1, 299, 299, 3),
         "inception-resnet-v2": (1, 299, 299, 3)}


def _network(name):
    kw = BUILDERS[name]
    return ("resnet", kw) if name.startswith("resnet50") else (name, kw)


def _build(mx, name):
    net, kw = _network(name)
    with mx.sym.NameManager():
        return mx.models.get_symbol(net, **kw)


def _data_shape(name):
    _, kw = _network(name)
    shape = IMAGE.get(name, (1, 224, 224, 3))
    if kw.get("layout") == "NCHW":
        shape = (shape[0], shape[3], shape[1], shape[2])
    return shape


@pytest.fixture(scope="module")
def ref():
    import jax
    import mxnet_tpu
    import mxnet_tpu.models  # noqa: F401
    return types.SimpleNamespace(jax=jax, mx=mxnet_tpu)


def _graph(sym):
    g = json.loads(sym.tojson())
    g["attrs"].pop("mxnet_tpu_version")  # each package's own version
    return g


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_symbol_json_and_shapes_match_jax(ref, name):
    with ref.jax.enable_x64(False):
        want = _build(ref.mx, name)
        want_shapes = want.infer_shape(data=_data_shape(name))
    got = _build(mxt, name)
    assert _graph(got) == _graph(want)
    assert got.infer_shape(data=_data_shape(name)) == want_shapes
    assert got.list_auxiliary_states() == want.list_auxiliary_states()


def test_pipe_stages_annotate_ctx_groups():
    groups = {d.get("ctx_group") for d in
              _build(mxt, "resnet50_v2_pipe4").attr_dict().values()}
    assert {"prologue", "epilogue", "stage0", "stage3"} <= groups


def test_transformer_lm_symbol_names_its_queue():
    with pytest.raises(MXNetError, match="A7"):
        mxt.models.get_symbol("transformer_lm")
    with pytest.raises(MXNetError, match="unknown network"):
        mxt.models.get_symbol("resnet-9000")


def test_symbol_arithmetic_matches_jax(ref):
    """The operators the builders compose with (ResNet's ``+``,
    Inception-ResNet's ``scale * x``) and the rest of the table."""
    def build(mx):
        with mx.sym.NameManager():
            a, b = mx.sym.var("a"), mx.sym.var("b")
            return mx.sym.Group([a + b, a + 1, 2 + a, a - b, a - 1.5, 3 - a,
                                 a * b, a * 2, 0.5 * a, a / b, a / 4, 1 / a,
                                 a ** b, a ** 2, -a])
    with ref.jax.enable_x64(False):
        want = build(ref.mx)
        want_shapes = want.infer_shape(a=(2, 3), b=(2, 3))
    got = build(mxt)
    assert _graph(got) == _graph(want)
    assert got.infer_shape(a=(2, 3), b=(2, 3)) == want_shapes

"""Model zoo: the JAX package's symbol-graph builders, and the transformer LM.

Counterpart of ``mxnet_tpu/models/__init__.py``. Each CNN builder is a copy
of the JAX package's (reference analogue:
``example/image-classification/symbols/``), host logic whose symbol JSON
is the same bit for bit; the builders default to NHWC layout and
channel-last BatchNorm, which cuDNN runs as channels_last, and the
reference's NCHW stays available via ``layout=``.
"""
from __future__ import annotations

from ..base import MXNetError
from . import (alexnet, googlenet, inception_bn, inception_resnet_v2,  # noqa: F401
               inception_v3, inception_v4, lenet, mlp,
               mobilenet, resnet, resnext, transformer, vgg)
from .transformer import TransformerConfig, TransformerLM  # noqa: F401


def _transformer_lm(**kwargs):
    raise MXNetError("get_symbol('transformer_lm') builds "
                     "models/transformer_sym.py, which ROADMAP A7 ports; the "
                     "transformer LM trains and serves through "
                     "models.transformer.TransformerLM")


_MODELS = {
    "resnet": resnet.get_symbol,
    "alexnet": alexnet.get_symbol,
    "vgg": vgg.get_symbol,
    "lenet": lenet.get_symbol,
    "mlp": mlp.get_symbol,
    "googlenet": googlenet.get_symbol,
    "resnet-v1": lambda **kw: resnet.get_symbol(
        **{**kw, "version": 1}),
    "inception-bn": inception_bn.get_symbol,
    "inception-v3": inception_v3.get_symbol,
    "inception-v4": inception_v4.get_symbol,
    "inception-resnet-v2": inception_resnet_v2.get_symbol,
    "mobilenet": mobilenet.get_symbol,
    "resnext": resnext.get_symbol,
    "transformer_lm": _transformer_lm,
}


def get_symbol(network: str, **kwargs):
    """Build a model symbol by name (reference: train_imagenet.py
    ``importlib.import_module('symbols.' + args.network).get_symbol``)."""
    if network not in _MODELS:
        raise MXNetError(
            f"unknown network {network!r}; available: {sorted(_MODELS)}")
    return _MODELS[network](**kwargs)

"""Vision model zoo: ResNet v1 and v2 as HybridBlocks.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/__init__.py``
(reference python/mxnet/gluon/model_zoo/vision/): ResNet v1 and v2 at
18, 34, 50, 101 and 152 layers and the ``get_model`` name registry;
``pretrained=True`` loads a cached ``.params`` file (``model_store``),
never downloads. The other families of the JAX package's zoo (alexnet,
densenet, inception, squeezenet, vgg) are queue A8's second half:
``get_model`` names them and raises.
"""
from ....base import MXNetError
from .resnet import (ResNetV1, ResNetV2, get_resnet,  # noqa: F401
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}

# the JAX package's other zoo names, not ported yet
_not_ported = (
    "alexnet", "densenet121", "densenet161", "densenet169", "densenet201",
    "inceptionv3", "squeezenet1.0", "squeezenet1.1", "vgg11", "vgg13",
    "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn")


def get_model(name, **kwargs):
    """Build a model by registry name (reference vision/__init__.py)."""
    name = name.lower()
    if name in _not_ported:
        raise MXNetError(
            f"model {name!r}: the zoo's alexnet, densenet, inception, "
            "squeezenet and vgg families are queue A8's second half, not "
            "ported yet; resnet v1 and v2 are")
    if name not in _models:
        raise MXNetError(
            f"model {name!r} is not in the zoo; available: "
            f"{sorted(_models)}")
    return _models[name](**kwargs)

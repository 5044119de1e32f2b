"""Gluon: the imperative-first high-level API (counterpart of
``mxnet_tpu/gluon``; reference python/mxnet/gluon/).

``Block``/``HybridBlock`` define models imperatively; ``hybridize()`` runs
a block through its cached ops (one a call signature). ``Trainer`` applies
an optimizer to ``Parameter``s in one fused update; ``loss``, ``nn``,
``rnn`` (layers and cells) and ``model_zoo.vision`` (ResNet) supply layers
and models; ``data`` the datasets, samplers and the DataLoader.
"""
from . import data  # noqa: F401
from . import loss  # noqa: F401
from . import model_zoo  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import utils  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import Constant, Parameter, ParameterDict  # noqa: F401
from .trainer import Trainer  # noqa: F401

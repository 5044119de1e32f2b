"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

It keeps the JAX package's API, symbol JSON and ``.params`` formats, and
imports neither JAX nor mxnet_tpu. Plain tensor code is PyTorch; each
Pallas kernel of the JAX package becomes a hand-written Hopper kernel
(``csrc/``) built at first use. Entry points run on the card unless the
caller asks for the CPU: the default context is ``gpu(0)``.

This slice serves the LSTM language model through the C predict
``Predictor`` and ``serving.PredictorBackend``.
"""
from . import c_predict, convert, ndarray, rnn, serving, symbol  # noqa: F401
from .base import MXNetError, __version__  # noqa: F401
from .context import Context, cpu, current_context, gpu, tpu  # noqa: F401
from .ops import OP_TABLE  # noqa: F401

nd = ndarray
sym = symbol

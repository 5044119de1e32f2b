"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

It keeps the JAX package's API, symbol JSON and ``.params`` formats, and
imports neither JAX nor mxnet_tpu. Plain tensor code is PyTorch; each
Pallas kernel of the JAX package becomes a hand-written Hopper kernel
(``csrc/``) built at first use. Entry points run on the card unless the
caller asks for the CPU: the default context is ``gpu(0)``.

It serves the LSTM language model through the C predict ``Predictor``
and ``serving.PredictorBackend``, and the transformer LM
(``models.transformer``) through ``serving.CallableBackend``. It has the
imperative path: ``nd`` (NDArray, ``save``/``load`` in the JAX package's
``.npz`` container, and the op functions generated from the table: the
math, tensor and optimizer-update ops), ``optimizer`` (SGD with momentum
and multi-precision, NAG, DCASGD, Adam, AdaGrad, RMSProp, AdaDelta, Ftrl,
Test; ``get_updater``), ``lr_scheduler``, and ``rtc``, whose bodies are
compiled to CUDA with NVRTC on the card.
"""
from . import (c_predict, convert, lr_scheduler, models,  # noqa: F401
               ndarray, optimizer, rnn, rtc, serving, symbol)
from .base import MXNetError, __version__  # noqa: F401
from .context import Context, cpu, current_context, gpu, tpu  # noqa: F401
from .ops import OP_TABLE  # noqa: F401

nd = ndarray
sym = symbol

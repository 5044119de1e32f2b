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
compiled to CUDA with NVRTC on the card. It trains symbol graphs: the
executor's backward (autograd, with the LSTM's backward a hand-written
kernel), ``mod.Module`` with ``fit``, ``init`` (the initializers),
``metric``, ``io`` (``NDArrayIter``), ``callback``, ``model``
(checkpoints) and ``random``; the CNN layer ops (cuDNN convolutions,
pooling, batch normalisation) and the JAX package's model zoo
(``models.get_symbol``: ResNet, ResNeXt, MobileNet, VGG, AlexNet, LeNet,
the MLP, GoogLeNet and the Inceptions). ``perf`` holds the fused training
step: ``Module.fit`` (and ``perf.module_stepper``) runs forward, backward
and the update as one step, one CUDA graph replay a step on the card,
with an optional bf16 cast over fp32 master weights. ``serving`` holds
the serving runtime: ``InferenceServer`` (admission, deadlines, the
circuit breaker, coalescing into warmed buckets) and ``InflightBatcher``
for decode, over ``Module.as_serving_backend()`` and the other backends,
with the ``config`` knobs, ``resilience`` pieces and
``compiler.batch_signature`` it reads. ``autograd`` (``record()``,
``backward()``, ``NDArray.attach_grad``) records imperative ops with torch
autograd, and ``gluon`` (blocks, hybridized cached ops, ``nn``, ``rnn``
layers over the RNN op and the stepwise cells, ``loss``, the fused-update
``Trainer``, ``data`` with its samplers and ``DataLoader``, the ResNet
zoo) trains models written as blocks. Sequences train through ``rnn``
(the symbolic cells, ``BucketSentenceIter``) and ``mod.BucketingModule``,
whose bucket modules share one set of parameter arrays;
``mod.SequentialModule`` and ``mod.PythonLossModule`` chain modules and
losses written in Python.
"""
from . import (analysis, autograd, c_predict, callback,  # noqa: F401
               compiler, config, convert, gluon, initializer, io,
               lr_scheduler, metric, model, models, module, ndarray,
               optimizer, perf, quant, random, resilience, rnn, rtc,
               serving, symbol)
from .base import MXNetError, __version__  # noqa: F401
from .context import Context, cpu, current_context, gpu, tpu  # noqa: F401
from .ops import OP_TABLE  # noqa: F401

nd = ndarray
sym = symbol
mod = module
init = initializer

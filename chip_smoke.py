#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It exits non-zero, and prints no result line, when there is no CUDA card or
no ``mxnet_tpu_torch`` package beside it. Every failure raises. Phases:

1. device: the card's name, capability, name and power limit; TF32 off;
2. build: every kernel library (four) built from ``mxnet_tpu_torch/csrc``
   by concurrent ``nvcc`` processes, with ``-Xptxas -v`` output, and the
   wgmma attention kernels' (forward and backward) registers, spills,
   wgmma serialization and shared memory a block; the register LSTM
   backward kernel's registers and spills (none allowed at
   ``<float, 8>``, the main path's), and beside them its two probe builds
   (``tools/probe_lstm_bwd.py``: without products, without copies) for
   phase 11's stage breakdown;
3. kernels: each kernel's wrapper on the card against its plain PyTorch
   version at its path's shapes and ragged ones, fp32 and bf16; the LSTM
   sequence kernel over T=128 steps at N=1 and 16 (H=1024) and T=7, N=3,
   H=200, forward and reverse; the dense and masked bf16 attention cases
   (D = 64 and 128, ragged, Sq < Sk, the transformer's (B, S, H, D) views,
   lengths, packed segments) through the wgmma/TMA variant, by its launch
   counter; and B5's rows (``phase_b5_kernels``): fp16 attention at D =
   64 and 128 on the wgmma/TMA, mma.sync and CUDA-core variants, D = 256
   (bf16, fp16) on mma.sync both ways, D = 320 and 588
   on CUDA cores, dense, lengths and packed, forward and gradients; B1
   at fp16 states and with fp32 xproj and w_h2h over bf16 and fp16
   states, both directions, on the sequence, register, shared-memory and
   per-step kernels; each launch held to its variant;
4. LSTM slice: the 2x1024 LSTM language model (V=10000, T=128, random
   weights from a seed) behind ``PredictorBackend(dev_type=2)`` answers 8
   requests of 1 and 16 rows, each forward one sequence-kernel launch a
   layer and no per-step launch; one request is answered again on the
   CPU. Then a one-layer LSTM LM at H=1536, whose weights do not fit in
   the sequence kernel's shared memory, answers 2 one-row requests through
   the per-step kernel (T launches a forward);
5. transformer slice: the transformer LM at ``TransformerConfig()``'s
   width (32000 vocab, 4 x 512, 8 heads, bf16, weights from seed 0)
   behind ``CallableBackend`` answers 8 requests of 1 and 4 rows at
   S=2048 and one of 1 row at S=1000; held against the port's CPU path in
   fp32 and against an fp32 forward on the card; each forward launches
   the wgmma/TMA attention variant 4 times;
6. masked attention: packed and length-masked batches through the public
   ``flash_attention(lengths=..., segment_ids=...)`` entry point, both on
   the wgmma/TMA variant;
7. timing: each kernel, its plain version and the nearest PyTorch library
   call with CUDA events; one LSTM layer (T=128, H=1024, fp32, N=1 and 16)
   through the sequence kernel, through 128 per-step launches, through its
   plain version and through cuDNN's ``torch.nn.LSTM`` (beside the port's
   input projection plus the kernel), and T grid barriers with no step
   body (the kernel's own and cooperative groups' grid sync); B2's wgmma/TMA variant, its earlier mma.sync variant and
   ``scaled_dot_product_attention`` in turns, each with TFLOP/s and share
   of bound, and the same for B3 with lengths and with packed segments
   (SDPA given the mask as a bool tensor); Predictor and transformer
   forward times; peak memory; B5's rows (``phase_b5_timing``): fp16 B2
   and B3 (lengths) forward and backward at (4, 8, 2048, 64) beside SDPA
   in fp16, bf16 at D = 256 (4, 8, 2048, 256) and fp32 at D = 320 beside
   SDPA, B1 at fp16 (T=256, N=64) beside cuDNN's fp16 LSTM and with bf16
   states over fp32 operands (T=64, N=16), each against its bound;
8. profile: device time by kernel over one forward per bucket of each
   model, and the device's idle share of it;
9. rtc kernels: Rtc bodies compiled by NVRTC (``csrc/rtc_runtime.cu``,
   ``ops/cuda/rtc_codegen.py``) against the plain version on the card's
   tensors: axpy at 8 and 2**24+3 elements, a two-output split, a
   transcendental body, a (4096,1024)+(1024,) broadcast, bf16 with
   ``.astype``, int32 floor ``//`` and ``%``, an aliased push, and one
   body under the default launch and under grid (4,1,1)/block (128,1,1),
   a misaligned view, a broadcast scalar and a bf16 body with n % 8 = 5;
   arithmetic bodies bit for bit, transcendental ones within 2 fp32 ulps,
   bf16 within one bf16 ulp; each push held to the kernel it must take
   (vector or scalar); NVRTC compile seconds and cache hits;
10. imperative path: the transformer LM's 12 parameter tensors
   (``init_params(0, TransformerConfig())``, 49,549,824 fp32 elements) as
   NDArrays on the card; three SGD-momentum steps through
   ``optimizer.get_updater(create('sgd', ...))`` and the same three steps
   as one Rtc body per parameter shape, held bit for bit equal; the same
   for a bf16 mixed-precision body against ``nd.mp_sgd_mom_update``; the
   updated weights through ``nd.save``/``nd.load`` bit for bit; every push
   of the path the vector kernel; ms per step of both, the vector and the
   scalar kernel on the largest tensor (in turns) against its bound, its
   plain version, axpy's against ``torch.add``, and peak memory;
11. training: the training forward (gates and c kept) and the backward
   kernels against their plain versions on the card's tensors, fp32 and
   bf16, both directions, each shape held to the kernel its plan must
   take: the register backward kernel (``lstm_seq_bwd_reg_kernel``,
   counted in ``lstm_sequence_backward.register_launches``) at (T,N,H) =
   (128,1,1024), (128,16,1024), the main path's (256,64,1024), (7,3,200),
   (7,37,200), (5,37,1024) and (1,5,100), each also through
   the shared-memory kernel and, bit for bit, through a second launch;
   the shared-memory kernel at (6,16,1032) and (4,3,1320); the per-step one at
   (8,1,1536);
   one forward_backward of the full-width LM (T=8, N=4) on the card and
   on the port's CPU path from the same seeded Xavier init, every
   gradient held to the CPU's; the benchmark's training shape (N=64,
   T=256, ``benchmarks/bench_lstm.py``): ``Module`` on the default
   context, Xavier, SGD (lr 0.5, no momentum), one ``fit`` epoch over 4
   batches, then 10 ``forward``/``backward``/``update`` steps on one
   batch at lr 0.5 / T (at 0.5 that training diverges; see
   ``TRAIN_STEP_LR``), each step 2 sequence forward and 2 sequence
   backward launches, both backwards on the register kernel, and no
   per-step one, every loss, output and parameter finite, and 10 steps
   from the same init at lr 0.5 / T, whose loss must fall; the fit epoch
   and the 5 steps before divergence at lr 0.5, through the kernels and
   through the plain backward on the card, the losses within
   ``BENCH_LR_TOL`` of each other; ms per step,
   tokens/s, peak memory, one profiled step; one training step of the
   one-layer H=1536 LM through the per-step kernels (T and T + 1
   launches); the backward sequence kernels side by side (the register
   kernel, the shared-memory kernel, and the register kernel's probe
   builds without products and without copies) against their bound
   and the plain loop, and the port's whole layer backward against
   cuDNN's LSTM backward on the same inputs, at T=128, N=1 and 16, and at
   the bench shape;
12. transformer training: (a) the attention backward kernels
   (``csrc/flash_attention_bwd.cu``) through the autograd Functions
   against the plain backward versions on the card's tensors, fp32 and
   bf16, every bf16 case on the wgmma/TMA variant (by its counter): dense
   at the model's (4,8,2048,64) causal, (2,3,1000,1000,64) non-causal,
   (2,2,77,200,128) causal Sq < Sk, (2,8,500,500,64) as (B,S,H,D) views,
   (1,2,77,77,40) fp32 (the CUDA-core variant) and one token; masked with
   ATT_LENGTHS and with packed segments at the model's shape, packed at
   D = 128 and one fp32 case, the gradients of rows and keys the mask
   leaves alone exact 0; each case's forward row logsumexps (the Hopper,
   mma.sync and CUDA-core forwards) against ``attention_lse_plain``; every
   bf16 case at D = 64 or 128 also through the earlier mma.sync backward
   (``_mma_sync_backward``, given the forward's lse) against the same
   plain result, tolerance and exact zeros; then the masked core's
   training path (a packed and a length-masked batch
   through the public ``flash_attention`` and ``torch.autograd.grad``,
   both backwards on the wgmma/TMA variant); (b) one ``lm_loss`` gradient of the
   full-width LM in fp32 (B=2, S=128, ``init_params(0, cfg)``) on the card
   and on the port's CPU path, each gradient within 1e-5 of its own
   largest; (c) ``TransformerLM(TransformerConfig(), seed=0)`` on the
   default context, 10 ``train_step``s on one batch of (4, 2049) tokens
   at lr 1e-3: 4 dense forward and 4 dense backward launches a step, the
   backwards on the wgmma/TMA variant, every loss and parameter finite,
   the loss falling; (d) ms per step (CUDA events, median of 7), tokens/s
   against the step's bound, peak memory, one profiled step; (e) one
   backward call at the model's shape, dense, with ATT_LENGTHS and with
   packed segments, in turns: the wgmma/TMA variant, the earlier mma.sync
   variant and ``scaled_dot_product_attention``'s autograd backward on the
   same inputs; each variant's kernels by stage, the bound, the plain
   version; and the forward with and without the lse kept, in turns;
13. ResNet-50 training: one LSTM layer's forward at the LSTM bench's
   training shape (T=256, N=64, fp32; the port's projection plus the
   sequence kernel, the kernel alone and cuDNN's ``torch.nn.LSTM``, in
   turns, for B1's library time); (a) the CNN ops (Convolution, Pooling,
   BatchNorm with its moving updates, Activation, LRN) on the card
   against the port's CPU path, forward and every input gradient, fp32
   with TF32 off and bf16, at ResNet-50's shapes (the stem's 7x7/2
   convolution on 224**2, a bottleneck's 3x3, a strided 1x1 projection,
   the stem's max pool over tied windows, the global pool, the stem's
   BatchNorm) and ragged ones, and Dropout's statistics; (b) one training
   forward_backward of ResNet-50 v2 at 224**2, batch 2, from seeded
   Xavier, on the card and on the CPU path in fp64 and fp32 (every array
   held; fp32 against the CPU fp32's own distance from fp64); (c)
   ``bench.py``'s bench_resnet configuration through ``Module`` on the
   default context (ResNet-50 v2, NHWC, bf16 over fp32 masters, batch
   256, seeded Xavier, SGD lr 0.1, momentum 0.9, rescale 1/256, one
   seeded batch): 10 forward/backward/update steps, every loss, output,
   parameter and moving statistic finite, the moving statistics moved,
   the loss falling, none of the hand-written kernels launched; 7 timed
   steps (CUDA events), img/s against the bound of the symbol's
   convolution and fully connected products (2 x 3 x MACs at 989.4
   TFLOP/s bf16), peak memory, and one profiled step by kernel and by
   kind, with any transpose kernel named. Phases 11 and 13 run under
   ``MXTPU_FUSED_STEP=0``: ``fit`` on forward_backward and update,
   ``Module.update`` one updater call a parameter (the classic path);
14. the fused training step (``perf.module_stepper(mod,
   compute_dtype="bfloat16")``, one CUDA graph captured after a warm-up
   and replayed a step) on (a) the LSTM LM at the bench's training shape
   (lr 0.5 / T) and (b) ResNet-50 at ``bench.py``'s configuration: 10
   steps on one batch with exactly one capture, every loss finite and
   the last below the first (ResNet: its moving statistics moved), B1's
   wrappers called only in the warm-up and the capture and its kernels
   counted by name in a profiled replay (2 + 2), 7 timed steps (CUDA
   events), device busy, idle share, peak memory; beside them, from the
   same seeded init, 3 replayed steps against the same body run eagerly
   on the card, fp32 fused steps against forward/backward/update, and
   ``Module.update``'s fused path against the per-parameter updater,
   and the classic step's time (with the fused update) in the same run;
   (c) one ``Module.fit`` epoch that takes the fused step, then
   ``get_params`` and ``save_optimizer_states``;
15. serving (``mxnet_tpu_torch.serving``): (a) phase 4's LM, its answers
   swapped batch-major, bound through ``Module`` at 16 rows and served
   through ``mod.as_serving_backend()`` and ``InferenceServer(max_batch=
   16, workers=1, batch_wait=0.002, capacity=64, default_deadline=120)``
   after ``warm_up()``: an open-loop burst of 64 single-row requests, then
   the same burst at ``max_batch=1, buckets=[1]``; every answer within
   ``PROB_TOL`` of the same row through the port's CPU path, and the
   answers rolled by one row outside it, 2 sequence launches a dispatch
   and no per-step one; (b) phase 5's transformer LM
   behind ``CallableBackend`` at S=2048, ``max_batch=4``: 8 single-row
   requests, each answer within ``BF16_LOGIT_TOL`` of ``lm.logits`` on
   that row alone, 4 wgmma attention launches a dispatch; (c) a one-step
   LSTM at the LM's width (input and H 1024, a FullyConnected head of
   10000) through ``ModuleStepBackend`` and ``InflightBatcher`` at
   capacity 16 for 32 steps, one leave and join at step 16, both churned
   sequences bit for bit their solo decodes, no retrace. Every request
   completes; none fails, degrades, is shed or abandoned, or runs at an
   unwarmed shape; the circuit stays closed; no fallback is configured
   and every result is read, so a kernel's failure fails the run; no
   kernel library is built after a warm-up. Requests/s batched and
   unbatched, p50 and p99 latency, dispatches, warmed buckets, pad
   waste, decode tokens/s and one profiled dispatch a model (busy, idle
   share, the output copy's share), each with the card's name and power
   limit;
16. imperative autograd and Gluon: (a) bench_lstm.py's LM written as a
   Gluon ``HybridBlock`` (``nn.Embedding``, ``rnn.LSTM(1024,
   num_layers=2, layout='TNC')``, a reshape, ``nn.Dense(10000,
   flatten=False)``, ``SoftmaxCrossEntropyLoss``; seeded Xavier) at N=64,
   T=256, fp32, trained imperative and then hybridized, 10
   ``autograd.record()``/``backward()``/``trainer.step(N*T)`` steps each
   on the repeated first batch (``gluon.Trainer`` SGD at lr 0.5: the
   per-token mean's step): every step 2 ``lstm_seq_kernel`` and 2
   ``lstm_seq_bwd_reg_kernel`` launches and no per-step one, the fused
   update captured once, the loss falling, one cached op hybridized; ms
   per step (CUDA events, median of 7), the host clock, one profiled step,
   peak memory, beside phase 11's Module step; one Gluon step against
   Module's classic step on the card from the same weights (the LSTM
   pieces packed into ``lstm_parameters``, ``convert.pack_rnn_pieces``)
   and batch, the mean loss and every gradient within 1e-5 of its largest
   magnitude; the full-width step at N=4, T=16 against the port's CPU
   path (loss 1e-5, gradients 1e-4); (b) ``nn.MultiHeadAttention`` (d_model
   512, 8 heads, bf16, causal) forward and backward under ``record()`` at
   (4, 2048): one wgmma forward and one wgmma backward launch; at S=256
   against the CPU path at ATT_BWD_BF16_TOL; (c)
   ``model_zoo.vision.get_model('resnet50_v2')`` hybridized, fp32 NCHW,
   batch 64 at 224**2: 10 SGD-momentum steps on one seeded batch, the
   loss falling, every moving statistic moved, one cached op a (shape,
   train) key, no hand-written kernel, ms per step;
17. sequences: B1 forward and backward (the register kernel, by its plan
   at N=32) against their plain versions at (T, N, H) = (10, 32, 1024) and
   (60, 32, 1024), fp32, both directions, and one layer at each shape
   timed against its bound; (a) upstream MXNet's
   ``example/rnn/lstm_bucketing.py`` at the bench's width (Embedding
   10000 -> 1024, ``FusedRNNCell(1024, num_layers=2)`` unrolled NTC,
   FullyConnected(10000), ``SoftmaxOutput`` ignoring label 0; buckets
   10-60, batch 32, SGD lr 0.01) over a seeded synthetic corpus of 4
   batches a bucket: ``BucketSentenceIter`` and ``BucketingModule.fit`` for
   one epoch on the default context, every bucket used, every step 2
   ``lstm_seq_kernel`` and 2 ``lstm_seq_bwd_reg_kernel`` launches and no
   per-step one, every bucket's module holding the default module's
   parameter and gradient NDArrays, one capture of the fused update for
   all six buckets, the corpus perplexity falling; ms a step by bucket
   (CUDA events), tokens/s, one profiled step at T=60 (B1's kernels
   counted by name), peak memory; one step of the buckets 10 and 20 at
   N=4 on the card and on the port's CPU path from the same weights (loss
   1e-5, gradients 1e-4 of their largest); (b) ``FusedRNNCell(1024,
   2).unfuse()``, the fused weights carried by ``unpack_weights``, on the
   bucket T=20, N=32: outputs and gradients within SEQ_FP32_TOL of the
   fused graph's, no B1 launch (the fused graph 2 + 2); (c) a Gluon
   ``SequentialRNNCell`` of two ``LSTMCell(1024)`` unrolled under
   ``record()`` against ``gluon.rnn.LSTM(1024, num_layers=2)`` from the
   same weights, fed by ``DataLoader(ArrayDataset(...), batch_size=32,
   shuffle=True)`` at T=35: logits and gradients within SEQ_FP32_TOL, B1
   launched only on the layer's side;
18. B5, the dtypes and head dims (``phase_b5``): (a) the transformer LM at
   ``TransformerConfig(dtype="float16")``'s width behind
   ``CallableBackend`` answers requests of 1 and 4 rows at S=2048 (4
   fp16 wgmma forwards each), then takes 5 ``train_step``s (4 forward
   and 4 wgmma backward launches a step, the loss falling), its logits
   within FP16_LOGIT_TOL of an fp32 forward on the card; (b) the LM at
   ``TransformerConfig(d_model=2048, num_heads=8)`` (bf16, head dim 256,
   399.5 M parameters) answers one request of 4 rows (4 mma.sync
   forwards at D = 256) and takes 3 ``train_step``s (4 mma.sync
   backwards a step), its logits within BF16_LOGIT_REL of its largest fp32
   logit; (c) ``_contrib_flash_attention`` through ``mx.nd`` under
   ``record()`` at fp16 D = 64, bf16 D = 256 and fp32 D = 320, output
   and gradients against the plain versions; (d) phase 16's Gluon LSTM
   LM cast to fp16 with fp16 begin states answers a batch and takes 3
   ``record()``/``backward()``/``Trainer.step()`` steps, each 2
   ``lstm_seq_kernel`` and 2 register-kernel backward launches at fp16,
   the losses finite; (e) ``nd.RNN`` (2 x 1024, T=64, N=16) with bf16
   states over fp32 data and parameters, card against the CPU path;
19. B4's body language (``phase_rtc_language``): (a) each form at
   moderate sizes ((4096, 1024) and full sums of 2**24 elements): views,
   partial stores, row, column and split full reductions, max/min/argmax
   with NaNs, softmax, fp32/bf16/fp16/int32 and batched products, int8,
   uint8 and bool, library functions and unrolled loops, each output
   against the plain version on the card's tensors within its stated
   tolerance and each stage kind's launches held to the stage plan; (b)
   B1's own Pallas body (``_gates`` and ``_lstm_kernel``) as an Rtc at
   N=64, H=1024, fp32 and with bf16 states over fp32 xproj, against
   ``lstm_cell_plain`` and B1's kernel and timed beside them; (c) the
   transformer LM's logits on (4, 2048) tokens through one body writing
   logp (8192, 32000) and lse (8192,), against ``F.log_softmax`` and the
   plain version, timed beside ``torch.log_softmax``; (d) the head product
   (8192, 512) x (512, 32000) in fp32 and bf16 beside ``torch.matmul``;
   (e) global-norm clipping of the LM's 49.5 M gradients on phase 10's
   SGD-momentum path (a sum-of-squares body a parameter, a fold into the
   scale, the update reading it as a 0-d Ref) against the same steps in
   torch, the norm beside ``torch.linalg.vector_norm``.

Each path (4 and its wide LSTM, 5, 6, 10, 11 and its wide LM, 12's masked
training path, 12c, 13c, 14a, 15's served bursts, 16's Gluon LM (each
mode) and attention layer, 17a's epoch, 18a-e, and 19b-e) sets its kernels' launch
counts to 0 (13c and 16c: read them) just before it runs and reads them
just after, and fails if a kernel of the path was not launched (13c and
16c: if any hand-written kernel was). Its last lines are a ``{"kernels": [...]}`` JSON line, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
import contextlib
import functools
import json
import math
import os
import re
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

# fp32 tolerance: only the summation order differs from the plain version
FP32_TOL = 2e-5
# the LSTM sequence kernel against its plain version in fp32: each step
# differs in summation order only, and the differences compound through
# the recurrence over 128 steps
SEQ_FP32_TOL = 1e-4
# bf16 tolerance, compared in bf16: two bf16 ulps at 1.0
BF16_TOL = 1.6e-2
# card against the port's CPU path on the LM's probabilities, both fp32:
# only summation order differs (5.8e-11 to 7.3e-11 measured on the H100).
# A 10000-way softmax over these weights puts every probability near
# 1/V = 1e-4 and a row's own input moves it by about 1e-6, so the limit
# sits two orders below that; held_probs shows each run that answers
# rolled by one row fail it
PROB_TOL = 1e-8
# bf16 attention output against its plain version, compared in fp32: two
# bf16 ulps at the reference's magnitude (at least 1.0)
BF16_REL_TOL = 2.0 ** -6
# transformer logits, card against the port's CPU path, both fp32 with
# TF32 off: only summation order differs, through 4 layers
LOGIT_TOL = 1e-4
# bf16 transformer logits against an fp32 forward of the same weights on
# the card: bf16 activations round at ~2**-9 relative through 4 layers,
# and the logits of these random weights reach |2.4|; 0.1 is 4% of that
BF16_LOGIT_TOL = 0.1
# published H100 SXM peaks (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989.4e12

V, H, LAYERS, T = 10000, 1024, 2, 128
BUCKETS = (1, 16)
# an LSTM width whose weights do not fit in the sequence kernel's shared
# memory on an H100 (ops/cuda/lstm.py:sequence_fits)
WIDE_H = 1536
# (T, N, H) of the sequence kernel's checks
SEQ_CASES = ((T, 1, H), (T, 16, H), (7, 3, 200))

# the transformer LM: TransformerConfig() defaults, requests of 1 and 4 rows
TF_S = 2048
TF_BUCKETS = (1, 4)
# (B, H, S, D) of the transformer's attention at its largest bucket
ATT_SHAPE = (4, 8, 2048, 64)
ATT_LENGTHS = [2048, 1500, 700, 0]


def log(*args):
    print(*args, flush=True)


def nvidia_smi_name_and_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} capability "
        f"{torch.cuda.get_device_capability(0)} count "
        f"{torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {nvidia_smi_name_and_limit()}")


@functools.lru_cache(maxsize=None)
def probe_tool():
    """tools/probe_lstm_bwd.py beside this script, as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "probe_lstm_bwd.py")
    spec = importlib.util.spec_from_file_location("probe_lstm_bwd", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_build():
    """Every kernel library, built by concurrent nvcc processes, and the
    register backward kernel's two probe builds (phase 11's stage
    breakdown) beside them: (the wgmma attention kernels' ptxas summaries,
    the register backward kernel's, {probe: the build's future})."""
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops.cuda.rtc import nvrtc_version
    probe = probe_tool()
    pool = ThreadPoolExecutor(len(probe.PROBES))
    probe_builds = {p: pool.submit(probe.build_probe, p) for p in probe.PROBES}
    pool.shutdown(wait=False)
    t0 = time.perf_counter()
    results = _build.build()
    log(f"[build] {len(results)} libraries in "
        f"{time.perf_counter() - t0:.3f} s (wall, concurrent nvcc)")
    for name, res in results.items():
        log(f"[build] {name}: {res.path} nvcc {res.seconds:.3f} s")
        for line in res.log.strip().splitlines():
            log(f"[build]   {line}")
    log(f"[build] NVRTC {nvrtc_version()}")
    from mxnet_tpu_torch.ops.cuda.attention import (
        wgmma_backward_shared_bytes, wgmma_shared_bytes)
    return (wgmma_build_summary(results["flash_attention"].log,
                                "flash_fwd_wgmma_kernel", wgmma_shared_bytes),
            wgmma_build_summary(results["flash_attention_bwd"].log,
                                "flash_bwd_wgmma_kernel",
                                wgmma_backward_shared_bytes),
            register_backward_build_summary(results["lstm_cell"].log),
            probe_builds)


def ptxas_summary(log_text, kernel):
    """{mangled instantiation: {"registers": n, "spills": ptxas's line}}
    for each instantiation of ``kernel`` in a library's build log."""
    out, current = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if kernel in line else None
        elif current and "spill stores" in line:
            out.setdefault(current, {})["spills"] = line.strip()
        elif current and "Used" in line and "registers" in line:
            out.setdefault(current, {})["registers"] = int(
                line.split("Used")[1].split("registers")[0])
    return out


def register_backward_build_summary(log_text):
    """ptxas's registers and spills for the register backward kernel's
    instantiations (``lstm_seq_bwd_reg_kernel<T, units>``); raises when
    the main path's, ``<float, 8>``, spills: its weights live in
    registers."""
    out = ptxas_summary(log_text, "lstm_seq_bwd_reg_kernel")
    for name, info in out.items():
        log(f"[build] register backward kernel {name}: {info}")
    main = [info for name, info in out.items()
            if "lstm_seq_bwd_reg_kernelIfLi8E" in name]
    if len(main) != 1:
        raise RuntimeError(f"no lstm_seq_bwd_reg_kernel<float, 8> in the "
                           f"build log: {sorted(out)}")
    if " 0 bytes spill stores, 0 bytes spill loads" not in (
            " " + main[0]["spills"]):
        raise RuntimeError(f"lstm_seq_bwd_reg_kernel<float, 8> spills: "
                           f"{main[0]}")
    return {"ptxas": out, "float_8": main[0],
            "setmaxnreg": setmaxnreg_in_source()}


def setmaxnreg_in_source():
    """The register counts the kernels' setmaxnreg instructions set in
    ``csrc/lstm_cell.cu`` as this checkout has it: {"inc": n, "dec": n}
    (constants of the source, not measurements)."""
    from mxnet_tpu_torch import _build
    text = (_build.CSRC / _build.SOURCES["lstm_cell"]).read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"setmaxnreg\.(inc|dec)\.sync\.aligned\.u32 (\d+)", text)}


def wgmma_build_summary(log_text, kernel, shared_bytes):
    """ptxas's registers and spills for each instantiation of a Hopper
    attention kernel (``kernel``, the forward's or the backward's), any
    wgmma serialization its library reports, and the shared memory a
    block of it takes (``shared_bytes(d)``)."""
    out = ptxas_summary(log_text, kernel)
    serialized = [line.strip() for line in log_text.splitlines()
                  if "wgmma" in line and "serialized" in line]
    smem = {d: shared_bytes(d) for d in (64, 128)}
    for name, info in out.items():
        log(f"[build] wgmma kernel {name}: {info}")
    log(f"[build] {kernel} shared memory a block: {smem} bytes (D: "
        f"bytes); wgmma serialized: {serialized or 'none reported'}")
    if not out:
        raise RuntimeError(f"no {kernel} in its library's build log")
    return {"ptxas": out, "serialized": serialized, "smem_bytes": smem}


def cell_inputs(n, hdim, dtype, seed):
    """LSTM-cell inputs at the LM's scale: |h|, |c| < 1 as a cell's state
    is, weights uniform +-0.05 as the smoke's model draws them."""
    rng = np.random.RandomState(seed)
    arrays = (rng.normal(0, 1, (n, 4 * hdim)),
              rng.uniform(-1, 1, (n, hdim)),
              rng.uniform(-1, 1, (n, hdim)),
              rng.uniform(-0.05, 0.05, (4 * hdim, hdim)))
    return [torch.tensor(a, dtype=dtype, device="cuda") for a in arrays]


def bf16_state_tol(ref):
    """Two bf16 ulps at the largest magnitude of ``ref``."""
    mag = ref.float().abs().max().item()
    return 2 * 2.0 ** (math.floor(math.log2(mag)) - 7) if mag else 0.0


def sequence_inputs(steps, n, hdim, dtype, seed):
    """xproj (T,N,4H) and the cell inputs' h0, c0, w_h2h at the LM's scale."""
    rng = np.random.RandomState(seed)
    xproj = torch.tensor(rng.normal(0, 1, (steps, n, 4 * hdim)), dtype=dtype,
                         device="cuda")
    return [xproj] + cell_inputs(n, hdim, dtype, seed + 1)[1:]


def phase_sequence_kernel():
    """The sequence kernel against lstm_sequence_plain; returns the worst
    fp32 error and the worst bf16 error in bf16 ulps of the state."""
    from mxnet_tpu_torch.ops.cuda.lstm import (lstm_cell_fused,
                                               lstm_sequence_fused,
                                               lstm_sequence_plain)
    errs = {"fp32": 0.0, "bf16_ulps": 0.0}
    for steps, n, hdim in SEQ_CASES:
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            args = sequence_inputs(steps, n, hdim, dtype, seed=steps + n + hdim)
            for reverse in (False, True):
                before = (lstm_sequence_fused.launches,
                          lstm_cell_fused.launches)
                got = lstm_sequence_fused(*args, reverse=reverse)
                torch.cuda.synchronize()
                if (lstm_sequence_fused.launches, lstm_cell_fused.launches) != (
                        before[0] + 1, before[1]):
                    raise RuntimeError("lstm_sequence: not one launch of the "
                                       "sequence kernel")
                want = lstm_sequence_plain(*args, reverse=reverse)
                worst = []
                for name, g, w in zip(("out", "hT", "cT"), got, want):
                    if g.dtype != dtype or g.shape != w.shape:
                        raise RuntimeError(f"lstm_sequence {name}: {g.dtype} "
                                           f"{tuple(g.shape)}")
                    tol = SEQ_FP32_TOL if tag == "fp32" else bf16_state_tol(w)
                    err = (g.float() - w.float()).abs().max().item()
                    if not err <= tol:
                        raise RuntimeError(
                            f"lstm_sequence {tag} T={steps} N={n} H={hdim} "
                            f"reverse={reverse} {name} disagrees with its "
                            f"plain version: {err} > {tol}")
                    worst.append(err if tag == "fp32" else 2 * err / tol)
                log(f"[kernels] lstm_sequence T={steps} N={n} H={hdim} {tag} "
                    f"reverse={reverse}: max|d| out, hT, cT "
                    + ", ".join(f"{e:.3e}" for e in worst)
                    + (f" (tol {SEQ_FP32_TOL})" if tag == "fp32"
                       else " bf16 ulps of the state (tol 2)"))
                key = "fp32" if tag == "fp32" else "bf16_ulps"
                errs[key] = max(errs[key], *worst)
    return errs


def phase_kernels():
    """The per-step kernel against lstm_cell_plain at the served widths, a
    ragged one and the wide LM's (1, WIDE_H); returns the errors by (N, H)
    and dtype."""
    from mxnet_tpu_torch.ops.cuda.lstm import lstm_cell_fused, lstm_cell_plain
    errs = {}
    for n, hdim in ((1, 1024), (16, 1024), (3, 200), (1, WIDE_H)):
        for tag, dtype, tol in (("fp32", torch.float32, FP32_TOL),
                                ("bf16", torch.bfloat16, BF16_TOL)):
            args = cell_inputs(n, hdim, dtype, seed=n * 1000 + hdim)
            before = lstm_cell_fused.launches
            h_k, c_k = lstm_cell_fused(*args)
            torch.cuda.synchronize()
            if lstm_cell_fused.launches != before + 1:
                raise RuntimeError("lstm_cell: the launch counter did not move")
            h_p, c_p = lstm_cell_plain(*args)
            if h_k.dtype != dtype or c_k.dtype != dtype:
                raise RuntimeError(f"lstm_cell: output dtype {h_k.dtype}")
            err = max((h_k.float() - h_p.float()).abs().max().item(),
                      (c_k.float() - c_p.float()).abs().max().item())
            log(f"[kernels] lstm_cell N={n} H={hdim} {tag}: max|d| {err:.3e} "
                f"(tol {tol})")
            if not err <= tol:
                raise RuntimeError(f"lstm_cell {tag} N={n} H={hdim} disagrees "
                                   f"with its plain version: {err} > {tol}")
            errs.setdefault((n, hdim), {})[tag] = err
    return errs


def build_lm(mx, vocab, hidden, layers, seq_len, train=False):
    """bench_lstm.py's model: for serving with an un-reshaped
    softmax_label, for training (``train``) with the label (N, T)
    reshaped in the graph as bench_lstm.py:39-49 does."""
    data = mx.sym.var("data")
    embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=hidden,
                             name="embed")
    embed = mx.sym.SwapAxis(embed, dim1=0, dim2=1)  # NTC -> TNC
    stack = mx.rnn.FusedRNNCell(hidden, num_layers=layers, mode="lstm",
                                prefix="lstm_")
    out, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True,
                          layout="TNC")
    pred = mx.sym.Reshape(out, shape=(-1, hidden))
    pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
    label = mx.sym.var("softmax_label")
    if train:
        label = mx.sym.Reshape(label, shape=(-1,))
    return mx.sym.SoftmaxOutput(pred, label, name="softmax")


def check_probs(out, rows):
    if out.shape != (rows * T, V):
        raise RuntimeError(f"output shape {out.shape} != {(rows * T, V)}")
    if not np.isfinite(out).all():
        raise RuntimeError("non-finite probabilities")
    dev = np.abs(out.sum(axis=1, dtype=np.float64) - 1.0).max()
    if not dev <= 1e-4:
        raise RuntimeError(f"probability rows sum to 1 +- {dev}")


def held_probs(got, want, label):
    """Largest |got - want| over probability rows stacked on axis 0 (one
    a request row), within PROB_TOL. The same rows rolled by one must
    differ by more than PROB_TOL, or the check could not tell a request
    given another row's answer from its own."""
    err = float(np.abs(got - want).max())
    rolled = float(np.abs(np.roll(got, 1, axis=0) - want).max())
    log(f"[{label}] card against CPU, {len(want)} rows: max|d| prob "
        f"{err:.3e} (tol {PROB_TOL}); rolled by one row {rolled:.3e}; "
        f"largest prob {float(want.max()):.3e}")
    if not err <= PROB_TOL:
        raise RuntimeError(f"[{label}] card and CPU disagree: {err} > "
                           f"{PROB_TOL}")
    if not rolled > PROB_TOL:
        raise RuntimeError(f"[{label}] answers rolled by one row are within "
                           f"{rolled} <= {PROB_TOL} of the CPU path")
    return err, rolled


def phase_slice():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda.lstm import (lstm_cell_fused,
                                               lstm_sequence_fused)
    from mxnet_tpu_torch.serving import PredictorBackend

    net = build_lm(mx, V, H, LAYERS, T)
    symbol_json = net.tojson()
    arg_shapes, _, _ = net.infer_shape(data=(1, T))
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.05, 0.05, s).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    param_bytes = mx.convert.params_to_bytes(params, {})
    log(f"[slice] LM V={V} H={H} layers={LAYERS} T={T}: "
        f"{sum(p.size for p in params.values())} parameters, "
        f"{len(param_bytes)} .params bytes")
    reqs = np.random.RandomState(1)
    requests = [reqs.randint(0, V, (rows, T)).astype(np.float32)
                for rows in BUCKETS * 4]

    torch.cuda.reset_peak_memory_stats()
    # the main path's run starts here
    lstm_sequence_fused.launches = lstm_cell_fused.launches = 0
    backend = PredictorBackend(symbol_json, param_bytes, row_shape=(T,),
                               dev_type=2)
    backend.load()
    per_forward = []

    def counts():
        return lstm_sequence_fused.launches, lstm_cell_fused.launches

    for rows in BUCKETS:
        before = counts()
        backend.bind_bucket(rows)  # binds and runs one forward
        per_forward.append(tuple(a - b for a, b in zip(counts(), before)))
    answers = []
    for batch in requests:
        before = counts()
        (out,) = backend.infer({"data": batch})
        per_forward.append(tuple(a - b for a, b in zip(counts(), before)))
        check_probs(out, batch.shape[0])
        answers.append(out)
    launches, cell_launches = counts()  # the main path's run ends here
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] {len(requests)} requests answered; (lstm_sequence, "
        f"lstm_cell) launches per forward {per_forward}; total "
        f"{(launches, cell_launches)}; peak device memory {peak} bytes")
    if any(n != (LAYERS, 0) for n in per_forward):
        raise RuntimeError(f"(lstm_sequence, lstm_cell) launched "
                           f"{per_forward} times per forward, expected "
                           f"{(LAYERS, 0)}")

    # the same bytes on the CPU's plain path, for the first 4 rows of a
    # 16-row request (rows of a batch are independent)
    cpu = PredictorBackend(symbol_json, param_bytes, row_shape=(T,),
                           dev_type=1)
    big = next(i for i, r in enumerate(requests) if r.shape[0] == 16)
    (cpu_out,) = cpu.infer({"data": requests[big][:4]})
    card = answers[big].reshape(T, 16, V)[:, :4]
    prob_err, _ = held_probs(card.transpose(1, 0, 2),
                             cpu_out.reshape(T, 4, V).transpose(1, 0, 2),
                             "slice")
    return backend, requests, launches, peak, prob_err


def phase_wide_lstm():
    """A one-layer LSTM LM at H=WIDE_H, whose weights do not fit in the
    sequence kernel's shared memory, answers 2 one-row requests: each
    forward launches the per-step kernel T times and the sequence kernel
    never. The first answer is held to the port's CPU path. Returns the
    per-step kernel's launches in this run and that error."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda.lstm import (lstm_cell_fused,
                                               lstm_sequence_fused,
                                               sequence_fits)
    from mxnet_tpu_torch.serving import PredictorBackend

    if sequence_fits(1, WIDE_H, torch.device("cuda", 0)):
        raise RuntimeError(f"H={WIDE_H} fits the sequence kernel on this card")
    net = build_lm(mx, V, WIDE_H, 1, T)
    arg_shapes, _, _ = net.infer_shape(data=(1, T))
    rng = np.random.RandomState(2)
    params = {n: rng.uniform(-0.05, 0.05, s).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    symbol_json = net.tojson()
    param_bytes = mx.convert.params_to_bytes(params, {})
    backend = PredictorBackend(symbol_json, param_bytes, row_shape=(T,),
                               dev_type=2)
    reqs = np.random.RandomState(3)
    batches = [reqs.randint(0, V, (1, T)).astype(np.float32)
               for _ in range(2)]
    answers = []
    # this path's run starts here
    lstm_sequence_fused.launches = lstm_cell_fused.launches = 0
    backend.load()
    for batch in batches:
        (out,) = backend.infer({"data": batch})
        check_probs(out, 1)
        answers.append(out)
    launches = (lstm_sequence_fused.launches, lstm_cell_fused.launches)
    log(f"[wide] LSTM LM H={WIDE_H}, 1 layer: 2 requests of 1 row; "
        f"(lstm_sequence, lstm_cell) launches {launches}")
    if launches[0] != 0 or launches[1] == 0 or launches[1] % T:
        raise RuntimeError(f"wide LSTM launched {launches}, expected (0, a "
                           f"multiple of {T})")
    cpu = PredictorBackend(symbol_json, param_bytes, row_shape=(T,),
                           dev_type=1)
    (cpu_out,) = cpu.infer({"data": batches[0]})
    prob_err = float(np.abs(answers[0] - cpu_out).max())
    log(f"[wide] card against CPU, 1 row: max|d| prob {prob_err:.3e} "
        f"(tol {PROB_TOL}); largest prob {float(cpu_out.max()):.3e}")
    if not prob_err <= PROB_TOL:
        raise RuntimeError(f"wide LM: card and CPU disagree: {prob_err} > "
                           f"{PROB_TOL}")
    return launches[1], prob_err


def time_on_stream(fn, iters=50):
    """Device ms per call of ``fn``: the host enqueues every call while the
    stream sleeps, so the events time the device and not the launch path.
    50 calls of the plain version stay inside the card's launch queue."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=20):
    """Host microseconds to enqueue one call of ``fn`` (host clock over
    ``iters`` calls, no synchronisation inside), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def cell_bound_ms(n, hdim, elem_bytes):
    """Least time on an H100 for one cell step: each input read once and
    each output written once from device memory, against the product's
    2*N*4H*H operations at the fp32 peak."""
    nbytes = elem_bytes * (n * 4 * hdim + 2 * n * hdim + 4 * hdim * hdim
                           + 2 * n * hdim)
    flops = 2 * n * 4 * hdim * hdim
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def phase_timing(backend, requests):
    from mxnet_tpu_torch.ops.cuda.lstm import lstm_cell_fused, lstm_cell_plain
    cells = {}
    for n, hdim in [(n, H) for n in BUCKETS] + [(1, WIDE_H)]:
        xproj, h, c, w = cell_inputs(n, hdim, torch.float32, seed=7 + n)
        row = {
            "kernel_ms": time_on_stream(lambda: lstm_cell_fused(xproj, h, c, w)),
            "plain_ms": time_on_stream(lambda: lstm_cell_plain(xproj, h, c, w)),
            "library_ms": time_on_stream(lambda: torch.addmm(xproj, h, w.t())),
        }
        row["bound_ms"], row["bound_by"] = cell_bound_ms(n, hdim, 4)
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        cells[(n, hdim)] = row
        log(f"[timing] lstm_cell N={n} H={hdim} fp32: kernel "
            f"{row['kernel_ms'] * 1e3:.3f} us, plain "
            f"{row['plain_ms'] * 1e3:.3f} us, addmm (library) "
            f"{row['library_ms'] * 1e3:.3f} us, bound "
            f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']}, "
            f"share of bound {row['share_of_bound']:.3f}")
    forward = {}
    for rows in BUCKETS:
        batch = next(r for r in requests if r.shape[0] == rows)
        pred = backend.bind_bucket(rows)
        pred.set_input("data", memoryview(batch.reshape(-1)), batch.shape)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            pred.forward()  # ends with the outputs' copy to the host
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        forward[rows] = {"forward_ms": ms, "tokens_per_s": rows * T / ms * 1e3,
                         "runs_ms": [t * 1e3 for t in times]}
        log(f"[timing] Predictor forward, {rows} row(s) x T={T}: median "
            f"{ms:.3f} ms of {forward[rows]['runs_ms']}, "
            f"{forward[rows]['tokens_per_s']:.1f} tokens/s")
    return cells, forward


def sequence_bound_ms(steps, n, hdim, elem_bytes):
    """Least time on an H100 for one LSTM layer over T steps: each input
    (xproj, h0, c0, w_h2h) read once and each output (out, hT, cT) written
    once from device memory, against the products' 2*T*N*4H*H operations
    at the fp32 peak."""
    nbytes = elem_bytes * (steps * n * 4 * hdim + 2 * n * hdim
                           + 4 * hdim * hdim + steps * n * hdim + 2 * n * hdim)
    flops = 2 * steps * n * 4 * hdim * hdim
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def phase_sequence_timing():
    """One LSTM layer (T=128, H=1024, fp32) at each bucket: the sequence
    kernel, the per-step route (T launches of the step kernel), the plain
    loop, T grid barriers with no step body, and cuDNN's LSTM (which also
    computes the input projection) beside the port's projection plus the
    kernel. The port never calls cuDNN's LSTM."""
    from mxnet_tpu_torch.ops.cuda.lstm import (lstm_cell_fused,
                                               lstm_sequence_fused,
                                               lstm_sequence_plain,
                                               sequence_barriers)
    out = {}
    for n in BUCKETS:
        xproj, h0, c0, w = sequence_inputs(T, n, H, torch.float32, seed=11 + n)

        def per_step():
            return lstm_sequence_plain(xproj, h0, c0, w, cell=lstm_cell_fused)

        rng = np.random.RandomState(13 + n)
        x_in = torch.tensor(rng.normal(0, 1, (T, n, H)), dtype=torch.float32,
                            device="cuda")
        w_i2h = torch.tensor(rng.uniform(-0.05, 0.05, (4 * H, H)),
                             dtype=torch.float32, device="cuda")
        bias = torch.tensor(rng.uniform(-0.05, 0.05, (4 * H,)),
                            dtype=torch.float32, device="cuda")
        cudnn = torch.nn.LSTM(H, H, 1).cuda()
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(w_i2h)
            cudnn.weight_hh_l0.copy_(w)
            cudnn.bias_ih_l0.copy_(bias)
            cudnn.bias_hh_l0.zero_()

        def port_with_projection():
            xp = torch.matmul(x_in.reshape(T * n, H), w_i2h.t()) + bias
            return lstm_sequence_fused(xp.reshape(T, n, 4 * H), h0, c0, w)

        with torch.no_grad():
            mine = port_with_projection()
            theirs = cudnn(x_in, (h0[None], c0[None]))
            torch.cuda.synchronize()
            yard_err = (mine[0] - theirs[0]).abs().max().item()
            row = {
                "kernel_ms": time_on_stream(
                    lambda: lstm_sequence_fused(xproj, h0, c0, w), iters=20),
                "per_step_ms": time_on_stream(per_step, iters=5),
                "plain_ms": time_on_stream(
                    lambda: lstm_sequence_plain(xproj, h0, c0, w), iters=2),
                "barrier_floor_ms": time_on_stream(
                    lambda: sequence_barriers(T, n, H, h0.device), iters=20),
                "cudnn_lstm_ms": time_on_stream(
                    lambda: cudnn(x_in, (h0[None], c0[None])), iters=20),
                "projection_plus_kernel_ms": time_on_stream(
                    port_with_projection, iters=20),
                "port_vs_cudnn_max_abs": yard_err,
            }
        row["bound_ms"], row["bound_by"] = sequence_bound_ms(T, n, H, 4)
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        out[n] = row
        log(f"[timing] one LSTM layer T={T} N={n} H={H} fp32: sequence kernel "
            f"{row['kernel_ms'] * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} (share "
            f"{row['share_of_bound']:.3f}); {T} per-step launches "
            f"{row['per_step_ms'] * 1e3:.1f} us; plain "
            f"{row['plain_ms'] * 1e3:.1f} us; {T} empty grid barriers "
            f"{row['barrier_floor_ms'] * 1e3:.1f} us; cuDNN LSTM with its "
            f"projection {row['cudnn_lstm_ms'] * 1e3:.1f} us against the "
            f"port's projection plus kernel "
            f"{row['projection_plus_kernel_ms'] * 1e3:.1f} us (outputs agree "
            f"to {yard_err:.2e})")
        if not yard_err <= SEQ_FP32_TOL:
            raise RuntimeError(f"the port's LSTM layer and cuDNN's disagree: "
                               f"{yard_err}")
    return out


def phase_profile(backend, requests):
    out = {}
    for rows in BUCKETS:
        batch = next(r for r in requests if r.shape[0] == rows)
        pred = backend.bind_bucket(rows)
        pred.set_input("data", memoryview(batch.reshape(-1)), batch.shape)
        out[str(rows)] = profile_device(
            f"one {rows}-row Predictor forward", pred.forward)
    return out


def attention_inputs(b, h, sq, sk, d, dtype, seed, offset=0, layout="bhsd"):
    """q, k, v; with ``offset``, views that start ``offset`` elements into
    wider rows, so that no row is 16-byte aligned; with layout "bshd",
    (B, H, S, D) views of (B, S, H, D) memory, as the transformer makes
    them."""
    rng = np.random.RandomState(seed)
    if layout == "bshd":
        return [torch.tensor(rng.normal(0, 1, (b, s, h, d)), dtype=dtype,
                             device="cuda").transpose(1, 2)
                for s in (sq, sk, sk)]
    return [torch.tensor(rng.normal(0, 1, (b, h, s, d + offset)), dtype=dtype,
                         device="cuda")[..., offset:]
            for s in (sq, sk, sk)]


def packed_segments(b, s):
    """Three packed segments and a pad tail in every row, cut at other
    places in each row."""
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = [s // 4 + 37 * i, s // 2 + 11 * i, (7 * s) // 8 - 5 * i]
        seg[i, :cuts[0]] = 1
        seg[i, cuts[0]:cuts[1]] = 2
        seg[i, cuts[1]:cuts[2]] = 3
    return torch.tensor(seg, device="cuda")


def attention_cases():
    """(label, (B, H, Sq, Sk, D), causal, lengths, segments, offset,
    layout) held against the plain versions: the transformer's shapes at
    both buckets, ragged ones, the transformer's (B, S, H, D) view layout,
    unaligned views (the CUDA-core variant in bf16), and the masked
    variants at the transformer's largest bucket. The dense and masked
    bf16 cases at D = 64 and 128 with aligned views run the wgmma/TMA
    variant."""
    b, h, s, d = ATT_SHAPE
    dense = [(f"dense causal={c}", shape, c, None, False, 0, "bhsd")
             for shape in ((b, h, s, s, d), (1, h, s, s, d))
             for c in (True, False)]
    ragged = [("ragged causal", (2, 3, 1000, 1000, 64), True, None, False, 0,
               "bhsd"),
              ("ragged", (2, 3, 1000, 1000, 64), False, None, False, 0,
               "bhsd"),
              ("causal Sq<Sk", (2, 2, 77, 200, 128), True, None, False, 0,
               "bhsd"),
              ("D=128 ragged", (2, 2, 300, 300, 128), False, None, False, 0,
               "bhsd"),
              ("transformer views (B,S,H,D) causal", (b, h, s, s, d), True,
               None, False, 0, "bshd"),
              ("transformer views D=128 ragged", (2, 4, 1000, 1000, 128),
               True, None, False, 0, "bshd"),
              ("tiny", (1, 4, 33, 33, 8), False, None, False, 0, "bhsd"),
              ("unaligned causal", (1, 8, 300, 300, 64), True, None, False, 1,
               "bhsd")]
    masked = [("masked lengths", (b, h, s, s, d), False, ATT_LENGTHS, False,
               0, "bhsd"),
              ("masked segments", (b, h, s, s, d), False, None, True, 0,
               "bhsd"),
              ("masked causal+lengths", (b, h, s, s, d), True, ATT_LENGTHS,
               False, 0, "bhsd"),
              ("masked causal segments", (b, h, s, s, d), True, None, True,
               0, "bhsd"),
              ("masked D=128 causal lengths views", (2, 4, 1000, 1000, 128),
               True, [777, 0], False, 0, "bshd"),
              ("masked unaligned segments", (2, 4, 300, 300, 64), True, None,
               True, 1, "bhsd")]
    return dense + ragged + masked


def phase_attention_kernels():
    from mxnet_tpu_torch.ops.cuda.attention import (attention_plain,
                                                    flash_attention,
                                                    masked_attention_plain)
    errs = {name: {"fp32": 0.0, "bf16": 0.0}
            for name in ("flash_attention", "flash_attention_masked")}
    wgmma_cases = 0
    for i, (label, shape, causal, lengths, segments, offset, layout) in \
            enumerate(attention_cases()):
        b, h, sq, sk, d = shape
        lens = (None if lengths is None else
                torch.tensor(lengths, dtype=torch.int32, device="cuda"))
        seg = packed_segments(b, sk) if segments else None
        masked = lens is not None or seg is not None
        name = "flash_attention_masked" if masked else "flash_attention"
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = attention_inputs(b, h, sq, sk, d, dtype, seed=i,
                                       offset=offset, layout=layout)
            before = (flash_attention.launches,
                      flash_attention.masked_launches,
                      flash_attention.wgmma_launches)
            out = flash_attention(q, k, v, causal=causal, lengths=lens,
                                  segment_ids=seg)
            torch.cuda.synchronize()
            # the dense and the masked bf16 core at D = 64 or 128 over
            # aligned views is the wgmma/TMA variant's; everything else
            # keeps its route
            wgmma = tag == "bf16" and d in (64, 128) and offset == 0
            after = (flash_attention.launches,
                     flash_attention.masked_launches,
                     flash_attention.wgmma_launches)
            if after != (before[0] + (not masked), before[1] + masked,
                         before[2] + wgmma):
                raise RuntimeError(f"{name} {label} {tag}: the launch "
                                   f"counters moved {before} -> {after}")
            wgmma_cases += wgmma
            want = (masked_attention_plain(q, k, v, lens, seg, causal=causal)
                    if masked else attention_plain(q, k, v, causal=causal))
            if out.dtype != dtype or out.shape != want.shape:
                raise RuntimeError(f"{name} {label}: output {out.dtype} "
                                   f"{tuple(out.shape)}")
            diff = (out.float() - want.float()).abs()
            err = diff.max().item()
            if tag == "fp32":
                ok, tol = err <= FP32_TOL, f"{FP32_TOL}"
            else:
                bound = BF16_REL_TOL * want.float().abs().clamp(min=1.0)
                ok = bool((diff <= bound).all())
                tol = f"{BF16_REL_TOL} x max(1, |ref|)"
            log(f"[kernels] {name} {label} {shape} {tag}"
                f"{' (wgmma)' if wgmma else ''}: max|d| {err:.3e} (tol {tol})")
            if not ok:
                raise RuntimeError(f"{name} {label} {tag} disagrees with its "
                                   f"plain version: {err}")
            if masked:
                dead = want == 0
                if not torch.equal(out[dead], want[dead]):
                    raise RuntimeError(f"{name} {label} {tag}: fully masked "
                                       "rows are not exact 0")
                log(f"[kernels]   {int(dead.all(-1).sum())} fully masked "
                    "rows, exact 0")
            errs[name][tag] = max(errs[name][tag], err)
    log(f"[kernels] flash_attention: {wgmma_cases} dense and masked bf16 "
        "cases through the wgmma/TMA variant")
    return errs


def transformer_requests():
    reqs = np.random.RandomState(2)
    out = [reqs.randint(0, 32000, (rows, TF_S)).astype(np.float32)
           for rows in TF_BUCKETS * 4]
    return out + [reqs.randint(0, 32000, (1, 1000)).astype(np.float32)]


def phase_transformer():
    """The transformer's main path: TransformerLM on gpu(0) behind
    CallableBackend, as one would serve the JAX package's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM, forward)
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention
    from mxnet_tpu_torch.serving import CallableBackend

    cfg = TransformerConfig()
    t0 = time.perf_counter()
    lm = TransformerLM(cfg, seed=0, ctx=mx.gpu(0))
    n_params = sum(p.numel() for p in lm.params["blocks"].values()) + sum(
        lm.params[k].numel() for k in ("embed", "ln_f", "head"))
    log(f"[transformer] vocab {cfg.vocab_size}, {cfg.num_layers} layers, "
        f"{cfg.num_heads} heads, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"{cfg.dtype}: {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.3f} s")
    backend = CallableBackend(
        lambda arrays: lm.logits(arrays["data"]).cpu().numpy(),
        input_specs={"data": (TF_S,)})
    requests = transformer_requests()

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0  # the main path's run starts here
    flash_attention.masked_launches = 0
    flash_attention.wgmma_launches = 0
    backend.load()
    per_forward, served_ms, kept = [], [], None
    for batch in requests:
        before = (flash_attention.launches, flash_attention.masked_launches,
                  flash_attention.wgmma_launches)
        t0 = time.perf_counter()
        (out,) = backend.infer({"data": batch})
        served_ms.append((time.perf_counter() - t0) * 1e3)
        per_forward.append((flash_attention.launches - before[0],
                            flash_attention.masked_launches - before[1],
                            flash_attention.wgmma_launches - before[2]))
        rows, s = batch.shape
        if out.shape != (rows, s, cfg.vocab_size) or out.dtype != np.float32:
            raise RuntimeError(f"logits {out.shape} {out.dtype} for a "
                               f"{batch.shape} request")
        if not np.isfinite(out).all():
            raise RuntimeError("non-finite logits")
        if kept is None:
            kept = out
    launches = flash_attention.launches  # the main path's run ends here
    masked = flash_attention.masked_launches
    wgmma = flash_attention.wgmma_launches
    peak = torch.cuda.max_memory_allocated()
    log(f"[transformer] {len(requests)} requests answered "
        f"(rows x S: {[r.shape for r in requests]}); flash_attention "
        f"launches per forward (dense, masked, of the dense the wgmma "
        f"variant's) {per_forward}; total {launches} dense ({wgmma} wgmma), "
        f"{masked} masked; peak device memory {peak} bytes")
    log(f"[transformer] served ms per request {served_ms}")
    want = (cfg.num_layers, 0, cfg.num_layers)
    if any(n != want for n in per_forward):
        raise RuntimeError(f"flash_attention launched {per_forward} times "
                           f"per forward, expected {want}")

    # the bf16 answer against an fp32 forward of the same weights
    cfg32 = TransformerConfig(dtype="float32")
    toks = torch.tensor(requests[0], device="cuda")
    with torch.inference_mode():
        ref32 = forward(lm.params, toks, cfg32).cpu().numpy()
    bf16_err = float(np.abs(kept - ref32).max())
    log(f"[transformer] bf16 logits against fp32 on the card, 1 x {TF_S}: "
        f"max|d| {bf16_err:.3e} (tol {BF16_LOGIT_TOL}); largest |logit| "
        f"{float(np.abs(ref32).max()):.3e}; argmax agreement "
        f"{float((kept.argmax(-1) == ref32.argmax(-1)).mean()):.4f}")
    if not bf16_err <= BF16_LOGIT_TOL:
        raise RuntimeError(f"bf16 and fp32 logits disagree: {bf16_err}")

    # the card against the port's CPU path on the same weights, fp32
    toks = requests[0][:, :256]
    cpu_params = {k: ({n: t.cpu() for n, t in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in lm.params.items()}
    with torch.inference_mode():
        card = forward(lm.params, torch.tensor(toks, device="cuda"),
                       cfg32).cpu().numpy()
        cpu = forward(cpu_params, torch.tensor(toks), cfg32).numpy()
    cpu_err = float(np.abs(card - cpu).max())
    log(f"[transformer] card against CPU, fp32, 1 x 256: max|d| "
        f"{cpu_err:.3e} (tol {LOGIT_TOL})")
    if not cpu_err <= LOGIT_TOL:
        raise RuntimeError(f"card and CPU disagree: {cpu_err} > {LOGIT_TOL}")
    return {"lm": lm, "backend": backend, "requests": requests,
            "launches": launches, "masked_launches_on_path": masked,
            "wgmma_launches": wgmma,
            "per_forward": per_forward, "served_ms": served_ms,
            "peak_device_bytes": peak, "bf16_vs_fp32_max_abs": bf16_err,
            "card_vs_cpu_max_abs": cpu_err, "parameters": n_params}


def phase_masked_path():
    """The masked core's path: a packed batch (three segments and a pad
    tail per row) and a length-masked causal batch at the transformer's
    attention shape, through the public flash_attention entry point, as a
    caller serving packed rows calls it."""
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention
    b, h, s, d = ATT_SHAPE
    q, k, v = attention_inputs(b, h, s, s, d, torch.bfloat16, seed=99)
    seg = packed_segments(b, s)
    lens = torch.tensor(ATT_LENGTHS, dtype=torch.int32, device="cuda")
    flash_attention.launches = 0  # the masked path's run starts here
    flash_attention.masked_launches = 0
    flash_attention.wgmma_launches = 0
    packed = flash_attention(q, k, v, causal=True, segment_ids=seg)
    ragged = flash_attention(q, k, v, causal=True, lengths=lens)
    torch.cuda.synchronize()
    launches = flash_attention.masked_launches  # and ends here
    for out in (packed, ragged):
        if not torch.isfinite(out).all():
            raise RuntimeError("non-finite masked attention output")
    if not (bool((packed[seg[:, None, :].expand(b, h, s) == 0] == 0).all())
            and bool((ragged[3] == 0).all())):
        raise RuntimeError("masked rows are not exact 0")
    log(f"[masked] packed and length-masked batches {ATT_SHAPE} bf16: "
        f"{launches} masked launches ({flash_attention.wgmma_launches} on "
        f"the wgmma/TMA variant), {flash_attention.launches} dense")
    if (launches != 2 or flash_attention.launches != 0
            or flash_attention.wgmma_launches != 2):
        raise RuntimeError("the masked path did not run the masked core on "
                           "the wgmma/TMA variant")
    return launches, flash_attention.wgmma_launches


def attention_bound_ms(live_pairs, b, h, sq, sk, d, elem_bytes):
    """Least time on an H100: q, k, v read once and o written once from
    device memory, against 4*D operations per live (query, key) pair at
    the bf16 tensor-core peak."""
    nbytes = elem_bytes * b * h * d * (2 * sq + 2 * sk)
    flops = 4 * d * live_pairs
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def variants_timing(label, q, k, v, live, lengths=None, seg=None):
    """B2 (no mask) or B3 (``lengths`` or ``seg``) at the transformer's
    shape, causal: the wgmma/TMA variant (the main path's), the earlier
    mma.sync variant (forced through the library's internal route) and
    scaled_dot_product_attention (given the mask as a bool tensor where
    there is one), in turns (wgmma, mma.sync, library, library, mma.sync,
    wgmma); each one's mean of its two turns, its TFLOP/s on the live
    pairs and its share of the bound."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda.attention import (_combined_mask,
                                                    _mma_sync,
                                                    flash_attention)
    b, h, s, d = q.shape
    mask = (None if lengths is None and seg is None
            else _combined_mask(s, s, True, lengths, seg, q.device))
    fns = {"wgmma": lambda: flash_attention(q, k, v, causal=True,
                                            lengths=lengths, segment_ids=seg),
           "mma_sync": lambda: _mma_sync(q, k, v, causal=True,
                                         lengths=lengths, segment_ids=seg),
           "library": lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=mask, is_causal=mask is None)}
    runs = {name: [] for name in fns}
    for name in ("wgmma", "mma_sync", "library", "library", "mma_sync",
                 "wgmma"):
        runs[name].append(time_on_stream(fns[name], iters=20))
    bound_ms, _ = attention_bound_ms(live, b, h, s, s, d, 2)
    out = {}
    for name, ms in runs.items():
        mean = statistics.mean(ms)
        out[name] = {"ms": mean, "runs_ms": ms,
                     "tflops": 4 * d * live / mean / 1e9,
                     "share_of_bound": bound_ms / mean}
        log(f"[timing] {label} {name}: {mean * 1e3:.3f} us (turns "
            f"{[round(t * 1e3, 3) for t in ms]}), "
            f"{out[name]['tflops']:.2f} TFLOP/s, share of bound "
            f"{out[name]['share_of_bound']:.4f}")
    return out


def phase_attention_timing():
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda.attention import (_combined_mask,
                                                    attention_plain,
                                                    flash_attention,
                                                    masked_attention_plain)
    b, h, s, d = ATT_SHAPE
    q, k, v = attention_inputs(b, h, s, s, d, torch.bfloat16, seed=7)
    lens = torch.tensor(ATT_LENGTHS, dtype=torch.int32, device="cuda")
    seg = packed_segments(b, s)
    mask = _combined_mask(s, s, True, lens, None, q.device)  # (B,1,S,S)
    packed_mask = _combined_mask(s, s, True, None, seg, q.device)
    variants = variants_timing("B2", q, k, v, b * h * s * (s + 1) // 2)
    rows = {}
    for name, fn, plain, library, live in (
            ("flash_attention",
             lambda: flash_attention(q, k, v, causal=True),
             lambda: attention_plain(q, k, v, causal=True),
             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
             b * h * s * (s + 1) // 2),
            ("flash_attention_masked",
             lambda: flash_attention(q, k, v, causal=True, lengths=lens),
             lambda: masked_attention_plain(q, k, v, lens, causal=True),
             lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
             h * int(mask.sum().item())),
            ("flash_attention_masked packed",
             lambda: flash_attention(q, k, v, causal=True, segment_ids=seg),
             lambda: masked_attention_plain(q, k, v, None, seg, causal=True),
             lambda: F.scaled_dot_product_attention(q, k, v,
                                                    attn_mask=packed_mask),
             h * int(packed_mask.sum().item()))):
        row = {"kernel_ms": time_on_stream(fn, iters=20),
               "plain_ms": time_on_stream(plain, iters=10),
               "library_ms": time_on_stream(library, iters=20),
               "live_pairs": live}
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            live, b, h, s, s, d, 2)
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        row["tflops"] = 4 * d * live / row["kernel_ms"] / 1e9
        rows[name] = row
        log(f"[timing] {name} {ATT_SHAPE} bf16 causal: kernel "
            f"{row['kernel_ms'] * 1e3:.3f} us ({row['tflops']:.2f} TFLOP/s), "
            f"plain {row['plain_ms'] * 1e3:.3f} us, scaled_dot_product_"
            f"attention (library) {row['library_ms'] * 1e3:.3f} us, live "
            f"pairs {live}, bound {row['bound_ms'] * 1e3:.3f} us by "
            f"{row['bound_by']}, share of bound {row['share_of_bound']:.4f}")
    rows["flash_attention"]["variants"] = variants
    masked = rows["flash_attention_masked"]
    masked["variants"] = variants_timing(
        f"B3 lengths={ATT_LENGTHS}", q, k, v, masked["live_pairs"],
        lengths=lens)
    masked["packed"] = rows.pop("flash_attention_masked packed")
    masked["packed"]["variants"] = variants_timing(
        "B3 packed", q, k, v, masked["packed"]["live_pairs"], seg=seg)
    # what the segment ranges' pre-pass costs beside the kernel
    masked["packed"]["profile"] = profile_device(
        "one packed B3 call", lambda: flash_attention(q, k, v, causal=True,
                                                      segment_ids=seg))
    return rows


def phase_transformer_timing(tf):
    """Device time of one forward, logits left on the card (CUDA events),
    and the served request time (host clock, includes the logits' copy
    to host memory), per bucket."""
    from mxnet_tpu_torch.models.transformer import forward
    lm, backend = tf["lm"], tf["backend"]
    out = {}
    for rows in TF_BUCKETS:
        batch = next(r for r in tf["requests"] if r.shape[0] == rows)
        toks = torch.tensor(batch, device="cuda").long()
        with torch.inference_mode():
            device_ms = time_on_stream(lambda: forward(lm.params, toks,
                                                       lm.cfg), iters=10)
        served = []
        for _ in range(3):
            t0 = time.perf_counter()
            backend.infer({"data": batch})
            served.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(served)
        out[str(rows)] = {"forward_device_ms": device_ms,
                          "served_ms": ms, "served_runs_ms": served,
                          "tokens_per_s_device": rows * TF_S / device_ms * 1e3,
                          "tokens_per_s_served": rows * TF_S / ms * 1e3}
        log(f"[timing] transformer forward {rows} x {TF_S}: device "
            f"{device_ms:.3f} ms ({out[str(rows)]['tokens_per_s_device']:.1f}"
            f" tokens/s); served median {ms:.3f} ms of {served} "
            f"({out[str(rows)]['tokens_per_s_served']:.1f} tokens/s)")
    return out


def profile_device(label, fn, keep_all=False, expect=None):
    """Device time by kernel over one call of ``fn`` and the device's idle
    share of its wall time (torch.profiler, CUPTI). Only device-side events
    (kernels, copies) are summed: a CPU op's device time repeats its
    kernels'. ``keep_all`` also returns every kernel's row
    (``top_all``). ``expect`` ({kernel name: launches}, with ``keep_all``):
    the window is opened one call of ``fn`` early, a warm-up call that
    runs with the profiler's activities on and whose records are thrown
    away (a cold window may keep no record of its first launches, PERF.md
    section 7); a window whose record still falls short of those counts is
    taken again, up to three windows, and the caller's check reads the
    last window's counts."""
    for window in range(3):
        out = profile_window(label, fn, keep_all, warmup=expect is not None)
        if expect is None:
            return out
        counts = replay_counts(out, list(expect))
        if counts == dict(expect):
            return out
        log(f"[profile] {label}: the window recorded {counts} of the named "
            f"kernels, {dict(expect)} launched (window {window + 1} of 3)")
    return out


def profile_window(label, fn, keep_all, warmup=False):
    """One profiled call of ``fn`` (see :func:`profile_device`), after a
    warm-up call of ``fn`` whose records are dropped when ``warmup``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(3):
        torch.cuda.synchronize()
        plan = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup \
            else None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=plan) as prof:
            if warmup:
                fn()
                torch.cuda.synchronize()
                prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # a schedule adds a device-side span for each of its steps
        events = [(e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == cuda and e.self_device_time_total > 0
                  and not e.key.startswith("ProfilerStep")]
        events.sort(key=lambda k: -k[1])
        busy_us = sum(k[1] for k in events)
        if busy_us:
            break
        # CUPTI now and then hands back no device records for a window;
        # the measurement is taken again, and fails after three windows
        log(f"[profile] {label}: no device time recorded (window "
            f"{attempt + 1} of 3)")
    if not busy_us:
        raise RuntimeError("the profiler recorded no device time")
    # values read back to the host inside fn (.item(), bool() of a device
    # tensor): each waits for the device
    host_reads = sum(e.count for e in prof.key_averages()
                     if e.key == "aten::_local_scalar_dense")
    log(f"[profile] {label} under the profiler: wall {wall_us:.1f} us, "
        f"device busy {busy_us:.1f} us, idle share "
        f"{1 - busy_us / wall_us:.4f}; host reads of device values "
        f"{host_reads}")
    for key, us, count in events[:8]:
        log(f"[profile]   {us:12.1f} us  x{count:<5d} {key[:90]}")
    out = {"wall_us": wall_us, "device_busy_us": busy_us,
           "idle_share": 1 - busy_us / wall_us, "host_reads": host_reads,
           "top": [[k[:90], us, n] for k, us, n in events[:8]]}
    if keep_all:
        out["top_all"] = [[k, us, n] for k, us, n in events]
    return out


def phase_transformer_profile(tf):
    lm = tf["lm"]
    out = {}
    for rows in TF_BUCKETS:
        batch = next(r for r in tf["requests"] if r.shape[0] == rows)
        out[str(rows)] = profile_device(
            f"one {rows} x {TF_S} transformer forward (logits on the card)",
            lambda: lm.logits(batch))
    return out

# -- rtc: runtime-compiled kernels (B4) -------------------------------------

# Rtc bodies against their plain version: "bits" bit for bit (NaN payloads
# aside), "ulp2" within 2 fp32 ulps (the plain version's torch exp/tanh and
# NVRTC's may differ by an ulp), "bf16" within one bf16 ulp
AXPY = "out[:] = x[:] * 2.0 + y[:]"
SGD_BODY = ("mom[:] = 0.9 * m[:] - 0.01 * (g[:] * 0.125 + 0.0001 * w[:])\n"
            "wout[:] = w[:] + mom[:]")
MP_SGD_BODY = ("mom[:] = 0.9 * m[:] - 0.01 * (g[:].astype(jnp.float32) * 0.125"
               " + 0.0001 * w32[:])\n"
               "w32out[:] = w32[:] + mom[:]\n"
               "wout[:] = w32out[:].astype(jnp.bfloat16)")
SGD_KW = dict(learning_rate=0.01, momentum=0.9, wd=1e-4, rescale_grad=0.125)
SGD_STEPS = 3
# the transformer's config for the imperative path (full width)
TF_CFG_KW = {}
RTC_BIG = 2 ** 24 + 3
RTC_ROWS = 4096


def rtc_cases():
    """(label, inputs [(name, shape, dtype, kind)], outputs [(name,
    dtype)], body, tolerance, push kwargs, aliased, vector kernel). Kind
    "n" is a normal draw, "i" int32, "n1" a view one element into a
    normal draw (not 16-byte aligned), "s" a (1,) scalar broadcast. The
    last field says which kernel the push must take: the vector one
    where every read is contiguous or one broadcast element and every
    vector pointer is aligned, else the scalar one."""
    f32, big, mat = "float32", (RTC_BIG,), (RTC_ROWS, 1024)
    return [
        ("axpy 8", [("x", (8,), f32, "n"), ("y", (8,), f32, "n")],
         [("out", f32)], AXPY, "bits", {}, False, True),
        ("axpy 2^24+3", [("x", big, f32, "n"), ("y", big, f32, "n")],
         [("out", f32)], AXPY, "bits", {}, False, True),
        ("axpy 2^24+3 misaligned x", [("x", big, f32, "n1"),
                                      ("y", big, f32, "n")],
         [("out", f32)], AXPY, "bits", {}, False, False),
        ("scalar broadcast", [("x", big, f32, "n"), ("a", (1,), f32, "s")],
         [("out", f32)], "out[:] = x[:] * a[:] + 1.0", "bits", {}, False,
         True),
        ("split", [("x", mat, f32, "n")], [("a", f32), ("b", f32)],
         "a[:] = x[:] + 1.0\nb[:] = x[:] * x[:]", "bits", {}, False, True),
        ("transcendental", [("x", mat, f32, "n"), ("y", mat, f32, "n")],
         [("o", f32)],
         "t = jnp.exp(x[:]) - jnp.tanh(y[:])\n"
         "o[:] = jnp.where(t > 1.0, jax.nn.sigmoid(t), jnp.maximum(x[:], y[:]))",
         "ulp2", {}, False, True),
        ("broadcast", [("m", mat, f32, "n"), ("v", (1024,), f32, "n")],
         [("o", f32)], "o[:] = m[:] + v[:]", "bits", {}, False, False),
        ("bf16", [("x", mat, "bfloat16", "n"), ("y", mat, f32, "n")],
         [("o", "bfloat16")],
         "o[:] = (x[:] * 0.1 + y[:].astype(jnp.bfloat16)) ** 2 - x[:] / 3.0",
         "bf16", {}, False, True),
        ("bf16 only, n % 8 = 5", [("x", (RTC_ROWS * 1024 + 5,), "bfloat16",
                                   "n")], [("o", "bfloat16")],
         "o[:] = x[:] * 0.1 - x[:] / 3.0", "bits", {}, False, True),
        ("int32 floor", [("x", mat, "int32", "i")], [("o", "int32")],
         "o[:] = x[:] // 7 + x[:] % -3 + x[:] // -2 * 100 + x[:] % 0",
         "bits", {}, False, True),
        ("aliased", [("x", mat, f32, "n")], [("a", f32), ("b", f32)],
         "a[:] = x[:] + 1.0\nb[:] = x[:] * 2.0", "bits", {}, True, True),
        ("launch (4,1,1)/(128,1,1)", [("x", big, f32, "n"),
                                      ("y", big, f32, "n")],
         [("out", f32)], AXPY, "bits",
         {"grid_dims": (4, 1, 1), "block_dims": (128, 1, 1)}, False, True),
    ]


def bits_equal(a, b):
    """Bit for bit, any NaN equal to any NaN."""
    view = torch.int32 if a.element_size() == 4 else torch.int16
    same = a.view(view) == b.view(view)
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return bool(same.all())


def max_ulp(a, b):
    """Largest distance in fp32 ulps (same-sign finite values)."""
    ia = a.float().view(torch.int32).long()
    ib = b.float().view(torch.int32).long()
    return int((ia - ib).abs().max().item())


def compare(kernel, plain, tol):
    if kernel.dtype != plain.dtype or kernel.shape != plain.shape:
        return False, (f"{kernel.dtype}{tuple(kernel.shape)} against "
                       f"{plain.dtype}{tuple(plain.shape)}")
    err = (kernel.double() - plain.double()).abs().nan_to_num(0.0).max().item()
    if tol == "bits":
        return bits_equal(kernel, plain), err
    if tol == "ulp2":
        return max_ulp(kernel, plain) <= 2, err
    bound = 2.0 ** -8 * plain.float().abs()
    return bool(((kernel.float() - plain.float()).abs() <= bound).all()), err


def case_arrays(mx, ins, outs, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    arrays = []
    for name, shape, dtype, kind in ins:
        if kind == "i":
            t = torch.randint(-1000, 1000, shape, generator=gen, device="cuda",
                              dtype=torch.int32)
        elif kind == "n1":  # one element into a wider draw
            t = (torch.randn(math.prod(shape) + 1, generator=gen,
                             device="cuda") * 2.0).to(getattr(torch, dtype))
            t = t[1:].view(shape)
            if t.data_ptr() % 16 == 0:
                raise RuntimeError("the misaligned view is aligned")
        else:
            t = torch.randn(shape, generator=gen, device="cuda") * 2.0
        t = t.to(getattr(torch, dtype))
        arrays.append((name, mx.nd.NDArray(t)))
    shape = ins[0][1]
    outputs = [(n, mx.nd.zeros(shape, ctx=mx.gpu(0), dtype=dt))
               for n, dt in outs]
    return arrays, outputs


def phase_rtc_kernels():
    """Each body's NVRTC kernel (Rtc.push on CUDA tensors) against the plain
    version (the body over torch ops) on the same tensors on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda.rtc import STATS, rtc_launch
    rows, worst = [], {"bits": 0.0, "ulp2": 0.0, "bf16": 0.0}
    for i, (label, ins, outs, body, tol, kw, aliased, vector) in enumerate(
            rtc_cases()):
        arrays, outputs = case_arrays(mx, ins, outs, seed=100 + i)
        k = mx.rtc.Rtc(label.split()[0], arrays, outputs, body)
        tensors = [a._data for _, a in arrays]
        plain = k._run_plain(tensors, tensors[0].device)
        compiles, before = STATS["compiles"], rtc_launch.launches
        vec_before = rtc_launch.vector_launches
        targets = ([arrays[0][1]] + [o for _, o in outputs[1:]]) if aliased \
            else [o for _, o in outputs]
        t0 = time.perf_counter()
        k.push([a for _, a in arrays], targets, **kw)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        if rtc_launch.launches != before + 1:
            raise RuntimeError(f"rtc {label}: the launch counter did not move")
        took_vector = rtc_launch.vector_launches == vec_before + 1
        if took_vector != vector:
            raise RuntimeError(f"rtc {label}: took the "
                               f"{'vector' if took_vector else 'scalar'} "
                               "kernel")
        for (name, _), got, want in zip(outputs, targets, plain):
            ok, err = compare(got._data, want, tol)
            log(f"[rtc] {label} {name} {tuple(got.shape)} {got.dtype}: "
                f"max|d| {err} ({tol})")
            if not ok:
                raise RuntimeError(f"rtc {label} output {name} disagrees with "
                                   f"its plain version: {err} ({tol})")
            worst[tol] = max(worst[tol], err)
        if aliased and not bits_equal(targets[1]._data, tensors[0] * 2.0):
            raise RuntimeError("rtc aliased push read x after writing it")
        compiled = STATS["compiles"] > compiles
        rows.append({"label": label, "tolerance": tol, "compiled": compiled,
                     "first_push_ms": first_ms, "vector": took_vector})
        log(f"[rtc] {label}: first push {first_ms:.3f} ms "
            f"({'compiled' if compiled else 'cache hit'}), "
            f"{'vector' if took_vector else 'scalar'} kernel")
    log(f"[rtc] NVRTC modules compiled {STATS['compiles']}, cache hits "
        f"{STATS['cache_hits']}, compile seconds {STATS['compile_seconds']}")
    return {"cases": rows, "max_abs_err": worst,
            "compiles": STATS["compiles"], "cache_hits": STATS["cache_hits"],
            "compile_seconds": list(STATS["compile_seconds"])}


def sgd_bound_ms(n, elem_bytes=4):
    """Least time on an H100 for one SGD-momentum update of n elements:
    w, g, m read once and w, m written once (5 x n x 4 bytes) at 3.35 TB/s,
    against its 7 fp32 operations an element at the fp32 peak."""
    by_bytes = 5 * elem_bytes * n / HBM_BYTES_PER_S
    by_ops = 7 * n / FP32_FLOPS
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def step_ms(fn):
    """One step's time: CUDA events and the host clock, both ending in a
    synchronize."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def phase_imperative():
    """The imperative path at the transformer LM's width: SGD-momentum steps
    through the optimizer's updater and through Rtc bodies compiled by
    NVRTC, held bit for bit equal; then the mixed-precision body, save/load
    and the timings."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.transformer import TransformerConfig, init_params
    from mxnet_tpu_torch.ops.cuda.rtc import STATS, rtc_launch
    nd = mx.nd
    params = init_params(0, TransformerConfig(**TF_CFG_KW), ctx=mx.gpu(0))
    flat = [(k, v) for k, v in params.items() if not isinstance(v, dict)]
    flat += [(f"blocks.{k}", v) for k, v in params["blocks"].items()]
    names = [n for n, _ in flat]
    n_elems = sum(t.numel() for _, t in flat)
    shapes = sorted({tuple(t.shape) for _, t in flat})
    log(f"[imperative] {len(flat)} parameter tensors, {n_elems} fp32 "
        f"elements, {len(shapes)} shapes {shapes}")
    wa = [nd.NDArray(t.clone()) for _, t in flat]
    wb = [nd.NDArray(t.clone()) for _, t in flat]
    mb = [nd.zeros(t.shape, ctx=mx.gpu(0)) for _, t in flat]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    grads = [[nd.NDArray(torch.randn(t.shape, generator=gen, device="cuda"))
              for _, t in flat] for _ in range(SGD_STEPS)]
    upd = mx.optimizer.get_updater(mx.optimizer.create("sgd", **SGD_KW))

    def updater_step(step):
        for i, (w, g) in enumerate(zip(wa, grads[step])):
            upd(i, g, w)

    def rtc_step(step):
        for w, g, m in zip(wb, grads[step], mb):
            kernels[w.shape].push([w, g, m], [w, m])

    torch.cuda.reset_peak_memory_stats()
    first = {"updater_ms": [], "rtc_ms": []}
    for step in range(SGD_STEPS):  # (a) the optimizer's updater
        first["updater_ms"].append(step_ms(lambda: updater_step(step))[0])
    compiles0, hits0 = STATS["compiles"], STATS["cache_hits"]
    rtc_launch.launches = 0  # the rtc path's run starts here
    rtc_launch.vector_launches = 0
    kernels = {}
    for w, m in zip(wb, mb):  # one Rtc per parameter shape
        if w.shape not in kernels:
            kernels[w.shape] = mx.rtc.Rtc(
                "sgd_mom", [("w", w), ("g", w), ("m", m)],
                [("wout", w), ("mom", m)], SGD_BODY)
    for step in range(SGD_STEPS):  # (b) the same steps as Rtc bodies
        first["rtc_ms"].append(step_ms(lambda: rtc_step(step))[0])
    launches = rtc_launch.launches  # and ends here
    vector_launches = rtc_launch.vector_launches
    peak = torch.cuda.max_memory_allocated()
    modules = STATS["compiles"] - compiles0
    hits = STATS["cache_hits"] - hits0
    log(f"[imperative] rtc launches {launches} ({launches // SGD_STEPS} per "
        f"step, {vector_launches} of them the vector kernel), NVRTC modules "
        f"{modules}, cache hits {hits}; peak device memory {peak} bytes")
    if vector_launches != launches:
        raise RuntimeError(f"the default push took the vector kernel "
                           f"{vector_launches} of {launches} times")
    log(f"[imperative] first steps ms (CUDA events): updater "
        f"{first['updater_ms']}, rtc {first['rtc_ms']}")
    if launches != SGD_STEPS * len(flat):
        raise RuntimeError(f"rtc launched {launches} times, expected "
                           f"{SGD_STEPS * len(flat)}")
    for i, name in enumerate(names):
        if not (bits_equal(wa[i]._data, wb[i]._data)
                and bits_equal(upd.states[i]._data, mb[i]._data)):
            err = (wa[i]._data - wb[i]._data).abs().max().item()
            raise RuntimeError(f"updater and rtc disagree on {name}: {err}")
    log(f"[imperative] updater and rtc bodies bit for bit equal over "
        f"{n_elems} weights and momenta after {SGD_STEPS} steps")

    # mixed precision: bf16 weight and grad, fp32 master and mom
    mp_launches = rtc_launch.launches
    mp = {}
    wbf = [nd.NDArray(t.to(torch.bfloat16)) for _, t in flat]
    w32 = [nd.NDArray(t.clone()) for _, t in flat]
    mom = [nd.zeros(t.shape, ctx=mx.gpu(0)) for _, t in flat]
    rb = [nd.NDArray(t.to(torch.bfloat16)) for _, t in flat]
    r32 = [nd.NDArray(t.clone()) for _, t in flat]
    rmom = [nd.zeros(t.shape, ctx=mx.gpu(0)) for _, t in flat]
    for step in range(SGD_STEPS):
        for i in range(len(flat)):
            g = nd.NDArray(grads[step][i]._data.to(torch.bfloat16))
            nd.mp_sgd_mom_update(wbf[i], g, mom[i], w32[i], lr=0.01,
                                 momentum=0.9, wd=1e-4, rescale_grad=0.125,
                                 out=[wbf[i], mom[i], w32[i]])
            if rb[i].shape not in mp:
                mp[rb[i].shape] = mx.rtc.Rtc(
                    "mp_sgd_mom", [("w", rb[i]), ("g", g), ("m", rmom[i]),
                                   ("w32", r32[i])],
                    [("wout", rb[i]), ("mom", rmom[i]), ("w32out", r32[i])],
                    MP_SGD_BODY)
            mp[rb[i].shape].push([rb[i], g, rmom[i], r32[i]],
                                 [rb[i], rmom[i], r32[i]])
    torch.cuda.synchronize()
    for i, name in enumerate(names):
        for a, b in ((wbf[i], rb[i]), (mom[i], rmom[i]), (w32[i], r32[i])):
            if a.dtype != b.dtype or not bits_equal(a._data, b._data):
                raise RuntimeError(f"mp_sgd_mom_update and the rtc body "
                                   f"disagree on {name}")
    log(f"[imperative] bf16 mixed precision: nd.mp_sgd_mom_update and the rtc "
        f"body bit for bit equal after {SGD_STEPS} steps "
        f"({rtc_launch.launches - mp_launches} launches)")
    del wbf, w32, mom, rb, r32, rmom

    # save / load round trip of the updated weights
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sgd.params")
        t0 = time.perf_counter()
        nd.save(path, dict(zip(names, wb)))
        back = nd.load(path, ctx=mx.gpu(0))
        io_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    for name, w in zip(names, wb):
        if back[name].dtype != w.dtype or not bits_equal(back[name]._data,
                                                         w._data):
            raise RuntimeError(f"nd.save/nd.load changed {name}")
    log(f"[imperative] nd.save + nd.load of {len(names)} arrays ({size} bytes)"
        f" bit for bit in {io_s:.3f} s")

    # timing: whole steps in turns (updater, rtc, rtc, updater), then the
    # kernel on the largest tensor against its bound and its plain version
    turns = {"updater": [], "rtc": []}
    for path_name in ("updater", "rtc", "rtc", "updater"):
        fn = updater_step if path_name == "updater" else rtc_step
        for step in range(SGD_STEPS):
            turns[path_name].append(step_ms(lambda: fn(step)))
    profiles = {"updater": profile_device("one updater SGD step",
                                          lambda: updater_step(0)),
                "rtc": profile_device("one rtc SGD step", lambda: rtc_step(0))}
    big = max(range(len(flat)), key=lambda i: flat[i][1].numel())
    w, g, m = wb[big], grads[0][big], mb[big]
    k = kernels[w.shape]
    wgm = [w._data, g._data, m._data]
    # the default push (the vector kernel) and the scalar kernel on the
    # same tensors, in turns (vector, scalar, scalar, vector)
    turns_us = {"vector": [], "scalar": []}
    for kind in ("vector", "scalar", "scalar", "vector"):
        fn = (lambda: k.push([w, g, m], [w, m])) if kind == "vector" else (
            lambda: rtc_launch(k._program, wgm, force_scalar=True))
        turns_us[kind].append(time_on_stream(fn, iters=50))
    kernel_ms = statistics.mean(turns_us["vector"])
    scalar_ms = statistics.mean(turns_us["scalar"])
    # the vector kernel under the scalar kernel's launch shape (8 blocks of
    # 256 threads an SM, a grid-stride loop) beside its default one-pass
    # grid
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    capped_ms = time_on_stream(
        lambda: k.push([w, g, m], [w, m], grid_dims=(sms * 8, 1, 1),
                       block_dims=(256, 1, 1)), iters=50)
    plain_ms = time_on_stream(
        lambda: k._run_plain(wgm, w._data.device), iters=20)
    bound_ms, bound_by = sgd_bound_ms(w.size)
    # axpy beside torch.add(y, x, alpha=2.0), the one library call that
    # computes the same function
    xg = torch.Generator(device="cuda").manual_seed(7)
    x = nd.NDArray(torch.randn(RTC_BIG, generator=xg, device="cuda"))
    y = nd.NDArray(torch.randn(RTC_BIG, generator=xg, device="cuda"))
    out = nd.zeros((RTC_BIG,), ctx=mx.gpu(0))
    ka = mx.rtc.Rtc("axpy", [("x", x), ("y", y)], [("out", out)], AXPY)
    axpy = {
        "n": RTC_BIG,
        "ms": time_on_stream(lambda: ka.push([x, y], [out]), iters=50),
        "scalar_ms": time_on_stream(
            lambda: rtc_launch(ka._program, [x._data, y._data],
                               force_scalar=True), iters=50),
        "plain_ms": time_on_stream(
            lambda: ka._run_plain([x._data, y._data], x._data.device),
            iters=20),
        "library_ms": time_on_stream(
            lambda: torch.add(y._data, x._data, alpha=2.0), iters=50),
        "bound_ms": 3 * 4 * RTC_BIG / HBM_BYTES_PER_S * 1e3,
    }
    timing = {
        "updater_step_ms": [t[0] for t in turns["updater"]],
        "rtc_step_ms": [t[0] for t in turns["rtc"]],
        "updater_step_host_ms": [t[1] for t in turns["updater"]],
        "rtc_step_host_ms": [t[1] for t in turns["rtc"]],
        "step_bound_ms": sgd_bound_ms(n_elems)[0],
        "kernel_ms": kernel_ms, "scalar_ms": scalar_ms,
        "vector_capped_grid_ms": capped_ms,
        "kernel_turns_ms": turns_us, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by, "largest": names[big], "largest_n": w.size,
        "axpy": axpy, "profiles": profiles,
    }
    med = {p: statistics.median(timing[f"{p}_step_ms"])
           for p in ("updater", "rtc")}
    log(f"[timing] SGD-momentum step over {n_elems} parameters (median of "
        f"{2 * SGD_STEPS}, CUDA events): updater {med['updater']:.3f} ms, rtc "
        f"{med['rtc']:.3f} ms, bound {timing['step_bound_ms']:.3f} ms (bytes);"
        f" host clock updater "
        f"{statistics.median(timing['updater_step_host_ms']):.3f} ms, rtc "
        f"{statistics.median(timing['rtc_step_host_ms']):.3f} ms")
    log(f"[timing] rtc SGD body on {names[big]} ({w.size} elements): vector "
        f"kernel (default push) {kernel_ms * 1e3:.3f} us, scalar kernel "
        f"{scalar_ms * 1e3:.3f} us (turns {turns_us}), vector kernel on "
        f"{sms * 8} blocks of 256 with a grid-stride loop "
        f"{capped_ms * 1e3:.3f} us, plain "
        f"{plain_ms * 1e3:.3f} us, bound {bound_ms * 1e3:.3f} us by "
        f"{bound_by}, share of bound {bound_ms / kernel_ms:.3f} (scalar "
        f"{bound_ms / scalar_ms:.3f}); no single torch call computes it")
    log(f"[timing] rtc axpy n={RTC_BIG}: vector kernel {axpy['ms'] * 1e3:.3f}"
        f" us, scalar kernel {axpy['scalar_ms'] * 1e3:.3f} us, plain "
        f"{axpy['plain_ms'] * 1e3:.3f} us, torch.add(alpha=2) (library)"
        f" {axpy['library_ms'] * 1e3:.3f} us, bound "
        f"{axpy['bound_ms'] * 1e3:.3f} us by bytes")
    return {"launches": launches, "launches_per_step": launches // SGD_STEPS,
            "vector_launches": vector_launches,
            "parameters": n_elems, "tensors": len(flat), "shapes": len(shapes),
            "modules": modules, "cache_hits": hits, "peak_device_bytes": peak,
            "first_steps_ms": first, "timing": timing,
            "save_load_bytes": size, "save_load_s": io_s}


# -- training (phase 11) ------------------------------------------------------

# the benchmark's training shape (benchmarks/bench_lstm.py:28-65)
TRAIN_N, TRAIN_T = 64, 256
TRAIN_BATCHES, TRAIN_STEPS = 4, 10
TRAIN_SGD = {"learning_rate": 0.5, "momentum": 0.0}
# the steps on one repeated batch run at the benchmark's rate divided by T:
# at 0.5 itself that training diverges from its 6th step (the loss 27.5
# there, in the port as in the JAX package), and whether it reaches inf or
# NaN within 10 steps then turns on fp32 rounding alone: three correct
# backwards (the register kernel, the shared-memory kernel, the plain loop
# on the card) agree through step 5 and part after it
# (tools/probe_lstm_bwd.py bench-lr prints each step's loss, gradients
# and weights)
TRAIN_STEP_LR = TRAIN_SGD["learning_rate"] / TRAIN_T
# the steps before that divergence run at 0.5 too, from the same init and
# fit epoch, through the kernels and through the plain backward on the
# card: fp32 sums in another order, through 9 updates at the bench's rate;
# each step's cross-entropy held within BENCH_LR_TOL of the other route's
BENCH_LR_STEPS = 5
BENCH_LR_TOL = 1e-3
# (T, N, H) of the training kernels' checks: the sequence kernels at the
# served shapes, at the main training path's shape (16 tiles of 4 rows on
# the register backward kernel) and ragged ones (one tile; two whole tiles
# of 16 rows and a part; nine of 4 rows and a part); the backward plan's
# edges: H=1032 and 1320 (the shared-memory kernel: more float4 columns
# a thread than registers hold; 10 units a block), H=100 (one unit a
# block, T=1); the per-step kernels at the wide LM's H
BWD_CASES = ((T, 1, H), (T, 16, H), (TRAIN_T, TRAIN_N, H), (7, 3, 200),
             (7, 37, 200), (5, 37, H), (6, 16, 1032), (4, 3, 1320),
             (1, 5, 100), (8, 1, WIDE_H))
# the backward kernel the plan gives each H of BWD_CASES on an H100's 132
# SMs, units = ceil(H / 132): the register kernel holds ceil(H / 256)
# float4 columns a unit within a consumer's 32, so it takes H = 1024 (8
# units, 4 columns) but not 1032 (8 units, 5 columns), which the
# shared-memory kernel takes up to 1320 (10 units); wider layers take the
# per-step kernel (None)
BWD_PLAN_ON_H100 = {100: "register", 200: "register", H: "register",
                    1032: "shared", 1320: "shared", WIDE_H: None}
# one forward_backward of the full-width LM, card against the port's CPU
GRAD_T, GRAD_N = 8, 4
# gradients card against CPU, fp32 with TF32 off on both: summation order
# only, through 8 steps and the 10000-way softmax; each held relative to its
# own largest magnitude (on the CPU from 0.012 for embed_weight to 1.0 for
# pred_bias)
GRAD_TOL = 1e-5
CARD = "cuda"


def train_counts():
    """(lstm_sequence_fused, lstm_sequence_backward, its register kernel's,
    lstm_cell_fused, lstm_cell_backward) launches."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    return (L.lstm_sequence_fused.launches, L.lstm_sequence_backward.launches,
            L.lstm_sequence_backward.register_launches,
            L.lstm_cell_fused.launches, L.lstm_cell_backward.launches)


def zero_train_counts():
    from mxnet_tpu_torch.ops.cuda import lstm as L
    for fn in (L.lstm_sequence_fused, L.lstm_sequence_backward,
               L.lstm_cell_fused, L.lstm_cell_backward):
        fn.launches = 0
    L.lstm_sequence_backward.register_launches = 0


def backward_case(steps, n, hdim, dtype, seed):
    """The sequence inputs and head cotangents (dout, dhT, dcT) at the
    LM's scale."""
    args = sequence_inputs(steps, n, hdim, dtype, seed)
    rng = np.random.RandomState(seed + 1000)
    cots = [torch.tensor(rng.normal(0, 0.1, shape), dtype=dtype, device=CARD)
            for shape in ((steps, n, hdim), (n, hdim), (n, hdim))]
    return args, cots


def max_err_against(got, want, tag, name):
    """(error, tolerance): fp32 SEQ_FP32_TOL (relative to the magnitude
    for dw, a sum over T*N rows), bf16 two bf16 ulps at the reference's
    largest magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    if tag == "fp32":
        scale = max(1.0, want.abs().max().item()) if name == "dw" else 1.0
        return err, SEQ_FP32_TOL * scale
    return err, bf16_state_tol(want)


def phase_train_kernels():
    """K1, the training forward (the sequence kernel, or at H=WIDE_H the
    per-step kernel, keeping gates and c), against
    lstm_sequence_train_plain, and the backward (K2, the sequence backward
    kernel the plan gives: the register kernel, or the shared-memory
    one at H=1032 and 1320; K3, the per-step one at H=WIDE_H) against
    lstm_sequence_backward_plain on the same card tensors, fp32 and bf16,
    both directions, each shape held to the kernel its plan must take
    (BWD_PLAN_ON_H100). Where the register kernel runs, the shared-memory
    kernel (timed beside it) is held to the same plain result, and two
    launches of the register kernel give the same bits. bf16 dw, which
    the kernel route sums in fp32 once and the plain version rounds to
    bf16 every step, is held to the fp32 sum of the plain version's
    dgates. Returns the worst errors by kernel and the plans."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    errs = {k: {"fp32": 0.0, "bf16_ulps": 0.0}
            for k in ("forward", "sequence_backward", "register",
                      "shared", "cell_backward")}
    plans = {}
    for steps, n, hdim in BWD_CASES:
        plan = L.backward_plan(n, hdim, torch.device(CARD, 0))
        plans[f"T={steps} N={n} H={hdim}"] = plan._asdict()
        if plan.variant != BWD_PLAN_ON_H100[hdim]:
            raise RuntimeError(f"backward plan N={n} H={hdim}: {plan}")
        kernel = plan.variant or "cell_backward"
        log(f"[train-kernels] backward plan T={steps} N={n} H={hdim}: "
            f"{plan}")
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            (xproj, h0, c0, w), (dout, dh_last, dc_last) = backward_case(
                steps, n, hdim, dtype, seed=steps + n + hdim)
            for reverse in (False, True):
                saved = L.lstm_sequence_train(xproj, h0, c0, w, reverse)
                plain = L.lstm_sequence_train_plain(xproj, h0, c0, w, reverse)
                torch.cuda.synchronize()
                for name, g, p in zip(("out", "hT", "cT", "gates", "cs"),
                                      saved, plain):
                    if g.dtype != p.dtype or g.shape != p.shape:
                        raise RuntimeError(f"training forward {name}: "
                                           f"{g.dtype} {tuple(g.shape)}")
                    err, tol = max_err_against(g, p, tag, name)
                    if not err <= tol:
                        raise RuntimeError(
                            f"training forward {tag} T={steps} N={n} "
                            f"H={hdim} reverse={reverse} {name}: {err} > "
                            f"{tol}")
                    errs["forward"][tag if tag == "fp32" else "bf16_ulps"] = \
                        max(errs["forward"][tag if tag == "fp32"
                                            else "bf16_ulps"],
                            err if tag == "fp32" else 2 * err / tol)
                out, _, _, gates, cs = saved
                case = (dout, dh_last, dc_last, gates, cs, out, h0, c0, w)
                before = train_counts()
                got = L.lstm_sequence_backward(*case, reverse=reverse)
                torch.cuda.synchronize()
                moved = tuple(a - b for a, b in zip(train_counts(), before))
                want_moved = {"register": (0, 1, 1, 0, 0),
                              "shared": (0, 1, 0, 0, 0),
                              None: (0, 0, 0, 0, steps + 1)}[plan.variant]
                if moved != want_moved:
                    raise RuntimeError(f"backward launched {moved}, expected "
                                       f"{want_moved}")
                want = L.lstm_sequence_backward_plain(*case, reverse=reverse)
                runs = [(kernel, got)]
                if plan.variant == "register":
                    # a second launch: the same sums in the same order, so
                    # the same bits
                    again = L.lstm_sequence_backward(*case, reverse=reverse)
                    if not all(torch.equal(a, b)
                               for a, b in zip(got[:3], again[:3])):
                        raise RuntimeError(
                            f"register backward T={steps} N={n} H={hdim} "
                            f"{tag} reverse={reverse}: two launches differ")
                    shared = L._sequence_backward_launch(
                        dout, dh_last, dc_last, gates, cs, h0, c0, w,
                        reverse, variant="shared")
                    runs.append(("shared", tuple(shared) + (got[3],)))
                for label, result in runs:
                    worst = []
                    for name, g, p in zip(("dxproj", "dh0", "dc0", "dw"),
                                          result, want):
                        if g.dtype != p.dtype or g.shape != p.shape:
                            raise RuntimeError(f"backward {name}: {g.dtype} "
                                               f"{tuple(g.shape)}")
                        if name == "dw" and tag == "bf16":
                            h_prev = (torch.cat([out[1:], h0[None]])
                                      if reverse
                                      else torch.cat([h0[None], out[:-1]]))
                            p = torch.einsum("tnk,tnh->kh", want[0],
                                             h_prev.float())
                        err, tol = max_err_against(g, p, tag, name)
                        if not err <= tol:
                            raise RuntimeError(
                                f"{label} {tag} T={steps} N={n} H={hdim} "
                                f"reverse={reverse} {name} disagrees with "
                                f"the plain backward: {err} > {tol}")
                        worst.append(err if tag == "fp32" else 2 * err / tol)
                    log(f"[train-kernels] {label} T={steps} N={n} H={hdim} "
                        f"{tag} reverse={reverse}: max|d| dxproj, dh0, dc0, "
                        "dw " + ", ".join(f"{e:.3e}" for e in worst)
                        + (" (tol 1e-4, dw relative)" if tag == "fp32"
                           else " bf16 ulps (tol 2; dw against the fp32 "
                           "sum)"))
                    key = "fp32" if tag == "fp32" else "bf16_ulps"
                    keys = [label] + (["sequence_backward"]
                                      if label != "cell_backward" else [])
                    for k in keys:
                        errs[k][key] = max(errs[k][key], *worst)
    errs["mixed"] = mixed_dtype_check()
    return errs, plans


def mixed_dtype_check():
    """B1's wrappers at the dtypes the fused bf16 LSTM step gives them
    (phase 14): fp32 xproj, h0 and c0 with a bf16 w_h2h, which they widen
    to fp32 for the kernels, at the main path's shape, both directions.
    Held to the plain versions on the same card tensors: the training
    forward, dxproj, dh0 and dc0 at the fp32 tolerance; dw, which the
    plain version sums in bf16 step by step and the kernel route in fp32
    once, against the fp32 sum of the plain version's dgates at two bf16
    ulps. Returns the worst errors."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    (xproj, h0, c0, w), (dout, dh_last, dc_last) = backward_case(
        TRAIN_T, TRAIN_N, H, torch.float32, seed=17)
    w = w.to(torch.bfloat16)
    errs = {"forward_fp32": 0.0, "backward_fp32": 0.0, "dw_bf16_ulps": 0.0}
    for reverse in (False, True):
        saved = L.lstm_sequence_train(xproj, h0, c0, w, reverse)
        plain = L.lstm_sequence_train_plain(xproj, h0, c0, w, reverse)
        torch.cuda.synchronize()
        checks = list(zip(("out", "hT", "cT", "gates", "cs"), saved, plain))
        out, _, _, gates, cs = saved
        case = (dout, dh_last, dc_last, gates, cs, out, h0, c0, w)
        before = train_counts()
        got = L.lstm_sequence_backward(*case, reverse=reverse)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(train_counts(), before))
        if moved != (0, 1, 1, 0, 0):
            raise RuntimeError(f"mixed-dtype backward launched {moved}, "
                               "expected the register kernel once")
        want = L.lstm_sequence_backward_plain(*case, reverse=reverse)
        h_prev = (torch.cat([out[1:], h0[None]]) if reverse
                  else torch.cat([h0[None], out[:-1]]))
        checks += list(zip(("dxproj", "dh0", "dc0"), got[:3], want[:3]))
        checks.append(("dw", got[3], want[3]))
        for name, g, p in checks:
            if g.dtype != p.dtype or g.shape != p.shape:
                raise RuntimeError(f"mixed-dtype {name}: {g.dtype} "
                                   f"{tuple(g.shape)}, plain {p.dtype} "
                                   f"{tuple(p.shape)}")
            if name == "dw":
                p = torch.einsum("tnk,tnh->kh", want[0], h_prev.float())
                err, tol = max_err_against(g, p, "bf16", name)
                key, value = "dw_bf16_ulps", 2 * err / tol
            else:
                err, tol = max_err_against(g, p, "fp32", name)
                key = ("forward_fp32" if name in ("out", "hT", "cT", "gates",
                                                  "cs") else "backward_fp32")
                value = err
            if not err <= tol:
                raise RuntimeError(
                    f"mixed-dtype T={TRAIN_T} N={TRAIN_N} H={H} "
                    f"reverse={reverse} {name} disagrees with the plain "
                    f"version: {err} > {tol}")
            errs[key] = max(errs[key], value)
    log(f"[train-kernels] fp32 states with a bf16 w_h2h, T={TRAIN_T} "
        f"N={TRAIN_N} H={H}, both directions: training forward "
        f"{errs['forward_fp32']:.3e}, dxproj/dh0/dc0 "
        f"{errs['backward_fp32']:.3e} (tol {SEQ_FP32_TOL}), dw "
        f"{errs['dw_bf16_ulps']:.3f} bf16 ulps against the fp32 sum (tol 2)")
    return errs


def phase_train_card_vs_cpu():
    """One forward_backward of the full-width LM at T=GRAD_T, N=GRAD_N on
    the card and on the port's CPU path, from the same seeded Xavier
    init: every gradient within GRAD_TOL of the CPU's, relative to its
    own largest magnitude."""
    import mxnet_tpu_torch as mx
    net = build_lm(mx, V, H, LAYERS, GRAD_T, train=True)
    rng = np.random.RandomState(21)
    tokens = [rng.randint(0, V, (GRAD_N, GRAD_T)).astype(np.float32)
              for _ in range(2)]
    grads = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        mx.random.seed(0)
        mod = mx.mod.Module(net, context=ctx)
        mod.bind(data_shapes=[("data", (GRAD_N, GRAD_T))],
                 label_shapes=[("softmax_label", (GRAD_N, GRAD_T))])
        mod.init_params(mx.init.Xavier())
        batch = mx.io.DataBatch([mx.nd.array(tokens[0], ctx=mx.cpu())],
                                [mx.nd.array(tokens[1], ctx=mx.cpu())])
        mod.forward_backward(batch)
        grads[ctx.device_type] = {n: g.asnumpy()
                                  for n, g in mod._exec.grad_dict.items()}
    errs, scales = {}, {}
    for name, cpu in grads["cpu"].items():
        card = grads["gpu"][name]
        scales[name] = float(np.abs(cpu).max())
        errs[name] = float(np.abs(card - cpu).max()) / scales[name]
        if not np.isfinite(card).all() or not errs[name] <= GRAD_TOL:
            raise RuntimeError(f"gradient {name}: card against CPU "
                               f"{errs[name]} > {GRAD_TOL}")
    log(f"[train] full-width LM T={GRAD_T} N={GRAD_N}: gradients card "
        f"against CPU, max|d| / max|cpu|: {errs} (tol {GRAD_TOL}); "
        f"max|cpu| {scales}")
    return errs


def cross_entropy(mx, mod, batch):
    metric = mx.metric.CrossEntropy()
    mod.update_metric(metric, batch.label)
    return metric.get()[1]


def descent_losses(mx, net, batch):
    """TRAIN_STEPS steps on the repeated batch from the same seeded init
    at the bench's learning rate divided by T: the loss must fall. At the
    bench's 0.5 the softmax gradient, summed over N*T rows and rescaled by
    1/N, takes a step T times the per-token one, and the loss on a
    repeated batch does not fall past the first steps, in the JAX package
    as in the port (tests/test_torch_port_module.py, at T=256 and toy
    widths)."""
    mx.random.seed(0)
    mod = mx.mod.Module(net)
    mod.bind(data_shapes=[("data", (TRAIN_N, TRAIN_T))],
             label_shapes=[("softmax_label", (TRAIN_N, TRAIN_T))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        TRAIN_SGD, learning_rate=TRAIN_STEP_LR))
    losses = []
    for _ in range(TRAIN_STEPS):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        losses.append(cross_entropy(mx, mod, batch))
    log(f"[train] {TRAIN_STEPS} steps on one batch at learning rate "
        f"{TRAIN_STEP_LR}: cross-entropy "
        f"{[round(x, 5) for x in losses]}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss on the repeated batch did not fall: "
                           f"{losses}")
    return losses


def train_data(mx):
    """The bench shape's seeded tokens: (data, label) of TRAIN_BATCHES
    batches, and the first batch as a DataBatch on the host."""
    rng = np.random.RandomState(0)
    shape = (TRAIN_BATCHES * TRAIN_N, TRAIN_T)
    data = rng.randint(0, V, shape).astype(np.float32)
    label = rng.randint(0, V, shape).astype(np.float32)
    batch = mx.io.DataBatch([mx.nd.array(data[:TRAIN_N], ctx=mx.cpu())],
                            [mx.nd.array(label[:TRAIN_N], ctx=mx.cpu())])
    return data, label, batch


def bench_lr_run(mx, net, data, label, batch, steps, on_step=None):
    """From the seeded Xavier init on the default context: one fit epoch
    over the batches, then ``steps`` steps on ``batch``, all at the bench's
    TRAIN_SGD; each step's cross-entropy. ``on_step(step, loss, mod)``
    runs after each step's update."""
    mx.random.seed(0)
    mod = mx.mod.Module(net)
    mod.bind(data_shapes=[("data", (TRAIN_N, TRAIN_T))],
             label_shapes=[("softmax_label", (TRAIN_N, TRAIN_T))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_SGD)
    mod.fit(mx.io.NDArrayIter(data, label, batch_size=TRAIN_N), num_epoch=1,
            eval_metric=mx.metric.create("ce"))
    losses = []
    for step in range(steps):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        losses.append(cross_entropy(mx, mod, batch))
        if on_step is not None:
            on_step(step, losses[-1], mod)
    return losses


@contextlib.contextmanager
def plain_backward_on_card():
    """The LSTM layers' backward (``lstm_sequence_backward``, as
    ``_Sequence`` calls it) through ``lstm_sequence_backward_plain`` on the
    card's tensors for the block: no kernel launch, none counted."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    kernel_route = L.lstm_sequence_backward

    def plain(dout, dh_last, dc_last, gates, cs, out, h0, c0, w,
              reverse=False):
        dout, dh_last, dc_last = (x.to(h0.dtype).contiguous()
                                  for x in (dout, dh_last, dc_last))
        return L.lstm_sequence_backward_plain(dout, dh_last, dc_last, gates,
                                              cs, out, h0, c0, w, reverse)
    L.lstm_sequence_backward = plain
    try:
        yield
    finally:
        L.lstm_sequence_backward = kernel_route


def bench_lr_routes(mx, net, data, label, batch):
    """The fit epoch and BENCH_LR_STEPS steps at the bench's lr 0.5
    (bench_lr_run) through the backward kernels and through the plain
    backward on the card: every loss finite, each step's within
    BENCH_LR_TOL of the other route's. Returns {route: losses}."""
    losses = {"kernels": bench_lr_run(mx, net, data, label, batch,
                                      BENCH_LR_STEPS)}
    with plain_backward_on_card():
        losses["plain"] = bench_lr_run(mx, net, data, label, batch,
                                       BENCH_LR_STEPS)
    worst = max(abs(a - b) for a, b in zip(losses["kernels"],
                                           losses["plain"]))
    log(f"[train] {BENCH_LR_STEPS} steps on one batch at the bench's "
        f"{TRAIN_SGD} after its fit epoch: cross-entropy through the "
        f"kernels {losses['kernels']}, through the plain backward on the "
        f"card {losses['plain']}; max|d| {worst!r} (tol {BENCH_LR_TOL})")
    if not all(math.isfinite(x) for v in losses.values() for x in v) or not (
            worst <= BENCH_LR_TOL):
        raise RuntimeError(f"at the bench's learning rate the kernels' "
                           f"losses leave the plain backward's: {losses}")
    return losses


def phase_train_bench():
    """The main training path at the benchmark's shape: Module on the
    default context, one fit epoch over TRAIN_BATCHES batches at the
    benchmark's learning rate, then TRAIN_STEPS forward/backward/update
    steps on one batch at TRAIN_STEP_LR; each step two sequence-kernel
    forwards and two sequence-kernel backwards, both on the register
    kernel, and no per-step launch; every loss, output and parameter
    finite. Then the descent at TRAIN_STEP_LR (descent_losses), the steps
    at the bench's rate through the kernels against the plain backward
    (bench_lr_routes), ms per step (CUDA events, median of 7), tokens/s,
    peak memory and one profiled step."""
    import mxnet_tpu_torch as mx
    net = build_lm(mx, V, H, LAYERS, TRAIN_T, train=True)
    data, label, batch = train_data(mx)
    marks = []
    torch.cuda.reset_peak_memory_stats()
    # the main path's run starts here
    zero_train_counts()
    mx.random.seed(0)
    mod = mx.mod.Module(net)  # the default context, gpu(0)
    mod.bind(data_shapes=[("data", (TRAIN_N, TRAIN_T))],
             label_shapes=[("softmax_label", (TRAIN_N, TRAIN_T))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_SGD)
    fit_metric = mx.metric.create("ce")
    mod.fit(mx.io.NDArrayIter(data, label, batch_size=TRAIN_N), num_epoch=1,
            eval_metric=fit_metric,
            batch_end_callback=lambda p: marks.append(train_counts()))
    mod._optimizer.set_learning_rate(TRAIN_STEP_LR)
    losses = []
    for _ in range(TRAIN_STEPS):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        marks.append(train_counts())
        losses.append(cross_entropy(mx, mod, batch))
    launches = train_counts()  # the main path's run ends here
    peak = torch.cuda.max_memory_allocated()
    per_step = [tuple(a - b for a, b in zip(m, prev))
                for m, prev in zip(marks, [(0,) * 5] + marks[:-1])]
    log(f"[train] LM V={V} H={H} layers={LAYERS} N={TRAIN_N} T={TRAIN_T}: "
        f"fit over {TRAIN_BATCHES} batches, cross-entropy "
        f"{fit_metric.get()[1]:.4f} at {TRAIN_SGD}; {TRAIN_STEPS} steps on "
        f"one batch at learning rate {TRAIN_STEP_LR}, cross-entropy "
        f"{[round(x, 4) for x in losses]}")
    log(f"[train] (lstm_sequence, lstm_sequence_backward, its register "
        f"kernel, lstm_cell, lstm_cell_backward) launches per step "
        f"{per_step}; total {launches}; peak device memory {peak} bytes")
    if any(c != (LAYERS, LAYERS, LAYERS, 0, 0) for c in per_step):
        raise RuntimeError(f"launches per step {per_step}, expected "
                           f"{(LAYERS, LAYERS, LAYERS, 0, 0)}: every "
                           "backward on the register kernel")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    out = mod.get_outputs()[0]
    if out.shape != (TRAIN_N * TRAIN_T, V) or not bool(
            torch.isfinite(out._data).all()):
        raise RuntimeError(f"outputs {out.shape} not finite")
    for name, arr in mod.get_params()[0].items():
        if not bool(torch.isfinite(arr._data).all()):
            raise RuntimeError(f"parameter {name} not finite")
    descent = descent_losses(mx, net, batch)
    bench_lr = bench_lr_routes(mx, net, data, label, batch)

    def step():
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    event_ms, host_ms = [], []
    for _ in range(8):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
    event_ms, host_ms = event_ms[1:], host_ms[1:]  # the first warms up
    ms = statistics.median(event_ms)
    tokens = TRAIN_N * TRAIN_T / ms * 1e3
    log(f"[train] one step (forward, backward, SGD update) at N={TRAIN_N} "
        f"T={TRAIN_T}: median {ms:.3f} ms (CUDA events) of "
        f"{[round(x, 3) for x in event_ms]}, host clock median "
        f"{statistics.median(host_ms):.3f} ms; {tokens:.1f} tokens/s")
    profile = profile_device(f"one training step N={TRAIN_N} T={TRAIN_T}",
                             step)
    return {"launches": launches, "per_step": per_step[0],
            "losses": losses, "descent_losses": descent,
            "bench_lr_losses": bench_lr,
            "fit_cross_entropy": fit_metric.get()[1],
            "step_ms": ms, "step_runs_ms": event_ms,
            "step_host_ms": statistics.median(host_ms),
            "tokens_per_s": tokens, "peak_device_bytes": peak,
            "profile": profile}


def phase_train_wide():
    """A training step of the one-layer LM at H=WIDE_H (over the sequence
    kernels' shared memory), one row, T steps: the per-step forward kernel
    T times and the per-step backward kernel T + 1 times. Returns the
    per-step backward kernel's launches in this run."""
    import mxnet_tpu_torch as mx
    net = build_lm(mx, V, WIDE_H, 1, T, train=True)
    rng = np.random.RandomState(5)
    batch = mx.io.DataBatch(
        [mx.nd.array(rng.randint(0, V, (1, T)).astype(np.float32),
                     ctx=mx.cpu())],
        [mx.nd.array(rng.randint(0, V, (1, T)).astype(np.float32),
                     ctx=mx.cpu())])
    # this path's run starts here
    zero_train_counts()
    mx.random.seed(3)
    mod = mx.mod.Module(net)
    mod.bind(data_shapes=[("data", (1, T))],
             label_shapes=[("softmax_label", (1, T))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_SGD)
    mod.forward_backward(batch)
    mod.update()
    launches = train_counts()  # this path's run ends here
    log(f"[train-wide] one step of the LM at H={WIDE_H}, 1 layer, 1 row: "
        f"(lstm_sequence, lstm_sequence_backward, its register kernel, "
        f"lstm_cell, lstm_cell_backward) launches {launches}")
    if launches != (0, 0, 0, T, T + 1):
        raise RuntimeError(f"wide training step launched {launches}, "
                           f"expected {(0, 0, 0, T, T + 1)}")
    for name, arr in mod.get_params()[0].items():
        if not bool(torch.isfinite(arr._data).all()):
            raise RuntimeError(f"wide LM parameter {name} not finite")
    return launches[4]


def sequence_backward_bound_ms(steps, n, hdim, elem_bytes):
    """Least time on an H100 for one layer's backward: each input (dout,
    dhT, dcT, the fp32 gates, cs, c0, w_h2h) read once and each output
    (the fp32 dgates, dh0, dc0) written once, against the products'
    2*T*N*4H*H operations (dh = dgates . w_h2h) at the fp32 peak."""
    nbytes = (elem_bytes * (2 * steps * n * hdim + 4 * n * hdim
                            + 4 * hdim * hdim)
              + 4 * 2 * steps * n * 4 * hdim)
    flops = 2 * steps * n * 4 * hdim * hdim
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


# the backward sequence kernels timed side by side in phase 11, in two
# rounds of alternating order: the plan's kernel (the register kernel),
# the shared-memory kernel, and the register kernel built by
# tools/probe_lstm_bwd.py without its products (copies, reductions,
# epilogue and writer counts) and without its dgates copies (products on
# stale tiles, reductions, epilogue, counts): wrong gradients on purpose,
# only what each part costs
BWD_TIMED = ("register", "shared", "no_product", "no_copy")


def backward_kernels_ms(args, probe_libs):
    """Device ms of one launch of each BWD_TIMED kernel on the same
    (dout, dh_last, dc_last, gates, cs, h0, c0, w), forward direction:
    {name: mean}, and {name: [round 1, round 2]}. probe_libs: {probe
    number: the probe build, loaded by tools/probe_lstm_bwd.py}."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    probe = probe_tool()
    calls = {
        "register": lambda: L._sequence_backward_launch(*args, False),
        "shared": lambda: L._sequence_backward_launch(*args, False,
                                                      "shared")}
    for p, name in probe.PROBES.items():
        calls[name] = functools.partial(probe.probe_backward, probe_libs[p],
                                        *args)
    rounds = {name: [] for name in BWD_TIMED}
    for r in range(2):
        for name in BWD_TIMED if r == 0 else BWD_TIMED[::-1]:
            rounds[name].append(time_on_stream(calls[name], iters=10))
    return ({name: statistics.mean(v) for name, v in rounds.items()},
            rounds)


def phase_train_timing(probe_libs):
    """The backward of one LSTM layer (H=1024, fp32) at T=128, N=1 and 16,
    and at the bench shape: the backward sequence kernels side by side
    (BWD_TIMED: the plan's register kernel, the shared-memory kernel, and the
    register kernel's probe builds without products and without copies),
    the kernel route with
    its dw product, the plain loop, the port's whole layer backward and
    cuDNN's torch.nn.LSTM backward (each through autograd, from the same
    inputs, weights and cotangents: the data, state and weight gradients,
    the input projection's included; their agreement is reported); then
    the per-step backward kernel at N=1, H=WIDE_H, its plain step and the dh
    product as torch.matmul. The port never calls cuDNN."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    from mxnet_tpu_torch.ops.rnn_ops import _run_direction
    out = {}
    for steps, n in ((T, 1), (T, 16), (TRAIN_T, TRAIN_N)):
        (xproj, h0, c0, w), (dout, dh_last, dc_last) = backward_case(
            steps, n, H, torch.float32, seed=31 + n)
        o, _, _, gates, cs = L.lstm_sequence_train(xproj, h0, c0, w)
        case = (dout, dh_last, dc_last, gates, cs, o, h0, c0, w)
        kernels, rounds = backward_kernels_ms(
            (dout, dh_last, dc_last, gates, cs, h0, c0, w), probe_libs)
        rng = np.random.RandomState(41 + n)
        x_in = torch.tensor(rng.normal(0, 1, (steps, n, H)),
                            dtype=torch.float32, device=CARD)
        cudnn = torch.nn.LSTM(H, H, 1).cuda()
        h0c = h0[None].clone().requires_grad_()
        c0c = c0[None].clone().requires_grad_()
        x_c = x_in.clone().requires_grad_()
        y, (hy, cy) = cudnn(x_c, (h0c, c0c))
        leaves = [x_c, h0c, c0c] + list(cudnn.parameters())

        def cudnn_backward():
            return torch.autograd.grad((y, hy, cy), leaves,
                                       (dout, dh_last[None], dc_last[None]),
                                       retain_graph=True)

        # the port's layer on cuDNN's inputs and weights: the input
        # projection (torch products) and the training Function (K1, K2)
        port = _run_direction(
            x_c, h0c[0], c0c[0], cudnn.weight_ih_l0, cudnn.weight_hh_l0,
            cudnn.bias_ih_l0, cudnn.bias_hh_l0, "lstm", H)

        def layer_backward():
            return torch.autograd.grad(port, leaves,
                                       (dout, dh_last, dc_last),
                                       retain_graph=True)

        layer_err = max(
            ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for a, b in zip(layer_backward(), cudnn_backward()))
        row = {
            "kernel_ms": kernels["register"],
            "shared_kernel_ms": kernels["shared"],
            "kernels_ms": kernels,
            "kernels_rounds_ms": rounds,
            "plan": L.backward_plan(n, H, torch.device(CARD, 0))._asdict(),
            "route_ms": time_on_stream(
                lambda: L.lstm_sequence_backward(*case), iters=10),
            "plain_ms": time_on_stream(
                lambda: L.lstm_sequence_backward_plain(*case), iters=2),
            "cudnn_backward_ms": time_on_stream(cudnn_backward, iters=10),
            "layer_backward_ms": time_on_stream(layer_backward, iters=10),
            "layer_vs_cudnn_max_rel": layer_err,
            "forward_kernel_ms": time_on_stream(
                lambda: L.lstm_sequence_fused(xproj, h0, c0, w), iters=10),
            "train_forward_kernel_ms": time_on_stream(
                lambda: L.lstm_sequence_train(xproj, h0, c0, w), iters=10),
        }
        row["bound_ms"], row["bound_by"] = sequence_backward_bound_ms(
            steps, n, H, 4)
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        out[f"T={steps} N={n}"] = row
        log(f"[train-timing] backward sequence kernels T={steps} N={n} "
            f"H={H} fp32, plan {row['plan']}: " + ", ".join(
                f"{name} {ms * 1e3:.1f} us (rounds "
                f"{[round(x * 1e3, 1) for x in rounds[name]]})"
                for name, ms in kernels.items()))
        log(f"[train-timing] one layer's backward T={steps} N={n} H={H} "
            f"fp32: register backward kernel {row['kernel_ms'] * 1e3:.1f} "
            f"us (the shared-memory kernel "
            f"{row['shared_kernel_ms'] * 1e3:.1f} us), bound "
            f"{row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} "
            f"(share {row['share_of_bound']:.3f}); with its dw product "
            f"{row['route_ms'] * 1e3:.1f} us; plain "
            f"{row['plain_ms'] * 1e3:.1f} us; the port's layer backward "
            f"{row['layer_backward_ms'] * 1e3:.1f} us against cuDNN's "
            f"{row['cudnn_backward_ms'] * 1e3:.1f} us (input projection "
            f"included, gradients agree to "
            f"{row['layer_vs_cudnn_max_rel']:.2e} of each one's largest); "
            f"forward kernel "
            f"{row['forward_kernel_ms'] * 1e3:.1f} us (inference), "
            f"{row['train_forward_kernel_ms'] * 1e3:.1f} us (training)")
    # the per-step backward kernel at the wide LM's shape, one step
    n, hdim = 1, WIDE_H
    (xproj, h0, c0, w), (dout, dh_last, dc_last) = backward_case(
        2, n, hdim, torch.float32, seed=51)
    o, _, _, gates, cs = L.lstm_sequence_train(xproj, h0, c0, w)
    w_t = w.t().contiguous()
    dg_next = torch.randn(n, 4 * hdim, device=CARD) * 0.01
    dg_out = torch.empty(n, 4 * hdim, device=CARD)
    dc = dc_last.clone()

    def cell_step():
        L.lstm_cell_backward(dg_next, w_t, gates[1], cs[0], dout[1],
                             dh_last, dc, dg_out, dc)

    cell = {
        "kernel_ms": time_on_stream(cell_step),
        "plain_ms": time_on_stream(lambda: L.lstm_cell_backward_plain(
            dout[1] + torch.matmul(dg_next, w).to(h0.dtype), dc, gates[1],
            cs[0], w, o[0])),
        "library_ms": time_on_stream(lambda: torch.matmul(dg_next, w)),
    }
    nbytes = 4 * (n * 4 * hdim + 4 * hdim * hdim + n * 4 * hdim
                  + 4 * n * hdim + n * 4 * hdim + n * hdim)
    flops = 2 * n * 4 * hdim * hdim
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    cell["bound_ms"] = max(by_bytes, by_ops) * 1e3
    cell["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    log(f"[train-timing] per-step backward kernel N={n} H={hdim} fp32: "
        f"{cell['kernel_ms'] * 1e3:.2f} us, bound "
        f"{cell['bound_ms'] * 1e3:.2f} us by {cell['bound_by']}; plain "
        f"{cell['plain_ms'] * 1e3:.2f} us; torch.matmul (dh) "
        f"{cell['library_ms'] * 1e3:.2f} us")
    out["cell"] = cell
    return out


def train_records(kerrs, plans, grad_errs, bench, wide_launches, timing,
                  reg_build):
    """The lstm_sequence_backward and lstm_cell_backward entries of the
    kernels line. The first is the main path's kernel, the register
    kernel (``lstm_seq_bwd_reg_kernel``), with the shared-memory kernel
    beside it."""
    main = timing[f"T={TRAIN_T} N={TRAIN_N}"]
    seq = {
        "name": "lstm_sequence_backward",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "mxnet_tpu/ops/pallas/lstm.py:77",
        "replaces_note": "_cell_bwd (jnp, the VJP of the Pallas cell "
                         "mxnet_tpu/ops/pallas/lstm.py:57), run once a step "
                         "by jax.vjp of the scan in "
                         "mxnet_tpu/ops/rnn_ops.py:139",
        "launches": bench["launches"][2],
        "launches_note": "the register kernel's launches on the main "
                         "path (phase 11); every sequence backward of it: "
                         f"{bench['launches'][1]}",
        "variant": "register: lstm_seq_bwd_reg_kernel (w_h2h in "
                   "registers, dgates by bulk copies into a shared-memory "
                   "ring, a writer count per tile of rows for the grid "
                   "barrier)",
        "registers_note": (
            f"ptxas reports {reg_build['float_8']['registers']} registers "
            "a thread at launch for <float, 8> (this run's build log); the "
            "kernel's setmaxnreg instructions then set "
            f"{reg_build['setmaxnreg']['inc']} for the consumer "
            f"warpgroups and {reg_build['setmaxnreg']['dec']} for the "
            "producer warpgroup (constants of the source, read from it)"),
        "setmaxnreg": reg_build["setmaxnreg"],
        "cluster_size": 1,
        "cluster_note": "launched without clusters: multicast copies of "
                        "the dgates tiles across clusters of 2 and 4 "
                        "measured slower (PERF.md)",
        "plan": main["plan"],
        "ptxas_float_8": reg_build["float_8"],
        "ptxas": reg_build["ptxas"],
        "plans": plans,
        "max_abs_err": kerrs["register"]["fp32"],
        "max_abs_err_shared_kernel": kerrs["shared"]["fp32"],
        "ms": main["kernel_ms"],
        "shared_kernel_ms": main["shared_kernel_ms"],
        "kernels_ms": main["kernels_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["cudnn_backward_ms"],
        "library": "torch.nn.LSTM (cuDNN, TF32 off) backward through "
                   "autograd: data, state and weight gradients, the input "
                   "projection's included",
        "layer_backward_ms": main["layer_backward_ms"],
        "layer_backward": "the port's whole layer backward through "
                          "autograd on the same inputs: K2, the dw product "
                          "and the input projection's gradients, the work "
                          "library_ms does",
        "shape": f"one layer T={TRAIN_T} N={TRAIN_N} H={H} fp32",
        "max_err_bf16_ulps": kerrs["register"]["bf16_ulps"],
        "max_err_bf16_ulps_shared_kernel": kerrs["shared"]["bf16_ulps"],
        "training_forward_max_err": kerrs["forward"],
        "mixed_dtype_max_err": kerrs["mixed"],
        "mixed_dtype_note": "fp32 xproj, h0 and c0 with a bf16 w_h2h (the "
                            "fused bf16 step's dtypes, phase 14), T="
                            f"{TRAIN_T} N={TRAIN_N} H={H}, both directions, "
                            "against the plain versions: forward and "
                            "dxproj/dh0/dc0 absolute (tol "
                            f"{SEQ_FP32_TOL}), dw in bf16 ulps against the "
                            "fp32 sum of the plain dgates (tol 2)",
        "share_of_bound": main["share_of_bound"],
        "by_shape": timing,
        "train": {k: bench[k] for k in (
            "per_step", "losses", "descent_losses", "bench_lr_losses",
            "fit_cross_entropy",
            "step_ms",
            "step_runs_ms", "step_host_ms", "tokens_per_s",
            "peak_device_bytes", "profile")},
        "gradients_card_vs_cpu": grad_errs,
    }
    cell = timing["cell"]
    cell_rec = {
        "name": "lstm_cell_backward",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "mxnet_tpu/ops/pallas/lstm.py:77",
        "launches": wide_launches,
        "launches_path": f"one training step of the LM at H={WIDE_H} "
                         "(phase 11); 0 on the 2x1024 LM's path",
        "max_abs_err": kerrs["cell_backward"]["fp32"],
        "ms": cell["kernel_ms"],
        "plain_ms": cell["plain_ms"],
        "bound_ms": cell["bound_ms"],
        "bound_by": cell["bound_by"],
        "library_ms": cell["library_ms"],
        "library": "torch.matmul(dgates, w_h2h), the step's product",
        "shape": f"one step N=1 H={WIDE_H} fp32",
        "max_err_bf16_ulps": kerrs["cell_backward"]["bf16_ulps"],
    }
    return [seq, cell_rec]


def rtc_record(rtc_k, imp, lang):
    t = imp["timing"]
    return {
        "name": "rtc",
        "route": "cuda",
        "compiler": "nvrtc",
        "source": "mxnet_tpu_torch/csrc/rtc_runtime.cu + "
                  "mxnet_tpu_torch/ops/cuda/rtc_codegen.py",
        "replaces": "mxnet_tpu/rtc.py:65",
        "launches": imp["launches"],
        "max_abs_err": max(rtc_k["max_abs_err"].values()),
        "ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "library_note": "no single torch call computes the SGD-momentum "
                        "body; axpy's is torch.add(y, x, alpha=2.0), below",
        "shape": f"SGD-momentum body on {t['largest']} "
                 f"({t['largest_n']} fp32 elements)",
        "scalar_ms": t["scalar_ms"],
        "vector_capped_grid_ms": t["vector_capped_grid_ms"],
        "kernel_turns_ms": t["kernel_turns_ms"],
        "vector_launches": imp["vector_launches"],
        "max_err_by_tolerance": rtc_k["max_abs_err"],
        "kernel_cases": rtc_k["cases"],
        "nvrtc": {k: rtc_k[k] for k in ("compiles", "cache_hits",
                                         "compile_seconds")},
        "imperative": {k: imp[k] for k in (
            "launches_per_step", "parameters", "tensors", "shapes",
            "modules", "cache_hits", "peak_device_bytes", "first_steps_ms",
            "save_load_bytes", "save_load_s")},
        "step_ms": {"updater": t["updater_step_ms"], "rtc": t["rtc_step_ms"],
                    "bound": t["step_bound_ms"],
                    "updater_host": t["updater_step_host_ms"],
                    "rtc_host": t["rtc_step_host_ms"]},
        "axpy": t["axpy"],
        "step_profiles": t["profiles"],
        # phase 19: the body language's map, reduce and product stages
        "stage_launches": lang["stage_launches"],
        "stage_launches_path": "phase 19b-19e: B1's Pallas body, the "
                               "transformer LM's log-softmax, head product "
                               "and clipped SGD step, each an Rtc body",
        "language": {
            "lstm_body_n64_h1024": lang["lstm_body"],
            "log_softmax_8192x32000": lang["log_softmax"],
            "head_product_8192x512x32000": lang["head_product"],
            "clip_norm_49.5M": lang["clip"],
            "forms": lang["kernels"]["cases"],
            "max_err_by_tolerance": lang["kernels"]["max_abs_err"],
            "seconds": lang["seconds"]},
    }


# -- transformer training (phase 12) -------------------------------------------

# the backward kernels against their plain versions on the card's tensors,
# each gradient relative to its largest magnitude (at least ATT_BWD_FLOOR:
# with one token dq is 0 by math, P = 1 and dS = dP - delta, and only
# summation order shows): fp32 only the summation order differs; bf16
# rounds P and dS to bf16 as the A operand of the dV, dK and dQ mma
# products (and each gradient once, as the plain version does)
ATT_BWD_FP32_TOL = 2e-5
ATT_BWD_BF16_TOL = 2.0 ** -6
ATT_BWD_FLOOR = 2.0 ** -10
# (B, H, Sq, Sk, D) of the transformer's attention at its largest bucket
ATT_SHAPE5 = ATT_SHAPE[:3] + ATT_SHAPE[2:]
# (label, (B, H, Sq, Sk, D), causal, lengths, packed segments, layout,
# dtype): the model's shape, ragged tiles, causal Sq < Sk at D = 128, the
# transformer's (B, S, H, D) views, the CUDA-core variant (fp32, D = 40),
# one token; the masked core with ATT_LENGTHS (batch 3 sees no key) and
# packed segments (pad tokens), one fp32 masked case, packed at D = 128.
# Every bf16 case runs the wgmma/TMA variant
ATT_BWD_CASES = [
    ("model", ATT_SHAPE5, True, None, False, "bhsd",
     torch.bfloat16),
    ("ragged", (2, 3, 1000, 1000, 64), False, None, False, "bhsd",
     torch.bfloat16),
    ("causal Sq<Sk D=128", (2, 2, 77, 200, 128), True, None, False, "bhsd",
     torch.bfloat16),
    ("views (B,S,H,D)", (2, 8, 500, 500, 64), True, None, False, "bshd",
     torch.bfloat16),
    ("fp32 D=40", (1, 2, 77, 77, 40), True, None, False, "bhsd",
     torch.float32),
    ("one token", (1, 1, 1, 1, 64), False, None, False, "bhsd",
     torch.bfloat16),
    ("lengths", ATT_SHAPE5, True, ATT_LENGTHS, False,
     "bhsd", torch.bfloat16),
    ("packed", ATT_SHAPE5, True, None, True, "bhsd",
     torch.bfloat16),
    ("fp32 masked", (2, 2, 300, 300, 64), True, [300, 111], True, "bhsd",
     torch.float32),
    ("packed D=128", (2, 4, 1000, 1000, 128), True, None, True, "bhsd",
     torch.bfloat16),
]
# the forward's row logsumexps (kept for the backward) against
# attention_lse_plain, absolute, on rows that see a key: fp32 sums in
# another order, the Hopper variants through exp2 and log2
ATT_LSE_TOL = 1e-5
# the transformer trained: TransformerConfig() on the default context,
# tokens (B, S + 1) from RandomState(0), plain SGD at this learning rate
# (TransformerLM.train_step's default)
TF_TRAIN_B, TF_TRAIN_S = 4, 2048
TF_TRAIN_STEPS = 10
TF_TRAIN_LR = 1e-3
# one lm_loss gradient of the fp32 LM, card against the port's CPU path,
# each held relative to its own largest magnitude: summation order only
TF_GRAD_B, TF_GRAD_S = 2, 128
TF_GRAD_TOL = 1e-5


def wgmma_backward_count():
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention as fa
    return fa.wgmma_backward_launches


def attention_counts():
    """(dense, masked, dense backward, masked backward) launches."""
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention as fa
    return (fa.launches, fa.masked_launches, fa.backward_launches,
            fa.masked_backward_launches)


def zero_attention_counts():
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention as fa
    for name in ("launches", "masked_launches", "wgmma_launches",
                 "mma_launches", "backward_launches",
                 "masked_backward_launches", "mma_backward_launches",
                 "wgmma_backward_launches"):
        setattr(fa, name, 0)


def attention_grad_inputs(b, h, sq, sk, d, dtype, seed, layout="bhsd"):
    """q, k, v and an output cotangent on the card; with layout "bshd",
    (B, H, S, D) views of (B, S, H, D) memory."""
    rng = np.random.RandomState(seed)

    def make(s):
        if layout == "bshd":
            return torch.tensor(rng.normal(0, 1, (b, s, h, d)), dtype=dtype,
                                device=CARD).transpose(1, 2)
        return torch.tensor(rng.normal(0, 1, (b, h, s, d)), dtype=dtype,
                            device=CARD)
    return make(sq), make(sk), make(sk), make(sq)


def phase_attention_backward_kernels():
    """(a) The backward kernels (csrc/flash_attention_bwd.cu) through the
    autograd Functions against the plain backward versions on the same
    card tensors; the route each takes (the wgmma/TMA variant for bf16 at
    D = 64 or 128 over views TMA can describe, CUDA cores for fp32); rows
    that see no key with dq exact 0 and keys no row sees with dk and dv
    exact 0; each case's forward row logsumexps, as the Hopper and the
    CUDA-core forward keep them (and the mma.sync forward, for bf16),
    against attention_lse_plain; for every bf16 case at D = 64 or 128,
    the earlier mma.sync backward (through _mma_sync_backward, given the
    forward's lse) against the same plain result, under the same
    tolerance and the same exact-zero checks. Then the masked core's
    training path: a
    packed and a length-masked batch through the public flash_attention,
    differentiated by torch.autograd.grad, as a caller training on packed
    rows does. Returns the worst errors by kernel, and the masked path's
    launches (all and the wgmma/TMA variant's)."""
    from mxnet_tpu_torch.ops.cuda.attention import (
        _combined_mask, _launch, _mma_sync_backward, attention_backward_plain,
        attention_lse_plain, flash_attention, masked_attention_backward_plain)
    errs = {name: {"fp32_rel": 0.0, "bf16_rel": 0.0, "max_abs": 0.0,
                   "lse_abs": 0.0, "mma_sync_bf16_rel": 0.0}
            for name in ("flash_attention_backward",
                         "flash_attention_masked_backward")}
    for i, (label, shape, causal, lengths, packed, layout, dtype) in \
            enumerate(ATT_BWD_CASES):
        b, h, sq, sk, d = shape
        q, k, v, do = attention_grad_inputs(b, h, sq, sk, d, dtype,
                                            seed=300 + i, layout=layout)
        lens = (None if lengths is None else
                torch.tensor(lengths, dtype=torch.int32, device=CARD))
        seg = packed_segments(b, sk) if packed else None
        masked = lens is not None or seg is not None
        name = ("flash_attention_masked_backward" if masked
                else "flash_attention_backward")
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, causal=causal, lengths=lens,
                              segment_ids=seg)
        before = (attention_counts(), flash_attention.mma_backward_launches,
                  wgmma_backward_count())
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        moved = (tuple(a - c for a, c in zip(attention_counts(), before[0])),
                 flash_attention.mma_backward_launches - before[1],
                 wgmma_backward_count() - before[2])
        wgmma = dtype == torch.bfloat16 and d in (64, 128)
        if moved != ((0, 0, int(not masked), int(masked)), 0, int(wgmma)):
            raise RuntimeError(f"{name} {label}: the counters moved {moved}")
        # the row logsumexps each forward variant keeps for the backward
        lse_want = attention_lse_plain(q, k, v, causal, lengths=lens,
                                       segment_ids=seg)
        live = lse_want > -1e29
        lse_errs, lses = [], []
        for route in ((0, 1) if wgmma else (0,)):
            lses.append(torch.empty((b, h, sq), dtype=torch.float32,
                                    device=CARD))
            _launch(q, k, v, causal, 1.0 / d ** 0.5, lens, seg, route=route,
                    lse=lses[-1])
            lse_errs.append((lses[-1] - lse_want)[live].abs().max().item())
            if not lse_errs[-1] <= ATT_LSE_TOL:
                raise RuntimeError(f"{name} {label}: the forward's lse "
                                   f"(route {route}) {lse_errs[-1]} from "
                                   f"attention_lse_plain")
        errs[name]["lse_abs"] = max(errs[name]["lse_abs"], *lse_errs)
        if masked:
            want = masked_attention_backward_plain(q, k, v, do, lens, seg,
                                                   causal=causal)
            mask = _combined_mask(sq, sk, causal, lens, seg, q.device)
            mask = mask.expand(b, h, sq, sk)
            dead_q, dead_k = ~mask.any(-1), ~mask.any(-2)
        else:
            want = attention_backward_plain(q, k, v, out.detach(), do,
                                            causal=causal)
        tol = ATT_BWD_FP32_TOL if dtype == torch.float32 else ATT_BWD_BF16_TOL

        def check(grads, variant):
            """Each gradient's largest error over the plain one's largest
            magnitude; raises past tol, or where a row or key the mask
            leaves alone has a nonzero gradient."""
            rel = []
            for gname, g, w in zip(("dq", "dk", "dv"), grads, want):
                if g.dtype != dtype or g.shape != w.shape:
                    raise RuntimeError(f"{name} {label} {variant} {gname}: "
                                       f"{g.dtype} {tuple(g.shape)}")
                diff = (g.float() - w.float()).abs().max().item()
                rel.append(diff / max(ATT_BWD_FLOOR,
                                      w.float().abs().max().item()))
                errs[name]["max_abs"] = max(errs[name]["max_abs"], diff)
                if not rel[-1] <= tol:
                    raise RuntimeError(
                        f"{name} {label} {variant} {gname} disagrees with "
                        f"the plain backward: {rel[-1]} > {tol}")
            if masked:
                if not (bool(dead_q.any())
                        and bool((grads[0][dead_q] == 0).all())
                        and bool((grads[1][dead_k] == 0).all())
                        and bool((grads[2][dead_k] == 0).all())):
                    raise RuntimeError(
                        f"{name} {label} {variant}: the gradients of rows "
                        "and keys the mask leaves alone are not exact 0")
                if lengths is not None and lengths[-1] == 0 and not all(
                        bool((g[-1] == 0).all()) for g in grads):
                    raise RuntimeError(f"{name} {label} {variant}: the "
                                       "length-0 batch's gradients are not "
                                       "exact 0")
            return rel

        rel = check(grads, "wgmma/TMA" if wgmma else "CUDA cores")
        key = "fp32_rel" if dtype == torch.float32 else "bf16_rel"
        errs[name][key] = max(errs[name][key], *rel)
        mma_rel = []
        if wgmma:  # the earlier mma.sync variant on the same inputs
            mma_before = flash_attention.mma_backward_launches
            mma_grads = _mma_sync_backward(q, k, v, out.detach(), do, causal,
                                           lengths=lens, segment_ids=seg,
                                           lse=lses[0])
            torch.cuda.synchronize()
            if flash_attention.mma_backward_launches != mma_before + 1:
                raise RuntimeError(f"{name} {label}: _mma_sync_backward "
                                   "did not launch the mma.sync variant")
            mma_rel = check(mma_grads, "mma.sync")
            errs[name]["mma_sync_bf16_rel"] = max(
                errs[name]["mma_sync_bf16_rel"], *mma_rel)
        dead = ""
        if masked:
            dead = (f"; {int(dead_q.sum())} rows and {int(dead_k.sum())} "
                    "keys unseen, their gradients exact 0")
        log(f"[train-attention] {name} {label} {shape} {str(dtype)[6:]}"
            f"{' (wgmma/TMA)' if wgmma else ' (CUDA cores)'}: dq, dk, dv "
            f"max|d| / max|plain| "
            + ", ".join(f"{e:.3e}" for e in rel)
            + ("; mma.sync variant " + ", ".join(f"{e:.3e}" for e in mma_rel)
               if mma_rel else "")
            + f" (tol {tol}){dead}; "
            f"forward lse max|d| on live rows "
            + ", ".join(f"{e:.2e}" for e in lse_errs)
            + f" ({'wgmma, mma.sync' if wgmma else 'CUDA cores'}; tol "
            f"{ATT_LSE_TOL})")

    # the masked core's training path
    b, h, s, d = ATT_SHAPE
    q, k, v, do = attention_grad_inputs(b, h, s, s, d, torch.bfloat16,
                                        seed=399)
    seg = packed_segments(b, s)
    lens = torch.tensor(ATT_LENGTHS, dtype=torch.int32, device=CARD)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    zero_attention_counts()  # the masked training path's run starts here
    grads = [torch.autograd.grad(
        flash_attention(*leaves, causal=True, **kw), leaves, do)
        for kw in ({"segment_ids": seg}, {"lengths": lens})]
    torch.cuda.synchronize()
    path = attention_counts()  # and ends here
    wgmma_path = wgmma_backward_count()
    log(f"[train-attention] masked training path, packed and length-masked "
        f"batches {ATT_SHAPE} bf16: (dense, masked, dense backward, masked "
        f"backward) launches {path}, of the backwards {wgmma_path} on the "
        "wgmma/TMA variant")
    if path != (0, 2, 0, 2) or wgmma_path != 2:
        raise RuntimeError(f"the masked training path launched {path}, "
                           f"{wgmma_path} wgmma backwards")
    if not all(bool(torch.isfinite(g).all()) for gs in grads for g in gs):
        raise RuntimeError("non-finite masked gradients")
    return errs, path[3], wgmma_path


def phase_tf_train_card_vs_cpu():
    """(b) One lm_loss gradient of the full-width LM in fp32 (TF32 off),
    B=TF_GRAD_B, S=TF_GRAD_S, parameters from init_params(0, cfg), on the
    card and on the port's CPU path: every gradient within TF_GRAD_TOL of
    its own largest magnitude."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params,
                                                    lm_loss_and_grads)
    cfg = TransformerConfig(dtype="float32")
    toks = np.random.RandomState(12).randint(
        0, cfg.vocab_size, (TF_GRAD_B, TF_GRAD_S + 1))
    before = attention_counts()
    loss_card, card = lm_loss_and_grads(init_params(0, cfg, ctx=mx.gpu(0)),
                                        torch.tensor(toks, device=CARD), cfg)
    torch.cuda.synchronize()
    moved = tuple(a - c for a, c in zip(attention_counts(), before))
    loss_cpu, cpu = lm_loss_and_grads(init_params(0, cfg, ctx=mx.cpu()),
                                      torch.tensor(toks), cfg)
    if moved != (cfg.num_layers, 0, cfg.num_layers, 0):
        raise RuntimeError(f"the fp32 gradient launched {moved}")
    errs, scales = {}, {}
    for name, want in cpu.items():
        got = card[name].cpu()
        scales[name] = float(want.abs().max())
        errs[name] = float((got - want).abs().max()) / scales[name]
        if not bool(torch.isfinite(got).all()) or not errs[name] <= \
                TF_GRAD_TOL:
            raise RuntimeError(f"transformer gradient {name}: card against "
                               f"CPU {errs[name]} > {TF_GRAD_TOL}")
    loss_err = abs(float(loss_card) - float(loss_cpu))
    log(f"[train-tf] fp32 LM B={TF_GRAD_B} S={TF_GRAD_S}: loss card "
        f"{float(loss_card):.6f}, CPU {float(loss_cpu):.6f}; gradients card "
        f"against CPU, max|d| / max|cpu|: "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (tol {TF_GRAD_TOL}); max|cpu| "
        + ", ".join(f"{n} {v:.3g}" for n, v in scales.items()))
    if not loss_err <= TF_GRAD_TOL * abs(float(loss_cpu)):
        raise RuntimeError(f"loss card against CPU: {loss_err}")
    return {"grad_rel_err": errs, "loss_abs_err": loss_err}


def train_step_bound_ms(cfg, tokens, live_pairs):
    """Least time of one training step: the fp32 head's three products
    (forward, and its two gradients; TF32 off) at the fp32 peak, the bf16
    block products (q, k, v, o, gate, up, down: forward and two gradients)
    and attention (4*D operations a live pair forward, 10*D backward) at
    the bf16 tensor-core peak, one after another."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    head = 6 * d * cfg.vocab_size * tokens
    blocks = 6 * L * (4 * d * d + 3 * d * f) * tokens
    att = 14 * cfg.head_dim * live_pairs * L
    return (head / FP32_FLOPS + (blocks + att) / BF16_TENSOR_FLOPS) * 1e3, {
        "head_gflop": head / 1e9, "block_gflop": blocks / 1e9,
        "attention_gflop": att / 1e9}


def phase_tf_train():
    """(c) The slice: TransformerLM(TransformerConfig(), seed=0) on the
    default context, TF_TRAIN_STEPS train_steps on one repeated batch of
    tokens (B, S + 1) at TF_TRAIN_LR; each step 4 dense forward and 4
    dense backward launches and no masked one; every loss and parameter
    finite; the loss falls. (d) Then ms per step (CUDA events, median of
    7 after a warm-up), tokens/s, peak device memory and one profiled
    step."""
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM, _leaves)
    cfg = TransformerConfig()
    toks = torch.tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TF_TRAIN_B, TF_TRAIN_S + 1)), device=CARD)
    torch.cuda.reset_peak_memory_stats()
    zero_attention_counts()  # the main path's run starts here
    lm = TransformerLM(cfg, seed=0)  # the default context, gpu(0)
    losses, per_step = [], []
    prev = (*attention_counts(), wgmma_backward_count())
    for _ in range(TF_TRAIN_STEPS):
        losses.append(lm.train_step(toks, lr=TF_TRAIN_LR))
        now = (*attention_counts(), wgmma_backward_count())
        per_step.append(tuple(a - c for a, c in zip(now, prev)))
        prev = now
    launches = attention_counts()  # the main path's run ends here
    wgmma_launches = wgmma_backward_count()
    peak = torch.cuda.max_memory_allocated()
    # (dense, masked, dense backward, masked backward, wgmma/TMA backward)
    want = (cfg.num_layers, 0, cfg.num_layers, 0, cfg.num_layers)
    log(f"[train-tf] TransformerLM {cfg.vocab_size} vocab, "
        f"{cfg.num_layers} x {cfg.d_model}, {cfg.dtype}, tokens "
        f"{tuple(toks.shape)}: {TF_TRAIN_STEPS} train_steps at lr "
        f"{TF_TRAIN_LR}, loss {losses}; (dense, masked, dense backward, "
        f"masked backward, wgmma/TMA backward) launches per step "
        f"{per_step[0]}, total {launches}, {wgmma_launches} backwards on the "
        f"wgmma/TMA variant; peak device memory {peak} bytes")
    if any(c != want for c in per_step):
        raise RuntimeError(f"launches per step {per_step}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    for name, p in _leaves(lm.params):
        if not bool(torch.isfinite(p).all()):
            raise RuntimeError(f"parameter {name} not finite")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall at lr {TF_TRAIN_LR}: "
                           f"{losses}")

    event_ms, host_ms = [], []
    for _ in range(8):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        lm.train_step(toks, lr=TF_TRAIN_LR)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
    event_ms, host_ms = event_ms[1:], host_ms[1:]  # the first warms up
    ms = statistics.median(event_ms)
    tokens = TF_TRAIN_B * TF_TRAIN_S
    live = TF_TRAIN_B * cfg.num_heads * TF_TRAIN_S * (TF_TRAIN_S + 1) // 2
    bound_ms, parts = train_step_bound_ms(cfg, tokens, live)
    log(f"[train-tf] one train_step ({TF_TRAIN_B} x {TF_TRAIN_S} tokens): "
        f"median {ms:.3f} ms (CUDA events) of "
        f"{[round(x, 3) for x in event_ms]}, host clock median "
        f"{statistics.median(host_ms):.3f} ms; {tokens / ms * 1e3:.1f} "
        f"tokens/s; bound {bound_ms:.3f} ms ({parts}), "
        f"{tokens / bound_ms * 1e3:.1f} tokens/s at most")
    profile = profile_device(f"one train_step {TF_TRAIN_B} x {TF_TRAIN_S}",
                             lambda: lm.train_step(toks, lr=TF_TRAIN_LR))
    return {"launches": launches, "wgmma_backward_launches": wgmma_launches,
            "per_step": per_step[0], "losses": losses,
            "lr": TF_TRAIN_LR, "step_ms": ms, "step_runs_ms": event_ms,
            "step_host_ms": statistics.median(host_ms),
            "tokens_per_s": tokens / ms * 1e3, "bound_ms": bound_ms,
            "bound_parts_gflop": parts,
            "bound_tokens_per_s": tokens / bound_ms * 1e3,
            "peak_device_bytes": peak, "profile": profile}


def attention_backward_bound_ms(live_pairs, b, h, sq, sk, d, elem_bytes):
    """Least time of one backward on an H100: q, k, v, o and dO read once
    and dq, dk, dv written once, against 10*D operations per live pair
    (S, dP, dV, dK, dQ) at the bf16 tensor-core peak."""
    nbytes = elem_bytes * b * h * d * (4 * sq + 4 * sk)
    flops = 10 * d * live_pairs
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def phase_attention_backward_timing():
    """(e) One backward call at the transformer's shape, bf16 causal, dense,
    with ATT_LENGTHS and with packed segments, as CUDA events over
    back-to-back calls in turns (wgmma/TMA, mma.sync, library, library,
    mma.sync, wgmma): the Hopper variant (the main path's, given the
    forward's lse), the earlier mma.sync variant (through _mma_sync_backward)
    and the library's backward: the autograd backward of
    scaled_dot_product_attention on the same inputs (is_causal, or the
    mask as a bool tensor), timed only; each one's host time to enqueue a
    call. Each kernel's device time by stage from the profiler, the bound,
    the plain version; then the forward with and without the lse kept, in
    turns."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda.attention import (
        _backward_launch, _combined_mask, _launch, _mma_sync_backward,
        attention_backward_plain, masked_attention_backward_plain)
    b, h, s, d = ATT_SHAPE
    scale = 1.0 / d ** 0.5
    q, k, v, do = attention_grad_inputs(b, h, s, s, d, torch.bfloat16,
                                        seed=401)
    lens = torch.tensor(ATT_LENGTHS, dtype=torch.int32, device=CARD)
    seg = packed_segments(b, s)
    rows = {}
    for name, lengths, segs, plain_kw in (
            ("flash_attention_backward", None, None, None),
            ("flash_attention_masked_backward", lens, None, {"lengths": lens}),
            ("packed", None, seg, {"segment_ids": seg})):
        mask = _combined_mask(s, s, True, lengths, segs, q.device)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=CARD)
        out = _launch(q, k, v, True, scale, lengths, segs, lse=lse)
        fns = {
            "wgmma": lambda: _backward_launch(q, k, v, out, do, True, scale,
                                              lengths, segs, lse),
            "mma_sync": lambda: _mma_sync_backward(
                q, k, v, out, do, True, scale, lengths, segs, lse=lse)}
        if plain_kw is None:
            plain = lambda: attention_backward_plain(  # noqa: E731
                q, k, v, out, do, causal=True)
            sdpa_kw, live = {"is_causal": True}, b * h * s * (s + 1) // 2
        else:
            plain = lambda: masked_attention_backward_plain(  # noqa: E731
                q, k, v, do, causal=True, **plain_kw)
            sdpa_kw, live = {"attn_mask": mask}, h * int(mask.sum().item())
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
        fns["library"] = lambda: torch.autograd.grad(y, leaves, do,
                                                     retain_graph=True)
        turns = {n: [] for n in fns}
        for turn in ("wgmma", "mma_sync", "library", "library", "mma_sync",
                     "wgmma"):
            turns[turn].append(time_on_stream(fns[turn], iters=20))
        bound_ms, bound_by = attention_backward_bound_ms(live, b, h, s, s, d,
                                                         2)
        variants = {}
        for n, ms in turns.items():
            mean = statistics.mean(ms)
            variants[n] = {"ms": mean, "turns_ms": ms,
                           "tflops": 10 * d * live / mean / 1e9,
                           "share_of_bound": bound_ms / mean,
                           "host_us": host_us(fns[n])}
        row = {"kernel_ms": variants["wgmma"]["ms"],
               "kernel_turns_ms": turns["wgmma"],
               "library_ms": variants["library"]["ms"],
               "library_turns_ms": turns["library"],
               "plain_ms": time_on_stream(plain, iters=3),
               "live_pairs": live, "bound_ms": bound_ms,
               "bound_by": bound_by, "variants": variants}
        row["share_of_bound"] = bound_ms / row["kernel_ms"]
        row["tflops"] = variants["wgmma"]["tflops"]
        # device us per launch of each stage, over the launches the
        # profiler recorded (it may drop a record of a window)
        row["stages_us"] = {}
        for variant, tags in (
                ("wgmma", (("K0 delta", "flash_bwd_delta"),
                           ("segment ranges", "seg_ranges"),
                           ("main dk dv dq", "flash_bwd_wgmma"),
                           ("K2 dq store", "flash_bwd_dq_store"))),
                ("mma_sync", (("K0 delta", "flash_bwd_delta_rows"),
                              ("K1 dk dv", "flash_bwd_dkdv"),
                              ("K2 dq", "flash_bwd_dq_mma")))):
            fn = fns[variant]
            prof = profile_device(f"10 backward calls, {name} {variant}",
                                  lambda: [fn() for _ in range(10)])
            row["stages_us"][variant] = {
                stage: sum(us for key, us, _ in prof["top"] if tag in key)
                / max(1, sum(n for key, _, n in prof["top"] if tag in key))
                for stage, tag in tags
                if any(tag in key for key, _, _ in prof["top"])}
        rows[name] = row
        log(f"[train-timing] {name} {ATT_SHAPE} bf16 causal"
            f"{' lengths=' + str(ATT_LENGTHS) if lengths is not None else ''}"
            f"{' packed segments' if segs is not None else ''}: "
            + "; ".join(f"{n} {v_['ms'] * 1e3:.3f} us (turns "
                        f"{[round(t * 1e3, 3) for t in v_['turns_ms']]}, "
                        f"{v_['tflops']:.2f} TFLOP/s, share "
                        f"{v_['share_of_bound']:.4f}; host "
                        f"{v_['host_us']:.1f} us a call to enqueue)"
                        for n, v_ in variants.items())
            + f"; by stage {row['stages_us']} us; {live} live pairs, bound "
            f"{bound_ms * 1e3:.3f} us by {bound_by}; plain "
            f"{row['plain_ms'] * 1e3:.1f} us; library = autograd backward "
            "of scaled_dot_product_attention")
    rows["flash_attention_masked_backward"]["packed"] = rows.pop("packed")
    # what keeping lse costs the forward (the training path's), in turns
    lse = torch.empty((b, h, s), dtype=torch.float32, device=CARD)
    fwd = {"without lse": lambda: _launch(q, k, v, True, scale, None, None),
           "with lse": lambda: _launch(q, k, v, True, scale, None, None,
                                       lse=lse)}
    fturns = {n: [] for n in fwd}
    for turn in ("without lse", "with lse", "with lse", "without lse",
                 "without lse", "with lse"):
        fturns[turn].append(time_on_stream(fwd[turn], iters=50))
    cost = {n: statistics.mean(t) for n, t in fturns.items()}
    cost["added_us"] = (cost["with lse"] - cost["without lse"]) * 1e3
    cost["turns_ms"] = fturns
    cost["host_us"] = {n: host_us(f) for n, f in fwd.items()}
    log(f"[train-timing] B2 forward {ATT_SHAPE} causal: without lse "
        f"{cost['without lse'] * 1e3:.3f} us, with lse "
        f"{cost['with lse'] * 1e3:.3f} us (turns {fturns}); keeping lse "
        f"adds {cost['added_us']:.3f} us; host us a call to enqueue "
        f"{cost['host_us']}")
    rows["flash_attention_backward"]["forward_lse_cost"] = cost
    return rows


def attention_backward_records(kerrs, masked_path, tf_train, timing,
                               wgmma_build):
    """The flash_attention_backward and flash_attention_masked_backward
    entries of the kernels line; ``masked_path`` is the masked training
    path's (backward launches, of them the wgmma/TMA variant's)."""
    records = []
    for name, line, launches, wgmma, path in (
            ("flash_attention_backward", 158, tf_train["launches"][2],
             tf_train["wgmma_backward_launches"],
             f"{TF_TRAIN_STEPS} train_steps of the transformer LM "
             "(phase 12c)"),
            ("flash_attention_masked_backward", 261, *masked_path,
             "the masked training path, a packed and a length-masked batch "
             "(phase 12a); 0 on the transformer's")):
        t = timing[name]
        records.append({
            "name": name,
            "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"mxnet_tpu/ops/pallas/attention.py:{line}",
            "launches": launches,
            "launches_path": path,
            "max_abs_err": kerrs[name]["max_abs"],
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "autograd backward of torch.nn.functional."
                       "scaled_dot_product_attention on the same inputs",
            "shape": f"(B,H,S,D)={ATT_SHAPE} bf16 causal" + (
                f" lengths={ATT_LENGTHS}" if "masked" in name else ""),
            "max_rel_err_fp32": kerrs[name]["fp32_rel"],
            "max_rel_err_bf16": kerrs[name]["bf16_rel"],
            "max_rel_err_bf16_mma_sync": kerrs[name]["mma_sync_bf16_rel"],
            "share_of_bound": t["share_of_bound"],
            "tflops": t["tflops"],
            "live_pairs": t["live_pairs"],
            "stages_us": t["stages_us"],
            "kernel_turns_ms": t["kernel_turns_ms"],
            "library_turns_ms": t["library_turns_ms"],
            "variants": t["variants"],
            "wgmma_backward_launches": wgmma,
            "max_lse_abs_err": kerrs[name]["lse_abs"],
        })
    records[0]["transformer_training"] = tf_train
    records[0]["forward_lse_cost"] = timing["flash_attention_backward"][
        "forward_lse_cost"]
    records[0]["wgmma_build"] = wgmma_build
    records[1]["packed"] = timing["flash_attention_masked_backward"]["packed"]
    return records


# -- ResNet-50 training (phase 13) ---------------------------------------------

# (a) the CNN ops on the card against the port's CPU path on the same
# seeded inputs, forward and every input gradient, fp32 (TF32 off) and
# bf16: ResNet-50's own shapes (the stem's 7x7/2 convolution on 224**2, a
# bottleneck's 3x3 and its strided 1x1 projection, the stem's max pool
# over ReLU'd windows with ties, the global pool, the stem's BatchNorm)
# and ragged ones. name -> (op, [input shape, kind], attrs, is_train);
# kinds: "x" normal, "w" a weight scaled by its fan-in, "ties" small
# integers after a ReLU
OP_CASES = {
    "conv stem 7x7/2": ("Convolution", [((2, 224, 224, 3), "x"),
                                        ((64, 7, 7, 3), "w")],
                        dict(kernel=(7, 7), num_filter=64, stride=(2, 2),
                             pad=(3, 3), no_bias=True, layout="NHWC"), False),
    "conv bottleneck 3x3": ("Convolution", [((2, 56, 56, 64), "x"),
                                            ((64, 3, 3, 64), "w")],
                            dict(kernel=(3, 3), num_filter=64, pad=(1, 1),
                                 no_bias=True, layout="NHWC"), False),
    "conv projection 1x1/2": ("Convolution", [((2, 56, 56, 256), "x"),
                                              ((512, 1, 1, 256), "w")],
                              dict(kernel=(1, 1), num_filter=512,
                                   stride=(2, 2), no_bias=True,
                                   layout="NHWC"), False),
    "conv ragged grouped dilated": ("Convolution",
                                    [((3, 17, 13, 6), "x"),
                                     ((10, 3, 3, 3), "w"), ((10,), "x")],
                                    dict(kernel=(3, 3), num_filter=10,
                                         num_group=2, stride=(2, 2),
                                         pad=(1, 1), dilate=(1, 2),
                                         layout="NHWC"), False),
    "conv ragged NCHW": ("Convolution", [((3, 5, 11, 9), "x"),
                                         ((7, 5, 3, 2), "w"), ((7,), "x")],
                         dict(kernel=(3, 2), num_filter=7, stride=(1, 2)),
                         False),
    "max pool stem 3x3/2 ties": ("Pooling", [((2, 112, 112, 64), "ties")],
                                 dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), pool_type="max",
                                      layout="NHWC"), False),
    "avg pool global": ("Pooling", [((2, 7, 7, 2048), "x")],
                        dict(kernel=(7, 7), global_pool=True,
                             pool_type="avg", layout="NHWC"), False),
    "avg pool 3x3/1 padded": ("Pooling", [((2, 35, 35, 192), "x")],
                              dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                   pool_type="avg", layout="NHWC"), False),
    "avg pool ragged full": ("Pooling", [((3, 4, 9, 10), "x")],
                             dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                  pool_type="avg",
                                  pooling_convention="full"), False),
    "batchnorm stem train": ("BatchNorm", [((2, 112, 112, 64), "x")],
                             dict(eps=2e-5, momentum=0.9, fix_gamma=False,
                                  axis=3), True),
    "batchnorm eval": ("BatchNorm", [((2, 56, 56, 256), "x")],
                       dict(eps=2e-5, fix_gamma=False, axis=3), False),
    "batchnorm ragged 2-D defaults": ("BatchNorm", [((37, 5), "x")], {},
                                      True),
    "relu": ("Activation", [((2, 112, 112, 64), "x")],
             dict(act_type="relu"), False),
    "softrelu ragged": ("Activation", [((3, 77), "x")],
                        dict(act_type="softrelu"), False),
    "lrn alexnet": ("LRN", [((2, 27, 27, 96), "x")],
                    dict(nsize=5, alpha=1e-4, beta=0.75, knorm=2.0,
                         axis=-1), False),
}
# card against CPU, fp32 with TF32 off on both: summation order and cuDNN's
# algorithms differ (Winograd or FFT transforms where the autotuner picks
# them), each held relative to the output's or gradient's largest magnitude
# (measured up to 1.2e-5, the bottleneck's 3x3 convolution)
OP_FP32_TOL = 1e-4
# bf16: both sides accumulate in fp32 and round once; a rounding may land
# an ulp apart (measured up to 2 ulps); held at 4 bf16 ulps of the
# largest magnitude
OP_BF16_ULPS = 4
# Dropout's mask comes from the card's generator: its kept share within
# 5 binomial sigmas of 1 - p
DROP_SHAPE, DROP_P = (256, 4096), 0.5
# (b) the full-width graph: ResNet-50 v2 at 224**2, batch 2, card against
# CPU from the same seeded Xavier init (TF32 off): the output, every
# gradient and every aux update, each relative to its own largest
# magnitude. The gradients are ill-conditioned at this batch (BatchNorm's
# backward subtracts near-equal terms): the CPU's own fp32 gradients sit
# up to 0.17 of their largest magnitude from its fp64 ones
# (stage3_unit5_conv2_weight), a rounding error amplified ~3e6 times. In
# fp64 that amplification leaves ~3e-10 (measured 1.6e-10): held at 1e-8.
# In fp32 each array on the card is held to at most 10 times the CPU
# fp32's distance from the fp64 result (measured up to 2.5 times), plus
# 1e-5 of its largest magnitude
RESNET_GRAD_N = 2
RESNET_F64_TOL = 1e-8
RESNET_F32_FACTOR = 10.0
RESNET_F32_FLOOR = 1e-5
# (c) bench.py's bench_resnet configuration (bench.py:96-144) through Module
RESNET_BATCH = 256
RESNET_SGD = {"learning_rate": 0.1, "momentum": 0.9,
              "rescale_grad": 1.0 / RESNET_BATCH}
RESNET_STEPS, RESNET_TIMED = 10, 7
# the profiled step's kernels by kind, the first pattern a name matches
RESNET_KERNEL_KINDS = (
    ("convolution (cuDNN)", r"xmma|implicit_gemm|conv|cudnn|wgrad|dgrad"),
    ("batch norm", r"batch_norm"),
    ("pooling", r"pool"),
    ("fully connected (cuBLAS)", r"gemm|cutlass|Kernel2"),
    ("elementwise and reductions", r"elementwise|reduce_kernel|copy"),
)


def hand_kernel_counts():
    """Every hand-written kernel's launch counts: the LSTM's, attention's
    and Rtc's."""
    from mxnet_tpu_torch.ops.cuda.rtc import rtc_launch
    return (*train_counts(), *attention_counts(), rtc_launch.launches)


def op_case_arrays(name):
    """A case's inputs (BatchNorm's gamma, beta and moving statistics
    included) and which take a gradient, from the case's own seed."""
    op, spec, attrs, _ = OP_CASES[name]
    rng = np.random.RandomState(sorted(OP_CASES).index(name))
    arrays = []
    for shape, kind in spec:
        if kind == "ties":
            a = np.maximum(rng.randint(-2, 3, shape), 0)
        elif kind == "w":
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[1:])), shape)
        else:
            a = rng.normal(0, 1, shape)
        arrays.append(a.astype(np.float32))
    diff = [True] * len(arrays)
    if op == "BatchNorm":
        shape = spec[0][0]
        c = shape[attrs.get("axis", 1) % len(shape)]
        arrays += [rng.uniform(0.5, 1.5, c), rng.normal(0, 0.5, c),
                   rng.normal(0, 0.5, c), rng.uniform(0.5, 2, c)]
        arrays = [a.astype(np.float32) for a in arrays]
        diff += [True, True, False, False]
    return arrays, diff


def run_op_case(name, dtype, device):
    """The port's op on ``device``: the outputs (BatchNorm's moving
    updates included) and every input gradient under a seeded cotangent,
    as fp32 host arrays."""
    import mxnet_tpu_torch as mx
    op, _, attrs, train = OP_CASES[name]
    opdef = mx.OP_TABLE[op]
    parsed = opdef.parse_attrs(attrs)
    if opdef.needs_is_train:
        parsed["_is_train"] = train
    arrays, diff = op_case_arrays(name)
    ins = [torch.tensor(a, device=device).to(
        dtype if i == 0 or op != "BatchNorm" else torch.float32)
        for i, a in enumerate(arrays)]
    leaves = [t.requires_grad_() if d else t for t, d in zip(ins, diff)]
    out = opdef.fn(*leaves, **parsed)
    out = out if isinstance(out, tuple) else (out,)
    rng = np.random.RandomState(100 + sorted(OP_CASES).index(name))
    cot = torch.tensor(rng.normal(0, 1, tuple(out[0].shape)),
                       device=device).to(out[0].dtype)
    wrt = [t for t, d in zip(leaves, diff) if d]
    grads = torch.autograd.grad(out[0], wrt, cot, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, wrt)]
    return ([o.detach().float().cpu().numpy() for o in out],
            [g.float().cpu().numpy() for g in grads])


def rel_err(got, want):
    """max |got - want| over the largest |want|."""
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / scale if scale else float(
        np.abs(got).max())


def ulps_err(got, want):
    """max |got - want| in bf16 ulps at the largest |want|."""
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7) if scale else 2.0 ** -133
    return float(np.abs(got - want).max()) / ulp


def phase_cnn_ops():
    """(a) Each CNN op on the card against the port's CPU path, fp32 and
    bf16; max pooling's tied windows send every gradient to the same
    element; Dropout's statistics on the card."""
    errs = {}
    for name in sorted(OP_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            outs_c, grads_c = run_op_case(name, dtype, "cpu")
            outs_g, grads_g = run_op_case(name, dtype, CARD)
            worst = 0.0
            for i, (g, c) in enumerate(zip(outs_g + grads_g,
                                           outs_c + grads_c, strict=True)):
                # BatchNorm's moving statistics stay fp32 for bf16 data
                fp32 = dtype == torch.float32 or 0 < i < len(outs_c)
                e = rel_err(g, c) if fp32 else ulps_err(g, c)
                tol = OP_FP32_TOL if fp32 else OP_BF16_ULPS
                if not (np.isfinite(g).all() and e <= tol):
                    raise RuntimeError(f"{name} {dtype} array {i}: card "
                                       f"against CPU {e} > {tol}")
                worst = max(worst, e)
            if "ties" in name and dtype == torch.float32:
                # the same elements take the gradient; in bf16 the sums of
                # overlapping windows' gradients round, some to exactly 0
                # (86 of 278222 on the CPU), so the check is fp32's
                for g, c in zip(grads_g, grads_c):
                    if not np.array_equal(g != 0, c != 0):
                        raise RuntimeError(f"{name}: the card's max pool "
                                           "picks other tied elements")
            errs[f"{name} {str(dtype)[6:]}"] = worst
    from mxnet_tpu_torch.ops import nn_ops
    import mxnet_tpu_torch as mx
    mx.random.seed(5)
    x = torch.ones(DROP_SHAPE, device=CARD, requires_grad=True)
    y = nn_ops._dropout(mx.random.generator(CARD), x, p=DROP_P,
                        _is_train=True)
    (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
    keep, n = 1 - DROP_P, math.prod(DROP_SHAPE)
    kept = float((y != 0).float().mean())
    sigma = math.sqrt(keep * DROP_P / n)
    if not (abs(kept - keep) < 5 * sigma and bool(
            ((y == 0) | (y == 1 / keep)).all()) and bool((g == y).all())):
        raise RuntimeError(f"dropout on the card: kept share {kept}")
    errs["dropout kept share"] = kept
    log(f"[resnet] (a) CNN ops, card against the port's CPU path, forward "
        f"and every input gradient: worst error a case (fp32: of the "
        f"largest magnitude, tol {OP_FP32_TOL}; bf16: in ulps, tol "
        f"{OP_BF16_ULPS}): {errs}; max pooling's tied gradients equal; "
        f"dropout p={DROP_P} keeps {kept} of {n}")
    return errs


def resnet_symbol(mx, dtype, num_layers=50):
    with mx.sym.NameManager():
        return mx.models.get_symbol("resnet", num_layers=num_layers,
                                    num_classes=1000,
                                    image_shape="224,224,3", dtype=dtype)


def resnet_forward_backward(net, params, data, label, ctx, dtype):
    """One training forward and backward of ``net`` on ``ctx`` with every
    array in ``dtype``: the output, each gradient and each aux update."""
    import mxnet_tpu_torch as mx
    names = net.list_arguments() + net.list_auxiliary_states()
    exe = net.simple_bind(ctx=ctx, type_dict={n: dtype for n in names},
                          data=data.shape, softmax_label=label.shape)
    for name, value in params.items():
        target = exe.arg_dict if name in exe.arg_dict else exe.aux_dict
        target[name][:] = value.astype(dtype)
    exe.forward_backward(data=mx.nd.array(data.astype(dtype), ctx=ctx),
                         softmax_label=mx.nd.array(label, ctx=ctx))
    run = {"output": exe.outputs[0].asnumpy().astype(np.float64)}
    run.update({f"grad {n}": g.asnumpy().astype(np.float64)
                for n, g in exe.grad_dict.items()})
    run.update({f"aux {n}": a.asnumpy().astype(np.float64)
                for n, a in exe.aux_dict.items()})
    return run


def phase_resnet_card_vs_cpu():
    """(b) One training forward_backward of ResNet-50 v2 (the fp32 symbol)
    at 224**2, batch RESNET_GRAD_N, from the same seeded Xavier init, on
    the card and on the port's CPU path, in fp64 and in fp32: in fp64
    every array (the output, each gradient, each aux update) within
    RESNET_F64_TOL of its largest magnitude; in fp32 each array's distance
    from the fp64 result within RESNET_F32_FACTOR times the CPU fp32's
    own, plus RESNET_F32_FLOOR of its largest magnitude."""
    import mxnet_tpu_torch as mx
    net = resnet_symbol(mx, "float32")
    rng = np.random.RandomState(3)
    data = rng.rand(RESNET_GRAD_N, 224, 224, 3).astype(np.float32)
    label = rng.randint(0, 1000, RESNET_GRAD_N).astype(np.float32)
    mx.random.seed(0)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=[("data", data.shape)],
             label_shapes=[("softmax_label", label.shape)])
    mod.init_params(mx.init.Xavier())
    args, auxs = mod.get_params()
    params = {n: v.asnumpy() for n, v in {**args, **auxs}.items()}
    runs = {(ctx.device_type, dt): resnet_forward_backward(
                net, params, data, label, ctx, dt)
            for dt in ("float64", "float32") for ctx in (mx.gpu(0), mx.cpu())}
    exact = runs[("cpu", "float64")]
    f64 = {k: rel_err(runs[("gpu", "float64")][k], v)
           for k, v in exact.items()}
    card32 = {k: rel_err(runs[("gpu", "float32")][k], v)
              for k, v in exact.items()}
    cpu32 = {k: rel_err(runs[("cpu", "float32")][k], v)
             for k, v in exact.items()}
    card_vs_cpu32 = {k: rel_err(runs[("gpu", "float32")][k], v)
                     for k, v in runs[("cpu", "float32")].items()}
    worst64 = max(f64, key=f64.get)
    worst32 = max(card_vs_cpu32, key=card_vs_cpu32.get)
    ratio = max(card32, key=lambda k: card32[k] / max(cpu32[k], 1e-12))
    bad = [k for k in exact
           if not (f64[k] <= RESNET_F64_TOL and card32[k]
                   <= RESNET_F32_FACTOR * cpu32[k] + RESNET_F32_FLOOR)]
    log(f"[resnet] (b) ResNet-50 v2 224x224 batch {RESNET_GRAD_N}, one "
        f"training forward_backward, card against the CPU path "
        f"({len(exact)} arrays: the output, {len(net.list_arguments())} "
        f"gradients, {len(net.list_auxiliary_states())} aux updates), "
        f"each relative to its largest magnitude: fp64 worst {worst64} "
        f"{f64[worst64]!r} (tol {RESNET_F64_TOL}); fp32 card against fp32 "
        f"CPU worst {worst32} {card_vs_cpu32[worst32]!r}, the CPU's own fp32 "
        f"against fp64 there {cpu32[worst32]!r}, the card's "
        f"{card32[worst32]!r}; largest ratio card/CPU distance from fp64 "
        f"{ratio} {card32[ratio]!r} / {cpu32[ratio]!r} (tol "
        f"{RESNET_F32_FACTOR} x the CPU's + {RESNET_F32_FLOOR}); output "
        f"fp32 {card_vs_cpu32['output']!r}")
    if bad:
        raise RuntimeError(f"ResNet-50 card against CPU: {bad[:5]} fp64 "
                           f"{[f64[k] for k in bad[:5]]} fp32 "
                           f"{[(card32[k], cpu32[k]) for k in bad[:5]]}")
    return {"f64_worst": f64[worst64], "f64_worst_array": worst64,
            "f32_card_vs_cpu_worst": card_vs_cpu32[worst32],
            "f32_card_vs_cpu_worst_array": worst32,
            "f32_cpu_vs_f64_there": cpu32[worst32],
            "f32_output": card_vs_cpu32["output"], "arrays": len(exact)}


def resnet_step_macs(net, batch):
    """The multiply-adds of one forward of ``net`` at ``batch`` in its
    convolutions and fully connected layers (from their inferred shapes),
    and the count of each."""
    internals = net.get_internals()
    _, out_shapes, _ = internals.infer_shape(data=(batch, 224, 224, 3))
    shapes = dict(zip(internals.list_outputs(), out_shapes))
    arg_shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(batch, 224, 224, 3))[0]))
    macs, counts = 0, {"Convolution": 0, "FullyConnected": 0}
    for node in net._topo_nodes():
        if node.op is None or node.op.name not in counts:
            continue
        weight = arg_shapes[node.inputs[1][0].name]
        out = shapes[f"{node.name}_output"]
        # each output element takes a weight row: kernel x in-channels/groups
        macs += math.prod(out) * math.prod(weight) // weight[0]
        counts[node.op.name] += 1
    return macs, counts


def phase_resnet_train():
    """(c) bench_resnet's configuration through Module on the default
    context: ResNet-50 v2 NHWC bf16, batch RESNET_BATCH, seeded Xavier,
    bench.py's data and SGD; RESNET_STEPS forward/backward/update steps on
    the one batch, every loss, output, parameter and moving statistic
    finite, the moving statistics moved, the last loss below the first;
    none of the hand-written kernels launched. Then RESNET_TIMED timed
    steps (CUDA events), img/s, the bound, peak memory and one profiled
    step."""
    import mxnet_tpu_torch as mx
    net = resnet_symbol(mx, "bfloat16")
    rng = np.random.RandomState(0)  # bench.py:112-116
    data = rng.rand(RESNET_BATCH, 224, 224, 3).astype(np.float32)
    label = rng.randint(0, 1000, (RESNET_BATCH,)).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = hand_kernel_counts()  # the main path's run starts here
    mx.random.seed(0)
    mod = mx.mod.Module(net)  # the default context, gpu(0)
    mod.bind(data_shapes=[("data", data.shape)],
             label_shapes=[("softmax_label", label.shape)])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=RESNET_SGD)
    aux0 = {n: a.asnumpy() for n, a in mod.get_params()[1].items()}
    batch = mx.io.DataBatch([mx.nd.array(data, ctx=mx.gpu(0))],
                            [mx.nd.array(label, ctx=mx.gpu(0))])
    labels = torch.tensor(label, device=CARD).long()

    def step():
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    def loss():
        prob = mod.get_outputs()[0]._data.float()
        return float(-torch.log(prob.gather(1, labels[:, None])
                                .clamp_min(1e-30)).mean())

    losses = []
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        step()
        losses.append(loss())
    first_steps_s = time.perf_counter() - t0
    after = hand_kernel_counts()  # and ends here
    peak = torch.cuda.max_memory_allocated()
    args, auxs = mod.get_params()
    out = mod.get_outputs()[0]._data
    finite = (bool(torch.isfinite(out).all())
              and all(bool(torch.isfinite(v._data).all())
                      for v in list(args.values()) + list(auxs.values())))
    moved = sum(not np.array_equal(a.asnumpy(), aux0[n])
                for n, a in auxs.items())
    log(f"[resnet] (c) ResNet-50 v2 NHWC bf16, batch {RESNET_BATCH}, "
        f"Module on the default context, SGD {RESNET_SGD}: {RESNET_STEPS} "
        f"steps in {first_steps_s:.1f} s (autotuning included), "
        f"cross-entropy {losses}; outputs, {len(args)} parameters and "
        f"{len(auxs)} moving statistics finite: {finite}; moving statistics "
        f"moved: {moved} of {len(auxs)}; hand-written kernel launches on "
        f"this path: {[a - b for a, b in zip(after, before)]} (none "
        f"expected: convolutions, pooling and BatchNorm are cuDNN and "
        f"torch kernels); peak device memory {peak} bytes")
    if after != before:
        raise RuntimeError(f"the ResNet path launched a hand-written "
                           f"kernel: {before} -> {after}")
    if not (finite and all(math.isfinite(x) for x in losses)):
        raise RuntimeError(f"non-finite ResNet-50 training: {losses}")
    if moved != len(auxs):
        raise RuntimeError(f"{len(auxs) - moved} moving statistics did not "
                           "move")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses}")

    event_ms, host_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RESNET_TIMED + 1):
        e, h = step_ms(step)
        event_ms.append(e)
        host_ms.append(h)
    event_ms, host_ms = event_ms[1:], host_ms[1:]  # the first warms up
    steady_peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(event_ms)
    macs, counts = resnet_step_macs(net, RESNET_BATCH)
    # forward 2*MAC, backward twice the forward (data and weight gradients)
    flops = 3 * 2 * macs
    bound_ms = flops / BF16_TENSOR_FLOPS * 1e3
    img_s = RESNET_BATCH / ms * 1e3
    log(f"[resnet] (c) one step: median {ms:.3f} ms (CUDA events) of "
        f"{[round(x, 3) for x in event_ms]}, host clock median "
        f"{statistics.median(host_ms):.3f} ms; {img_s:.1f} img/s; bound "
        f"{bound_ms:.3f} ms ({flops / 1e12:.3f} TFLOP: {counts} layers, "
        f"{macs / RESNET_BATCH / 1e9:.3f} GMAC an image forward, x3 for "
        f"training, at {BF16_TENSOR_FLOPS / 1e12} TFLOP/s bf16), share "
        f"{bound_ms / ms:.4f}; peak device memory {steady_peak} bytes")
    profile = profile_device(f"one ResNet-50 step batch {RESNET_BATCH}", step,
                             keep_all=True)
    transposes = [row for row in profile["top_all"]
                  if re.search(r"transpose|nchwToNhwc|nhwcToNchw",
                               row[0], re.I)]
    kinds = {}
    for key, us, _ in profile.pop("top_all"):
        kind = next((k for k, pattern in RESNET_KERNEL_KINDS
                     if re.search(pattern, key)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + us
    log(f"[resnet] (c) device us by kind in the profiled step: {kinds}; "
        f"transpose kernels: {transposes}")
    profile["by_kind_us"] = kinds
    profile["transposes"] = transposes
    return {"losses": losses, "step_ms": ms, "step_runs_ms": event_ms,
            "step_host_ms": statistics.median(host_ms), "img_per_s": img_s,
            "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
            "train_tflop": flops / 1e12, "layers": counts,
            "peak_device_bytes": max(peak, steady_peak),
            "first_steps_s": first_steps_s, "profile": profile,
            "hand_kernel_launches": [a - b for a, b in zip(after, before)]}


def phase_lstm_bench_forward():
    """One LSTM layer's forward at the bench's training shape (T=256,
    N=64, H=1024, fp32): the port's input projection plus the sequence
    kernel, and cuDNN's ``torch.nn.LSTM`` (which computes the projection
    too) on the same inputs, in turns; the bound of the recurrence's
    products."""
    from mxnet_tpu_torch.ops.cuda.lstm import lstm_sequence_fused
    steps, n = TRAIN_T, TRAIN_N
    xproj, h0, c0, w = sequence_inputs(steps, n, H, torch.float32, seed=41)
    rng = np.random.RandomState(43)
    x_in = torch.tensor(rng.normal(0, 1, (steps, n, H)), dtype=torch.float32,
                        device="cuda")
    w_i2h = torch.tensor(rng.uniform(-0.05, 0.05, (4 * H, H)),
                         dtype=torch.float32, device="cuda")
    bias = torch.tensor(rng.uniform(-0.05, 0.05, (4 * H,)),
                        dtype=torch.float32, device="cuda")
    cudnn = torch.nn.LSTM(H, H, 1).cuda()
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_i2h)
        cudnn.weight_hh_l0.copy_(w)
        cudnn.bias_ih_l0.copy_(bias)
        cudnn.bias_hh_l0.zero_()

    def port():
        xp = torch.matmul(x_in.reshape(steps * n, H), w_i2h.t()) + bias
        return lstm_sequence_fused(xp.reshape(steps, n, 4 * H), h0, c0, w)

    runs = {"projection_plus_kernel_ms": [], "kernel_ms": [],
            "cudnn_lstm_ms": []}
    with torch.no_grad():
        err = (port()[0] - cudnn(x_in, (h0[None], c0[None]))[0]).abs().max()
        for _ in range(3):
            runs["projection_plus_kernel_ms"].append(time_on_stream(port,
                                                                    iters=5))
            runs["cudnn_lstm_ms"].append(time_on_stream(
                lambda: cudnn(x_in, (h0[None], c0[None])), iters=5))
            runs["kernel_ms"].append(time_on_stream(
                lambda: lstm_sequence_fused(xproj, h0, c0, w), iters=5))
    row = {k: statistics.median(v) for k, v in runs.items()}
    row["runs"] = runs
    row["port_vs_cudnn_max_abs"] = float(err)
    row["bound_ms"], row["bound_by"] = sequence_bound_ms(steps, n, H, 4)
    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    log(f"[timing] one LSTM layer forward at the bench's training shape "
        f"T={steps} N={n} H={H} fp32, in turns (median of 3 rounds): the "
        f"port's projection plus sequence kernel "
        f"{row['projection_plus_kernel_ms'] * 1e3:.1f} us, the kernel alone "
        f"{row['kernel_ms'] * 1e3:.1f} us (bound {row['bound_ms'] * 1e3:.1f} "
        f"us by {row['bound_by']}, share {row['share_of_bound']:.3f}), "
        f"cuDNN's LSTM with its projection {row['cudnn_lstm_ms'] * 1e3:.1f} "
        f"us; outputs agree to {float(err):.2e}; rounds {runs}")
    if not float(err) <= SEQ_FP32_TOL:
        raise RuntimeError(f"the port's LSTM layer and cuDNN's disagree at "
                           f"the bench shape: {float(err)}")
    return row


# -- the fused training step (phase 14) ----------------------------------------

# steps through the fused step on one repeated batch (one capture), the
# steps of each comparison, and the timed steps (a median of them)
FUSED_STEPS, FUSED_CHECK_STEPS, FUSED_TIMED = 10, 3, 7
# compute_dtype=None fused steps against the classic forward/backward/update
# path on the card, and Module.update's fused path against the per-parameter
# updater: fp32 on both sides, the same kernels; only summation order may
# differ (a library may pick another algorithm for a call). Each parameter
# within 1e-5 of the model's largest parameter magnitude
FUSED_VS_CLASSIC_TOL = 1e-5
# the replayed step against the same body run eagerly on the card: the graph
# replays the kernels the eager body launched. The LSTM LM's must agree bit
# for bit; the ResNet's cuDNN backward-filter algorithms may sum in another
# order from run to run, held as FUSED_VS_CLASSIC_TOL
REPLAY_TOL = {"lstm": 0.0, "resnet": FUSED_VS_CLASSIC_TOL}
# B1's kernels in one replayed LSTM step, by the profiler's kernel names
B1_KERNELS = {"lstm_seq_kernel": LAYERS, "lstm_seq_bwd_reg_kernel": LAYERS}


@contextlib.contextmanager
def fused_path(enabled):
    """``MXTPU_FUSED_STEP`` set to ``enabled`` (1 or 0) inside: 0 keeps
    ``Module.fit`` on forward_backward and update and ``Module.update`` on
    the per-parameter updater, the classic path phases 11 and 13 time."""
    old = os.environ.get("MXTPU_FUSED_STEP")
    os.environ["MXTPU_FUSED_STEP"] = str(int(enabled))
    try:
        yield
    finally:
        if old is None:
            del os.environ["MXTPU_FUSED_STEP"]
        else:
            os.environ["MXTPU_FUSED_STEP"] = old


def params_of(mod):
    return {n: a._data.detach().clone() for n, a in mod.get_params()[0].items()}


def params_err(got, want):
    """The largest parameter difference over the model's largest parameter
    magnitude, and whether every parameter agrees bit for bit."""
    largest = max(float(w.abs().max()) for w in want.values())
    err = max(float((got[n] - w).abs().max()) for n, w in want.items())
    return err / largest, all(torch.equal(got[n], w) for n, w in want.items())


def replay_counts(profile, names):
    """Kernel launches in a profiled window, by the first name each kernel's
    name contains."""
    counts = {n: 0 for n in names}
    for key, _, count in profile["top_all"]:
        for n in names:
            if n + "<" in key or key.endswith(n) or n + "(" in key:
                counts[n] += count
                break
    return counts


def timed_steps(step, steps=FUSED_TIMED):
    """The median of ``steps`` steps (CUDA events) after one more that is
    not kept, and the host clock's median."""
    event_ms, host_ms = [], []
    for _ in range(steps + 1):
        e, h = step_ms(step)
        event_ms.append(e)
        host_ms.append(h)
    event_ms, host_ms = event_ms[1:], host_ms[1:]
    return statistics.median(event_ms), event_ms, statistics.median(host_ms)


def fused_module(mx, config, net, batch, sgd):
    mx.random.seed(0)
    mod = mx.mod.Module(net)  # the default context, gpu(0)
    mod.bind(data_shapes=[("data", tuple(batch.data[0].shape))],
             label_shapes=[("softmax_label", tuple(batch.label[0].shape))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=sgd)
    return mod


def fused_checks(mx, config, net, batch, sgd):
    """The comparisons of phase 14 for one configuration, each from the same
    seeded init: FUSED_CHECK_STEPS replayed steps against the same body run
    eagerly on the card (compute_dtype bf16); fp32 fused steps against the
    classic forward/backward/update; Module.update's fused path against the
    per-parameter updater. Every module's graph is released before the
    next is built."""
    def run(step_fn, compute_dtype=None, fused=True):
        with fused_path(fused):
            mod = fused_module(mx, config, net, batch, sgd)
            stepper = (mx.perf.module_stepper(mod, compute_dtype=compute_dtype)
                       if step_fn in ("graph", "eager") else None)
            for _ in range(FUSED_CHECK_STEPS):
                if stepper is not None:
                    stepper.step(batch, capture=step_fn == "graph")
                else:
                    mod.forward(batch, is_train=True)
                    mod.backward()
                    mod.update()
            out = params_of(mod)
            if stepper is not None:
                captures = stepper.guard.count
                stepper.release()
            else:
                apply = getattr(mod._updater, "_fused_apply", None)
                captures = apply.guard.count if apply is not None else None
        del mod, stepper
        torch.cuda.empty_cache()
        return out, captures

    graph, captures = run("graph", "bfloat16")
    eager, _ = run("eager", "bfloat16")
    replay_err, replay_bits = params_err(graph, eager)
    fused32, _ = run("graph")
    classic, update_captures = run("classic")
    classic_err, classic_bits = params_err(fused32, classic)
    per_param, per_param_captures = run("classic", fused=False)
    update_err, update_bits = params_err(classic, per_param)
    out = {"replay_vs_eager_rel": replay_err, "replay_vs_eager_bitwise":
           replay_bits, "captures_in_check": captures,
           "fused_fp32_vs_classic_rel": classic_err,
           "fused_fp32_vs_classic_bitwise": classic_bits,
           "fused_update_vs_updater_rel": update_err,
           "fused_update_vs_updater_bitwise": update_bits,
           "fused_update_captures": update_captures}
    log(f"[fused] {config}: {FUSED_CHECK_STEPS} steps each from one init: "
        f"replayed against eager (bf16) {replay_err:.3g} of the largest "
        f"parameter (bit for bit: {replay_bits}); fused fp32 against "
        f"forward/backward/update {classic_err:.3g} ({classic_bits}); "
        f"Module.update's fused path against the per-parameter updater "
        f"{update_err:.3g} ({update_bits}; the fused update captured "
        f"{update_captures} time(s))")
    if captures != 1 or update_captures != 1:
        raise RuntimeError(f"{config}: {captures} step and {update_captures} "
                           "update captures, expected 1 each")
    if per_param_captures is not None:
        raise RuntimeError(f"{config}: MXTPU_FUSED_STEP=0 took the fused "
                           "update")
    if replay_err > REPLAY_TOL[config]:
        raise RuntimeError(f"{config}: the replayed step is {replay_err} "
                           "from the eager body")
    for what, err in (("fused fp32 against classic", classic_err),
                      ("fused update against updater", update_err)):
        if not err <= FUSED_VS_CLASSIC_TOL:
            raise RuntimeError(f"{config}: {what}: {err}")
    return out


def fused_main_path(mx, config, net, batch, sgd, loss, marks=None):
    """The main path of phase 14 for one configuration: FUSED_STEPS steps
    through module_stepper(compute_dtype="bfloat16") on the one batch,
    exactly one capture, every loss finite and the last below the first;
    then FUSED_TIMED timed steps, one profiled step (B1's kernels counted
    by name in it), peak memory; and the classic path's FUSED_TIMED steps
    (forward/backward/update, Module.update fused) in the same run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod = fused_module(mx, config, net, batch, sgd)
    aux0 = {n: a.asnumpy() for n, a in mod.get_params()[1].items()}
    stepper = mx.perf.module_stepper(mod, compute_dtype="bfloat16")
    if stepper is None:
        raise RuntimeError(f"{config}: module_stepper refused the module")
    losses = []
    t0 = time.perf_counter()
    for _ in range(FUSED_STEPS):
        stepper.step(batch)
        losses.append(loss(mod))
    first_s = time.perf_counter() - t0
    if marks is not None:
        marks.append(train_counts())  # the main path's run ends here
    captures = stepper.guard.count
    args, auxs = mod.get_params()
    finite = all(bool(torch.isfinite(v._data).all())
                 for v in list(args.values()) + list(auxs.values()))
    moved = sum(not np.array_equal(a.asnumpy(), aux0[n])
                for n, a in auxs.items())
    log(f"[fused] {config}: {FUSED_STEPS} fused bf16 steps in {first_s:.2f} "
        f"s (warm-up and capture included), {captures} capture(s), "
        f"cross-entropy {[round(x, 5) for x in losses]}; parameters and "
        f"moving statistics finite: {finite}; moving statistics moved: "
        f"{moved} of {len(auxs)}")
    if captures != 1:
        raise RuntimeError(f"{config}: {captures} captures, expected 1")
    if not (finite and all(math.isfinite(x) for x in losses)):
        raise RuntimeError(f"{config}: non-finite fused training {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{config}: the loss did not fall: {losses}")
    if moved != len(auxs):
        raise RuntimeError(f"{config}: {len(auxs) - moved} moving statistics "
                           "did not move")
    ms, runs, host = timed_steps(lambda: stepper.step(batch))
    peak = torch.cuda.max_memory_allocated()
    unread_ms = None
    fused = stepper._fused
    if fused._checks_ids:
        # what the Embedding flag's read at each step's start costs: the
        # same steps with the read left out (a diagnostic; the path reads)
        fused.check_ids = lambda: None
        unread_ms, _, _ = timed_steps(lambda: stepper.step(batch))
        del fused.check_ids
        fused.check_ids()
    profile = profile_device(f"one fused {config} step",
                             lambda: stepper.step(batch), keep_all=True,
                             expect=B1_KERNELS if config == "lstm" else None)
    kernels = replay_counts(profile, list(B1_KERNELS))
    profile["replay_kernels"] = kernels
    top_all = profile.pop("top_all")
    profile["kernels_in_step"] = sum(row[2] for row in top_all)
    if stepper.guard.count != 1:
        raise RuntimeError(f"{config}: the timed steps captured again")
    stepper.release()
    del mod, stepper
    torch.cuda.empty_cache()

    with fused_path(True):  # forward/backward/update, Module.update fused
        mod = fused_module(mx, config, net, batch, sgd)

        def classic_step():
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()

        classic_ms, classic_runs, _ = timed_steps(classic_step)
        classic_profile = profile_device(f"one classic {config} step",
                                         classic_step)
    del mod
    torch.cuda.empty_cache()
    log(f"[fused] {config}: fused bf16 step median {ms:.3f} ms (CUDA events) "
        f"of {[round(x, 3) for x in runs]}, host {host:.3f} ms; device busy "
        f"{profile['device_busy_us'] / 1e3:.3f} ms, idle share "
        f"{profile['idle_share']:.4f}, host reads {profile['host_reads']}; "
        f"B1 kernels in the profiled replay {kernels}; peak {peak} bytes; "
        f"without the Embedding flag's read {unread_ms} ms. "
        f"Classic step (Module.update fused) median {classic_ms:.3f} ms, "
        f"idle share {classic_profile['idle_share']:.4f}")
    return {"losses": losses, "captures": captures, "step_ms": ms,
            "step_runs_ms": runs, "step_host_ms": host,
            "peak_device_bytes": peak, "profile": profile,
            "step_ms_without_id_read": unread_ms,
            "classic_fused_update_step_ms": classic_ms,
            "classic_fused_update_runs_ms": classic_runs,
            "classic_fused_update_profile": classic_profile,
            "first_steps_s": first_s}


def phase_fused_lstm(fit_check=True):
    """(a) the LSTM LM at the bench's shape through the fused step, its
    checks, and (c) a Module.fit epoch that takes it."""
    import mxnet_tpu_torch as mx
    net = build_lm(mx, V, H, LAYERS, TRAIN_T, train=True)
    data, label, host_batch = train_data(mx)
    batch = mx.io.DataBatch([mx.nd.array(host_batch.data[0].asnumpy())],
                            [mx.nd.array(host_batch.label[0].asnumpy())])
    sgd = dict(TRAIN_SGD, learning_rate=TRAIN_STEP_LR)
    marks = []
    zero_train_counts()  # the main path's run starts here
    rec = fused_main_path(mx, "lstm", net, batch, sgd,
                          lambda mod: cross_entropy(mx, mod, batch), marks)
    rec["launches_outside_replays"] = marks[0]
    if marks[0][:3] != (2 * LAYERS, 2 * LAYERS, 2 * LAYERS):
        raise RuntimeError(f"B1's wrappers ran {marks[0]} times outside the "
                           "replays, expected 2 x LAYERS each (the warm-up "
                           "and the capture)")
    if rec["profile"]["replay_kernels"] != B1_KERNELS:
        raise RuntimeError(f"B1's kernels in a replay: "
                           f"{rec['profile']['replay_kernels']}, expected "
                           f"{B1_KERNELS}")
    rec["checks"] = fused_checks(mx, "lstm", net, batch, sgd)
    if fit_check:
        rec["fit"] = fused_fit(mx, net, data, label)
    return rec


def fused_fit(mx, net, data, label):
    """(c) one Module.fit epoch over NDArrayIter (TRAIN_BATCHES batches) on
    the fused step, then get_params and save_optimizer_states."""
    import pickle
    mx.random.seed(0)
    mod = mx.mod.Module(net)
    mod.fit(mx.io.NDArrayIter(data, label, batch_size=TRAIN_N), num_epoch=1,
            optimizer="sgd", optimizer_params=TRAIN_SGD,
            initializer=mx.init.Xavier(), eval_metric=mx.metric.create("ce"))
    stepper = mod._fused_stepper
    if stepper in (None, False) or stepper.guard.count != 1:
        raise RuntimeError(f"fit did not take the fused step: {stepper}")
    args, _ = mod.get_params()
    finite = all(bool(torch.isfinite(v._data).all()) for v in args.values())
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "lm.states")
        mod.save_optimizer_states(fname)
        with open(fname, "rb") as f:
            _, opt = pickle.loads(f.read())
    log(f"[fused] (c) fit: one epoch of {TRAIN_BATCHES} batches on the fused "
        f"step ({stepper.guard.count} capture), parameters finite: {finite}, "
        f"saved optimizer state num_update {opt.num_update}")
    if not finite or opt.num_update != TRAIN_BATCHES:
        raise RuntimeError("the fit epoch's parameters or optimizer state")
    stepper.release()
    return {"captures": stepper.guard.count, "num_update": opt.num_update}


def phase_fused_resnet():
    """(b) bench.py's bench_resnet configuration through the fused step."""
    import mxnet_tpu_torch as mx
    net = resnet_symbol(mx, "bfloat16")
    rng = np.random.RandomState(0)  # bench.py:112-116
    data = rng.rand(RESNET_BATCH, 224, 224, 3).astype(np.float32)
    label = rng.randint(0, 1000, (RESNET_BATCH,)).astype(np.float32)
    batch = mx.io.DataBatch([mx.nd.array(data, ctx=mx.gpu(0))],
                            [mx.nd.array(label, ctx=mx.gpu(0))])
    labels = torch.tensor(label, device=CARD).long()

    def loss(mod):
        prob = mod.get_outputs()[0]._data.float()
        return float(-torch.log(prob.gather(1, labels[:, None])
                                .clamp_min(1e-30)).mean())

    before = hand_kernel_counts()
    rec = fused_main_path(mx, "resnet", net, batch, RESNET_SGD, loss)
    if hand_kernel_counts() != before:
        raise RuntimeError("the fused ResNet path launched a hand-written "
                           "kernel")
    rec["checks"] = fused_checks(mx, "resnet", net, batch, RESNET_SGD)
    return rec


def phase_fused(bench, resnet):
    """14: the fused step on both configurations, beside the classic
    path's numbers of phases 11 and 13 from this run."""
    card = nvidia_smi_name_and_limit()
    lstm = phase_fused_lstm()
    lstm["classic_per_parameter_step_ms"] = bench["step_ms"]
    res = phase_fused_resnet()
    res["classic_per_parameter_step_ms"] = resnet["step_ms"]
    for name, rec in (("lstm", lstm), ("resnet", res)):
        log(f"[fused] {name} on {card}: fused bf16 {rec['step_ms']:.3f} ms "
            f"(idle share {rec['profile']['idle_share']:.4f}), classic with "
            f"the fused update {rec['classic_fused_update_step_ms']:.3f} ms, "
            f"classic per-parameter (phase {11 if name == 'lstm' else 13}) "
            f"{rec['classic_per_parameter_step_ms']:.3f} ms")
    return {"card": card, "lstm": lstm, "resnet": res}


# -- 15: the serving runtime ------------------------------------------------

# bench_serving.py's burst: 64 single-row requests, coalesced up to 16 rows
SERVE_REQUESTS = 64
SERVE_MAX_BATCH = 16
SERVE_DEADLINE_S = 120.0
SERVE_WAIT_S = 0.002
TF_SERVE_REQUESTS = 8
TF_SERVE_MAX_BATCH = 4
# bench_serving.py's decode: a full table stepped 32 times, one churn at 16
DECODE_CAPACITY = 16
DECODE_STEPS = 32


def served_lm_symbol(mx):
    """Phase 4's LM with its (T*N, V) probabilities reshaped and swapped to
    batch-major (N, T, V): the server scatters a dispatch's answers by
    rows of the leading axis."""
    probs = build_lm(mx, V, H, LAYERS, T)
    return mx.sym.SwapAxis(mx.sym.Reshape(probs, shape=(T, -1, V)),
                           dim1=0, dim2=1)


def served_lm_module(mx, ctx):
    """The served LM bound for inference at 16 rows, with phase 4's
    seeded weights."""
    net = served_lm_symbol(mx)
    arg_shapes, _, _ = net.infer_shape(data=(1, T))
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.05, 0.05, s).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (SERVE_MAX_BATCH, T))],
             for_training=False)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in params.items()},
                    aux_params={})
    return mod


def decode_step_symbol(mx):
    """One LSTM decode step at the LM's width, as the JAX package's
    ``rnn.LSTMCell`` unrolls it (gates i, f, g, o), with a FullyConnected
    head over the vocabulary; outputs (logits, next h, next c)."""
    x, h, c = mx.sym.var("data"), mx.sym.var("h"), mx.sym.var("c")
    i2h = mx.sym.FullyConnected(x, num_hidden=4 * H, name="dec_i2h")
    h2h = mx.sym.FullyConnected(h, num_hidden=4 * H, name="dec_h2h")
    lanes = mx.sym.SliceChannel(i2h + h2h, num_outputs=4, name="dec_slice")
    keep, forget, emit = (mx.sym.Activation(lanes[i], act_type="sigmoid")
                          for i in (0, 1, 3))
    cand = mx.sym.Activation(lanes[2], act_type="tanh")
    next_c = forget * c + keep * cand
    next_h = emit * mx.sym.Activation(next_c, act_type="tanh")
    logits = mx.sym.FullyConnected(next_h, num_hidden=V, name="dec_proj")
    return mx.sym.Group([logits, next_h, next_c])


def check_served(stats, n, label):
    """Every request of the run completed; nothing failed, degraded, shed,
    abandoned or ran at an unwarmed shape; the circuit is closed."""
    bad = {k: stats[k] for k in ("failed", "degraded", "shed", "abandoned",
                                 "rejected_open", "deadline_queued",
                                 "deadline_inflight") if stats[k]}
    unwarmed = stats["batching"]["unwarmed_dispatch_signatures"]
    if (stats["completed"] != n or bad or unwarmed
            or stats["circuit"]["state"] != "closed"):
        raise RuntimeError(
            f"[serve] {label}: completed {stats['completed']} of {n}, "
            f"{bad}, unwarmed {unwarmed}, circuit "
            f"{stats['circuit']['state']}")


def serve_burst(backend, rows, max_batch, name, counts, buckets=None):
    """bench_serving.py's open-loop burst: every request submitted at
    once, one worker draining, each answer read in submit order (a
    failed request raises here). Launch counts start at 0 after the
    warm-up; returns the answers and the burst's numbers."""
    from mxnet_tpu_torch import compiler
    from mxnet_tpu_torch.serving import InferenceServer
    server = InferenceServer(backend, name=name, max_batch=max_batch,
                             batch_wait=SERVE_WAIT_S, workers=1,
                             capacity=SERVE_REQUESTS, buckets=buckets,
                             default_deadline=SERVE_DEADLINE_S)
    try:
        server.warm_up()
        builds = compiler.stats()
        counts(reset=True)  # the served path's run starts here
        t0 = time.perf_counter()
        pending = [server.submit({"data": x}) for x in rows]
        answers, latencies = [], []
        for req in pending:
            answers.append(server.result(req)[0])
            latencies.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
        launched = counts()  # ... and ends here
        stats = server.stats()
    finally:
        server.close()
    check_served(stats, len(rows), name)
    if compiler.stats() != builds:
        raise RuntimeError(f"[serve] {name}: a kernel library was built "
                           f"on a live request: {builds} -> "
                           f"{compiler.stats()}")
    pw = stats["pad_waste"]
    return answers, {
        "requests": len(rows), "wall_s": wall, "rps": len(rows) / wall,
        "p50_ms": float(np.percentile(latencies, 50)) * 1e3,
        "p99_ms": float(np.percentile(latencies, 99)) * 1e3,
        "dispatches": stats["dispatches"],
        "coalesced_requests": stats["coalesced_requests"],
        "warmed_buckets": stats["warmed_buckets"],
        "warmup_compiles": stats["warmup_compiles"],
        "warmup_cache_hits": stats["warmup_cache_hits"],
        "pad_waste_ratio": pw["ratio"], "pad_waste": pw,
        "launches": launched}


def output_copy_share(profiled):
    """The device-to-host copies' share of a profiled dispatch's busy
    time (the server's answers are numpy arrays)."""
    copy_us = sum(us for key, us, _ in profiled["top_all"]
                  if "DtoH" in key or "Device -> Host" in key)
    return copy_us / profiled["device_busy_us"], copy_us


def phase_serve_lstm(card):
    """15a: the LSTM LM through InferenceServer: a burst coalesced up to 16
    rows, then the same burst one request a dispatch."""
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda.lstm import (lstm_cell_fused,
                                               lstm_sequence_fused)
    mod = served_lm_module(mx, mx.gpu(0))
    backend = mod.as_serving_backend()
    seen = []
    probe = threading.Thread(target=lambda: seen.append(
        torch.cuda.current_device()))
    probe.start()
    probe.join()
    if seen != [mod._exec._device.index]:
        raise RuntimeError(f"a fresh thread's current device {seen} is not "
                           f"the module's {mod._exec._device}")
    rng = np.random.RandomState(3)
    rows = [rng.randint(0, V, (1, T)).astype(np.float32)
            for _ in range(SERVE_REQUESTS)]

    def counts(reset=False):
        if reset:
            lstm_sequence_fused.launches = lstm_cell_fused.launches = 0
        return {"lstm_sequence": lstm_sequence_fused.launches,
                "lstm_cell": lstm_cell_fused.launches}

    runs = {}
    batched, runs["batched"] = serve_burst(
        backend, rows, SERVE_MAX_BATCH, "lstm-b16", counts)
    unbatched, runs["unbatched"] = serve_burst(
        backend, rows, 1, "lstm-b1", counts, buckets=[1])
    for name, run in runs.items():
        got = run["launches"]
        if (got["lstm_sequence"] != LAYERS * run["dispatches"]
                or got["lstm_cell"] != 0 or not run["dispatches"]):
            raise RuntimeError(
                f"[serve] lstm {name}: launches {got} over "
                f"{run['dispatches']} dispatches; expected "
                f"{LAYERS} sequence launches a dispatch, no per-step one")

    # every answer against the same row through the port's CPU path
    cpu = served_lm_module(mx, mx.cpu()).as_serving_backend()
    want = np.concatenate([
        cpu.infer({"data": np.concatenate(rows[i:i + SERVE_MAX_BATCH])})[0]
        for i in range(0, SERVE_REQUESTS, SERVE_MAX_BATCH)])
    errs = {}
    for name, answers in (("batched", batched), ("unbatched", unbatched)):
        if any(a.shape != (1, T, V) or not np.isfinite(a).all()
               for a in answers):
            raise RuntimeError(f"[serve] lstm {name}: answers of shapes "
                               f"{sorted({a.shape for a in answers})} or "
                               f"not finite")
        errs[name] = held_probs(np.concatenate(answers), want,
                                f"serve lstm {name}")
    prob_err = max(err for err, _ in errs.values())
    rolled_err = min(rolled for _, rolled in errs.values())

    full = np.concatenate(rows[:SERVE_MAX_BATCH])
    profiled = profile_device(
        f"one {SERVE_MAX_BATCH}-row LSTM dispatch (ModuleBackend.infer)",
        lambda: backend.infer({"data": full}), keep_all=True)
    share, copy_us = output_copy_share(profiled)
    del profiled["top_all"]
    profiled.update(output_copy_us=copy_us, output_copy_share=share)
    b, u = runs["batched"], runs["unbatched"]
    log(f"[serve] lstm on {card}: batched {b['rps']:.2f} req/s (p50 "
        f"{b['p50_ms']:.2f} ms, p99 {b['p99_ms']:.2f} ms, {b['dispatches']} "
        f"dispatches, {b['warmed_buckets']} warmed buckets, pad waste "
        f"{b['pad_waste_ratio']:.4f}); unbatched {u['rps']:.2f} req/s (p50 "
        f"{u['p50_ms']:.2f} ms, p99 {u['p99_ms']:.2f} ms, {u['dispatches']} "
        f"dispatches); ratio {b['rps'] / u['rps']:.3f}; answers within "
        f"{prob_err:.3e} of the CPU path (tol {PROB_TOL}; rolled by one "
        f"row {rolled_err:.3e})")
    log(f"[serve] lstm on {card}: one 16-row dispatch busy "
        f"{profiled['device_busy_us']:.1f} us of {profiled['wall_us']:.1f} "
        f"(idle share {profiled['idle_share']:.4f}); output copy "
        f"{copy_us:.1f} us, share of busy {share:.4f}")
    return {"batched": b, "unbatched": u, "speedup": b["rps"] / u["rps"],
            "prob_err_vs_cpu": prob_err, "rolled_err_vs_cpu": rolled_err,
            "profile": profiled}


def phase_serve_transformer(card, lm):
    """15b: the transformer LM (phase 5's) through InferenceServer: 8
    single-row requests coalesced up to 4 rows."""
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention
    from mxnet_tpu_torch.serving import CallableBackend
    backend = CallableBackend(
        lambda arrays: lm.logits(arrays["data"]).cpu().numpy(),
        input_specs={"data": (TF_S,)})
    rng = np.random.RandomState(4)
    rows = [rng.randint(0, lm.cfg.vocab_size, (1, TF_S)).astype(np.float32)
            for _ in range(TF_SERVE_REQUESTS)]

    def counts(reset=False):
        if reset:
            flash_attention.launches = flash_attention.wgmma_launches = 0
            flash_attention.masked_launches = 0
        return {"flash_attention": flash_attention.launches,
                "wgmma": flash_attention.wgmma_launches,
                "masked": flash_attention.masked_launches}

    answers, run = serve_burst(backend, rows, TF_SERVE_MAX_BATCH, "tf-b4",
                               counts)
    got, n = run["launches"], lm.cfg.num_layers * run["dispatches"]
    if (got["flash_attention"] != n or got["wgmma"] != n
            or got["masked"] != 0 or not n):
        raise RuntimeError(f"[serve] transformer launches {got} over "
                           f"{run['dispatches']} dispatches; expected "
                           f"{lm.cfg.num_layers} wgmma launches a dispatch")
    logit_err = 0.0
    for row, ans in zip(rows, answers):
        want = lm.logits(row).cpu().numpy()
        if ans.shape != want.shape or not np.isfinite(ans).all():
            raise RuntimeError(f"[serve] transformer answer {ans.shape}")
        logit_err = max(logit_err, float(np.abs(ans - want).max()))
    if not logit_err <= BF16_LOGIT_TOL:
        raise RuntimeError(f"[serve] transformer answers against direct "
                           f"logits: {logit_err} > {BF16_LOGIT_TOL}")
    full = np.concatenate(rows[:TF_SERVE_MAX_BATCH])
    profiled = profile_device(
        f"one {TF_SERVE_MAX_BATCH}-row transformer dispatch "
        "(CallableBackend.infer)", lambda: backend.infer({"data": full}),
        keep_all=True)
    share, copy_us = output_copy_share(profiled)
    del profiled["top_all"]
    profiled.update(output_copy_us=copy_us, output_copy_share=share)
    log(f"[serve] transformer on {card}: {run['rps']:.2f} req/s (p50 "
        f"{run['p50_ms']:.2f} ms, p99 {run['p99_ms']:.2f} ms, "
        f"{run['dispatches']} dispatches, {run['warmed_buckets']} warmed "
        f"buckets, pad waste {run['pad_waste_ratio']:.4f}); answers within "
        f"{logit_err:.3e} of direct logits (tol {BF16_LOGIT_TOL})")
    log(f"[serve] transformer on {card}: one {TF_SERVE_MAX_BATCH}-row "
        f"dispatch busy {profiled['device_busy_us']:.1f} us of "
        f"{profiled['wall_us']:.1f} (idle share "
        f"{profiled['idle_share']:.4f}); output copy {copy_us:.1f} us, "
        f"share of busy {share:.4f}")
    return {"run": run, "logit_err_vs_direct": logit_err,
            "profile": profiled}


def phase_serve_decode(card):
    """15c: decode through InflightBatcher over ModuleStepBackend: a full
    table of 16 sequences stepped 32 times, sequence 0 leaving at step 16
    and a new one joining its slot; both equal their solo decodes at the
    same capacity bit for bit (each step runs at the one (16, ...) shape,
    for which cuBLAS picks one algorithm whichever rows are live)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import InflightBatcher
    net = decode_step_symbol(mx)
    mod = mx.mod.Module(net, data_names=["data", "h", "c"], label_names=[])
    mod.bind(data_shapes=[("data", (DECODE_CAPACITY, H)),
                          ("h", (DECODE_CAPACITY, H)),
                          ("c", (DECODE_CAPACITY, H))], for_training=False)
    mx.random.seed(13)
    mod.init_params(mx.init.Xavier())
    rng = np.random.RandomState(7)
    tokens = [[rng.rand(H).astype(np.float32) for _ in range(DECODE_STEPS)]
              for _ in range(DECODE_CAPACITY + 1)]   # +1: the joiner

    def batcher(name):
        return InflightBatcher(mod.as_decode_backend(["h", "c"]),
                               name=name).warm_up()

    b = batcher("decode")
    slots = [b.join() for _ in range(DECODE_CAPACITY)]
    churn_at = DECODE_STEPS // 2
    traced = {0: [], DECODE_CAPACITY: []}
    seq0 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(DECODE_STEPS):
        if t == churn_at:
            b.leave(slots[0])
            slots[0] = b.join()
            seq0 = DECODE_CAPACITY
        feed = {slots[i]: {"data": tokens[i][t]}
                for i in range(1, DECODE_CAPACITY)}
        feed[slots[0]] = {"data": tokens[seq0][t - churn_at * (seq0 > 0)]}
        outs = b.step(feed)
        traced[seq0].append(outs[slots[0]][0])
    wall = time.perf_counter() - t0
    stats = b.stats()
    if stats["retraced"] or stats["steps"] != DECODE_STEPS:
        raise RuntimeError(f"[serve] decode stats {stats}")
    for seq, n_steps in ((0, churn_at), (DECODE_CAPACITY,
                                         DECODE_STEPS - churn_at)):
        solo = batcher(f"decode-solo{seq}")
        s = solo.join()
        for t in range(n_steps):
            out = solo.step({s: {"data": tokens[seq][t]}})[s][0]
            if not np.array_equal(out, traced[seq][t]):
                raise RuntimeError(f"[serve] decode: sequence {seq} step {t} "
                                   "differs from its solo decode")
            if not np.isfinite(out).all():
                raise RuntimeError("[serve] decode: non-finite logits")
    tps = stats["tokens"] / wall
    log(f"[serve] decode on {card}: {stats['tokens']} tokens in "
        f"{DECODE_STEPS} steps at capacity {DECODE_CAPACITY}, "
        f"{tps:.1f} tokens/s ({wall * 1e3 / DECODE_STEPS:.3f} ms a step); "
        f"churned sequences bit for bit their solo decodes; retraces "
        f"{int(stats['retraced'])}, compiles {stats['compiles']}")
    return {"tokens_per_s": tps, "step_ms": wall * 1e3 / DECODE_STEPS,
            "tokens": stats["tokens"], "steps": stats["steps"],
            "retraced": stats["retraced"], "compiles": stats["compiles"],
            "bitwise_vs_solo": True}


def phase_serve(tf):
    """15: the serving runtime on the card (see the module docstring)."""
    card = nvidia_smi_name_and_limit()
    out = {"card": card, "lstm": phase_serve_lstm(card),
           "transformer": phase_serve_transformer(card, tf["lm"]),
           "decode": phase_serve_decode(card)}
    log("[serve] phase 15: " + json.dumps(out))
    return out


# -- 16: imperative autograd and Gluon ------------------------------------

# the Gluon LM trained: bench_lstm.py's width and shape, plain SGD at 0.5
# with trainer.step(N * T): each update the per-token mean's, the descent
# of Module at 0.5 / T (phase 11)
GLUON_STEPS = 10
GLUON_SGD = {"learning_rate": 0.5}
# one Gluon step against Module's classic step on the card, same weights
# and batch, both through B1's kernels: the per-token cross entropy's and
# SoftmaxOutput's gradients are the same sums, in other orders; each
# gradient held at GLUON_MODULE_TOL of its own largest magnitude
GLUON_MODULE_TOL = 1e-5
# the full-width Gluon step at a small batch, card against the port's CPU
# path: the loss at GLUON_CPU_LOSS_TOL, each gradient at GLUON_CPU_GRAD_TOL
# of its own largest magnitude (phase 11's card-against-CPU bound, 1e-5,
# is for Module's graph over 8 steps; here 16 steps and the gradients of
# the LSTM's four pieces a layer)
GLUON_CPU_N, GLUON_CPU_T = 4, 16
GLUON_CPU_LOSS_TOL = 1e-5
GLUON_CPU_GRAD_TOL = 1e-4
# nn.MultiHeadAttention at the transformer's width, bf16, causal: (B, S)
# on the card for the launch counts, S = MHA_CPU_S against the CPU path
# at the attention phases' bf16 tolerance (ATT_BWD_BF16_TOL of each
# result's largest magnitude)
MHA_D, MHA_HEADS, MHA_B, MHA_S, MHA_CPU_S = 512, 8, 4, 2048, 256
# model_zoo's resnet50_v2, hybridized, fp32 NCHW at 224**2; the batch is
# cut from bench_resnet's 256 to 64 (PERF.md section 4); SGD with momentum
# on one repeated batch
ZOO_BATCH, ZOO_SIZE, ZOO_STEPS = 64, 224, 10
ZOO_SGD = {"learning_rate": 0.1, "momentum": 0.9}


def gluon_lm(mx, vocab, hidden, layers):
    """bench_lstm.py's model as MXNet's Gluon word-language-model example
    writes it (RNNModel without dropout or tied weights)."""
    gluon = mx.gluon

    class RNNModel(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.encoder = gluon.nn.Embedding(vocab, hidden)
                self.rnn = gluon.rnn.LSTM(hidden, num_layers=layers,
                                          layout="TNC")
                self.decoder = gluon.nn.Dense(vocab, flatten=False)

        def hybrid_forward(self, F, x):
            out = self.rnn(self.encoder(x))
            return self.decoder(F.reshape(out, shape=(-1, hidden)))

    return RNNModel(prefix="lm_")


def gluon_batch(mx, data, label, n, t, ctx=None):
    """Module's (N, T) batch as the Gluon LM takes it: the tokens TNC, the
    labels flattened N-major, as bench_lstm.py's graph reshapes them (its
    output rows are T-major: each row is paired with the same label)."""
    return (mx.nd.array(data[:n, :t].T, ctx=ctx),
            mx.nd.array(label[:n, :t].reshape(-1), ctx=ctx))


def gluon_init(mx, x, ctx=None, seed=0):
    """The Gluon LM at full width from seeded Xavier, its deferred shapes
    fixed by one forward."""
    mx.random.seed(seed)
    net = gluon_lm(mx, V, H, LAYERS)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(x)
    return net


def gluon_grads(mx, net, x, y):
    """One recorded forward and backward: the per-token losses (host) and
    every parameter's gradient (on its device)."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    return loss.asnumpy(), {k: p.grad()._data.clone()
                            for k, p in net.collect_params().items()}


def gluon_lm_train(mx, data, label, hybrid):
    """GLUON_STEPS record/backward/trainer.step(N*T) steps of the Gluon LM
    on the first batch, on the default context: every step 2 sequence
    forward and 2 register-kernel backward launches and no per-step one,
    the fused update captured once, the loss falling; then ms per step
    (CUDA events, median of 7), the host clock, one profiled step and the
    peak memory."""
    x, y = gluon_batch(mx, data, label, TRAIN_N, TRAIN_T)
    net = gluon_init(mx, x)
    if hybrid:
        net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_SGD))

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(TRAIN_N * TRAIN_T)
        return loss

    label_ = "hybridized" if hybrid else "imperative"
    torch.cuda.reset_peak_memory_stats()
    losses, per_step = [], []
    zero_train_counts()  # the Gluon LM's path starts here
    for _ in range(GLUON_STEPS):
        before = train_counts()
        loss = step()
        per_step.append(tuple(a - b for a, b in zip(train_counts(), before)))
        losses.append(float(loss.mean().asscalar()))
        del loss
    launches = train_counts()  # and ends here
    peak = torch.cuda.max_memory_allocated()
    captures = trainer._fused_apply.guard.count
    log(f"[gluon] LM {label_} N={TRAIN_N} T={TRAIN_T}: {GLUON_STEPS} steps "
        f"at {GLUON_SGD}, step({TRAIN_N * TRAIN_T}): cross-entropy "
        f"{[round(v, 5) for v in losses]}; (lstm_sequence, "
        f"lstm_sequence_backward, its register kernel, lstm_cell, "
        f"lstm_cell_backward) launches per step {per_step}; fused update "
        f"captures {captures}; cached ops "
        f"{len(net._cached_ops) if hybrid else 0}; peak {peak} bytes")
    if any(c != (LAYERS, LAYERS, LAYERS, 0, 0) for c in per_step):
        raise RuntimeError(f"Gluon LM launches per step {per_step}, expected "
                           f"{(LAYERS, LAYERS, LAYERS, 0, 0)}")
    if captures != 1:
        raise RuntimeError(f"the fused update was captured {captures} times")
    if hybrid and len(net._cached_ops) != 1:
        raise RuntimeError(f"cached ops {list(net._cached_ops)}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the Gluon LM's loss did not fall: {losses}")
    for k, p in net.collect_params().items():
        if not bool(torch.isfinite(p.data()._data).all()):
            raise RuntimeError(f"parameter {k} not finite")
    ms, runs, host = timed_steps(step)
    tokens = TRAIN_N * TRAIN_T / ms * 1e3
    log(f"[gluon] LM {label_} step: median {ms:.3f} ms (CUDA events) of "
        f"{[round(v, 3) for v in runs]}, host clock median {host:.3f} ms; "
        f"{tokens:.1f} tokens/s")
    profile = profile_device(f"one Gluon LM step ({label_})", step)
    return {"losses": losses, "per_step": per_step[0], "launches": launches,
            "captures": captures, "step_ms": ms, "step_runs_ms": runs,
            "step_host_ms": host, "tokens_per_s": tokens,
            "peak_device_bytes": peak, "profile": profile}


def gluon_vs_module(mx, data, label):
    """One Gluon step against Module's classic step on the card, from the
    same weights (the LSTM pieces packed into Module's ``lstm_parameters``)
    and batch: the mean loss and every gradient."""
    from mxnet_tpu_torch.convert import pack_rnn_pieces
    x, y = gluon_batch(mx, data, label, TRAIN_N, TRAIN_T)
    net = gluon_init(mx, x, seed=1)
    loss, grads = gluon_grads(mx, net, x, y)
    params = net.collect_params()
    rnn = {k[len("lm_lstm0_"):]: p for k, p in params.items()
           if k.startswith("lm_lstm0_")}
    mod = mx.mod.Module(build_lm(mx, V, H, LAYERS, TRAIN_T, train=True))
    mod.bind(data_shapes=[("data", (TRAIN_N, TRAIN_T))],
             label_shapes=[("softmax_label", (TRAIN_N, TRAIN_T))])
    mod.init_params(mx.init.Xavier())
    mod.set_params({
        "embed_weight": params["lm_embedding0_weight"].data(),
        "lstm_parameters": mx.nd.array(pack_rnn_pieces(
            {k: p.data() for k, p in rnn.items()}, LAYERS)),
        "pred_weight": params["lm_dense0_weight"].data(),
        "pred_bias": params["lm_dense0_bias"].data()}, {})
    batch = mx.io.DataBatch([mx.nd.array(data[:TRAIN_N], ctx=mx.cpu())],
                            [mx.nd.array(label[:TRAIN_N], ctx=mx.cpu())])
    zero_train_counts()
    mod.forward(batch, is_train=True)
    mod.backward()
    if train_counts()[:2] != (LAYERS, LAYERS):
        raise RuntimeError(f"Module's step launched {train_counts()}")
    prob = mod.get_outputs()[0]._data
    rows = torch.arange(TRAIN_N * TRAIN_T, device=prob.device)
    labels = torch.tensor(label[:TRAIN_N].reshape(-1), device=prob.device)
    ce = float(-torch.log(prob[rows, labels.long()]).mean())
    mgrads = {k: v._data for k, v in mod._exec.grad_dict.items()}
    pairs = {"embed_weight": grads["lm_embedding0_weight"],
             "pred_weight": grads["lm_dense0_weight"],
             "pred_bias": grads["lm_dense0_bias"],
             "lstm_parameters": torch.tensor(pack_rnn_pieces(
                 {k: grads["lm_lstm0_" + k].cpu().numpy() for k in rnn},
                 LAYERS), device=prob.device)}
    errs = {}
    for name, g in pairs.items():
        want = mgrads[name].float()
        errs[name] = float((g.float() - want).abs().max()
                           / want.abs().max())
    loss_err = abs(float(loss.mean()) - ce) / abs(ce)
    log(f"[gluon] one Gluon step against Module's classic step on the card "
        f"(N={TRAIN_N} T={TRAIN_T}): mean loss {float(loss.mean()):.6f} "
        f"against {ce:.6f} (relative {loss_err:.3g}); each gradient's "
        f"largest difference over its largest magnitude {errs}")
    if loss_err > GLUON_MODULE_TOL or any(e > GLUON_MODULE_TOL
                                          for e in errs.values()):
        raise RuntimeError("the Gluon step disagrees with Module's step "
                           f"beyond {GLUON_MODULE_TOL}")
    return {"loss_rel_err": loss_err, "grad_rel_err": errs}


def gluon_card_vs_cpu(mx, data, label):
    """The full-width Gluon step at GLUON_CPU_N x GLUON_CPU_T on the card
    and on the port's CPU path from the same weights."""
    from mxnet_tpu_torch.convert import gluon_params_from_numpy
    n, t = GLUON_CPU_N, GLUON_CPU_T
    x, y = gluon_batch(mx, data, label, n, t)
    xc, yc = gluon_batch(mx, data, label, n, t, ctx=mx.cpu())
    net = gluon_init(mx, x, seed=2)
    cpu = gluon_init(mx, xc, ctx=mx.cpu(), seed=3)
    gluon_params_from_numpy(cpu, {k: p.data().asnumpy() for k, p in
                                  net.collect_params().items()})
    loss, grads = gluon_grads(mx, net, x, y)
    loss_c, grads_c = gluon_grads(mx, cpu, xc, yc)
    loss_err = float(np.abs(loss - loss_c).max() / np.abs(loss_c).max())
    errs = {k: float((g.cpu() - grads_c[k]).abs().max()
                     / grads_c[k].abs().max()) for k, g in grads.items()}
    log(f"[gluon] full-width Gluon step N={n} T={t}, card against the CPU "
        f"path: loss {loss_err:.3g}, gradients {errs}")
    if loss_err > GLUON_CPU_LOSS_TOL or any(e > GLUON_CPU_GRAD_TOL
                                            for e in errs.values()):
        raise RuntimeError("the Gluon step on the card disagrees with the "
                           "CPU path")
    return {"loss_rel_err": loss_err, "grad_rel_err": errs}


def mha_run(mx, s, ctx=None, weights=None):
    """nn.MultiHeadAttention (bf16, causal) forward and backward under
    record() on (MHA_B, s, MHA_D) seeded inputs: the output, the input's
    and every parameter's gradient (host fp32), and the weights."""
    mx.random.seed(4)
    att = mx.gluon.nn.MultiHeadAttention(MHA_D, MHA_HEADS, causal=True,
                                         dtype="bfloat16", prefix="mha_")
    att.initialize(mx.init.Xavier(), ctx=ctx)
    if weights is not None:
        for k, p in att.collect_params().items():
            p.data()[:] = weights[k]
    rng = np.random.RandomState(5)
    x = mx.nd.array(rng.normal(0, 1, (MHA_B, s, MHA_D)), ctx=ctx,
                    dtype="bfloat16")
    cot = mx.nd.array(rng.normal(0, 1, (MHA_B, s, MHA_D)), ctx=ctx,
                      dtype="bfloat16")
    x.attach_grad()
    with mx.autograd.record():
        out = att(x)
    out.backward(cot)
    res = {"out": out.asnumpy(), "dx": x.grad.asnumpy()}
    # a key bias moves every score of a query row alike, which the softmax
    # cancels: its gradient is 0 up to rounding, with no scale to hold
    res.update({k: p.grad().asnumpy()
                for k, p in att.collect_params().items()
                if k != "mha_key_bias"})
    return res, {k: p.data().asnumpy() for k, p in
                 att.collect_params().items()}


def phase_gluon_attention(mx):
    """(b) nn.MultiHeadAttention at the transformer's width: one forward
    and backward at S=MHA_S, one wgmma forward and one wgmma backward
    launch; at S=MHA_CPU_S against the port's CPU path."""
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention as fa
    zero_attention_counts()  # the attention layer's path starts here
    res, _ = mha_run(mx, MHA_S)
    counts = {"forward": fa.launches, "wgmma_forward": fa.wgmma_launches,
              "backward": fa.backward_launches,
              "wgmma_backward": fa.wgmma_backward_launches}
    if counts != {"forward": 1, "wgmma_forward": 1, "backward": 1,
                  "wgmma_backward": 1}:
        raise RuntimeError(f"nn.MultiHeadAttention launches {counts}")
    if not all(np.isfinite(v).all() for v in res.values()):
        raise RuntimeError("nn.MultiHeadAttention: a non-finite result")
    card, weights = mha_run(mx, MHA_CPU_S)
    cpu, _ = mha_run(mx, MHA_CPU_S, ctx=mx.cpu(), weights=weights)
    errs = {k: float(np.abs(card[k] - cpu[k]).max()
                     / max(np.abs(cpu[k]).max(), ATT_BWD_FLOOR))
            for k in cpu}
    log(f"[gluon] nn.MultiHeadAttention d_model={MHA_D} heads={MHA_HEADS} "
        f"bf16 causal (B, S)=({MHA_B}, {MHA_S}): launches {counts}; at "
        f"S={MHA_CPU_S} card against the CPU path, largest difference over "
        f"largest magnitude {errs} (bound {ATT_BWD_BF16_TOL})")
    if any(e > ATT_BWD_BF16_TOL for e in errs.values()):
        raise RuntimeError("nn.MultiHeadAttention disagrees with the CPU path")
    return {"launches": counts, "card_vs_cpu_rel_err": errs}


def phase_gluon_resnet(mx):
    """(c) model_zoo.vision.get_model('resnet50_v2'), hybridized, fp32
    NCHW, ZOO_BATCH x 224**2: ZOO_STEPS SGD-momentum steps on one seeded
    batch (the loss falls, the moving statistics move), one cached op for
    each (shape, train) key, ms per step."""
    net = mx.gluon.model_zoo.vision.get_model("resnet50_v2", classes=1000)
    mx.random.seed(0)
    net.initialize(mx.init.Xavier())
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(ZOO_BATCH, 3, ZOO_SIZE, ZOO_SIZE))
    y = mx.nd.array(rng.randint(0, 1000, (ZOO_BATCH,)).astype(np.float32))
    net.hybridize()
    net(x)  # predict mode: fixes the deferred shapes (one cached op)
    params = net.collect_params()
    moving0 = {k: p.data()._data.clone() for k, p in params.items()
               if "running" in k}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(params, "sgd", dict(ZOO_SGD))

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(ZOO_BATCH)
        return loss

    before = hand_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(ZOO_STEPS):
        loss = step()
        losses.append(float(loss.mean().asscalar()))
        del loss
    peak = torch.cuda.max_memory_allocated()
    moved = sum(not torch.equal(p.data()._data, moving0[k])
                for k, p in params.items() if k in moving0)
    keys = {k: op.calls for k, op in net._cached_ops.items()}
    log(f"[gluon] resnet50_v2 hybridized fp32 NCHW batch {ZOO_BATCH}: "
        f"{ZOO_STEPS} steps at {ZOO_SGD}: cross-entropy "
        f"{[round(v, 4) for v in losses]}; moving statistics moved "
        f"{moved} of {len(moving0)}; cached ops (key: calls) {keys}; fused "
        f"update captures {trainer._fused_apply.guard.count}; peak {peak} "
        "bytes")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the ResNet's loss did not fall: {losses}")
    if moved != len(moving0):
        raise RuntimeError("a BatchNorm's moving statistics did not move")
    if sorted(k[1] for k in keys) != [False, True] or any(
            n < 1 for n in keys.values()):
        raise RuntimeError(f"cached ops {keys}: one a (shape, train) key")
    if hand_kernel_counts() != before:
        raise RuntimeError("the Gluon ResNet launched a hand-written kernel")
    ms, runs, host = timed_steps(step)
    log(f"[gluon] resnet50_v2 step: median {ms:.3f} ms (CUDA events) of "
        f"{[round(v, 3) for v in runs]}, host clock median {host:.3f} ms; "
        f"{ZOO_BATCH / ms * 1e3:.1f} img/s")
    return {"losses": losses, "moved_statistics": moved,
            "cached_ops": {str(k): n for k, n in keys.items()},
            "step_ms": ms, "step_runs_ms": runs, "step_host_ms": host,
            "img_per_s": ZOO_BATCH / ms * 1e3, "peak_device_bytes": peak}


def gluon_records(records, gluon):
    """Each kernel's launches on the Gluon paths (phase 16) beside its
    record's main-path count."""
    by_name = {r["name"]: r for r in records}
    for mode in ("imperative", "hybridized"):
        rec = gluon["lm_" + mode]
        for name, i in (("lstm_sequence", 0), ("lstm_sequence_backward", 1)):
            by_name[name].setdefault("gluon", {})[f"lm_{mode}"] = {
                "launches": rec["launches"][i], "steps": GLUON_STEPS,
                "path": f"the Gluon LM {mode}, {GLUON_STEPS} "
                        "record/backward/trainer.step steps (phase 16a)"}
    att = gluon["attention"]["launches"]
    by_name["flash_attention"]["gluon"] = {
        "launches": att["forward"], "wgmma_launches": att["wgmma_forward"],
        "path": "nn.MultiHeadAttention, one forward (phase 16b)"}
    by_name["flash_attention_backward"]["gluon"] = {
        "launches": att["backward"],
        "wgmma_launches": att["wgmma_backward"],
        "path": "nn.MultiHeadAttention, one backward (phase 16b)"}


def phase_gluon(bench):
    """16: the Gluon LM imperative and hybridized, its step against
    Module's and against the CPU path; nn.MultiHeadAttention; the Gluon
    ResNet-50 (see the module docstring); ``bench`` is phase 11's."""
    import mxnet_tpu_torch as mx
    card = nvidia_smi_name_and_limit()
    data, label, _ = train_data(mx)
    out = {"card": card,
           "lm_imperative": gluon_lm_train(mx, data, label, False),
           "lm_hybridized": gluon_lm_train(mx, data, label, True),
           "lm_vs_module": gluon_vs_module(mx, data, label),
           "lm_card_vs_cpu": gluon_card_vs_cpu(mx, data, label),
           "attention": phase_gluon_attention(mx),
           "resnet50_v2": phase_gluon_resnet(mx)}
    out["module_classic_step_ms"] = bench["step_ms"]
    for name in ("lm_imperative", "lm_hybridized"):
        rec = out[name]
        log(f"[gluon] {name} on {card}: {rec['step_ms']:.3f} ms a step "
            f"(idle share {rec['profile']['idle_share']:.4f}); Module's "
            f"classic step (phase 11) {bench['step_ms']:.3f} ms")
    log("[gluon] phase 16: " + json.dumps(out))
    return out


# -- 17: sequences: the bucketed LSTM LM -------------------------------------

# upstream MXNet's example/rnn/lstm_bucketing.py defaults but for the width
# (the bench's 2 x 1024, V=10000): its buckets, batch 32, SGD at lr 0.01,
# label 0 invalid (the padding, ignored by the loss and the metric)
SEQ_BUCKETS = (10, 20, 30, 40, 50, 60)
SEQ_N = 32
SEQ_SGD = {"learning_rate": 0.01}
# the synthetic corpus (upstream reads PTB, which is not in the
# repository): SEQ_BATCHES batches of sentences a bucket, lengths uniform
# over the bucket's range (from 2 up to the first bucket), tokens from a
# 1/rank unigram over 1..V-1 (a text's skew, which one epoch can learn)
SEQ_BATCHES = 4
# one step of two buckets at full width, card against the port's CPU path:
# fp32 with TF32 off on both, sums in other orders through up to 20 steps
# and the 10000-way softmax; the loss at SEQ_CPU_LOSS_TOL, each gradient
# at SEQ_CPU_GRAD_TOL of its own largest magnitude
SEQ_CPU_N, SEQ_CPU_BUCKETS = 4, (10, 20)
SEQ_CPU_LOSS_TOL, SEQ_CPU_GRAD_TOL = 1e-5, 1e-4
# B1 against its plain version at the bucketed path's shortest and longest
# buckets (fp32, SEQ_FP32_TOL; dw relative to its magnitude)
SEQ_B1_CASES = ((10, SEQ_N, H), (60, SEQ_N, H))
# (b) the unfused twin's bucket; (c) the Gluon cells' length and rows (two
# DataLoader batches)
SEQ_TWIN_T = 20
SEQ_GLUON_T, SEQ_GLUON_ROWS = 35, 2 * SEQ_N


def seq_corpus(vocab, seed=0):
    """SEQ_BATCHES * SEQ_N sentences a bucket of SEQ_BUCKETS, each of a
    length drawn uniformly from its bucket's range, of tokens drawn from a
    1/rank unigram over 1..vocab-1."""
    rng = np.random.RandomState(seed)
    prob = 1.0 / np.arange(1, vocab)
    prob /= prob.sum()
    sentences, low = [], 2
    for key in SEQ_BUCKETS:
        for length in rng.randint(low, key + 1, SEQ_BATCHES * SEQ_N):
            sentences.append(list(rng.choice(vocab - 1, length, p=prob) + 1))
        low = key + 1
    return sentences


def seq_sym_gen(mx, stack, vocab, hidden):
    """Upstream lstm_bucketing.py's graph for a bucket's length over
    ``stack`` (a fused cell, or its unfused twin), unrolled NTC."""
    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=hidden,
                                 name="embed")
        out, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True,
                              layout="NTC")
        pred = mx.sym.Reshape(out, shape=(-1, hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, name="softmax",
                                    use_ignore=True, ignore_label=0)
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def seq_stack(mx):
    return mx.rnn.FusedRNNCell(H, num_layers=LAYERS, mode="lstm",
                               prefix="lstm_")


def seq_err(got, want):
    """The largest difference over max(1, the largest magnitude): the
    kernels' fp32 rule for a sum (max_err_against's dw)."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(1.0,
                                                float(want.abs().max()))


def phase_seq_kernels():
    """B1 at SEQ_B1_CASES: the training forward and the backward (the
    register kernel, by its plan and its counter) against the plain
    versions on the card's tensors, fp32, both directions; then one layer
    at each shape timed (CUDA events): the training forward kernel, the
    backward kernel alone and with its dw product, the plain versions,
    against sequence_bound_ms and sequence_backward_bound_ms."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    out = {}
    for steps, n, hdim in SEQ_B1_CASES:
        plan = L.backward_plan(n, hdim, torch.device(CARD, 0))
        if plan.variant != "register":
            raise RuntimeError(f"backward plan T={steps} N={n} H={hdim}: "
                               f"{plan}, expected the register kernel")
        (xproj, h0, c0, w), (dout, dh, dc) = backward_case(
            steps, n, hdim, torch.float32, seed=7 * steps + n)
        worst = {"forward": 0.0, "backward": 0.0}
        for reverse in (False, True):
            saved = L.lstm_sequence_train(xproj, h0, c0, w, reverse)
            plain = L.lstm_sequence_train_plain(xproj, h0, c0, w, reverse)
            for name, g, p in zip(("out", "hT", "cT", "gates", "cs"), saved,
                                  plain):
                err, tol = max_err_against(g, p, "fp32", name)
                if not err <= tol:
                    raise RuntimeError(f"B1 forward T={steps} N={n} "
                                       f"reverse={reverse} {name}: {err} > "
                                       f"{tol}")
                worst["forward"] = max(worst["forward"], err)
            o, _, _, gates, cs = saved
            case = (dout, dh, dc, gates, cs, o, h0, c0, w)
            before = train_counts()
            got = L.lstm_sequence_backward(*case, reverse=reverse)
            torch.cuda.synchronize()
            moved = tuple(a - b for a, b in zip(train_counts(), before))
            if moved != (0, 1, 1, 0, 0):
                raise RuntimeError(f"B1 backward T={steps} N={n} launched "
                                   f"{moved}, expected the register kernel")
            want = L.lstm_sequence_backward_plain(*case, reverse=reverse)
            for name, g, p in zip(("dxproj", "dh0", "dc0", "dw"), got, want):
                err, tol = max_err_against(g, p, "fp32", name)
                if not err <= tol:
                    raise RuntimeError(f"B1 backward T={steps} N={n} "
                                       f"reverse={reverse} {name}: {err} > "
                                       f"{tol}")
                worst["backward"] = max(worst["backward"], err)
        o, _, _, gates, cs = L.lstm_sequence_train(xproj, h0, c0, w)
        case = (dout, dh, dc, gates, cs, o, h0, c0, w)
        row = {
            "max_abs_err": worst, "plan": plan._asdict(),
            "forward_kernel_ms": time_on_stream(
                lambda: L.lstm_sequence_train(xproj, h0, c0, w), iters=20),
            "forward_plain_ms": time_on_stream(
                lambda: L.lstm_sequence_train_plain(xproj, h0, c0, w),
                iters=2),
            "backward_kernel_ms": time_on_stream(
                lambda: L._sequence_backward_launch(
                    dout, dh, dc, gates, cs, h0, c0, w, False), iters=20),
            "backward_route_ms": time_on_stream(
                lambda: L.lstm_sequence_backward(*case), iters=20),
            "backward_plain_ms": time_on_stream(
                lambda: L.lstm_sequence_backward_plain(*case), iters=2)}
        row["forward_bound_ms"], row["forward_bound_by"] = sequence_bound_ms(
            steps, n, hdim, 4)
        row["backward_bound_ms"], row["backward_bound_by"] = \
            sequence_backward_bound_ms(steps, n, hdim, 4)
        row["forward_share_of_bound"] = (row["forward_bound_ms"]
                                         / row["forward_kernel_ms"])
        row["backward_share_of_bound"] = (row["backward_bound_ms"]
                                          / row["backward_kernel_ms"])
        out[f"T={steps} N={n}"] = row
        log(f"[seq-kernels] B1 T={steps} N={n} H={hdim} fp32, both "
            f"directions: forward max|d| {worst['forward']:.3e}, backward "
            f"{worst['backward']:.3e} (tol {SEQ_FP32_TOL}, dw relative); "
            f"plan {plan.variant}")
        log(f"[seq-kernels] one layer T={steps} N={n} H={hdim}: training "
            f"forward kernel {row['forward_kernel_ms'] * 1e3:.1f} us, bound "
            f"{row['forward_bound_ms'] * 1e3:.1f} us by "
            f"{row['forward_bound_by']} (share "
            f"{row['forward_share_of_bound']:.3f}), plain "
            f"{row['forward_plain_ms'] * 1e3:.1f} us; backward kernel "
            f"{row['backward_kernel_ms'] * 1e3:.1f} us, bound "
            f"{row['backward_bound_ms'] * 1e3:.1f} us by "
            f"{row['backward_bound_by']} (share "
            f"{row['backward_share_of_bound']:.3f}), with its dw product "
            f"{row['backward_route_ms'] * 1e3:.1f} us, plain "
            f"{row['backward_plain_ms'] * 1e3:.1f} us")
    return out


def seq_first_batches(it):
    """The first batch of each bucket in one pass over ``it``."""
    first = {}
    it.reset()
    for batch in it:
        first.setdefault(batch.bucket_key, batch)
    it.reset()
    return first


def phase_seq_bucketing(mx):
    """(a) the bucketed LM on the default context: BucketingModule over
    BucketSentenceIter, seeded Xavier, one fit epoch (every bucket, every
    step 2 + 2 B1 launches and no per-step one, every bucket module on the
    default module's arrays, one update capture), the perplexity on the
    corpus before and after; then ms a step by bucket, tokens/s, one
    profiled step at the longest bucket and the peak memory."""
    import random
    sentences = seq_corpus(V)
    random.seed(0)
    np.random.seed(0)
    mx.random.seed(0)
    it = mx.rnn.BucketSentenceIter(sentences, SEQ_N,
                                   buckets=list(SEQ_BUCKETS), invalid_label=0)
    mod = mx.mod.BucketingModule(seq_sym_gen(mx, seq_stack(mx), V, H),
                                 default_bucket_key=it.default_bucket_key)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.init.Xavier())
    ppl_before = mod.score(it, mx.metric.Perplexity(ignore_label=0))[0][1]
    it.reset()
    marks = []
    metric = mx.metric.Perplexity(ignore_label=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zero_train_counts()  # the bucketed LM's path starts here
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SEQ_SGD,
            eval_metric=metric,
            batch_end_callback=lambda p: marks.append(
                (mod._curr_bucket_key, train_counts())))
    launches = train_counts()  # and ends here
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    per_step = [(key, tuple(a - b for a, b in zip(c, prev)))
                for (key, c), (_, prev) in zip(marks,
                                               [(None, (0,) * 5)] + marks)]
    ppl_after = mod.score(it, mx.metric.Perplexity(ignore_label=0))[0][1]
    default = mod._buckets[max(SEQ_BUCKETS)]
    unshared = [(key, n) for key, m in mod._buckets.items()
                for n in default._param_names
                if m._exec.arg_dict[n] is not default._exec.arg_dict[n]
                or m._exec.grad_dict[n] is not default._exec.grad_dict[n]]
    captures = default._updater._fused_apply.guard.count
    by_key = {k: sum(1 for key, _ in per_step if key == k)
              for k in SEQ_BUCKETS}
    padded = sum(SEQ_N * k * n for k, n in by_key.items())
    real = sum(len(s) for s in sentences)
    log(f"[seq] bucketed LM V={V} H={H} layers={LAYERS} N={SEQ_N} buckets "
        f"{list(SEQ_BUCKETS)}: one fit epoch of {len(per_step)} steps "
        f"(by bucket {by_key}) at {SEQ_SGD} in {epoch_s:.3f} s (bucket "
        f"modules bound and the update captured inside), training "
        f"perplexity {metric.get()[1]:.2f}; corpus perplexity "
        f"{ppl_before:.2f} before, {ppl_after:.2f} after; (lstm_sequence, "
        f"lstm_sequence_backward, its register kernel, lstm_cell, "
        f"lstm_cell_backward) launches per step "
        f"{sorted(set(c for _, c in per_step))}, total {launches}; update "
        f"captures {captures}; arrays not shared {unshared}; peak {peak} "
        "bytes")
    if sorted(mod._buckets) != list(SEQ_BUCKETS) or sorted(
            by_key.values()) != [SEQ_BATCHES] * len(SEQ_BUCKETS):
        raise RuntimeError(f"buckets used {by_key}, modules "
                           f"{sorted(mod._buckets)}")
    if any(c != (LAYERS, LAYERS, LAYERS, 0, 0) for _, c in per_step):
        raise RuntimeError(f"bucketed steps launched {per_step}")
    if unshared:
        raise RuntimeError(f"bucket modules hold their own arrays: {unshared}")
    if captures != 1:
        raise RuntimeError(f"the update was captured {captures} times")
    if not (math.isfinite(ppl_after) and ppl_after < ppl_before):
        raise RuntimeError(f"the perplexity did not fall: {ppl_before} -> "
                           f"{ppl_after}")
    batches = seq_first_batches(it)
    steps = {}
    for key, batch in sorted(batches.items()):
        def step(batch=batch):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        ms, runs, host = timed_steps(step)
        steps[key] = {"step_ms": ms, "step_runs_ms": runs,
                      "step_host_ms": host,
                      "tokens_per_s": SEQ_N * key / ms * 1e3}
    steady = padded / sum(by_key[k] * steps[k]["step_ms"]
                          for k in SEQ_BUCKETS) * 1e3
    log("[seq] ms a step by bucket (CUDA events, median of "
        f"{FUSED_TIMED}): " + ", ".join(
            f"T={k} {v['step_ms']:.3f} (host {v['step_host_ms']:.3f})"
            for k, v in steps.items())
        + f"; the epoch's padded tokens at those rates {steady:.1f} tokens/s"
        f"; the fit epoch {padded / epoch_s:.1f} padded and "
        f"{real / epoch_s:.1f} real tokens/s")
    longest = max(SEQ_BUCKETS)
    batch = batches[longest]

    def step_longest():
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    profile = profile_device(f"one bucketed step T={longest} N={SEQ_N}",
                             step_longest, keep_all=True, expect=B1_KERNELS)
    b1 = replay_counts(profile, B1_KERNELS)
    if b1 != B1_KERNELS:
        raise RuntimeError(f"the profiled T={longest} step ran B1 kernels "
                           f"{b1}, expected {B1_KERNELS}")
    profile.pop("top_all")
    return {"launches": launches, "steps": len(per_step),
            "steps_by_bucket": by_key, "per_step": per_step[0][1],
            "perplexity_before": ppl_before, "perplexity_after": ppl_after,
            "fit_perplexity": metric.get()[1], "update_captures": captures,
            "epoch_s": epoch_s, "padded_tokens": padded,
            "real_tokens": real,
            "epoch_tokens_per_s": padded / epoch_s,
            "epoch_real_tokens_per_s": real / epoch_s,
            "steady_tokens_per_s": steady, "by_bucket": steps,
            "peak_device_bytes": peak, "profile": profile,
            "profile_b1_kernels": b1,
            "params": {k: v.asnumpy() for k, v in mod.get_params()[0].items()},
            "twin_batch": batches[SEQ_TWIN_T]}


def seq_token_batch(mx, n, key, seed):
    """``n`` seeded sentences of up to ``key`` tokens, padded with 0, and
    their next-token labels, as BucketSentenceIter gives a bucket."""
    rng = np.random.RandomState(seed)
    data = np.zeros((n, key), np.float32)
    for row in range(n):
        length = rng.randint(2, key + 1)
        data[row, :length] = rng.randint(1, V, length)
    label = np.zeros_like(data)
    label[:, :-1] = data[:, 1:]
    return mx.io.DataBatch(
        [mx.nd.array(data, ctx=mx.cpu())], [mx.nd.array(label, ctx=mx.cpu())],
        bucket_key=key,
        provide_data=[mx.io.DataDesc("data", (n, key))],
        provide_label=[mx.io.DataDesc("softmax_label", (n, key))])


def seq_buckets_step(mx, ctx, params=None):
    """From the same weights (seeded Xavier, or ``params``), one step of
    each of SEQ_CPU_BUCKETS through a BucketingModule on ``ctx`` (None: the
    default context): each bucket's loss (the per-token mean cross-entropy
    over the labels not ignored) and gradients, then its update."""
    n, keys = SEQ_CPU_N, SEQ_CPU_BUCKETS
    mod = mx.mod.BucketingModule(seq_sym_gen(mx, seq_stack(mx), V, H),
                                 default_bucket_key=max(keys), context=ctx)
    mod.bind(data_shapes=[("data", (n, max(keys)))],
             label_shapes=[("softmax_label", (n, max(keys)))])
    mx.random.seed(5)
    if params is None:
        mod.init_params(mx.init.Xavier())
    else:
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=SEQ_SGD)
    start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    out = {}
    for key in keys:
        batch = seq_token_batch(mx, n, key, seed=key)
        mod.forward(batch, is_train=True)
        mod.backward()
        metric = mx.metric.Perplexity(ignore_label=0)
        mod.update_metric(metric, batch.label)
        grads = {name: arr._data.cpu().clone() for name, arr in
                 mod._curr_module._exec.grad_dict.items()
                 if name in mod._curr_module._param_names}
        out[key] = (math.log(metric.get()[1]), grads)
        mod.update()
    return start, out


def seq_card_vs_cpu(mx):
    """One step of two buckets at full width, N=SEQ_CPU_N, on the card and
    on the port's CPU path from the same weights."""
    params, card = seq_buckets_step(mx, None)
    _, cpu = seq_buckets_step(mx, mx.cpu(), params)
    errs = {}
    for key in SEQ_CPU_BUCKETS:
        loss, grads = card[key]
        loss_c, grads_c = cpu[key]
        errs[key] = {"loss": abs(loss - loss_c) / abs(loss_c), "grads": {
            name: float((g - grads_c[name]).abs().max()
                        / grads_c[name].abs().max())
            for name, g in grads.items()}}
    log(f"[seq] one step of buckets {list(SEQ_CPU_BUCKETS)} at N={SEQ_CPU_N}"
        f", full width, card against the CPU path: {errs}")
    if any(e["loss"] > SEQ_CPU_LOSS_TOL
           or any(g > SEQ_CPU_GRAD_TOL for g in e["grads"].values())
           for e in errs.values()):
        raise RuntimeError("the bucketed step on the card disagrees with the "
                           "CPU path")
    return {str(k): v for k, v in errs.items()}


def phase_seq_twin(mx, params, batch):
    """(b) FusedRNNCell(H, LAYERS).unfuse(): two LSTMCells, the fused
    weights carried over by unpack_weights; the same LM on one bucket
    (T=SEQ_TWIN_T, N=SEQ_N) on the card, the fused graph and its twin:
    outputs and gradients within SEQ_FP32_TOL, 2 + 2 B1 launches on the
    fused graph, none on the twin."""
    fused = seq_stack(mx)
    twin = fused.unfuse()
    unpacked = fused.unpack_weights(
        {k: mx.nd.array(v) for k, v in params.items()})
    runs = {}
    for name, stack, args in (("fused", fused, params),
                              ("twin", twin, unpacked)):
        net = seq_sym_gen(mx, stack, V, H)(SEQ_TWIN_T)[0]
        mod = mx.mod.Module(net)
        mod.bind(data_shapes=[("data", (SEQ_N, SEQ_TWIN_T))],
                 label_shapes=[("softmax_label", (SEQ_N, SEQ_TWIN_T))])
        mod.init_params(arg_params={
            k: mx.nd.array(v) if isinstance(v, np.ndarray) else v
            for k, v in args.items()}, aux_params={})
        before = train_counts()
        mod.forward(batch, is_train=True)
        mod.backward()
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(train_counts(), before))
        grads = {k: mod._exec.grad_dict[k] for k in mod._param_names}
        if name == "twin":
            grads = fused.pack_weights(grads)
        runs[name] = (mod.get_outputs()[0]._data, {k: g._data for k, g in
                                                   grads.items()}, moved)
    (fo, fg, f_moved), (to, tg, t_moved) = runs["fused"], runs["twin"]
    out_err = float((to - fo).abs().max() / fo.abs().max())
    errs = {k: seq_err(tg[k], g) for k, g in fg.items()}
    log(f"[seq] unfused twin ({len(twin._cells)} cells) at T={SEQ_TWIN_T} "
        f"N={SEQ_N} against the fused graph: outputs {out_err:.3e} of their "
        f"largest, gradients {errs} (tol {SEQ_FP32_TOL}); launches fused "
        f"{f_moved}, twin {t_moved}")
    if f_moved != (LAYERS, LAYERS, LAYERS, 0, 0) or any(t_moved):
        raise RuntimeError(f"launches fused {f_moved}, twin {t_moved}")
    if sorted(tg) != sorted(fg) or out_err > SEQ_FP32_TOL or any(
            e > SEQ_FP32_TOL for e in errs.values()):
        raise RuntimeError("the unfused twin disagrees with the fused graph")
    return {"output_rel_err": out_err, "grad_err": errs,
            "launches_fused": f_moved, "launches_twin": t_moved}


def phase_seq_gluon(mx):
    """(c) gluon.rnn.SequentialRNNCell of LAYERS LSTMCells unrolled under
    record() against gluon.rnn.LSTM(H, LAYERS) (B1) from the same weights,
    between one Embedding and one Dense(V), each DataLoader batch
    (ArrayDataset of seeded tokens, shuffled, SEQ_N rows, T=SEQ_GLUON_T):
    the logits and every gradient within SEQ_FP32_TOL; B1 launches only on
    the layer's side (2 + 2 a batch)."""
    gluon = mx.gluon
    t = SEQ_GLUON_T
    rng = np.random.RandomState(11)
    tokens = rng.randint(1, V, (SEQ_GLUON_ROWS, t + 1)).astype(np.float32)
    np.random.seed(12)
    loader = gluon.data.DataLoader(
        gluon.data.ArrayDataset(tokens[:, :-1], tokens[:, 1:]),
        batch_size=SEQ_N, shuffle=True)
    mx.random.seed(13)
    emb = gluon.nn.Embedding(V, H, prefix="emb_")
    dec = gluon.nn.Dense(V, flatten=False, in_units=H, prefix="dec_")
    layer = gluon.rnn.LSTM(H, num_layers=LAYERS, layout="NTC", input_size=H,
                           prefix="lstm_")
    cells = gluon.rnn.SequentialRNNCell(prefix="lstm_")
    with cells.name_scope():
        for i in range(LAYERS):
            cells.add(gluon.rnn.LSTMCell(H, input_size=H, prefix=f"l{i}_"))
    for block in (emb, dec, layer, cells):
        block.initialize(mx.init.Xavier())
    layer_params, cell_params = layer.collect_params(), cells.collect_params()
    if sorted(layer_params) != sorted(cell_params):
        raise RuntimeError(f"cell parameters {sorted(cell_params)} are not "
                           f"the layer's {sorted(layer_params)}")
    for k, p in layer_params.items():
        cell_params[k].set_data(p.data())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    shared = list(emb.collect_params().values()) + list(
        dec.collect_params().values())
    worst, counts, batches = {}, {}, 0
    for x, y in loader:
        batches += 1
        runs = {}
        for name, model, params in (("layer", layer, layer_params),
                                    ("cells", cells, cell_params)):
            before = train_counts()
            with mx.autograd.record():
                h = emb(x)
                h = (model(h) if name == "layer" else
                     model.unroll(t, h, layout="NTC", merge_outputs=True)[0])
                logits = dec(h.reshape((-1, H)))
                loss = loss_fn(logits, y.reshape((-1,)))
            loss.backward()
            torch.cuda.synchronize()
            counts.setdefault(name, []).append(tuple(
                a - b for a, b in zip(train_counts(), before)))
            grads = {p.name: p.grad()._data.clone()
                     for p in shared + list(params.values())}
            runs[name] = (logits._data.detach().clone(), grads)
        (lo, lg), (co, cg) = runs["layer"], runs["cells"]
        errs = {"logits": seq_err(co, lo)}
        errs.update({k: seq_err(cg[k], g) for k, g in lg.items()})
        for k, e in errs.items():
            worst[k] = max(worst.get(k, 0.0), e)
    log(f"[seq] Gluon: a SequentialRNNCell of {LAYERS} LSTMCells against "
        f"rnn.LSTM({H}, num_layers={LAYERS}) over {batches} DataLoader "
        f"batches (N={SEQ_N}, T={t}): largest differences {worst} (tol "
        f"{SEQ_FP32_TOL}); launches a batch {counts}")
    if batches != SEQ_GLUON_ROWS // SEQ_N:
        raise RuntimeError(f"the DataLoader gave {batches} batches")
    if any(c != (LAYERS, LAYERS, LAYERS, 0, 0) for c in counts["layer"]) or \
            any(any(c) for c in counts["cells"]):
        raise RuntimeError(f"Gluon launches {counts}")
    if any(e > SEQ_FP32_TOL for e in worst.values()):
        raise RuntimeError("the Gluon cells disagree with rnn.LSTM")
    return {"max_err": worst, "launches": counts, "batches": batches}


def phase_seq():
    """17: sequences (see the module docstring)."""
    import mxnet_tpu_torch as mx
    card = nvidia_smi_name_and_limit()
    kernels = phase_seq_kernels()
    bucketing = phase_seq_bucketing(mx)
    params = bucketing.pop("params")
    twin_batch = bucketing.pop("twin_batch")
    out = {"card": card, "b1": kernels, "bucketing": bucketing,
           "card_vs_cpu": seq_card_vs_cpu(mx),
           "unfused_twin": phase_seq_twin(mx, params, twin_batch),
           "gluon_cells": phase_seq_gluon(mx)}
    log(f"[seq] phase 17 on {card}: " + json.dumps(out, default=str))
    return out


def seq_records(records, seq):
    """B1's launches on the bucketed path (phase 17a) and its times at the
    bucketed shapes beside its records' main-path numbers."""
    by_name = {r["name"]: r for r in records}
    bucketing = seq["bucketing"]
    for name, i, prefix in (("lstm_sequence", 0, "forward"),
                            ("lstm_sequence_backward", 2, "backward")):
        by_name[name]["bucketing"] = {
            "launches": bucketing["launches"][i],
            "steps": bucketing["steps"],
            "path": "the bucketed 2x1024 LSTM LM, one BucketingModule.fit "
                    f"epoch over buckets {list(SEQ_BUCKETS)} at N={SEQ_N} "
                    "(phase 17a)",
            "by_shape": {shape: {
                k: v for k, v in row.items()
                if k.startswith(prefix) or k in ("max_abs_err", "plan")}
                for shape, row in seq["b1"].items()}}


# -- B5: the dtypes and head dims (phase 3's and 7's rows, phase 18) ---------

# fp16 attention, kernel against plain on the same card tensors: 2e-3 for
# results of unit scale, scaled by the result's largest magnitude past 1
# (one fp16 ulp at |x| in [4, 8) is 3.9e-3; PERF.md section 6)
ATT_FP16_TOL = 2e-3
# bf16 at D = 256 as today's bf16 cases (two bf16 ulps at 1.0), fp32 at
# D = 320 summation order only, absolute
ATT_B5_BF16_TOL = 1.6e-2
ATT_B5_FP32_TOL = 2e-5
# the LSTM at fp16 over up to 128 steps, h and c absolute (states of unit
# scale rounded to fp16 every step, as the plain version rounds them)
LSTM_FP16_TOL = 4e-3
# fp16 logits of the transformer against an fp32 forward of the same
# weights on the card: fp16 rounds at 2**-11 where bf16 rounds at 2**-8,
# so an eighth of BF16_LOGIT_TOL, doubled for margin
FP16_LOGIT_TOL = BF16_LOGIT_TOL / 4
# bf16 logits of the head-dim-256 LM against its fp32 forward, relative to
# the largest logit: BF16_LOGIT_TOL is 4% of the default LM's |2.4|
BF16_LOGIT_REL = 0.05
# (B, H, S, D) of the timed wide-head attention, and of the fp32 D = 320
# one (the CUDA-core variant: 8 heads of a 1024-token row)
ATT_D256_SHAPE = (4, 8, 2048, 256)
ATT_D320_SHAPE = (1, 8, 1024, 320)
# phase 18: (a) the fp16 LM's train steps; (b) the head-dim-256 LM's;
# (d) the fp16 Gluon LM's steps and batch; (e) nd.RNN's shape
B5_TF16_STEPS, B5_D256_STEPS, B5_GLUON_STEPS = 5, 3, 3
B5_RNN_T, B5_RNN_N = 64, 16


def b5_tol(dtype, ref):
    """The B5 tolerance of a result ``ref`` in ``dtype``."""
    if dtype == torch.float16:
        return ATT_FP16_TOL * max(1.0, ref.float().abs().max().item())
    if dtype == torch.bfloat16:
        return ATT_B5_BF16_TOL * max(1.0, ref.float().abs().max().item())
    return ATT_B5_FP32_TOL


def b5_bound_ms(nbytes, flops, dtype):
    """max(bytes / HBM rate, operations / the peak of the inputs' type):
    the tensor cores' bf16/fp16 rate, or fp32's outside them."""
    peak = FP32_FLOPS if dtype == torch.float32 else BF16_TENSOR_FLOPS
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def b5_attention_counts():
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention as fa
    return {k: getattr(fa, k) for k in (
        "launches", "masked_launches", "wgmma_launches", "mma_launches",
        "backward_launches", "masked_backward_launches",
        "mma_backward_launches", "wgmma_backward_launches")}


def b5_moved(before):
    now = b5_attention_counts()
    return {k: now[k] - before[k] for k in now}


# (label, (B, H, Sq, Sk, D), dtype, causal, mask, offset, route, the
# forward's and the backward's variant): route "mma" forces the mma.sync
# variants (_mma_sync, _mma_sync_backward); offset 1 makes views no row of
# which is 16-byte aligned (the CUDA-core variant)
B5_ATT_CASES = [
    ("fp16 D=64 causal", (2, 4, 1000, 1000, 64), torch.float16, True, None,
     0, None, "wgmma", "wgmma"),
    ("fp16 D=128 Sq<Sk", (2, 3, 300, 517, 128), torch.float16, False, None,
     0, None, "wgmma", "wgmma"),
    ("fp16 D=64 lengths", (4, 4, 1024, 1024, 64), torch.float16, True,
     "lengths", 0, None, "wgmma", "wgmma"),
    ("fp16 D=128 packed", (2, 4, 1000, 1000, 128), torch.float16, True,
     "packed", 0, None, "wgmma", "wgmma"),
    ("fp16 D=64 mma.sync", (2, 4, 1000, 1000, 64), torch.float16, True,
     None, 0, "mma", "mma", "mma"),
    ("fp16 D=128 mma.sync lengths", (2, 4, 500, 500, 128), torch.float16,
     True, "lengths", 0, "mma", "mma", "mma"),
    ("fp16 D=64 unaligned", (1, 4, 300, 300, 64), torch.float16, True, None,
     1, None, "cuda_core", "cuda_core"),
    ("bf16 D=256 causal", (2, 4, 1000, 1000, 256), torch.bfloat16, True,
     None, 0, None, "mma", "mma"),
    ("fp16 D=256 Sq<Sk", (2, 2, 300, 517, 256), torch.float16, True, None,
     0, None, "mma", "mma"),
    ("bf16 D=256 lengths", (4, 2, 600, 600, 256), torch.bfloat16, False,
     "lengths", 0, None, "mma", "mma"),
    ("fp16 D=256 packed", (2, 2, 600, 600, 256), torch.float16, True,
     "packed", 0, None, "mma", "mma"),
    ("fp32 D=320 causal", (2, 4, 500, 500, 320), torch.float32, True, None,
     0, None, "cuda_core", "cuda_core"),
    ("fp32 D=320 packed", (2, 2, 500, 500, 320), torch.float32, True,
     "packed", 0, None, "cuda_core", "cuda_core"),
    ("bf16 D=320 lengths", (4, 2, 400, 400, 320), torch.bfloat16, False,
     "lengths", 0, None, "cuda_core", "cuda_core"),
    ("fp16 D=588 causal", (1, 2, 200, 200, 588), torch.float16, True, None,
     0, None, "cuda_core", "cuda_core"),
]


def b5_masks(kind, b, s):
    if kind == "lengths":
        lens = [s, (2 * s) // 3, s // 5, 0][:b] + [s] * max(0, b - 4)
        return torch.tensor(lens, dtype=torch.int32, device=CARD), None
    if kind == "packed":
        return None, packed_segments(b, s)
    return None, None


def b5_attention_case(label, shape, dtype, causal, kind, offset, route,
                      fwd_variant, bwd_variant, seed):
    """One B5 attention case: the forward and its gradients through the
    kernels against the plain versions on the same card tensors, each
    launch held to the variant the case must take. Returns the largest
    error of the forward and of the gradients."""
    from mxnet_tpu_torch.ops.cuda.attention import (
        _default_scale, _launch, _mma_sync_backward, attention_backward_plain,
        attention_plain, flash_attention, masked_attention_backward_plain,
        masked_attention_plain)
    b, h, sq, sk, d = shape
    q, k, v = attention_inputs(b, h, sq, sk, d, dtype, seed=seed,
                               offset=offset)
    do = attention_inputs(b, h, sq, sq, d, dtype, seed=seed + 1,
                          offset=offset)[0]
    lens, seg = b5_masks(kind, b, sk)
    before = b5_attention_counts()
    if route == "mma":
        scale = _default_scale(d, None)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=CARD)
        out = _launch(q, k, v, causal, scale, lens, seg, route=1, lse=lse)
        grads = _mma_sync_backward(q, k, v, out, do, causal, scale, lens, seg,
                                   lse=lse)
    else:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, causal=causal, lengths=lens,
                              segment_ids=seg)
        grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    moved = b5_moved(before)
    fwd = {"wgmma": "wgmma_launches", "mma": "mma_launches"}
    bwd = {"wgmma": "wgmma_backward_launches", "mma": "mma_backward_launches"}
    want_moved = {key: 0 for key in moved}
    want_moved["masked_launches" if kind else "launches"] = 1
    want_moved["masked_backward_launches" if kind
               else "backward_launches"] = 1
    if fwd_variant in fwd:
        want_moved[fwd[fwd_variant]] = 1
    if bwd_variant in bwd:
        want_moved[bwd[bwd_variant]] = 1
    if moved != want_moved:
        raise RuntimeError(f"B5 attention {label}: counters moved {moved}, "
                           f"expected {want_moved}")
    if kind is None:
        want = attention_plain(q, k, v, causal)
        wgrads = attention_backward_plain(q, k, v, want, do, causal)
    else:
        want = masked_attention_plain(q, k, v, lens, seg, causal)
        wgrads = masked_attention_backward_plain(q, k, v, do, lens, seg,
                                                 causal)
    errs = []
    for what, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads),
                              (want, *wgrads)):
        if got.dtype != dtype or got.shape != ref.shape:
            raise RuntimeError(f"B5 attention {label} {what}: {got.dtype} "
                               f"{tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        tol = b5_tol(dtype, ref)
        if not err <= tol:
            raise RuntimeError(f"B5 attention {label} {what} disagrees with "
                               f"its plain version: {err} > {tol}")
        errs.append(err)
    log(f"[kernels] B5 attention {label} {shape} {dtype} causal={causal} "
        f"{kind or 'dense'}: forward on {fwd_variant}, backward on "
        f"{bwd_variant}; max|d| out, dq, dk, dv "
        + ", ".join(f"{e:.3e}" for e in errs)
        + f" (tol {b5_tol(dtype, want):.3e} for out)")
    return errs[0], max(errs[1:])


# (label, T, N, H, states' dtype, xproj's and w_h2h's dtype, reverse, the
# forward kernel, the backward kernel)
B5_LSTM_CASES = [
    ("fp16", T, 16, H, torch.float16, torch.float16, False, "sequence",
     "register"),
    ("fp16 reverse", T, 1, H, torch.float16, torch.float16, True, "sequence",
     "register"),
    ("fp16 ragged reverse", 7, 37, 200, torch.float16, torch.float16, True,
     "sequence", "register"),
    ("bf16 over fp32", 64, 16, H, torch.bfloat16, torch.float32, False,
     "sequence", "register"),
    ("fp16 over fp32 reverse", 32, 5, H, torch.float16, torch.float32, True,
     "sequence", "register"),
    ("fp16 shared backward", 8, 16, 1100, torch.float16, torch.float16,
     False, "sequence", "shared"),
    ("fp16 wide", 6, 2, WIDE_H, torch.float16, torch.float16, False,
     "cell", "cell"),
    ("bf16 over fp32 wide reverse", 4, 3, WIDE_H, torch.bfloat16,
     torch.float32, True, "cell", "cell"),
]


def b5_lstm_inputs(steps, n, hdim, sdt, odt, seed):
    """xproj (T, N, 4H) and w_h2h in ``odt``, h0 and c0 in ``sdt``, at the
    LM's scale (phase 3's), and the cotangents of (out, hT, cT)."""
    xproj, h0, c0, w = sequence_inputs(steps, n, hdim, torch.float32, seed)
    rng = np.random.RandomState(seed + 7)
    cot = [torch.tensor(rng.normal(0, 1, s), dtype=sdt, device=CARD)
           for s in ((steps, n, hdim), (n, hdim), (n, hdim))]
    return xproj.to(odt), h0.to(sdt), c0.to(sdt), w.to(odt), cot


def b5_lstm_case(label, steps, n, hdim, sdt, odt, reverse, fwd_kernel,
                 bwd_kernel, seed):
    """One B1 case at a B5 dtype: the inference and the training forward
    and the backward against their plain versions on the same card
    tensors, each launch held to the kernel it must take. Returns the
    largest forward and backward errors."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    xproj, h0, c0, w, cot = b5_lstm_inputs(steps, n, hdim, sdt, odt, seed)
    counts = lambda: (L.lstm_sequence_fused.launches,  # noqa: E731
                      L.lstm_cell_fused.launches,
                      L.lstm_sequence_backward.launches,
                      L.lstm_sequence_backward.register_launches,
                      L.lstm_cell_backward.launches)
    before = counts()
    got = L.lstm_sequence_fused(xproj, h0, c0, w, reverse=reverse)
    train = L.lstm_sequence_train(xproj, h0, c0, w, reverse)
    grads = L.lstm_sequence_backward(*cot, train[3], train[4], train[0], h0,
                                     c0, w, reverse)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(counts(), before))
    want_moved = ((2, 0) if fwd_kernel == "sequence" else (0, 2 * steps)) + {
        "register": (1, 1, 0), "shared": (1, 0, 0),
        "cell": (0, 0, steps + 1)}[bwd_kernel]
    if moved != want_moved:
        raise RuntimeError(f"B5 lstm {label}: (sequence, cell, backward, "
                           f"register backward, cell backward) launches "
                           f"{moved}, expected {want_moved}")
    want = L.lstm_sequence_plain(xproj, h0, c0, w, reverse=reverse)
    wtrain = L.lstm_sequence_train_plain(xproj, h0, c0, w, reverse)
    wgrads = L.lstm_sequence_backward_plain(*cot, wtrain[3], wtrain[4],
                                            wtrain[0], h0, c0, w, reverse)
    tol = LSTM_FP16_TOL if sdt == torch.float16 else BF16_TOL
    errs = {}
    for what, g, r in (("out", got[0], want[0]), ("hT", got[1], want[1]),
                       ("cT", got[2], want[2]),
                       ("train out", train[0], wtrain[0]),
                       ("dh0", grads[1], wgrads[1]),
                       ("dc0", grads[2], wgrads[2])):
        if g.dtype != sdt or g.shape != r.shape:
            raise RuntimeError(f"B5 lstm {label} {what}: {g.dtype}")
        errs[what] = (g.float() - r.float()).abs().max().item()
        if not errs[what] <= tol:
            raise RuntimeError(f"B5 lstm {label} {what} disagrees with its "
                               f"plain version: {errs[what]} > {tol}")
    log(f"[kernels] B5 lstm {label} T={steps} N={n} H={hdim} states {sdt} "
        f"xproj and w_h2h {odt} reverse={reverse}: forward on the "
        f"{fwd_kernel} kernel, backward on the {bwd_kernel} kernel; max|d| "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (tol {tol})")
    return (max(errs[k] for k in ("out", "hT", "cT", "train out")),
            max(errs["dh0"], errs["dc0"]))


def phase_b5_kernels():
    """Phase 3's B5 rows: every new attention variant (fp16 on the
    wgmma/TMA, mma.sync and CUDA-core kernels at D = 64 and 128, D = 256
    on mma.sync both ways, D = 320 and 588 on CUDA cores; dense, lengths,
    packed)
    and B1 at fp16 states and at fp32 operands over narrower states, both
    directions, forward and backward, against their plain versions.
    Returns the largest errors by kernel row of the kernels line."""
    errs = {}
    for i, case in enumerate(B5_ATT_CASES):
        label, shape, dtype = case[:3]
        fwd_err, bwd_err = b5_attention_case(*case, seed=700 + i)
        key = ("fp16" if dtype == torch.float16 and shape[4] <= 128
               else "d256" if shape[4] == 256 else "wide")
        row = errs.setdefault(f"attention_{key}", {"forward": 0.0,
                                                   "backward": 0.0})
        row["forward"] = max(row["forward"], fwd_err)
        row["backward"] = max(row["backward"], bwd_err)
    for i, case in enumerate(B5_LSTM_CASES):
        fwd_err, bwd_err = b5_lstm_case(*case, seed=800 + i)
        key = "lstm_fp16" if case[5] == case[4] else "lstm_mixed"
        row = errs.setdefault(key, {"forward": 0.0, "backward": 0.0})
        row["forward"] = max(row["forward"], fwd_err)
        row["backward"] = max(row["backward"], bwd_err)
    from mxnet_tpu_torch.ops.cuda.attention import (MAX_HEAD_DIM,
                                                    library_max_head_dim)
    if library_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError(f"the library takes D up to "
                           f"{library_max_head_dim()}, the wrapper states "
                           f"{MAX_HEAD_DIM}")
    log(f"[kernels] B5: largest errors by row {errs}; the library's head "
        f"dim limit {MAX_HEAD_DIM}")
    return errs


def b5_turns(fns, order, iters):
    """CUDA-event ms of each of ``fns`` over ``iters`` calls, in the turns
    ``order`` gives: {name: (mean, [turns])}."""
    turns = {name: [] for name in fns}
    for name in order:
        turns[name].append(time_on_stream(fns[name], iters=iters))
    return {name: (statistics.mean(t), t) for name, t in turns.items()}


def b5_attention_timing(label, shape, dtype, kind=None):
    """Phase 7's B5 attention rows at ``shape``, causal: the forward and
    the backward kernels (given the forward's lse) in turns with
    scaled_dot_product_attention's forward and autograd backward on the
    same inputs (kernel, library, library, kernel), the plain versions,
    and the bounds (4 D operations a live pair forward, 10 D backward, at
    the inputs' type's peak)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda.attention import (
        _backward_launch, _combined_mask, _launch, attention_backward_plain,
        attention_plain, masked_attention_backward_plain,
        masked_attention_plain)
    b, h, s, d = shape
    scale = 1.0 / d ** 0.5
    q, k, v, do = attention_grad_inputs(b, h, s, s, d, dtype, seed=900)
    lens, seg = b5_masks(kind, b, s)
    mask = (None if kind is None
            else _combined_mask(s, s, True, lens, seg, q.device))
    lse = torch.empty((b, h, s), dtype=torch.float32, device=CARD)
    out = _launch(q, k, v, True, scale, lens, seg, lse=lse)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_kw = {"is_causal": True} if mask is None else {"attn_mask": mask}
    y = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
    fwd = {"kernel": lambda: _launch(q, k, v, True, scale, lens, seg),
           "library": lambda: F.scaled_dot_product_attention(q, k, v,
                                                             **sdpa_kw)}
    bwd = {"kernel": lambda: _backward_launch(q, k, v, out, do, True, scale,
                                              lens, seg, lse),
           "library": lambda: torch.autograd.grad(y, leaves, do,
                                                  retain_graph=True)}
    order = ("kernel", "library", "library", "kernel")
    iters = 20 if d <= 128 else 5
    f_t, b_t = b5_turns(fwd, order, iters), b5_turns(bwd, order, iters)
    if kind is None:
        live = b * h * s * (s + 1) // 2
        plain_f = lambda: attention_plain(q, k, v, True)  # noqa: E731
        plain_b = lambda: attention_backward_plain(  # noqa: E731
            q, k, v, out, do, True)
    else:
        live = h * int(mask.sum().item())
        plain_f = lambda: masked_attention_plain(  # noqa: E731
            q, k, v, lens, seg, True)
        plain_b = lambda: masked_attention_backward_plain(  # noqa: E731
            q, k, v, do, lens, seg, True)
    elem = q.element_size()
    rows = {}
    for part, t, plain, ops, io in (("forward", f_t, plain_f, 4, 4),
                                    ("backward", b_t, plain_b, 10, 8)):
        bound_ms, bound_by = b5_bound_ms(elem * b * h * d * s * io,
                                         ops * d * live, dtype)
        ms = t["kernel"][0]
        rows[part] = {"kernel_ms": ms, "kernel_turns_ms": t["kernel"][1],
                      "library_ms": t["library"][0],
                      "library_turns_ms": t["library"][1],
                      "plain_ms": time_on_stream(plain, iters=2),
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "share_of_bound": bound_ms / ms,
                      "tflops": ops * d * live / ms / 1e9,
                      "live_pairs": live}
        log(f"[timing] B5 {label} {part} {shape} {dtype} causal"
            f"{' ' + kind if kind else ''}: kernel {ms * 1e3:.3f} us (turns "
            f"{[round(x * 1e3, 3) for x in t['kernel'][1]]}), library "
            f"{t['library'][0] * 1e3:.3f} us (turns "
            f"{[round(x * 1e3, 3) for x in t['library'][1]]}), plain "
            f"{rows[part]['plain_ms'] * 1e3:.1f} us; bound "
            f"{bound_ms * 1e3:.3f} us by {bound_by}, share "
            f"{rows[part]['share_of_bound']:.4f}, "
            f"{rows[part]['tflops']:.2f} TFLOP/s")
    return rows


def b5_lstm_timing(steps, n, hdim, sdt, odt, library):
    """Phase 7's B1 rows at a B5 dtype: one layer's forward (the sequence
    kernel, given xproj; and the port's input projection plus the kernel)
    and backward (the kernel alone; and the layer's whole backward, dw's
    product included) in turns with cuDNN's ``torch.nn.LSTM`` in the
    states' dtype (its forward, input projection included, and its
    autograd backward: data, state and weight gradients) where
    ``library``; the plain versions; the bounds (the products at the fp32
    rate the kernels compute at)."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    xproj, h0, c0, w, cot = b5_lstm_inputs(steps, n, hdim, sdt, odt, 990)
    train = L.lstm_sequence_train(xproj, h0, c0, w)
    rng = np.random.RandomState(991)
    x = torch.tensor(rng.normal(0, 1, (steps, n, hdim)), dtype=odt,
                     device=CARD)
    w_i2h = torch.tensor(rng.uniform(-0.05, 0.05, (4 * hdim, hdim)),
                         dtype=odt, device=CARD)
    bias = torch.zeros(4 * hdim, dtype=odt, device=CARD)
    fwd = {"kernel": lambda: L.lstm_sequence_fused(xproj, h0, c0, w),
           "projection_plus_kernel": lambda: L.lstm_sequence_fused(
               torch.addmm(bias, x.view(-1, hdim), w_i2h.t()).view(
                   steps, n, 4 * hdim), h0, c0, w)}
    w_k = L._operand(w, sdt)
    bwd = {"kernel": lambda: L._sequence_backward_launch(
               *cot, train[3], train[4], h0, c0, w_k, False),
           "layer": lambda: L.lstm_sequence_backward(
               *cot, train[3], train[4], train[0], h0, c0, w)}
    order = ("kernel", "projection_plus_kernel", "library", "library",
             "projection_plus_kernel", "kernel")
    border = ("kernel", "layer", "library", "library", "layer", "kernel")
    if library:
        cell = torch.nn.LSTM(hdim, hdim).to(CARD, sdt)
        xl = x.to(sdt).requires_grad_()
        hc = (h0[None], c0[None])
        fwd["library"] = lambda: cell(xl, hc)
        leaves = [xl] + list(cell.parameters())
        y, _ = cell(xl, hc)
        bwd["library"] = lambda: torch.autograd.grad(y, leaves, cot[0],
                                                     retain_graph=True)
    else:
        order = ("kernel", "projection_plus_kernel", "projection_plus_kernel",
                 "kernel")
        border = ("kernel", "layer", "layer", "kernel")
    f_t, b_t = b5_turns(fwd, order, 5), b5_turns(bwd, border, 5)
    rows = {}
    elem = torch.tensor([], dtype=sdt).element_size()
    for part, t, plain, bound, extra in (
            ("forward", f_t,
             lambda: L.lstm_sequence_plain(xproj, h0, c0, w),
             sequence_bound_ms(steps, n, hdim, elem),
             "projection_plus_kernel"),
            ("backward", b_t,
             lambda: L.lstm_sequence_backward_plain(
                 *cot, train[3], train[4], train[0], h0, c0, w),
             sequence_backward_bound_ms(steps, n, hdim, elem), "layer")):
        ms = t["kernel"][0]
        rows[part] = {"kernel_ms": ms, "kernel_turns_ms": t["kernel"][1],
                      f"{extra}_ms": t[extra][0],
                      "library_ms": t["library"][0] if library else None,
                      "library_turns_ms": (t["library"][1] if library
                                           else None),
                      "plain_ms": time_on_stream(plain, iters=1),
                      "bound_ms": bound[0], "bound_by": bound[1],
                      "share_of_bound": bound[0] / ms}
        log(f"[timing] B5 lstm {part} T={steps} N={n} H={hdim} states {sdt} "
            f"over {odt}: kernel {ms * 1e3:.1f} us (turns "
            f"{[round(x * 1e3, 1) for x in t['kernel'][1]]}), {extra} "
            f"{t[extra][0] * 1e3:.1f} us"
            + (f", cuDNN torch.nn.LSTM {t['library'][0] * 1e3:.1f} us"
               if library else "")
            + f", plain {rows[part]['plain_ms'] * 1e3:.1f} us; bound "
            f"{bound[0] * 1e3:.1f} us by {bound[1]}, share "
            f"{rows[part]['share_of_bound']:.4f}")
    return rows


def phase_b5_timing():
    """Phase 7's B5 rows (CUDA events, each kernel in turns with its
    library call): fp16 B2 and B3 (lengths) forward and backward at the
    transformer's (4, 8, 2048, 64) against SDPA in fp16; bf16 at D = 256,
    (4, 8, 2048, 256), against SDPA; fp32 at D = 320 on CUDA cores against
    SDPA; B1 at fp16 (T=256, N=64, H=1024) against cuDNN's fp16 LSTM; and
    B1 with bf16 states over fp32 operands at phase 18e's shape (no
    library call takes that mix)."""
    out = {"attention_fp16": b5_attention_timing(
               "B2 fp16", ATT_SHAPE, torch.float16),
           "attention_fp16_lengths": b5_attention_timing(
               "B3 fp16", ATT_SHAPE, torch.float16, "lengths"),
           "attention_d256": b5_attention_timing(
               "B2 D=256", ATT_D256_SHAPE, torch.bfloat16),
           "attention_wide": b5_attention_timing(
               "B2 fp32 D=320", ATT_D320_SHAPE, torch.float32),
           "lstm_fp16": b5_lstm_timing(TRAIN_T, TRAIN_N, H, torch.float16,
                                       torch.float16, True),
           "lstm_mixed": b5_lstm_timing(B5_RNN_T, B5_RNN_N, H,
                                        torch.bfloat16, torch.float32,
                                        False)}
    return out


def b5_serve(lm, rows_list, label):
    """Serve ``lm`` behind CallableBackend: one request a batch of
    ``rows_list`` at TF_S tokens; the attention counters moved by each
    forward, the logits of the first request, and ms per request."""
    from mxnet_tpu_torch.serving import CallableBackend
    backend = CallableBackend(
        lambda arrays: lm.logits(arrays["data"]).cpu().numpy(),
        input_specs={"data": (TF_S,)})
    backend.load()
    reqs = np.random.RandomState(31)
    per_forward, served_ms, kept = [], [], None
    for rows in rows_list:
        batch = reqs.randint(0, lm.cfg.vocab_size, (rows, TF_S)).astype(
            np.float32)
        before = b5_attention_counts()
        t0 = time.perf_counter()
        (out,) = backend.infer({"data": batch})
        served_ms.append((time.perf_counter() - t0) * 1e3)
        per_forward.append(b5_moved(before))
        if (out.shape != (rows, TF_S, lm.cfg.vocab_size)
                or not np.isfinite(out).all()):
            raise RuntimeError(f"{label}: logits {out.shape}, or not finite")
        if kept is None:
            kept = (batch, out)
    return per_forward, served_ms, kept


def b5_train(lm, steps, label):
    """``steps`` train_steps on one repeated batch of (4, TF_S + 1)
    tokens: the losses and the attention counters moved by each step."""
    from mxnet_tpu_torch.models.transformer import _leaves
    toks = torch.tensor(np.random.RandomState(0).randint(
        0, lm.cfg.vocab_size, (TF_TRAIN_B, TF_TRAIN_S + 1)), device=CARD)
    losses, per_step, ms = [], [], []
    for _ in range(steps):
        before = b5_attention_counts()
        e, _ = step_ms(lambda: losses.append(lm.train_step(
            toks, lr=TF_TRAIN_LR)))
        ms.append(e)
        per_step.append(b5_moved(before))
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{label}: non-finite loss {losses}")
    for name, p in _leaves(lm.params):
        if not bool(torch.isfinite(p).all()):
            raise RuntimeError(f"{label}: parameter {name} not finite")
    return losses, per_step, ms


def b5_check_counts(label, moved, want):
    for i, m in enumerate(moved):
        got = {k: m[k] for k in want}
        if got != want:
            raise RuntimeError(f"{label} {i}: attention launches {got}, "
                               f"expected {want}")


def phase_b5_transformers():
    """18 (a) and (b): the fp16 transformer LM at TransformerConfig()'s
    width and the bf16 one at d_model 2048, 8 heads (head dim 256), each
    served through CallableBackend and trained by train_step on the
    default context."""
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM, forward)
    out = {}
    for key, cfg, rows_list, steps in (
            ("fp16", TransformerConfig(dtype="float16"), (1, 4),
             B5_TF16_STEPS),
            ("d256", TransformerConfig(d_model=2048, num_heads=8), (4,),
             B5_D256_STEPS)):
        label = f"[b5] ({'a' if key == 'fp16' else 'b'}) {key} LM"
        torch.cuda.reset_peak_memory_stats()
        zero_attention_counts()  # the path's run starts here
        lm = TransformerLM(cfg, seed=0)
        n_params = sum(p.numel() for p in lm.params["blocks"].values()) + sum(
            lm.params[k].numel() for k in ("embed", "ln_f", "head"))
        per_forward, served_ms, (batch, logits) = b5_serve(lm, rows_list,
                                                           label)
        losses, per_step, step_ms_ = b5_train(lm, steps, label)
        launches = b5_attention_counts()  # and ends here
        peak = torch.cuda.max_memory_allocated()
        L_ = cfg.num_layers
        variant = "wgmma_launches" if key == "fp16" else "mma_launches"
        b5_check_counts(f"{label} forward", per_forward,
                        {"launches": L_, "masked_launches": 0, variant: L_})
        want_step = {"launches": L_, "backward_launches": L_,
                     "masked_launches": 0, variant: L_}
        if key == "fp16":
            want_step["wgmma_backward_launches"] = L_
        else:  # D = 256 trains on the mma.sync backward
            want_step.update(wgmma_backward_launches=0,
                             mma_backward_launches=L_)
        b5_check_counts(f"{label} train step", per_step, want_step)
        if key == "fp16" and not losses[-1] < losses[0]:
            raise RuntimeError(f"{label}: the loss did not fall at lr "
                               f"{TF_TRAIN_LR}: {losses}")
        cfg32 = TransformerConfig(d_model=cfg.d_model,
                                  num_heads=cfg.num_heads, dtype="float32")
        with torch.inference_mode():
            ref32 = forward(lm.params, torch.tensor(batch[:1], device=CARD),
                            cfg32).cpu().numpy()
        err = float(np.abs(logits[:1] - ref32).max())
        mag = float(np.abs(ref32).max())
        tol = FP16_LOGIT_TOL if key == "fp16" else BF16_LOGIT_REL * mag
        log(f"{label}: {cfg.vocab_size} vocab, {L_} x {cfg.d_model}, "
            f"{cfg.num_heads} heads of {cfg.head_dim}, {cfg.dtype}, "
            f"{n_params} parameters; served requests of {rows_list} rows x "
            f"{TF_S}: ms {[round(x, 3) for x in served_ms]}, launches per "
            f"forward {per_forward}; {steps} train_steps on "
            f"({TF_TRAIN_B}, {TF_TRAIN_S + 1}) at lr {TF_TRAIN_LR}: loss "
            f"{losses}, ms {[round(x, 3) for x in step_ms_]}, launches per "
            f"step {per_step}; logits against fp32 on the card, 1 x {TF_S}: "
            f"max|d| {err:.3e} (tol {tol:.3e}), largest |logit| {mag:.3e}; "
            f"peak {peak} bytes")
        if not err <= tol:
            raise RuntimeError(f"{label}: logits and the fp32 forward "
                               f"disagree: {err} > {tol}")
        out[key] = {"parameters": n_params, "per_forward": per_forward[0],
                    "served_ms": served_ms, "losses": losses,
                    "step_ms": step_ms_, "per_step": per_step[0],
                    "launches": launches, "vs_fp32_max_abs": err,
                    "peak_device_bytes": peak}
        del lm
        torch.cuda.empty_cache()
    return out


def phase_b5_contrib():
    """18 (c): ``_contrib_flash_attention`` through ``mx.nd`` on the card,
    forward and gradients under ``autograd.record()``, at fp16 D = 64,
    bf16 D = 256 and fp32 D = 320, against the plain versions."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda.attention import (attention_backward_plain,
                                                    attention_plain)
    out = {}
    zero_attention_counts()  # the path's run starts here
    for label, dtype, d in (("fp16 D=64", torch.float16, 64),
                            ("bf16 D=256", torch.bfloat16, 256),
                            ("fp32 D=320", torch.float32, 320)):
        q, k, v, do = attention_grad_inputs(2, 4, 512, 512, d, dtype,
                                            seed=950 + d)
        arrays = [mx.nd.array(t.float().cpu().numpy(), dtype=str(
            dtype).split(".")[1]) for t in (q, k, v)]
        for a in arrays:
            a.attach_grad()
        before = b5_attention_counts()
        with mx.autograd.record():
            y = mx.nd._contrib_flash_attention(*arrays, causal=True)
        y.backward(mx.nd.array(do.float().cpu().numpy(),
                               dtype=str(dtype).split(".")[1]))
        torch.cuda.synchronize()
        moved = b5_moved(before)
        if (moved["launches"], moved["backward_launches"]) != (1, 1):
            raise RuntimeError(f"[b5] (c) {label}: launches {moved}")
        want = attention_plain(q, k, v, True)
        wgrads = attention_backward_plain(q, k, v, want, do, True)
        errs = []
        for got, ref in zip([y] + [a.grad for a in arrays], (want, *wgrads)):
            t = got._data
            if t.device.type != "cuda" or t.dtype != dtype:
                raise RuntimeError(f"[b5] (c) {label}: {t.device} {t.dtype}")
            err = (t.float() - ref.float()).abs().max().item()
            if not err <= b5_tol(dtype, ref):
                raise RuntimeError(f"[b5] (c) {label} disagrees with the "
                                   f"plain version: {err}")
            errs.append(err)
        out[label] = {"max_abs_err": errs, "moved": moved}
        log(f"[b5] (c) _contrib_flash_attention {label} (2, 4, 512, {d}) "
            f"causal through mx.nd under record(): out, dq, dk, dv max|d| "
            f"{[f'{e:.3e}' for e in errs]}; launches {moved}")
    out["launches"] = b5_attention_counts()  # and ends here
    return out


def phase_b5_gluon():
    """18 (d): phase 16's 2x1024 Gluon LSTM LM cast to fp16,
    with fp16 begin states (``begin_state(N, dtype='float16')``): one
    batch answered, then B5_GLUON_STEPS record()/backward()/
    Trainer.step() steps on it, each 2 lstm_seq_kernel and 2 backward
    launches (the register kernel) at fp16 and no per-step one; the
    losses finite."""
    import mxnet_tpu_torch as mx
    gluon = mx.gluon

    class RNNModel(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.encoder = gluon.nn.Embedding(V, H)
                self.rnn = gluon.rnn.LSTM(H, num_layers=LAYERS,
                                          layout="TNC")
                self.decoder = gluon.nn.Dense(V, flatten=False)

        def hybrid_forward(self, F, x, h0, c0):
            out, _ = self.rnn(self.encoder(x), [h0, c0])
            return self.decoder(F.reshape(out, shape=(-1, H)))

    data, label = train_data(mx)[:2]
    x, y = gluon_batch(mx, data, label, TRAIN_N, TRAIN_T)
    mx.random.seed(0)
    net = RNNModel(prefix="lm_")
    net.initialize(mx.init.Xavier())
    net(x, *net.rnn.begin_state(TRAIN_N))  # fixes the deferred shapes
    net.cast("float16")
    states = net.rnn.begin_state(TRAIN_N, dtype="float16")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_SGD))
    zero_train_counts()  # the path's run starts here
    answered = net(x, *states)
    if (answered.dtype != np.float16
            or not np.isfinite(answered.asnumpy()).all()):
        raise RuntimeError(f"[b5] (d) fp16 Gluon LM answered {answered.dtype}")
    per_step, losses = [], []
    for _ in range(B5_GLUON_STEPS):
        before = train_counts()
        with mx.autograd.record():
            loss = loss_fn(net(x, *states), y)
        loss.backward()
        trainer.step(TRAIN_N * TRAIN_T)
        losses.append(float(loss.mean().asscalar()))
        per_step.append(tuple(a - b for a, b in zip(train_counts(), before)))
    launches = train_counts()  # and ends here
    log(f"[b5] (d) the 2x{H} Gluon LSTM LM cast to fp16, fp16 begin states, "
        f"N={TRAIN_N} T={TRAIN_T}: answered {tuple(answered.shape)} "
        f"{answered.dtype}; {B5_GLUON_STEPS} steps at {GLUON_SGD}: "
        f"cross-entropy {losses}; (lstm_sequence, lstm_sequence_backward, its "
        f"register kernel, lstm_cell, lstm_cell_backward) launches per step "
        f"{per_step}, total {launches}")
    if any(c != (LAYERS, LAYERS, LAYERS, 0, 0) for c in per_step):
        raise RuntimeError(f"[b5] (d) launches per step {per_step}")
    if launches[0] != LAYERS * (B5_GLUON_STEPS + 1):
        raise RuntimeError(f"[b5] (d) forward launches {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"[b5] (d) non-finite losses {losses}")
    for k, p in net.collect_params().items():
        t = p.data()._data
        if t.dtype != torch.float16 or not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"[b5] (d) parameter {k}: {t.dtype}")
    return {"losses": losses, "per_step": per_step[0], "launches": launches}


def phase_b5_rnn():
    """18 (e): ``nd.RNN`` (two LSTM layers, H = 1024) with bf16 states over
    fp32 data and parameters on the card, against the port's CPU path (the
    plain versions) on the same inputs: one sequence-kernel launch a
    layer, reading the fp32 xproj and w_h2h as they are."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda import lstm as L
    from mxnet_tpu_torch.ops.rnn_ops import rnn_param_size
    rng = np.random.RandomState(960)
    size = rnn_param_size(LAYERS, H, H, "lstm", False)
    arrays = [rng.normal(0, 1, (B5_RNN_T, B5_RNN_N, H)).astype(np.float32),
              rng.uniform(-0.05, 0.05, (size,)).astype(np.float32),
              rng.uniform(-1, 1, (LAYERS, B5_RNN_N, H)).astype(np.float32),
              rng.uniform(-1, 1, (LAYERS, B5_RNN_N, H)).astype(np.float32)]
    dtypes = ("float32", "float32", "bfloat16", "bfloat16")
    kw = dict(state_size=H, num_layers=LAYERS, mode="lstm",
              state_outputs=True)
    inputs = [mx.nd.array(a, dtype=t) for a, t in zip(arrays, dtypes)]
    zero_train_counts()  # the path's run starts here
    got = mx.nd.RNN(*inputs, **kw)
    got = [o._data.float().cpu() for o in got]
    launches = (L.lstm_sequence_fused.launches,  # and ends here
                L.lstm_cell_fused.launches)
    with mx.cpu():
        want = mx.nd.RNN(*(mx.nd.array(a, dtype=t) for a, t in zip(
            arrays, dtypes)), **kw)
    errs = [(g - w._data.float()).abs().max().item()
            for g, w in zip(got, want)]
    log(f"[b5] (e) nd.RNN 2 x LSTM({H}) T={B5_RNN_T} N={B5_RNN_N}, bf16 "
        f"states over fp32 data and parameters: card against the CPU path, "
        f"max|d| out, hy, cy {[f'{e:.3e}' for e in errs]} (tol {BF16_TOL}); "
        f"(sequence, per-step) launches {launches}")
    if launches != (LAYERS, 0):
        raise RuntimeError(f"[b5] (e) launches {launches}")
    if not max(errs) <= BF16_TOL:
        raise RuntimeError(f"[b5] (e) nd.RNN disagrees with the CPU path: "
                           f"{errs}")
    return {"max_abs_err": errs, "launches": launches[0]}


def phase_b5():
    """18: the B5 paths (see the module docstring)."""
    card = nvidia_smi_name_and_limit()
    out = phase_b5_transformers()
    out["contrib"] = phase_b5_contrib()
    out["gluon_fp16"] = phase_b5_gluon()
    out["rnn_mixed"] = phase_b5_rnn()
    out["card"] = card
    log(f"[b5] phase 18 on {card}: " + json.dumps(out, default=str))
    return out


def b5_records(records, errs, timing, b5):
    """The kernels line's B5 rows: each new variant by name, with its
    launches on phase 18's paths, its largest error in phase 3, and its
    times in phase 7."""
    source_fwd = "mxnet_tpu_torch/csrc/flash_attention.cu"
    source_bwd = "mxnet_tpu_torch/csrc/flash_attention_bwd.cu"
    source_lstm = "mxnet_tpu_torch/csrc/lstm_cell.cu"
    card = b5["card"]
    rows = (
        ("flash_attention_fp16", source_fwd, "attention.py:32",
         b5["fp16"]["launches"]["wgmma_launches"], "attention_fp16",
         "forward", "attention_fp16",
         "the fp16 transformer LM served and trained (phase 18a)",
         f"(B,H,S,D)={ATT_SHAPE} fp16 causal, flash_fwd_wgmma_kernel<__half>"),
        ("flash_attention_backward_fp16", source_bwd, "attention.py:158",
         b5["fp16"]["launches"]["wgmma_backward_launches"], "attention_fp16",
         "backward", "attention_fp16",
         "the fp16 transformer LM trained (phase 18a)",
         f"(B,H,S,D)={ATT_SHAPE} fp16 causal, flash_bwd_wgmma_kernel<__half>"),
        ("flash_attention_d256", source_fwd, "attention.py:32",
         b5["d256"]["launches"]["mma_launches"], "attention_d256", "forward",
         "attention_d256",
         "the head-dim-256 transformer LM served and trained (phase 18b)",
         f"(B,H,S,D)={ATT_D256_SHAPE} bf16 causal, "
         "flash_fwd_mma_kernel<bf16, 256>"),
        ("flash_attention_backward_d256", source_bwd, "attention.py:158",
         b5["d256"]["launches"]["mma_backward_launches"], "attention_d256",
         "backward", "attention_d256",
         "the head-dim-256 transformer LM trained (phase 18b)",
         f"(B,H,S,D)={ATT_D256_SHAPE} bf16 causal, the mma.sync K1 (two "
         "column halves) and K2 at D = 256"),
        ("flash_attention_wide", source_fwd, "attention.py:32",
         b5["contrib"]["launches"]["launches"], "attention_wide", "forward",
         "attention_wide",
         "_contrib_flash_attention through mx.nd (phase 18c)",
         f"(B,H,S,D)={ATT_D320_SHAPE} fp32 causal, flash_fwd_kernel's wide "
         "tiles"),
        ("flash_attention_backward_wide", source_bwd, "attention.py:158",
         b5["contrib"]["launches"]["backward_launches"], "attention_wide",
         "backward", "attention_wide",
         "_contrib_flash_attention through mx.nd (phase 18c)",
         f"(B,H,S,D)={ATT_D320_SHAPE} fp32 causal, the CUDA-core wide "
         "tiles"),
        ("lstm_sequence_fp16", source_lstm, "lstm.py:43",
         b5["gluon_fp16"]["launches"][0], "lstm_fp16", "forward", "lstm_fp16",
         "the fp16 Gluon LSTM LM (phase 18d)",
         f"one layer T={TRAIN_T} N={TRAIN_N} H={H} fp16, "
         "lstm_seq_kernel<__half>"),
        ("lstm_sequence_backward_fp16", source_lstm, "lstm.py:77",
         b5["gluon_fp16"]["launches"][1], "lstm_fp16", "backward",
         "lstm_fp16", "the fp16 Gluon LSTM LM trained (phase 18d)",
         f"one layer T={TRAIN_T} N={TRAIN_N} H={H} fp16, "
         "lstm_seq_bwd_reg_kernel<__half, 8>"),
        ("lstm_sequence_mixed", source_lstm, "lstm.py:43",
         b5["rnn_mixed"]["launches"], "lstm_mixed", "forward", "lstm_mixed",
         "nd.RNN with bf16 states over fp32 parameters (phase 18e)",
         f"one layer T={B5_RNN_T} N={B5_RNN_N} H={H} bf16 states, fp32 "
         "xproj and w_h2h"),
    )
    for (name, source, line, launches, err_key, part, timing_key, path,
         shape) in rows:
        t = timing[timing_key][part]
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"mxnet_tpu/ops/pallas/{line}",
            "launches": launches, "launches_path": path,
            "max_abs_err": errs[err_key][part],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": ("scaled_dot_product_attention on the same inputs"
                        if "attention" in name else
                        "torch.nn.LSTM in fp16 (cuDNN), input projection "
                        "included" if "fp16" in name else None),
            "shape": shape, "share_of_bound": t["share_of_bound"],
            "kernel_turns_ms": t["kernel_turns_ms"],
            "library_turns_ms": t["library_turns_ms"], "card": card})
    by_name = {r["name"]: r for r in records}
    by_name["flash_attention_fp16"]["masked_lengths"] = timing[
        "attention_fp16_lengths"]
    by_name["flash_attention_fp16"]["phase_18a"] = b5["fp16"]
    by_name["flash_attention_d256"]["phase_18b"] = b5["d256"]
    by_name["flash_attention_wide"]["phase_18c"] = b5["contrib"]
    by_name["lstm_sequence_mixed"]["phase_18e"] = b5["rnn_mixed"]


# -- rtc: the rest of B4's body language (phase 19) -----------------------------

# 19a's tolerances, each output against the plain version on the same card
# tensors: "bits" bit for bit (NaN equal to NaN): arithmetic, indexing,
# views, casts, max/min/argmax/argmin, any/all; "ulp2" within 2 fp32 ulps
# (library functions: NVRTC's and torch's differ by an ulp); ("sum", n):
# sums, means, products and dots over n terms, which add in another order,
# within n * 2**-24 of the largest magnitude of the plain output; ("bf16",
# n) and ("f16", n) within one ulp of the type (2**-7 and 2**-10 of the
# value) plus, for a value summed over n terms in fp32 before its one
# rounding, that sum's n * 2**-24 of the largest magnitude
LANG_ROWS, LANG_COLS = 4096, 1024
# B1's Pallas body (mxnet_tpu/ops/pallas/lstm.py:25-48): _gates as written
# there, then _lstm_kernel's statements, run as one Rtc body
LSTM_BODY = '''
def _gates(xproj, h, w_h2h):
    g = xproj.astype(jnp.float32) + jax.lax.dot_general(
        h.astype(jnp.float32), w_h2h.astype(jnp.float32),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
    H = h.shape[-1]
    return (jax.nn.sigmoid(g[:, 0 * H:1 * H]),
            jax.nn.sigmoid(g[:, 1 * H:2 * H]),
            jnp.tanh(g[:, 2 * H:3 * H]),
            jax.nn.sigmoid(g[:, 3 * H:4 * H]))
i, f, g, o = _gates(xproj_ref[:], h_ref[:], w_ref[:])
c_new = f * c_ref[:].astype(jnp.float32) + i * g
h_new = o * jnp.tanh(c_new)
hn_ref[:] = h_new.astype(hn_ref.dtype)
cn_ref[:] = c_new.astype(cn_ref.dtype)
'''
LSTM_N, LSTM_H = 64, 1024
# the transformer LM's row log-softmax over its logits at (4, 2048) tokens:
# one body, outputs of two shapes
LOGSOFTMAX_BODY = ("m = jnp.max(x[:], axis=1, keepdims=True)\n"
                   "s = x[:] - m\n"
                   "l = jnp.log(jnp.sum(jnp.exp(s), axis=1, keepdims=True))\n"
                   "logp[:] = s - l\n"
                   "lse[:] = (m + l)[:, 0]")
LOGSOFTMAX_TOKENS = (4, 2048)
HEAD_BODY = "o[:] = jnp.dot(h[:], w[:])"
# global-norm clipping on phase 10's SGD-momentum path: each parameter's
# sum of squares, their fold into the scale, then the update reading the
# scale as a 0-d Ref
CLIP_NORM = 1.0
SUMSQ_BODY = "ss[...] = jnp.sum(g[:] * g[:])"
CLIP_SGD_BODY = ("mom[:] = 0.9 * m[:] - 0.01 * (g[:] * scale[...] + 0.0001 * "
                 "w[:])\nwout[:] = w[:] + mom[:]")
# the sums of squares add up to 16.4 M positive terms: each thread of the
# reduce stage adds ~120 in order and a tree of depth ~17 folds them, and
# torch adds in another order; both within (120 + 17) * 2**-24 = 8.2e-6
# of the true sum, so the scale and the sums are held within 2e-5
CLIP_TOL = 2e-5


def rtc_language_cases():
    """(label, inputs [(name, shape, dtype, kind)], outputs [(name, shape,
    dtype, tolerance)], body). Kinds: "n" a normal draw, "nan" one with a
    NaN every 97 elements, "i" int32 in [-1000, 1000), "i8"/"u8" int8/
    uint8 draws, "b" bool."""
    f32, rows, cols = "float32", LANG_ROWS, LANG_COLS
    mat, half = (rows, cols), LANG_ROWS // 2
    return [
        ("views and stores", [("x", mat, f32, "n"), ("y", (cols,), f32, "n")],
         [("a", (cols, rows), f32, "bits"), ("b", mat, f32, "bits"),
          ("c", (rows // 2, cols // 4), f32, "bits")],
         f"a[:] = x[:].T * 2.0 + y[:][:, None]\n"
         f"b[0:{half}] = x[{half}:{rows}] - y[:]\nb[-1] = y[:]\n"
         f"b[{half}:{rows - 1}, ::2] = x[0:{half - 1}, 1::2]\n"
         f"b[:, 1::2] *= 0.5\n"
         f"c[:] = x[:].reshape({half}, 2, {cols})[:, 1, ::4]"),
        ("row and column sums", [("x", mat, f32, "n")],
         [("r", (rows,), f32, ("sum", cols)), ("c", (cols,), f32, ("sum", rows)),
          ("m", (rows, 1), f32, ("sum", cols)), ("p", (rows,), f32, ("sum", cols))],
         "r[:] = jnp.sum(x[:], axis=1)\nc[:] = x[:].sum(axis=0)\n"
         "m[:] = jnp.mean(x[:], axis=-1, keepdims=True)\n"
         "p[:] = jnp.prod(1.0 + x[:] * 0.001, axis=1)"),
        ("full sums (split)", [("g", (2 ** 24 + 3,), f32, "n"),
                               ("b", (2 ** 20,), "bfloat16", "n"),
                               ("i", (2 ** 22,), "int32", "i")],
         [("s", (), f32, ("sum", 2 ** 24)), ("t", (), "bfloat16", ("bf16", 2 ** 20)),
          ("w", (), "int32", "bits"), ("q", (), f32, ("sum", 2 ** 22))],
         "s[...] = jnp.sum(g[:] * g[:])\nt[...] = jnp.sum(b[:])\n"
         "w[...] = jnp.sum(i[:] * 1000003)\nq[...] = jnp.mean(i[:])"),
        ("max min arg", [("x", mat, f32, "nan"), ("z", mat, f32, "n")],
         [("a", (rows,), f32, "bits"), ("b", (cols,), f32, "bits"),
          ("c", (rows,), "int32", "bits"), ("d", (cols,), "int32", "bits"),
          ("e", (), "int32", "bits"), ("f", (rows,), "int32", "bits")],
         "a[:] = jnp.max(x[:], axis=1)\nb[:] = z[:].min(axis=0)\n"
         "c[:] = jnp.argmax(x[:], axis=1)\nd[:] = jnp.argmin(z[:], axis=0)\n"
         "e[...] = jnp.argmax(z[:])\nf[:] = jnp.argmin(x[:], axis=-1)"),
        ("softmax", [("x", mat, f32, "n")],
         [("s", mat, f32, ("sum", cols)), ("l", mat, f32, ("sum", cols))],
         "s[:] = jax.nn.softmax(x[:], axis=1)\n"
         "l[:] = jax.nn.log_softmax(x[:])"),
        ("products", [("a", (512, cols), f32, "n"), ("w", (cols, 768), f32, "n"),
                      ("x3", (8, 256, 128), f32, "n"),
                      ("b3", (8, 128, 256), f32, "n")],
         [("o", (512, 768), f32, ("sum", cols)),
          ("g", (512, 512), f32, ("sum", cols)),
          ("bm", (8, 256, 256), f32, ("sum", 128)),
          ("v", (768,), f32, ("sum", cols))],
         "o[:] = a[:] @ w[:]\n"
         "g[:] = jax.lax.dot_general(a[:], a[:], (((1,), (1,)), ((), ())))\n"
         "bm[:] = jnp.matmul(x3[:], b3[:])\nv[:] = jnp.dot(a[0], w[:])"),
        ("16-bit and int products", [("a", (512, cols), f32, "n"),
                                     ("w", (cols, 768), f32, "n"),
                                     ("i", (256, 512), "int32", "i")],
         [("b", (512, 768), "bfloat16", ("bf16", cols)),
          ("h", (512, 768), "float16", ("f16", cols)),
          ("p", (512, 768), f32, ("sum", cols)),
          ("ii", (256, 256), "int32", "bits")],
         "b[:] = jnp.dot(a[:].astype(jnp.bfloat16), w[:].astype(jnp.bfloat16))\n"
         "h[:] = a[:].astype(jnp.float16) @ (w[:] * 0.1).astype(jnp.float16)\n"
         "p[:] = jax.lax.dot_general(a[:].astype(jnp.bfloat16), "
         "w[:].astype(jnp.bfloat16), (((1,), (0,)), ((), ())), "
         "preferred_element_type=jnp.float32)\n"
         "ii[:] = i[:] @ i[:].T"),
        ("small dtypes", [("u", mat, "uint8", "u8"), ("s", mat, "int8", "i8"),
                          ("q", mat, "bool", "b"), ("x", mat, f32, "n")],
         [("a", mat, "int32", "bits"), ("b", mat, "uint8", "bits"),
          ("c", mat, "int8", "bits"), ("d", mat, "bool", "bits"),
          ("e", mat, f32, "bits"), ("n", (rows,), "int32", "bits"),
          ("k", (cols,), "bool", "bits")],
         "a[:] = (u[:] + s[:]).astype(jnp.int32) * 7 + (u[:] * s[:]).astype(jnp.int32)\n"
         "b[:] = u[:] // 3 + u[:] % 7 + (u[:] >> 1) + q[:].astype(jnp.uint8)\n"
         "c[:] = s[:] * 3 - s[:] // -4 + (s[:] << 2) + (x[:] * 50.0).astype(jnp.int8)\n"
         "d[:] = (q[:] ^ (u[:] > 128)) | ~(s[:] < 0)\n"
         "e[:] = u[:] / 3 + s[:] * 0.5 + q[:]\n"
         "n[:] = jnp.sum(s[:], axis=1) + jnp.sum(q[:], axis=1)\n"
         "k[:] = jnp.any(q[:] & (u[:] > 250), axis=0)"),
        ("functions and control flow", [("x", mat, f32, "n"), ("y", mat, f32, "n")],
         [("a", mat, f32, "ulp2"), ("b", mat, f32, "bits"),
          ("c", mat, "bfloat16", ("bf16", 0))],
         "z = x[:] * 0.3\n"
         "a[:] = jax.lax.erf(x[:]) + jnp.tan(z) + jnp.arcsin(jnp.tanh(z)) + "
         "jax.nn.gelu(y[:]) + jnp.log2(jnp.abs(x[:]) + 1.0) + jax.nn.softplus(y[:])\n"
         "t = x[:]\nfor k in range(3):\n    t = t * 0.5 + y[:] * k\n"
         "b[:] = jax.lax.fori_loop(0, 2, lambda k, v: v - x[:], t) if "
         "x.shape[0] > 1 else t\n"
         "c[:] = (x[:].astype(jnp.bfloat16) * 3.0 + jnp.round(y[:]).astype(jnp.bfloat16))"),
    ]


def lang_arrays(mx, ins, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    arrays = []
    for name, shape, dtype, kind in ins:
        if kind == "i":
            t = torch.randint(-1000, 1000, shape, generator=gen, device="cuda",
                              dtype=torch.int32)
        elif kind in ("i8", "u8", "b"):
            lo, hi = {"i8": (-128, 128), "u8": (0, 256), "b": (0, 2)}[kind]
            t = torch.randint(lo, hi, shape, generator=gen, device="cuda")
            t = t.to(getattr(torch, dtype))
        else:
            t = torch.randn(shape, generator=gen, device="cuda")
            if kind == "nan":
                t.view(-1)[::97] = float("nan")
            t = t.to(getattr(torch, dtype))
        arrays.append((name, mx.nd.NDArray(t)))
    return arrays


def lang_compare(kernel, plain, tol):
    """(within tolerance, largest absolute difference)."""
    if kernel.dtype != plain.dtype or kernel.shape != plain.shape:
        return False, f"{kernel.dtype}{tuple(kernel.shape)} against " \
                      f"{plain.dtype}{tuple(plain.shape)}"
    k, p = kernel.double(), plain.double()
    nan = torch.isnan(k) & torch.isnan(p)
    diff = (k - p).abs().masked_fill(nan, 0.0)
    err = float(diff.nan_to_num(float("inf")).max()) if diff.numel() else 0.0
    if tol == "bits":
        same = (kernel == plain) | nan if kernel.is_floating_point() else \
            kernel == plain
        return bool(same.all()), err
    if tol == "ulp2":
        return max_ulp(kernel.masked_fill(nan, 0), plain.masked_fill(nan, 0)) \
            <= 2, err
    kind, n = tol
    scale = max(float(p.abs().nan_to_num(0.0).max()), 1e-30)
    bound = n * 2.0 ** -24 * scale
    if kind in ("bf16", "f16"):
        rel = 2.0 ** -7 if kind == "bf16" else 2.0 ** -10
        return bool((diff <= rel * p.abs() + bound + 1e-30).all()), err
    return bool((diff <= bound).all()), err


def stage_counts():
    from mxnet_tpu_torch.ops.cuda.rtc import rtc_launch
    return dict(rtc_launch.stage_launches)


def stage_moved(before):
    now = stage_counts()
    return {k: now[k] - before[k] for k in now}


def phase_rtc_language_kernels():
    """19a: each form of the language at moderate sizes, the NVRTC stages
    against the plain version on the same card tensors, each stage kind's
    counter held to the stage plan."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda.rtc import STATS
    cases, worst = [], {}
    for i, (label, ins, outs, body) in enumerate(rtc_language_cases()):
        arrays = lang_arrays(mx, ins, seed=1900 + i)
        targets = [(n, mx.nd.zeros(s, ctx=mx.gpu(0), dtype=dt))
                   for n, s, dt, _ in outs]
        t0 = time.perf_counter()
        k = mx.rtc.Rtc(label.split()[0], arrays, targets, body)
        tensors = [a._data for _, a in arrays]
        plain = k._run_plain(tensors, tensors[0].device)
        compiles, before = STATS["compiles"], stage_counts()
        k.push([a for _, a in arrays], [t for _, t in targets])
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        moved = stage_moved(before)
        kinds = [s.kind for s in k._program.stages.stages] \
            if not k._program.simple else ["map"]
        for kind in ("map", "product"):
            if moved[kind] != kinds.count(kind):
                raise RuntimeError(f"rtc {label}: {moved} launches for the "
                                   f"stages {kinds}")
        if moved["reduce"] < kinds.count("reduce"):
            raise RuntimeError(f"rtc {label}: {moved} launches for {kinds}")
        errs = {}
        for (n, s, dt, tol), (_, t), p in zip(outs, targets, plain):
            ok, err = lang_compare(t._data, p, tol)
            log(f"[rtc19a] {label} {n} {tuple(s)} {dt} {tol}: max abs "
                f"{err}")
            if not ok:
                raise RuntimeError(f"rtc {label} output {n} disagrees with "
                                   f"the plain version ({tol}): {err}")
            errs[n] = err
            key = tol if isinstance(tol, str) else tol[0]
            worst[key] = max(worst.get(key, 0.0), err)
        cases.append({"label": label, "stages": kinds, "launches": moved,
                      "compiled": STATS["compiles"] - compiles,
                      "first_push_ms": first_ms, "max_abs_err": errs})
        log(f"[rtc19a] {label}: stages {kinds}, launches {moved}, first push "
            f"{first_ms:.3f} ms")
    return {"cases": cases, "max_abs_err": worst}


def lstm_body_bound_ms(n, hdim):
    """The cell's product (2 N 4H H operations at the fp32 peak) or
    w_h2h's bytes at 3.35 TB/s, the larger."""
    by_ops = 2 * n * 4 * hdim * hdim / FP32_FLOPS
    by_bytes = 4 * 4 * hdim * hdim / HBM_BYTES_PER_S
    return max(by_ops, by_bytes) * 1e3, ("operations" if by_ops >= by_bytes
                                         else "bytes")


def phase_rtc_lstm_body(mx):
    """19b: B1's own Pallas body as an Rtc at the LSTM LM's width, fp32 and
    with bf16 states over fp32 xproj, against lstm_cell_plain and B1's
    lstm_cell_kernel (lstm_cell_fused on CUDA tensors) on the same
    tensors, and timed beside them."""
    from mxnet_tpu_torch.ops.cuda.lstm import lstm_cell_fused, lstm_cell_plain
    n, hdim = LSTM_N, LSTM_H
    gen = torch.Generator(device="cuda").manual_seed(19)
    xp = torch.randn(n, 4 * hdim, generator=gen, device="cuda")
    w = torch.randn(4 * hdim, hdim, generator=gen, device="cuda") * hdim ** -0.5
    out = {}
    for state in ("float32", "bfloat16"):
        sdt = getattr(torch, state)
        h = torch.randn(n, hdim, generator=gen, device="cuda").to(sdt)
        c = torch.randn(n, hdim, generator=gen, device="cuda").to(sdt)
        ins = [("xproj_ref", xp), ("h_ref", h), ("c_ref", c), ("w_ref", w)]
        arrays = [(k_, mx.nd.NDArray(t)) for k_, t in ins]
        targets = [(k_, mx.nd.zeros((n, hdim), ctx=mx.gpu(0), dtype=state))
                   for k_ in ("hn_ref", "cn_ref")]
        k = mx.rtc.Rtc("lstm_cell", arrays, targets, LSTM_BODY)
        push = lambda: k.push([a for _, a in arrays], [t for _, t in targets])
        push()
        torch.cuda.synchronize()
        got = [t._data for _, t in targets]
        plain = lstm_cell_plain(xp, h, c, w)
        before = lstm_cell_fused.launches
        kern = lstm_cell_fused(xp, h, c, w)
        if lstm_cell_fused.launches != before + 1:
            raise RuntimeError("19b: B1's kernel did not launch")
        tol = ("sum" if state == "float32" else "bf16", 4 * hdim)
        errs = {}
        for name, g, p, q in zip(("hn", "cn"), got, plain, kern):
            for ref_name, ref in (("plain", p), ("b1_kernel", q)):
                ok, err = lang_compare(g, ref.to(g.dtype), tol)
                if not ok:
                    raise RuntimeError(f"19b {state} {name} against "
                                       f"{ref_name}: {err}")
                errs[f"{name}_vs_{ref_name}"] = err
        rtc_ms = time_on_stream(push, iters=50)
        b1_ms = time_on_stream(lambda: lstm_cell_fused(xp, h, c, w), iters=50)
        plain_ms = time_on_stream(lambda: lstm_cell_plain(xp, h, c, w), iters=50)
        bound, by = lstm_body_bound_ms(n, hdim)
        out[state] = {"ms": rtc_ms, "b1_kernel_ms": b1_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": by, "max_abs_err": errs,
                      "stages": [s.kind for s in k._program.stages.stages]}
        log(f"[rtc19b] LSTM body N={n} H={hdim} {state} states: rtc "
            f"{rtc_ms:.4f} ms, B1 kernel {b1_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); errors {errs}")
    return out


def phase_rtc_log_softmax(mx, lm):
    """19c: the transformer LM's logits on (4, 2048) tokens, (8192, 32000)
    fp32, through one body writing logp (8192, 32000) and lse (8192,),
    held to F.log_softmax (as lm_loss takes it) and to the plain version,
    and timed beside torch.log_softmax."""
    import torch.nn.functional as F
    b, s = LOGSOFTMAX_TOKENS
    rng = np.random.RandomState(19)
    tokens = rng.randint(0, lm.cfg.vocab_size, (b, s))
    logits = lm.logits(tokens).reshape(b * s, -1).float().contiguous()
    rows, vocab = logits.shape
    x = mx.nd.NDArray(logits)
    logp = mx.nd.zeros((rows, vocab), ctx=mx.gpu(0))
    lse = mx.nd.zeros((rows,), ctx=mx.gpu(0))
    k = mx.rtc.Rtc("log_softmax", [("x", x)], [("logp", logp), ("lse", lse)],
                   LOGSOFTMAX_BODY)
    push = lambda: k.push([x], [logp, lse])
    push()
    torch.cuda.synchronize()
    plain = k._run_plain([logits], logits.device)
    lib = F.log_softmax(logits, dim=-1)
    errs = {}
    for name, got, ref, tol in (("logp_vs_plain", logp._data, plain[0],
                                 ("sum", vocab)),
                                ("lse_vs_plain", lse._data, plain[1],
                                 ("sum", vocab)),
                                ("logp_vs_F.log_softmax", logp._data, lib,
                                 ("sum", vocab))):
        ok, err = lang_compare(got, ref, tol)
        if not ok:
            raise RuntimeError(f"19c {name}: {err}")
        errs[name] = err
    del plain, lib
    rtc_ms = time_on_stream(push, iters=20)
    lib_ms = time_on_stream(lambda: torch.log_softmax(logits, dim=-1), iters=20)
    plain_ms = time_on_stream(lambda: k._run_plain([logits], logits.device),
                              iters=5)
    bound = 2 * logits.numel() * 4 / HBM_BYTES_PER_S * 1e3
    out = {"ms": rtc_ms, "library_ms": lib_ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": "bytes", "shape": [rows, vocab],
           "max_abs_err": errs,
           "stages": [st.kind for st in k._program.stages.stages]}
    log(f"[rtc19c] log-softmax ({rows}, {vocab}): rtc {rtc_ms:.4f} ms, "
        f"torch.log_softmax {lib_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms; errors {errs}")
    return out


def phase_rtc_head(mx, lm):
    """19d: the head product o = h @ w at (8192, 512) x (512, 32000), fp32
    and bf16, against the plain version and timed beside torch.matmul."""
    rows = LOGSOFTMAX_TOKENS[0] * LOGSOFTMAX_TOKENS[1]
    head = lm.params["head"].float().contiguous()
    gen = torch.Generator(device="cuda").manual_seed(191)
    hidden = torch.randn(rows, head.shape[0], generator=gen, device="cuda")
    out = {}
    for dtype, peak in (("float32", FP32_FLOPS), ("bfloat16", BF16_TENSOR_FLOPS)):
        h = hidden.to(getattr(torch, dtype))
        w = head.to(getattr(torch, dtype))
        hn, wn = mx.nd.NDArray(h), mx.nd.NDArray(w)
        o = mx.nd.zeros((rows, w.shape[1]), ctx=mx.gpu(0), dtype=dtype)
        k = mx.rtc.Rtc("head", [("h", hn), ("w", wn)], [("o", o)], HEAD_BODY)
        push = lambda: k.push([hn, wn], [o])
        push()
        torch.cuda.synchronize()
        plain = k._run_plain([h, w], h.device)[0]
        tol = ("sum" if dtype == "float32" else "bf16", h.shape[1])
        ok, err = lang_compare(o._data, plain, tol)
        if not ok:
            raise RuntimeError(f"19d {dtype}: {err}")
        del plain
        rtc_ms = time_on_stream(push, iters=5)
        lib_ms = time_on_stream(lambda: torch.matmul(h, w), iters=20)
        plain_ms = time_on_stream(lambda: k._run_plain([h, w], h.device),
                                  iters=5)
        flops = 2 * rows * h.shape[1] * w.shape[1]
        nbytes = (h.numel() + w.numel() + rows * w.shape[1]) * h.element_size()
        bound = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
        out[dtype] = {"ms": rtc_ms, "library_ms": lib_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": "operations",
                      "max_abs_err": err, "tflops": flops / rtc_ms / 1e9}
        log(f"[rtc19d] head product {dtype} ({rows}, {h.shape[1]}) x "
            f"({w.shape[0]}, {w.shape[1]}): rtc {rtc_ms:.4f} ms "
            f"({flops / rtc_ms / 1e9:.2f} TFLOP/s), torch.matmul {lib_ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms; max abs {err}")
    return out


def phase_rtc_clip(mx, lm):
    """19e: global-norm clipping on phase 10's imperative SGD-momentum path
    over the transformer LM's 49.5 M gradients: one reduction body per
    parameter, one body folding the sums into the scale, the update reading
    the scale as a 0-d Ref; against the same steps in plain torch on the
    card, the norm timed beside torch.linalg.vector_norm."""
    from mxnet_tpu_torch.models.transformer import lm_loss_and_grads
    rng = np.random.RandomState(190)
    tokens = torch.as_tensor(rng.randint(0, lm.cfg.vocab_size, (2, 129)),
                             device="cuda")
    _, grads = lm_loss_and_grads(lm.params, tokens, lm.cfg)
    names = sorted(grads)
    gs = [grads[n_].float().contiguous() for n_ in names]
    n_elems = sum(g.numel() for g in gs)
    g_nd = [mx.nd.NDArray(g) for g in gs]
    ss = [mx.nd.zeros((), ctx=mx.gpu(0)) for _ in gs]
    sumsq = {}
    for g in g_nd:
        if g.shape not in sumsq:
            sumsq[g.shape] = mx.rtc.Rtc("sumsq", [("g", g)], [("ss", ss[0])],
                                        SUMSQ_BODY)
    parts = [f"s{j}" for j in range(len(gs))]
    fold_body = (f"n = jnp.sqrt({' + '.join(p + '[...]' for p in parts)})\n"
                 f"scale[...] = jnp.minimum(1.0, {CLIP_NORM} / (n + 1e-6))")
    scale = mx.nd.zeros((), ctx=mx.gpu(0))
    fold = mx.rtc.Rtc("clip_scale", list(zip(parts, ss)), [("scale", scale)],
                      fold_body)
    gen = torch.Generator(device="cuda").manual_seed(192)
    w0 = [torch.randn(g.shape, generator=gen, device="cuda") for g in gs]
    wr = [mx.nd.NDArray(w.clone()) for w in w0]
    mr = [mx.nd.zeros(tuple(g.shape), ctx=mx.gpu(0)) for g in gs]
    sgd = {}
    for w, g, m in zip(wr, g_nd, mr):
        if w.shape not in sgd:
            sgd[w.shape] = mx.rtc.Rtc("clip_sgd", [("w", w), ("g", g), ("m", m),
                                                   ("scale", scale)],
                                      [("wout", w), ("mom", m)], CLIP_SGD_BODY)

    def norm_rtc():
        for g, s_ in zip(g_nd, ss):
            sumsq[g.shape].push([g], [s_])
        fold.push(ss, [scale])

    def step_rtc():
        norm_rtc()
        for w, g, m in zip(wr, g_nd, mr):
            sgd[w.shape].push([w, g, m, scale], [w, m])

    def norm_plain():
        total = torch.zeros((), device="cuda")
        sums = [torch.sum(g * g) for g in gs]
        for s_ in sums:
            total = total + s_
        n_ = torch.sqrt(total)
        return sums, torch.clamp(CLIP_NORM / (n_ + 1e-6), max=1.0)

    before = stage_counts()
    step_rtc()
    torch.cuda.synchronize()
    moved = stage_moved(before)
    sums, scale_p = norm_plain()
    wp, mp = [w.clone() for w in w0], [torch.zeros_like(w) for w in w0]
    for w, g, m in zip(wp, gs, mp):
        m.copy_(0.9 * m - 0.01 * (g * scale_p + 0.0001 * w))
        w.add_(m)
    errs = {"sumsq_rel": max(float(((s_._data - p).abs() / p).item())
                             for s_, p in zip(ss, sums)),
            "scale_rel": float(((scale._data - scale_p).abs() / scale_p).item())}
    errs["weights_max_abs"] = max(float((w._data - p).abs().max())
                                  for w, p in zip(wr, wp))
    if errs["sumsq_rel"] > CLIP_TOL or errs["scale_rel"] > CLIP_TOL:
        raise RuntimeError(f"19e: the clip norm disagrees with torch: {errs}")
    wmax = max(float(p.abs().max()) for p in wp)
    if errs["weights_max_abs"] > CLIP_TOL * wmax:
        raise RuntimeError(f"19e: the clipped update disagrees: {errs}")
    flat = torch.cat([g.reshape(-1) for g in gs])
    rtc_ms = time_on_stream(norm_rtc, iters=20)
    lib_ms = time_on_stream(lambda: torch.linalg.vector_norm(flat), iters=20)
    plain_ms = time_on_stream(norm_plain, iters=20)
    step_ms_ = time_on_stream(step_rtc, iters=5)
    bound = n_elems * 4 / HBM_BYTES_PER_S * 1e3
    out = {"ms": rtc_ms, "library_ms": lib_ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": "bytes", "parameters": n_elems,
           "tensors": len(gs), "clipped_step_ms": step_ms_,
           "launches_one_step": moved, "max_err": errs,
           "scale": float(scale._data)}
    log(f"[rtc19e] clip norm over {len(gs)} gradients ({n_elems} fp32): rtc "
        f"{rtc_ms:.4f} ms, torch.linalg.vector_norm {lib_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms; clipped step {step_ms_:.4f}"
        f" ms; launches {moved}; errors {errs}")
    return out


def phase_rtc_language():
    """Phase 19: 19a's forms against the plain version, then the path: B1's
    body (19b), the log-softmax (19c), the head product (19d) and the
    clipped SGD step (19e), each stage kind's launch count zeroed just
    before and read just after."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from mxnet_tpu_torch.ops.cuda.rtc import rtc_launch
    t0 = time.perf_counter()
    kernels = phase_rtc_language_kernels()
    lm = TransformerLM(TransformerConfig(), seed=0)
    for kind in rtc_launch.stage_launches:  # the path's run starts here
        rtc_launch.stage_launches[kind] = 0
    launches0 = rtc_launch.launches
    lstm = phase_rtc_lstm_body(mx)
    logsm = phase_rtc_log_softmax(mx, lm)
    head = phase_rtc_head(mx, lm)
    clip = phase_rtc_clip(mx, lm)
    path = dict(rtc_launch.stage_launches)  # and ends here
    if not all(path.values()):
        raise RuntimeError(f"phase 19: a stage kind never launched: {path}")
    out = {"kernels": kernels, "lstm_body": lstm, "log_softmax": logsm,
           "head_product": head, "clip": clip, "stage_launches": path,
           "launches": rtc_launch.launches - launches0,
           "seconds": time.perf_counter() - t0}
    del lm
    torch.cuda.empty_cache()
    log(f"[rtc19] phase 19 on {nvidia_smi_name_and_limit()}: stage launches "
        f"{path}, {out['seconds']:.1f} s")
    return out


def main():
    phase_device()
    wgmma_build, wgmma_bwd_build, reg_build, probe_builds = phase_build()
    errs = phase_kernels()
    seq_errs = phase_sequence_kernel()
    att_errs = phase_attention_kernels()
    b5_errs = phase_b5_kernels()
    backend, requests, launches, peak, prob_err = phase_slice()
    wide_launches, wide_prob_err = phase_wide_lstm()
    tf = phase_transformer()
    masked_launches, masked_wgmma = phase_masked_path()
    cells, forward = phase_timing(backend, requests)
    seq = phase_sequence_timing()
    att = phase_attention_timing()
    b5_timing = phase_b5_timing()
    tf_timing = phase_transformer_timing(tf)
    profiled = phase_profile(backend, requests)
    tf_profiled = phase_transformer_profile(tf)
    rtc_k = phase_rtc_kernels()
    imp = phase_imperative()
    train_kerrs, bwd_plans = phase_train_kernels()
    grad_errs = phase_train_card_vs_cpu()
    with fused_path(False):  # phase 11 times the classic path
        bench = phase_train_bench()
        wide_train_launches = phase_train_wide()
    for future in probe_builds.values():
        future.result()  # the probe builds, or their nvcc's error
    train_timing = phase_train_timing(
        {p: probe_tool().load_probe(p) for p in probe_builds})
    att_bwd_errs, *masked_bwd_launches = phase_attention_backward_kernels()
    tf_grads = phase_tf_train_card_vs_cpu()
    tf_train = phase_tf_train()
    tf_train["gradients_card_vs_cpu"] = tf_grads
    att_bwd_timing = phase_attention_backward_timing()
    lstm_bench_forward = phase_lstm_bench_forward()
    cnn_errs = phase_cnn_ops()
    resnet_grads = phase_resnet_card_vs_cpu()
    with fused_path(False):  # phase 13 times the classic path
        resnet = phase_resnet_train()
    resnet["ops_card_vs_cpu"] = cnn_errs
    resnet["card_vs_cpu"] = resnet_grads
    log("[resnet] phase 13: " + json.dumps(resnet))
    fused = phase_fused(bench, resnet)
    log("[fused] phase 14: " + json.dumps(fused))
    serve = phase_serve(tf)
    gluon = phase_gluon(bench)
    sequences = phase_seq()
    b5 = phase_b5()
    lang = phase_rtc_language()
    main_n = max(BUCKETS)
    layer = seq[main_n]
    lstm_sequence = {
        "name": "lstm_sequence",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "mxnet_tpu/ops/rnn_ops.py:139",
        "replaces_scan_over": "mxnet_tpu/ops/pallas/lstm.py:57",
        "launches": launches,
        "max_abs_err": seq_errs["fp32"],
        "ms": layer["kernel_ms"],
        "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"],
        "bound_by": layer["bound_by"],
        "library_ms": layer["cudnn_lstm_ms"],
        "library": "torch.nn.LSTM (cuDNN, TF32 off), input projection "
                   "included; the port's projection plus the kernel is "
                   "projection_plus_kernel_ms",
        "shape": f"one layer T={T} N={main_n} H={H} fp32",
        "max_err_fp32": seq_errs["fp32"],
        "max_err_bf16_ulps": seq_errs["bf16_ulps"],
        "per_step_route_ms": layer["per_step_ms"],
        "barrier_floor_ms": layer["barrier_floor_ms"],
        "projection_plus_kernel_ms": layer["projection_plus_kernel_ms"],
        "share_of_bound": layer["share_of_bound"],
        "by_rows": {str(n): r for n, r in seq.items()},
        "predictor": {str(n): f for n, f in forward.items()},
        "prob_err_card_vs_cpu": prob_err,
        "peak_device_bytes": peak,
        "profile": profiled,
        "bench_training_shape_forward": lstm_bench_forward,
        "fused_step": {
            "launches_in_a_replay": fused["lstm"]["profile"][
                "replay_kernels"]["lstm_seq_kernel"],
            "launches_outside_replays": fused["lstm"][
                "launches_outside_replays"][0],
            "path": "the LSTM LM's fused bf16 training step (phase 14), "
                    "counted by the profiler's kernel names in a replay"},
    }
    # the per-step kernel's numbers at its path's shape, the wide LM's
    cell = cells[(1, WIDE_H)]
    lstm = {
        "name": "lstm_cell",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "mxnet_tpu/ops/pallas/lstm.py:43",
        "launches": wide_launches,
        "launches_path": f"the one-layer LSTM LM at H={WIDE_H} (phase 4); "
                         "0 on the 2x1024 LM's path",
        "max_abs_err": errs[(1, WIDE_H)]["fp32"],
        "ms": cell["kernel_ms"],
        "plain_ms": cell["plain_ms"],
        "bound_ms": cell["bound_ms"],
        "bound_by": cell["bound_by"],
        "library_ms": cell["library_ms"],
        "shape": f"N=1 H={WIDE_H} fp32",
        "max_err_bf16": errs[(1, WIDE_H)]["bf16"],
        "max_err_by_shape": {f"N={n} H={hdim}": e
                             for (n, hdim), e in errs.items()},
        "prob_err_card_vs_cpu": wide_prob_err,
        "by_shape": {f"N={n} H={hdim}": c for (n, hdim), c in cells.items()},
    }
    lstm_sequence["serving"] = {
        name: {"launches": serve["lstm"][name]["launches"]["lstm_sequence"],
               "dispatches": serve["lstm"][name]["dispatches"]}
        for name in ("batched", "unbatched")}
    lstm_sequence["serving"]["path"] = (
        "the LSTM LM through InferenceServer (phase 15a), counted after "
        "each burst's warm-up")
    records = [lstm_sequence, lstm]
    for name, line, n in (("flash_attention", 32, tf["launches"]),
                          ("flash_attention_masked", 277, masked_launches)):
        t = att[name]
        record = {
            "name": name,
            "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"mxnet_tpu/ops/pallas/attention.py:{line}",
            "launches": n,
            "max_abs_err": max(att_errs[name].values()),
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": f"(B,H,S,D)={ATT_SHAPE} bf16 causal" + (
                f" lengths={ATT_LENGTHS}" if name.endswith("masked") else ""),
            "max_err_fp32": att_errs[name]["fp32"],
            "max_err_bf16": att_errs[name]["bf16"],
            "share_of_bound": t["share_of_bound"],
            "tflops": t["tflops"],
            "live_pairs": t["live_pairs"],
        }
        if name == "flash_attention_masked":
            record["wgmma_launches"] = masked_wgmma
            record["variants"] = t["variants"]
            record["packed"] = t["packed"]
        if name == "flash_attention":
            record["wgmma_launches"] = tf["wgmma_launches"]
            record["variants"] = t["variants"]
            record["wgmma_build"] = wgmma_build
            record["transformer"] = {
                k: tf[k] for k in ("per_forward", "served_ms",
                                   "peak_device_bytes",
                                   "bf16_vs_fp32_max_abs",
                                   "card_vs_cpu_max_abs", "parameters",
                                   "masked_launches_on_path")}
            record["transformer"]["timing"] = tf_timing
            record["transformer"]["profile"] = tf_profiled
            run = serve["transformer"]["run"]
            record["serving"] = {
                "launches": run["launches"]["flash_attention"],
                "wgmma_launches": run["launches"]["wgmma"],
                "dispatches": run["dispatches"],
                "path": "the transformer LM through InferenceServer "
                        "(phase 15b), counted after the warm-up"}
        records.append(record)
    records.append(rtc_record(rtc_k, imp, lang))
    records += train_records(train_kerrs, bwd_plans, grad_errs, bench,
                             wide_train_launches, train_timing, reg_build)
    next(r for r in records if r["name"] == "lstm_sequence_backward")[
        "fused_step"] = {
        "launches_in_a_replay": fused["lstm"]["profile"]["replay_kernels"][
            "lstm_seq_bwd_reg_kernel"],
        "launches_outside_replays": fused["lstm"][
            "launches_outside_replays"][2],
        "path": "the LSTM LM's fused bf16 training step (phase 14), "
                "counted by the profiler's kernel names in a replay"}
    records += attention_backward_records(att_bwd_errs, masked_bwd_launches,
                                          tf_train, att_bwd_timing,
                                          wgmma_bwd_build)
    gluon_records(records, gluon)
    seq_records(records, sequences)
    b5_records(records, b5_errs, b5_timing, b5)
    print(json.dumps({"kernels": records}), flush=True)
    print(nvidia_smi_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

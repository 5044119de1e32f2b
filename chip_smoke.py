#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It exits non-zero, and prints no result line, when there is no CUDA card or
no ``mxnet_tpu_torch`` package beside it. Every failure raises. Phases:

1. device: the card's name, capability, name and power limit; TF32 off;
2. build: every kernel library (four) built from ``mxnet_tpu_torch/csrc``
   by concurrent ``nvcc`` processes, with ``-Xptxas -v`` output, and the
   wgmma attention kernel's registers, spills, wgmma serialization and
   shared memory a block;
3. kernels: each kernel's wrapper on the card against its plain PyTorch
   version at its path's shapes and ragged ones, fp32 and bf16; the LSTM
   sequence kernel over T=128 steps at N=1 and 16 (H=1024) and T=7, N=3,
   H=200, forward and reverse; the dense and masked bf16 attention cases
   (D = 64 and 128, ragged, Sq < Sk, the transformer's (B, S, H, D) views,
   lengths, packed segments) through the wgmma/TMA variant, by its launch
   counter;
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
   forward times; peak memory;
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
   bf16, both directions: the sequence backward kernel at (T,N,H) =
   (128,1,1024), (128,16,1024), the main path's (256,64,1024), (7,3,200)
   and (7,37,200), the per-step one at (8,1,1536);
   one forward_backward of the full-width LM (T=8, N=4) on the card and
   on the port's CPU path from the same seeded Xavier init, every
   gradient held to the CPU's; the benchmark's training shape (N=64,
   T=256, ``benchmarks/bench_lstm.py``): ``Module`` on the default
   context, Xavier, SGD (lr 0.5, no momentum), one ``fit`` epoch over 4
   batches and 10 ``forward``/``backward``/``update`` steps on one batch,
   each step 2 sequence forward and 2 sequence backward launches and no
   per-step one, every output and parameter finite, and 10 steps from the
   same init at learning rate 0.5 / T, whose loss must fall; ms per
   step, tokens/s, peak
   memory, one profiled step; one training step of the one-layer H=1536
   LM through the per-step kernels (T and T + 1 launches); the backward
   kernel's time against its bound and the plain loop, and the port's
   whole layer backward against cuDNN's LSTM backward on the same inputs,
   at T=128, N=1 and 16, and at the bench shape;
12. transformer training: (a) the attention backward kernels
   (``csrc/flash_attention_bwd.cu``) through the autograd Functions
   against the plain backward versions on the card's tensors, fp32 and
   bf16: dense at the model's (4,8,2048,64) causal, (2,3,1000,1000,64)
   non-causal, (2,2,77,200,128) causal Sq < Sk, (2,8,500,500,64) as
   (B,S,H,D) views, (1,2,77,77,40) fp32 (the CUDA-core variant) and one
   token; masked with ATT_LENGTHS and with packed segments at the model's
   shape and one fp32 case, the gradients of rows and keys the mask leaves
   alone exact 0; then the masked core's training path (a packed and a
   length-masked batch through the public ``flash_attention`` and
   ``torch.autograd.grad``); (b) one ``lm_loss`` gradient of the
   full-width LM in fp32 (B=2, S=128, ``init_params(0, cfg)``) on the card
   and on the port's CPU path, each gradient within 1e-5 of its own
   largest; (c) ``TransformerLM(TransformerConfig(), seed=0)`` on the
   default context, 10 ``train_step``s on one batch of (4, 2049) tokens
   at lr 1e-3: 4 dense forward and 4 dense backward launches a step, every
   loss and parameter finite, the loss falling; (d) ms per step (CUDA
   events, median of 7), tokens/s against the step's bound, peak memory,
   one profiled step; (e) one backward call at the model's shape, dense
   and with ATT_LENGTHS: its time, each of its three kernels', its bound,
   its plain version and ``scaled_dot_product_attention``'s autograd
   backward on the same inputs.

Each path (4 and its wide LSTM, 5, 6, 10, 11 and its wide LM, 12's masked
training path and 12c) sets its kernels' launch counts to 0 just before it
runs and reads them just after, and fails if a kernel of the path was not
launched. Its last lines are a ``{"kernels": [...]}`` JSON line, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
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
# card against the port's CPU path on the LM's probabilities
PROB_TOL = 1e-4
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


def phase_build():
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops.cuda.rtc import nvrtc_version
    t0 = time.perf_counter()
    results = _build.build()
    log(f"[build] {len(results)} libraries in "
        f"{time.perf_counter() - t0:.3f} s (wall, concurrent nvcc)")
    for name, res in results.items():
        log(f"[build] {name}: {res.path} nvcc {res.seconds:.3f} s")
        for line in res.log.strip().splitlines():
            log(f"[build]   {line}")
    log(f"[build] NVRTC {nvrtc_version()}")
    return wgmma_build_summary(results["flash_attention"].log)


def wgmma_build_summary(log_text):
    """ptxas's registers and spills for each instantiation of the Hopper
    attention kernel, any wgmma serialization it reports, and the shared
    memory a block of it takes."""
    from mxnet_tpu_torch.ops.cuda.attention import wgmma_shared_bytes
    out, current = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "flash_fwd_wgmma_kernel" in line \
                else None
        elif current and "spill stores" in line:
            out.setdefault(current, {})["spills"] = line.strip()
        elif current and "Used" in line and "registers" in line:
            out.setdefault(current, {})["registers"] = int(
                line.split("Used")[1].split("registers")[0])
    serialized = [line.strip() for line in log_text.splitlines()
                  if "wgmma" in line and "serialized" in line]
    smem = {d: wgmma_shared_bytes(d) for d in (64, 128)}
    for name, info in out.items():
        log(f"[build] wgmma kernel {name}: {info}")
    log(f"[build] wgmma kernel shared memory a block: {smem} bytes (D: "
        f"bytes); wgmma serialized: {serialized or 'none reported'}")
    if not out:
        raise RuntimeError("no wgmma kernel in the flash_attention build log")
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
    card = answers[big].reshape(T, 16, V)[:, :4].reshape(T * 4, V)
    prob_err = float(np.abs(card - cpu_out).max())
    log(f"[slice] card against CPU, 4 rows: max|d| prob {prob_err:.3e} "
        f"(tol {PROB_TOL}); largest prob {float(cpu_out.max()):.3e}")
    if not prob_err <= PROB_TOL:
        raise RuntimeError(f"card and CPU disagree: {prob_err} > {PROB_TOL}")
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


def profile_device(label, fn):
    """Device time by kernel over one call of ``fn`` and the device's idle
    share of its wall time (torch.profiler, CUPTI). Only device-side events
    (kernels, copies) are summed: a CPU op's device time repeats its
    kernels'."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [(e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == cuda and e.self_device_time_total > 0]
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
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "idle_share": 1 - busy_us / wall_us, "host_reads": host_reads,
            "top": [[k[:90], us, n] for k, us, n in events[:8]]}


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
# (T, N, H) of the training kernels' checks: the sequence kernels at the
# served shapes, at the main training path's shape (four chunks of 16 rows)
# and two ragged ones (one chunk; two whole chunks and a part), the
# per-step kernels at the wide LM's H
BWD_CASES = ((T, 1, H), (T, 16, H), (TRAIN_T, TRAIN_N, H), (7, 3, 200),
             (7, 37, 200), (8, 1, WIDE_H))
# one forward_backward of the full-width LM, card against the port's CPU
GRAD_T, GRAD_N = 8, 4
# gradients card against CPU, fp32 with TF32 off on both: summation order
# only, through 8 steps and the 10000-way softmax; each held relative to its
# own largest magnitude (on the CPU from 0.012 for embed_weight to 1.0 for
# pred_bias)
GRAD_TOL = 1e-5
CARD = "cuda"


def train_counts():
    """(lstm_sequence_fused, lstm_sequence_backward, lstm_cell_fused,
    lstm_cell_backward) launches."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    return (L.lstm_sequence_fused.launches, L.lstm_sequence_backward.launches,
            L.lstm_cell_fused.launches, L.lstm_cell_backward.launches)


def zero_train_counts():
    from mxnet_tpu_torch.ops.cuda import lstm as L
    for fn in (L.lstm_sequence_fused, L.lstm_sequence_backward,
               L.lstm_cell_fused, L.lstm_cell_backward):
        fn.launches = 0


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
    lstm_sequence_train_plain, and the backward (K2, the sequence
    backward kernel; K3, the per-step one at H=WIDE_H) against
    lstm_sequence_backward_plain on the same card tensors, fp32 and bf16,
    both directions. bf16 dw, which the kernel route sums in fp32 once and
    the plain version rounds to bf16 every step, is held to the fp32 sum
    of the plain version's dgates. Returns the worst errors by kernel."""
    from mxnet_tpu_torch.ops.cuda import lstm as L
    errs = {k: {"fp32": 0.0, "bf16_ulps": 0.0}
            for k in ("forward", "sequence_backward", "cell_backward")}
    for steps, n, hdim in BWD_CASES:
        fits = L.backward_fits(n, hdim, torch.device(CARD, 0))
        if fits != (hdim != WIDE_H):
            raise RuntimeError(f"backward_fits(N={n}, H={hdim}) = {fits}")
        kernel = "sequence_backward" if fits else "cell_backward"
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
                want_moved = (0, 1, 0, 0) if fits else (0, 0, 0, steps + 1)
                if moved != want_moved:
                    raise RuntimeError(f"backward launched {moved}, expected "
                                       f"{want_moved}")
                want = L.lstm_sequence_backward_plain(*case, reverse=reverse)
                worst = []
                for name, g, p in zip(("dxproj", "dh0", "dc0", "dw"), got,
                                      want):
                    if g.dtype != p.dtype or g.shape != p.shape:
                        raise RuntimeError(f"backward {name}: {g.dtype} "
                                           f"{tuple(g.shape)}")
                    if name == "dw" and tag == "bf16":
                        h_prev = (torch.cat([out[1:], h0[None]]) if reverse
                                  else torch.cat([h0[None], out[:-1]]))
                        p = torch.einsum("tnk,tnh->kh", want[0],
                                         h_prev.float())
                    err, tol = max_err_against(g, p, tag, name)
                    if not err <= tol:
                        raise RuntimeError(
                            f"{kernel} {tag} T={steps} N={n} H={hdim} "
                            f"reverse={reverse} {name} disagrees with the "
                            f"plain backward: {err} > {tol}")
                    worst.append(err if tag == "fp32" else 2 * err / tol)
                log(f"[train-kernels] {kernel} T={steps} N={n} H={hdim} "
                    f"{tag} reverse={reverse}: max|d| dxproj, dh0, dc0, dw "
                    + ", ".join(f"{e:.3e}" for e in worst)
                    + (" (tol 1e-4, dw relative)" if tag == "fp32"
                       else " bf16 ulps (tol 2; dw against the fp32 sum)"))
                key = "fp32" if tag == "fp32" else "bf16_ulps"
                errs[kernel][key] = max(errs[kernel][key], *worst)
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
        TRAIN_SGD, learning_rate=TRAIN_SGD["learning_rate"] / TRAIN_T))
    losses = []
    for _ in range(TRAIN_STEPS):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        losses.append(cross_entropy(mx, mod, batch))
    log(f"[train] {TRAIN_STEPS} steps on one batch at learning rate "
        f"{TRAIN_SGD['learning_rate'] / TRAIN_T}: cross-entropy "
        f"{[round(x, 5) for x in losses]}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss on the repeated batch did not fall: "
                           f"{losses}")
    return losses


def phase_train_bench():
    """The main training path at the benchmark's shape: Module on the
    default context, one fit epoch over TRAIN_BATCHES batches, then
    TRAIN_STEPS forward/backward/update steps on one batch; each step two
    sequence-kernel forwards and two sequence-kernel backwards and no
    per-step launch. Then ms per step (CUDA events, median of 7), tokens/s,
    peak memory and one profiled step."""
    import mxnet_tpu_torch as mx
    net = build_lm(mx, V, H, LAYERS, TRAIN_T, train=True)
    rng = np.random.RandomState(0)
    shape = (TRAIN_BATCHES * TRAIN_N, TRAIN_T)
    data = rng.randint(0, V, shape).astype(np.float32)
    label = rng.randint(0, V, shape).astype(np.float32)
    batch = mx.io.DataBatch([mx.nd.array(data[:TRAIN_N], ctx=mx.cpu())],
                            [mx.nd.array(label[:TRAIN_N], ctx=mx.cpu())])
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
                for m, prev in zip(marks, [(0, 0, 0, 0)] + marks[:-1])]
    log(f"[train] LM V={V} H={H} layers={LAYERS} N={TRAIN_N} T={TRAIN_T}: "
        f"fit over {TRAIN_BATCHES} batches, cross-entropy "
        f"{fit_metric.get()[1]:.4f}; {TRAIN_STEPS} steps on one batch at "
        f"{TRAIN_SGD}, cross-entropy {[round(x, 4) for x in losses]}")
    log(f"[train] (lstm_sequence, lstm_sequence_backward, lstm_cell, "
        f"lstm_cell_backward) launches per step {per_step}; total "
        f"{launches}; peak device memory {peak} bytes")
    if any(c != (LAYERS, LAYERS, 0, 0) for c in per_step):
        raise RuntimeError(f"launches per step {per_step}, expected "
                           f"{(LAYERS, LAYERS, 0, 0)}")
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
        f"(lstm_sequence, lstm_sequence_backward, lstm_cell, "
        f"lstm_cell_backward) launches {launches}")
    if launches != (0, 0, T, T + 1):
        raise RuntimeError(f"wide training step launched {launches}, "
                           f"expected {(0, 0, T, T + 1)}")
    for name, arr in mod.get_params()[0].items():
        if not bool(torch.isfinite(arr._data).all()):
            raise RuntimeError(f"wide LM parameter {name} not finite")
    return launches[3]


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


def phase_train_timing():
    """The backward of one LSTM layer (H=1024, fp32) at T=128, N=1 and 16,
    and at the bench shape: the sequence backward kernel, the kernel route with
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
        def kernel_only():
            L._sequence_backward_launch(dout, dh_last, dc_last, gates, cs, h0,
                                        c0, w, False)

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
            "kernel_ms": time_on_stream(kernel_only, iters=10),
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
        log(f"[train-timing] one layer's backward T={steps} N={n} H={H} "
            f"fp32: sequence backward kernel {row['kernel_ms'] * 1e3:.1f} "
            f"us, bound {row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} "
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


def train_records(kerrs, grad_errs, bench, wide_launches, timing):
    """The lstm_sequence_backward and lstm_cell_backward entries of the
    kernels line."""
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
        "launches": bench["launches"][1],
        "max_abs_err": kerrs["sequence_backward"]["fp32"],
        "ms": main["kernel_ms"],
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
        "max_err_bf16_ulps": kerrs["sequence_backward"]["bf16_ulps"],
        "training_forward_max_err": kerrs["forward"],
        "share_of_bound": main["share_of_bound"],
        "by_shape": timing,
        "train": {k: bench[k] for k in (
            "per_step", "losses", "descent_losses", "fit_cross_entropy",
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


def rtc_record(rtc_k, imp):
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
# packed segments (pad tokens), and one fp32 masked case
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
]
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


def attention_counts():
    """(dense, masked, dense backward, masked backward) launches."""
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention as fa
    return (fa.launches, fa.masked_launches, fa.backward_launches,
            fa.masked_backward_launches)


def zero_attention_counts():
    from mxnet_tpu_torch.ops.cuda.attention import flash_attention as fa
    for name in ("launches", "masked_launches", "wgmma_launches",
                 "backward_launches", "masked_backward_launches",
                 "mma_backward_launches"):
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
    card tensors; the route each takes (the mma.sync variant for bf16 at
    D = 64 or 128 over aligned views); rows that see no key with dq exact
    0 and keys no row sees with dk and dv exact 0. Then the masked core's
    training path: a packed and a length-masked batch through the public
    flash_attention, differentiated by torch.autograd.grad, as a caller
    training on packed rows does. Returns the worst errors by kernel, and
    the masked path's launches."""
    from mxnet_tpu_torch.ops.cuda.attention import (
        _combined_mask, attention_backward_plain, flash_attention,
        masked_attention_backward_plain)
    errs = {name: {"fp32_rel": 0.0, "bf16_rel": 0.0, "max_abs": 0.0}
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
        before = (attention_counts(), flash_attention.mma_backward_launches)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        moved = (tuple(a - c for a, c in zip(attention_counts(), before[0])),
                 flash_attention.mma_backward_launches - before[1])
        mma = dtype == torch.bfloat16 and d in (64, 128)
        if moved != ((0, 0, int(not masked), int(masked)), int(mma)):
            raise RuntimeError(f"{name} {label}: the counters moved {moved}")
        if masked:
            want = masked_attention_backward_plain(q, k, v, do, lens, seg,
                                                   causal=causal)
        else:
            want = attention_backward_plain(q, k, v, out.detach(), do,
                                            causal=causal)
        tol = ATT_BWD_FP32_TOL if dtype == torch.float32 else ATT_BWD_BF16_TOL
        rel = []
        for gname, g, w in zip(("dq", "dk", "dv"), grads, want):
            if g.dtype != dtype or g.shape != w.shape:
                raise RuntimeError(f"{name} {label} {gname}: {g.dtype} "
                                   f"{tuple(g.shape)}")
            diff = (g.float() - w.float()).abs().max().item()
            rel.append(diff / max(ATT_BWD_FLOOR,
                                  w.float().abs().max().item()))
            errs[name]["max_abs"] = max(errs[name]["max_abs"], diff)
            if not rel[-1] <= tol:
                raise RuntimeError(f"{name} {label} {gname} disagrees with "
                                   f"the plain backward: {rel[-1]} > {tol}")
        key = "fp32_rel" if dtype == torch.float32 else "bf16_rel"
        errs[name][key] = max(errs[name][key], *rel)
        dead = ""
        if masked:
            mask = _combined_mask(sq, sk, causal, lens, seg, q.device)
            mask = mask.expand(b, h, sq, sk)
            dead_q, dead_k = ~mask.any(-1), ~mask.any(-2)
            if not (bool(dead_q.any())
                    and bool((grads[0][dead_q] == 0).all())
                    and bool((grads[1][dead_k] == 0).all())
                    and bool((grads[2][dead_k] == 0).all())):
                raise RuntimeError(f"{name} {label}: the gradients of rows "
                                   "and keys the mask leaves alone are not "
                                   "exact 0")
            if lengths is not None and lengths[-1] == 0 and not all(
                    bool((g[-1] == 0).all()) for g in grads):
                raise RuntimeError(f"{name} {label}: the length-0 batch's "
                                   "gradients are not exact 0")
            dead = (f"; {int(dead_q.sum())} rows and {int(dead_k.sum())} "
                    "keys unseen, their gradients exact 0")
        log(f"[train-attention] {name} {label} {shape} {str(dtype)[6:]}"
            f"{' (mma.sync)' if mma else ' (CUDA cores)'}: dq, dk, dv "
            f"max|d| / max|plain| "
            + ", ".join(f"{e:.3e}" for e in rel) + f" (tol {tol}){dead}")

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
    log(f"[train-attention] masked training path, packed and length-masked "
        f"batches {ATT_SHAPE} bf16: (dense, masked, dense backward, masked "
        f"backward) launches {path}")
    if path != (0, 2, 0, 2):
        raise RuntimeError(f"the masked training path launched {path}")
    if not all(bool(torch.isfinite(g).all()) for gs in grads for g in gs):
        raise RuntimeError("non-finite masked gradients")
    return errs, path[3]


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
    losses, per_step, prev = [], [], attention_counts()
    for _ in range(TF_TRAIN_STEPS):
        losses.append(lm.train_step(toks, lr=TF_TRAIN_LR))
        now = attention_counts()
        per_step.append(tuple(a - c for a, c in zip(now, prev)))
        prev = now
    launches = attention_counts()  # the main path's run ends here
    peak = torch.cuda.max_memory_allocated()
    want = (cfg.num_layers, 0, cfg.num_layers, 0)
    log(f"[train-tf] TransformerLM {cfg.vocab_size} vocab, "
        f"{cfg.num_layers} x {cfg.d_model}, {cfg.dtype}, tokens "
        f"{tuple(toks.shape)}: {TF_TRAIN_STEPS} train_steps at lr "
        f"{TF_TRAIN_LR}, loss {losses}; (dense, masked, dense backward, "
        f"masked backward) launches per step {per_step[0]}, total "
        f"{launches}; peak device memory {peak} bytes")
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
    return {"launches": launches, "per_step": per_step[0], "losses": losses,
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
    """(e) One backward call (K0, K1, K2) at the transformer's shape, bf16
    causal, dense and with ATT_LENGTHS: CUDA events over back-to-back
    calls; each kernel's device time from the profiler; its bound, the
    plain version and the library's backward: the autograd backward of
    scaled_dot_product_attention on the same inputs (is_causal, or the
    mask as a bool tensor), timed only."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda.attention import (
        _backward_launch, _combined_mask, attention_backward_plain,
        attention_plain, masked_attention_backward_plain,
        masked_attention_plain)
    b, h, s, d = ATT_SHAPE
    scale = 1.0 / d ** 0.5
    q, k, v, do = attention_grad_inputs(b, h, s, s, d, torch.bfloat16,
                                        seed=401)
    lens = torch.tensor(ATT_LENGTHS, dtype=torch.int32, device=CARD)
    mask = _combined_mask(s, s, True, lens, None, q.device)
    out = attention_plain(q, k, v, causal=True)
    out_len = masked_attention_plain(q, k, v, lens, causal=True)
    rows = {}
    for name, kernel, plain, sdpa_kw, live in (
            ("flash_attention_backward",
             lambda: _backward_launch(q, k, v, out, do, True, scale, None,
                                      None),
             lambda: attention_backward_plain(q, k, v, out, do, causal=True),
             {"is_causal": True}, b * h * s * (s + 1) // 2),
            ("flash_attention_masked_backward",
             lambda: _backward_launch(q, k, v, out_len, do, True, scale,
                                      lens, None),
             lambda: masked_attention_backward_plain(q, k, v, do, lens,
                                                     causal=True),
             {"attn_mask": mask}, h * int(mask.sum().item()))):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves, **sdpa_kw)

        def library():
            return torch.autograd.grad(y, leaves, do, retain_graph=True)

        turns = {"kernel": [], "library": []}
        for turn in ("kernel", "library", "library", "kernel"):
            turns[turn].append(time_on_stream(
                kernel if turn == "kernel" else library, iters=20))
        row = {"kernel_ms": statistics.mean(turns["kernel"]),
               "kernel_turns_ms": turns["kernel"],
               "library_ms": statistics.mean(turns["library"]),
               "library_turns_ms": turns["library"],
               "plain_ms": time_on_stream(plain, iters=3),
               "live_pairs": live}
        row["bound_ms"], row["bound_by"] = attention_backward_bound_ms(
            live, b, h, s, s, d, 2)
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        row["tflops"] = 10 * d * live / row["kernel_ms"] / 1e9
        prof = profile_device(f"10 backward calls, {name}",
                              lambda: [kernel() for _ in range(10)])
        # device us per launch of each kernel, over the launches the
        # profiler recorded (it may drop a record of a window)
        row["stages_us"] = {
            stage: sum(us for key, us, _ in prof["top"] if tag in key)
            / max(1, sum(n for key, _, n in prof["top"] if tag in key))
            for stage, tag in (("K0 prep", "flash_bwd_prep"),
                               ("K1 dk dv", "flash_bwd_dkdv"),
                               ("K2 dq", "flash_bwd_dq"))}
        rows[name] = row
        log(f"[train-timing] {name} {ATT_SHAPE} bf16 causal"
            f"{' lengths=' + str(ATT_LENGTHS) if 'masked' in name else ''}: "
            f"kernels {row['kernel_ms'] * 1e3:.3f} us a call (turns "
            f"{[round(t * 1e3, 3) for t in turns['kernel']]}; by stage "
            f"{ {k: round(u, 3) for k, u in row['stages_us'].items()} } us), "
            f"{row['tflops']:.2f} TFLOP/s on {live} live pairs, bound "
            f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} (share "
            f"{row['share_of_bound']:.4f}); plain {row['plain_ms'] * 1e3:.1f}"
            f" us; scaled_dot_product_attention's autograd backward "
            f"(library) {row['library_ms'] * 1e3:.3f} us (turns "
            f"{[round(t * 1e3, 3) for t in turns['library']]})")
    return rows


def attention_backward_records(kerrs, masked_path_launches, tf_train,
                               timing):
    """The flash_attention_backward and flash_attention_masked_backward
    entries of the kernels line."""
    records = []
    for name, line, launches, path in (
            ("flash_attention_backward", 158, tf_train["launches"][2],
             f"{TF_TRAIN_STEPS} train_steps of the transformer LM "
             "(phase 12c)"),
            ("flash_attention_masked_backward", 261, masked_path_launches,
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
            "share_of_bound": t["share_of_bound"],
            "tflops": t["tflops"],
            "live_pairs": t["live_pairs"],
            "stages_us": t["stages_us"],
            "kernel_turns_ms": t["kernel_turns_ms"],
            "library_turns_ms": t["library_turns_ms"],
        })
    records[0]["transformer_training"] = tf_train
    return records


def main():
    phase_device()
    wgmma_build = phase_build()
    errs = phase_kernels()
    seq_errs = phase_sequence_kernel()
    att_errs = phase_attention_kernels()
    backend, requests, launches, peak, prob_err = phase_slice()
    wide_launches, wide_prob_err = phase_wide_lstm()
    tf = phase_transformer()
    masked_launches, masked_wgmma = phase_masked_path()
    cells, forward = phase_timing(backend, requests)
    seq = phase_sequence_timing()
    att = phase_attention_timing()
    tf_timing = phase_transformer_timing(tf)
    profiled = phase_profile(backend, requests)
    tf_profiled = phase_transformer_profile(tf)
    rtc_k = phase_rtc_kernels()
    imp = phase_imperative()
    train_kerrs = phase_train_kernels()
    grad_errs = phase_train_card_vs_cpu()
    bench = phase_train_bench()
    wide_train_launches = phase_train_wide()
    train_timing = phase_train_timing()
    att_bwd_errs, masked_bwd_launches = phase_attention_backward_kernels()
    tf_grads = phase_tf_train_card_vs_cpu()
    tf_train = phase_tf_train()
    tf_train["gradients_card_vs_cpu"] = tf_grads
    att_bwd_timing = phase_attention_backward_timing()
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
        records.append(record)
    records.append(rtc_record(rtc_k, imp))
    records += train_records(train_kerrs, grad_errs, bench,
                             wide_train_launches, train_timing)
    records += attention_backward_records(att_bwd_errs, masked_bwd_launches,
                                          tf_train, att_bwd_timing)
    print(json.dumps({"kernels": records}), flush=True)
    print(nvidia_smi_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

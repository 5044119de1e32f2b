#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It exits non-zero, and prints no result line, when there is no CUDA card or
no ``mxnet_tpu_torch`` package beside it. Every failure raises. Phases:

1. device: the card's name, capability, name and power limit; TF32 off;
2. build: every kernel library built from ``mxnet_tpu_torch/csrc`` by
   concurrent ``nvcc`` processes, with ``-Xptxas -v`` output;
3. kernels: each kernel's wrapper on the card against its plain PyTorch
   version at the main path's shapes and a ragged one;
4. slice: the 2x1024 LSTM language model (V=10000, T=128, random weights
   from a seed) behind ``PredictorBackend(dev_type=2)`` answers 8 requests
   of 1 and 16 rows; launch counts are reset just before and read just
   after, and one request is answered again on the CPU for comparison;
5. timing: each kernel, its plain version and the nearest PyTorch library
   call with CUDA events; Predictor forward time and tokens/s; peak memory;
6. profile: device time by kernel over one forward per bucket, and the
   device's idle share of it.

Its last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import time

import numpy as np
import torch

# fp32 tolerance: only the summation order differs from the plain version
FP32_TOL = 2e-5
# bf16 tolerance, compared in bf16: two bf16 ulps at 1.0
BF16_TOL = 1.6e-2
# card against the port's CPU path on the LM's probabilities
PROB_TOL = 1e-4
# published H100 SXM peaks (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

V, H, LAYERS, T = 10000, 1024, 2, 128
BUCKETS = (1, 16)


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
    t0 = time.perf_counter()
    results = _build.build()
    log(f"[build] {len(results)} libraries in "
        f"{time.perf_counter() - t0:.3f} s (wall, concurrent nvcc)")
    for name, res in results.items():
        log(f"[build] {name}: {res.path} nvcc {res.seconds:.3f} s")
        for line in res.log.strip().splitlines():
            log(f"[build]   {line}")


def cell_inputs(n, hdim, dtype, seed):
    """LSTM-cell inputs at the LM's scale: |h|, |c| < 1 as a cell's state
    is, weights uniform +-0.05 as the smoke's model draws them."""
    rng = np.random.RandomState(seed)
    arrays = (rng.normal(0, 1, (n, 4 * hdim)),
              rng.uniform(-1, 1, (n, hdim)),
              rng.uniform(-1, 1, (n, hdim)),
              rng.uniform(-0.05, 0.05, (4 * hdim, hdim)))
    return [torch.tensor(a, dtype=dtype, device="cuda") for a in arrays]


def phase_kernels():
    from mxnet_tpu_torch.ops.cuda.lstm import lstm_cell_fused, lstm_cell_plain
    errs = {"fp32": 0.0, "bf16": 0.0}
    for n, hdim in ((1, 1024), (16, 1024), (3, 200)):
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
            errs[tag] = max(errs[tag], err)
    return errs


def build_lm(mx, vocab, hidden, layers, seq_len):
    """bench_lstm.py's model, with an un-reshaped softmax_label."""
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
    return mx.sym.SoftmaxOutput(pred, mx.sym.var("softmax_label"),
                                name="softmax")


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
    from mxnet_tpu_torch.ops.cuda.lstm import lstm_cell_fused
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
    lstm_cell_fused.launches = 0  # the main path's run starts here
    backend = PredictorBackend(symbol_json, param_bytes, row_shape=(T,),
                               dev_type=2)
    backend.load()
    per_forward = []
    for rows in BUCKETS:
        before = lstm_cell_fused.launches
        backend.bind_bucket(rows)  # binds and runs one forward
        per_forward.append(lstm_cell_fused.launches - before)
    answers = []
    for batch in requests:
        before = lstm_cell_fused.launches
        (out,) = backend.infer({"data": batch})
        per_forward.append(lstm_cell_fused.launches - before)
        check_probs(out, batch.shape[0])
        answers.append(out)
    launches = lstm_cell_fused.launches  # the main path's run ends here
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] {len(requests)} requests answered; lstm_cell launches per "
        f"forward {per_forward}; total {launches}; peak device memory "
        f"{peak} bytes")
    if any(n != LAYERS * T for n in per_forward):
        raise RuntimeError(f"lstm_cell launched {per_forward} times per "
                           f"forward, expected {LAYERS * T}")

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
    for n in BUCKETS:
        xproj, h, c, w = cell_inputs(n, H, torch.float32, seed=7 + n)
        row = {
            "kernel_ms": time_on_stream(lambda: lstm_cell_fused(xproj, h, c, w)),
            "plain_ms": time_on_stream(lambda: lstm_cell_plain(xproj, h, c, w)),
            "library_ms": time_on_stream(lambda: torch.addmm(xproj, h, w.t())),
        }
        row["bound_ms"], row["bound_by"] = cell_bound_ms(n, H, 4)
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        cells[n] = row
        log(f"[timing] lstm_cell N={n} H={H} fp32: kernel "
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


def phase_profile(backend, requests):
    """Device time by kernel over one forward per bucket, and the device's
    idle share of that forward's wall time (torch.profiler, CUPTI). Only
    device-side events (kernels, copies) are summed: a CPU op's device time
    repeats its kernels'."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for rows in BUCKETS:
        batch = next(r for r in requests if r.shape[0] == rows)
        pred = backend.bind_bucket(rows)
        pred.set_input("data", memoryview(batch.reshape(-1)), batch.shape)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pred.forward()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [(e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == cuda and e.self_device_time_total > 0]
        events.sort(key=lambda k: -k[1])
        busy_us = sum(k[1] for k in events)
        if not busy_us:
            raise RuntimeError("the profiler recorded no device time")
        log(f"[profile] one {rows}-row forward under the profiler: wall "
            f"{wall_us:.1f} us, device busy {busy_us:.1f} us, idle share "
            f"{1 - busy_us / wall_us:.4f}")
        for key, us, count in events[:8]:
            log(f"[profile]   {us:12.1f} us  x{count:<5d} {key[:90]}")
        out[str(rows)] = {"wall_us": wall_us, "device_busy_us": busy_us,
                          "idle_share": 1 - busy_us / wall_us,
                          "top": [[k[:90], us, n] for k, us, n in events[:8]]}
    return out


def main():
    phase_device()
    phase_build()
    errs = phase_kernels()
    backend, requests, launches, peak, prob_err = phase_slice()
    cells, forward = phase_timing(backend, requests)
    profiled = phase_profile(backend, requests)
    main_n = max(BUCKETS)
    cell = cells[main_n]
    record = {
        "name": "lstm_cell",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/lstm_cell.cu",
        "replaces": "mxnet_tpu/ops/pallas/lstm.py:43",
        "launches": launches,
        "max_abs_err": errs["fp32"],
        "ms": cell["kernel_ms"],
        "plain_ms": cell["plain_ms"],
        "bound_ms": cell["bound_ms"],
        "bound_by": cell["bound_by"],
        "library_ms": cell["library_ms"],
        "shape": f"N={main_n} H={H} fp32",
        "max_err_fp32": errs["fp32"],
        "max_err_bf16": errs["bf16"],
        "kernel_us": cell["kernel_ms"] * 1e3,
        "plain_us": cell["plain_ms"] * 1e3,
        "library_us": cell["library_ms"] * 1e3,
        "bound_us": cell["bound_ms"] * 1e3,
        "by_rows": {str(n): c for n, c in cells.items()},
        "predictor": {str(n): f for n, f in forward.items()},
        "prob_err_card_vs_cpu": prob_err,
        "peak_device_bytes": peak,
        "profile": profiled,
    }
    print(json.dumps({"kernels": [record]}), flush=True)
    print(nvidia_smi_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Probe the LSTM backward's launch, and build its probe variants.

Run from the root of a checkout on a machine with an H100:

    python3 tools/probe_lstm_bwd.py launch-check

builds a small kernel (a block of 288 threads, 200 KB of dynamic shared
memory, a cluster barrier and four grid barriers on an arrival counter,
each spin bounded by a time-out) and launches it with
``cudaLaunchKernelExC`` and both ``cudaLaunchAttributeClusterDimension``
and ``cudaLaunchAttributeCooperative``, on C x the clusters that
``cudaOccupancyMaxActiveClusters`` says can be resident, for C = 1, 2, 4
and 8. For each C it prints the resident clusters, whether the launch
was taken (or CUDA's error), whether every grid barrier completed, and
the SMs the blocks ran on. Such a launch is what copies of the backward's
dgates tiles multicast across a cluster would need; the backward kernel
does without them (they measured slower; ``PERF.md``).

    python3 tools/probe_lstm_bwd.py bench-lr

trains the 2 x 1024 LSTM LM as ``chip_smoke.py`` phase 11 does (seeded
Xavier, a ``fit`` epoch of 4 batches and 10 steps on one batch at the
benchmark's learning rate 0.5, N=64, T=256; ``chip_smoke.bench_lr_run``)
three times, with the backward's recurrence through the register kernel,
the shared-memory kernel and the plain loop on the card, and prints
each step's loss and the largest gradient and parameter magnitudes: where
the three agree and where the run diverges.

    python3 tools/probe_lstm_bwd.py handoff

runs that training through the plain backward on the card for its fit
epoch and 6 steps, then hands each later step's state (to step 10) to the
backward kernels and to the plain backward, after one forward: it prints
each route's non-finite gradients, largest gradient magnitudes and their
difference, and updates with the plain backward's gradients. A step where
only the kernels' gradients are non-finite would be a fault of the
kernels.

``build_probe(p)`` builds ``csrc/lstm_cell.cu`` with ``-DMXT_BWD_PROBE=p``
and the package's flags into ``build/probe_lstm_bwd/``, named by the hash
that names the package's build of the source and by p, so a build is
reused until the source, its headers or the flags change: the register
backward kernel without its products (p = 1) or without its dgates copies
(p = 2), wrong on purpose, for timing each part. ``load_probe(p)`` loads
it and ``probe_backward(lib, ...)`` launches its register kernel as
``ops/cuda/lstm.py:_sequence_backward_launch`` launches the package's;
``chip_smoke.py`` phase 11 times them beside the kernel (``BWD_TIMED``).
"""
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "probe_lstm_bwd"

LAUNCH_CHECK_SRC = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(288, 1)
    probe_kernel(unsigned* counter, int* out, long long timeout) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned rank, nrank, smid;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(nrank));
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  smem[threadIdx.x] = 1;
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  int ok = 1;
  for (int s = 0; s < 4; ++s) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(counter, 1u);
      const long long start = clock64();
      unsigned seen;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(seen) : "l"(counter) : "memory");
        if (clock64() - start > timeout) { ok = 0; break; }
      } while (seen < (s + 1) * gridDim.x);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[3 * blockIdx.x] = ok;
    out[3 * blockIdx.x + 1] = static_cast<int>(rank | (nrank << 8));
    out[3 * blockIdx.x + 2] = static_cast<int>(smid);
  }
}

extern "C" int max_clusters(int cluster, int smem, int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(288);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      n, reinterpret_cast<const void*>(probe_kernel), &cfg));
}

extern "C" int launch(int cluster, int blocks, int smem, int cooperative,
                      void* counter, void* out, long long timeout) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(288);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[2];
  int n = 0;
  attr[n].id = cudaLaunchAttributeClusterDimension;
  attr[n].val.clusterDim.x = cluster;
  attr[n].val.clusterDim.y = 1;
  attr[n].val.clusterDim.z = 1;
  ++n;
  if (cooperative) {
    attr[n].id = cudaLaunchAttributeCooperative;
    attr[n].val.cooperative = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  void* args[] = {&counter, &out, &timeout};
  cudaError_t err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(probe_kernel), args);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


# MXT_BWD_PROBE values of the probe builds: what each skips
PROBES = {1: "no_product", 2: "no_copy"}
# ``handoff``: the bench-lr steps through the plain backward on the card up
# to this one; each later step's backward runs through both routes
HANDOFF_FROM = 6


def probe_library_path(probe):
    """Where the build of csrc/lstm_cell.cu with -DMXT_BWD_PROBE=probe
    goes: the hash of ``_build.library_path("lstm_cell")`` (the source,
    the headers it includes and the flags) and the probe in its name."""
    from mxnet_tpu_torch import _build
    digest = _build.library_path("lstm_cell").stem.rsplit("-", 1)[1]
    return OUT / f"liblstm_cell_probe{probe}-{digest}.so"


def build_probe(probe):
    """The path of csrc/lstm_cell.cu built with -DMXT_BWD_PROBE=probe,
    built now unless it is already."""
    from mxnet_tpu_torch import _build
    lib = probe_library_path(probe)
    if lib.exists():
        return lib
    OUT.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DMXT_BWD_PROBE={probe}",
           "-o", str(tmp), str(_build.CSRC / _build.SOURCES["lstm_cell"])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"probe build {PROBES[probe]} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_probe(probe):
    """The probe build ``probe`` (built first if needed), loaded, with the
    argument types of its ``lstm_sequence_backward``."""
    lib = ctypes.CDLL(str(build_probe(probe)))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.lstm_sequence_backward.argtypes = [c_ptr] * 11 + [c_int] * 8 + [
        c_ptr] * 2
    lib.lstm_sequence_backward.restype = c_int
    lib.lstm_cell_error_string.argtypes = [c_int]
    lib.lstm_cell_error_string.restype = ctypes.c_char_p
    return lib


def probe_backward(lib, dout, dh_last, dc_last, gates, cs, h0, c0, w_h2h,
                   reverse=False):
    """One launch of a probe build's register kernel (``lib`` from
    :func:`load_probe`) on the card's tensors, as the package's
    ``_sequence_backward_launch(..., variant="register")`` makes it:
    (dgates, dh0, dc0), wrong on purpose. Counted nowhere."""
    import torch

    from mxnet_tpu_torch.ops.cuda import lstm as L
    steps, n, hdim = cs.shape
    dgates = torch.empty_like(gates)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    scratch = torch.zeros(n, dtype=torch.int32, device=h0.device)
    plan = (ctypes.c_int * len(L.BackwardPlan._fields))()
    register = 2  # the library's variant number of the register kernel
    with torch.cuda.device(h0.device):
        err = lib.lstm_sequence_backward(
            dout.data_ptr(), dh_last.data_ptr(), dc_last.data_ptr(),
            gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), w_h2h.data_ptr(),
            dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            scratch.data_ptr(), steps, n, hdim, L._KERNEL_DTYPES[h0.dtype],
            0, int(reverse), register, L._sm_count(h0.device),
            ctypes.addressof(plan), L._stream(h0.device))
    if err != 0 or plan[0] != register:
        raise RuntimeError(
            f"probe launch: {lib.lstm_cell_error_string(err).decode()} "
            f"({err}), variant taken {plan[0]}")
    return dgates, dh0, dc0


def nvidia_smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def launch_check():
    import torch
    from mxnet_tpu_torch import _build
    if not torch.cuda.is_available():
        raise SystemExit("probe_lstm_bwd: needs a CUDA card")
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / "launch_check.cu", OUT / "liblaunch_check.so"
    src.write_text(LAUNCH_CHECK_SRC)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)], capture_output=True,
                          text=True)
    print(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit("launch check does not build")
    lib = ctypes.CDLL(str(lib_path))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.max_clusters.argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
    lib.launch.argtypes = [c_int] * 4 + [c_ptr, c_ptr, ctypes.c_longlong]
    lib.error_string.argtypes = [c_int]
    lib.error_string.restype = ctypes.c_char_p
    smem = 200 * 1024
    timeout = 2_000_000_000  # clocks, about a second
    results = {}
    for cluster in (1, 2, 4, 8):
        n = c_int(0)
        err = lib.max_clusters(cluster, smem, ctypes.byref(n))
        row = {"max_active_clusters": n.value,
               "occupancy_error": lib.error_string(err).decode()}
        blocks = cluster * n.value
        row["blocks"] = blocks
        for cooperative in (1, 0):
            key = "cooperative" if cooperative else "cluster_only"
            if blocks < 1:
                row[key] = "no resident cluster"
                continue
            counter = torch.zeros(1, dtype=torch.int32, device="cuda")
            out = torch.full((3 * blocks,), -1, dtype=torch.int32,
                             device="cuda")
            err = lib.launch(cluster, blocks, smem, cooperative,
                             counter.data_ptr(), out.data_ptr(), timeout)
            torch.cuda.synchronize()
            if err != 0:
                row[key] = f"refused: {lib.error_string(err).decode()} ({err})"
                continue
            o = out.view(blocks, 3).cpu()
            row[key] = {
                "barriers_completed": bool((o[:, 0] == 1).all()),
                "ranks_seen": sorted({int(v) & 255 for v in o[:, 1]}),
                "cluster_size_seen": sorted({int(v) >> 8 for v in o[:, 1]}),
                "distinct_sms": len({int(v) for v in o[:, 2]}),
            }
        results[cluster] = row
        print(f"cluster {cluster}: {json.dumps(row)}", flush=True)
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda)
    print(nvidia_smi())
    return results


def bench_lr():
    import torch

    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda import lstm as L
    if not torch.cuda.is_available():
        raise SystemExit("probe_lstm_bwd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_route = L.lstm_sequence_backward

    def route(name):
        def backward(dout, dh_last, dc_last, gates, cs_, out, h0, c0, w,
                     reverse=False):
            dout, dh_last, dc_last = (x.to(h0.dtype).contiguous()
                                      for x in (dout, dh_last, dc_last))
            if name == "plain":
                return L.lstm_sequence_backward_plain(
                    dout, dh_last, dc_last, gates, cs_, out, h0, c0, w,
                    reverse)
            dg, dh0, dc0 = L._sequence_backward_launch(
                dout, dh_last, dc_last, gates, cs_, h0, c0, w, reverse,
                name)
            return dg, dh0, dc0, L._dw_product(dg, out, h0, w, reverse)
        # the launch counts the wrapper it replaces keeps
        backward.launches = backward.register_launches = 0
        return backward

    def report(step, loss, mod):
        grads = {k: f"{float(v._data.abs().max()):.3g}"
                 for k, v in mod._exec.grad_dict.items()}
        params = {k: f"{float(v._data.abs().max()):.3g}"
                  for k, v in mod.get_params()[0].items()}
        print(f"  {step + 1} {loss:.4f} {grads} {params}", flush=True)

    net = cs.build_lm(mx, cs.V, cs.H, cs.LAYERS, cs.TRAIN_T, train=True)
    data, label, batch = cs.train_data(mx)
    try:
        for name in ("register", "shared", "plain"):
            L.lstm_sequence_backward = route(name)
            print(f"{name}: step, loss, max |gradient|, max |parameter| "
                  "after the update", flush=True)
            cs.bench_lr_run(mx, net, data, label, batch, cs.TRAIN_STEPS,
                            on_step=report)
    finally:
        L.lstm_sequence_backward = kernel_route
    print(nvidia_smi())


def handoff():
    import torch

    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    if not torch.cuda.is_available():
        raise SystemExit("probe_lstm_bwd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    net = cs.build_lm(mx, cs.V, cs.H, cs.LAYERS, cs.TRAIN_T, train=True)
    data, label, batch = cs.train_data(mx)
    state = {}

    def keep(step, loss, mod):
        state["mod"] = mod

    with cs.plain_backward_on_card():
        cs.bench_lr_run(mx, net, data, label, batch, HANDOFF_FROM,
                        on_step=keep)
    mod = state["mod"]
    grads = mod._exec.grad_dict
    rows = []
    for step in range(HANDOFF_FROM + 1, cs.TRAIN_STEPS + 1):
        params = [v._data for v in mod.get_params()[0].values()]
        mod.forward(batch, is_train=True)
        by_route = {}
        for route in ("kernel", "plain"):
            if route == "kernel":
                mod.backward()
            else:
                with cs.plain_backward_on_card():
                    mod.backward()
            by_route[route] = {n: g._data.clone() for n, g in grads.items()}
        row = {"step": step,
               "params_finite": all(bool(torch.isfinite(p).all())
                                    for p in params),
               "loss": cs.cross_entropy(mx, mod, batch)}
        for route, g in by_route.items():
            row[f"{route}_non_finite"] = [
                n for n, v in g.items() if not bool(torch.isfinite(v).all())]
            row[f"{route}_max_abs"] = {
                n: float(v.abs().max()) for n, v in g.items()}
        row["kernel_vs_plain_rel"] = {
            n: float((by_route["kernel"][n] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30))
            for n, v in by_route["plain"].items()}
        rows.append(row)
        print(json.dumps(row), flush=True)
        mod.update()  # the plain backward's gradients, the last written
    faults = [r["step"] for r in rows
              if r["kernel_non_finite"] and not r["plain_non_finite"]]
    print(json.dumps({"handoff_from_step": HANDOFF_FROM,
                      "steps_where_only_the_kernel_is_non_finite": faults}))
    print(nvidia_smi())


def main():
    what = sys.argv[1] if len(sys.argv) > 1 else "launch-check"
    if what == "launch-check":
        launch_check()
    elif what == "bench-lr":
        bench_lr()
    elif what == "handoff":
        handoff()
    else:
        raise SystemExit(f"probe_lstm_bwd: unknown mode {what!r}")


if __name__ == "__main__":
    main()

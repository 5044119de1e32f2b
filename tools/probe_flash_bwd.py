#!/usr/bin/env python3
"""Time variants of the Hopper attention backward side by side on one card.

Run from the root of a checkout on a machine with an H100:

    python3 tools/probe_flash_bwd.py

Each variant is ``csrc/flash_attention_bwd.cu`` with a few lines edited,
built by ``nvcc`` into ``build/probe_flash_bwd/`` with the package's own
flags and loaded in place of the library; all are timed at the
transformer's attention shape, (4, 8, 2048, 64) bf16 causal, with CUDA
events over 20 back-to-back calls, in three rounds that alternate the
order. Variants that skip work compute wrong gradients on purpose: they
only show what that work costs. ``base`` is the source as it stands;
``no_reduce`` drops the bulk reduce-add of dQ's partial sums;
``stages2`` and ``stages4`` change the ring of query tiles. Prints each
variant's mean and its rounds, the card's name and power limit, and the
base's three kernels' device times from the profiler.
"""
import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "base": [],
    "no_reduce": [("    add_dq(m, 0);\n", "\n")],
    "stages2": [("kBwdStages = 3;", "kBwdStages = 2;")],
    "stages4": [("kBwdStages = 3;", "kBwdStages = 4;")],
}
SHAPE = (4, 8, 2048, 64)


def build(name, edits):
    from mxnet_tpu_torch import _build
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    out = ROOT / "build" / "probe_flash_bwd"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    lib = out / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(lib), str(out / f"{name}.cu"),
           *_build.link_flags("flash_attention_bwd")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"variant {name} does not build:\n{proc.stderr}")
    return name, lib


def main():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops.cuda import attention as A
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash_bwd: needs a CUDA card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = {name: ctypes.CDLL(str(lib)) for name, lib in
                pool.map(lambda kv: build(*kv), VARIANTS.items())}
    _build.build(["flash_attention"])
    b, h, s, d = SHAPE
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.tensor(rng.normal(0, 1, SHAPE), dtype=torch.bfloat16,
                                device="cuda") for _ in range(4))
    lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    out = A._launch(q, k, v, True, d ** -0.5, None, None, lse=lse)

    def run(name):
        _build._LOADED["flash_attention_bwd"] = libs[name]
        return A._backward_launch(q, k, v, out, do, True, d ** -0.5, None,
                                  None, lse)

    def ms(name, iters=20):
        run(name)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run(name)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    names = list(VARIANTS)
    rounds = {name: [] for name in names}
    for r in range(3):
        for name in names if r % 2 == 0 else names[::-1]:
            rounds[name].append(ms(name) * 1e3)
    for name in names:
        print(f"{name}: {statistics.mean(rounds[name]):.1f} us a call "
              f"(rounds {[round(t, 1) for t in rounds[name]]})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build._LOADED["flash_attention_bwd"] = libs["base"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run("base")
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            print(f"base {e.key[:60]}: "
                  f"{e.device_time_total / max(e.count, 1):.2f} us x {e.count}")


if __name__ == "__main__":
    main()

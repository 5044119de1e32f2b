"""Which kernel launches torch.profiler keeps no record of.

On the card, two calls are profiled in windows of two kinds, as
``chip_smoke.py:profile_window`` takes them: "bare", one call of the
function, and "warm", one call after a warm-up call whose records are
thrown away (``schedule(wait=0, warmup=1, active=1, repeat=1)``). The
calls are ``lstm``, a step shaped like the start of the bucketed LSTM
LM's forward (twice an input product and B1's sequence kernel at T=60
N=32 H=1024, then 20 fp32 products), and ``attention``, ten autograd
backward calls of B2 at (4, 8, 2048, 64) bf16 causal (each K0, the
wgmma kernel, K2), as phase 12's "10 backward calls" windows make them.
For each window it prints the kernel records kept by name and the
ordinals of the launch calls that have no kernel record:

    python tools/probe_profiler_window.py [--windows 6]

The last line is one JSON object with every window's counts.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from mxnet_tpu_torch.ops.cuda.attention import flash_attention  # noqa: E402
from mxnet_tpu_torch.ops.cuda.lstm import lstm_sequence_fused  # noqa: E402

T, N, H = 60, 32, 1024
PRODUCTS = 20
CALLS = 10


def lstm_call(card):
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(T * N, H, device=card, generator=gen)
    w_i2h = torch.randn(4 * H, H, device=card, generator=gen) * H ** -0.5
    w_h2h = torch.randn(4 * H, H, device=card, generator=gen) * H ** -0.5
    h0 = torch.zeros(N, H, device=card)
    a = torch.randn(2048, 2048, device=card, generator=gen)

    def call():
        layer = x
        for _ in range(2):
            xproj = (layer @ w_i2h.t()).view(T, N, 4 * H)
            out, _, _ = lstm_sequence_fused(xproj, h0, h0, w_h2h)
            layer = out.view(T * N, H)
        b = a
        for _ in range(PRODUCTS):
            b = a @ b
    return call


def attention_call(card):
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(4, 2048, 8, 64, device=card, generator=gen,
                    dtype=torch.bfloat16)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for _ in range(3)]
    out = flash_attention(*leaves, causal=True)
    do = torch.randn_like(out)

    def call():
        for _ in range(CALLS):
            torch.autograd.grad(out, leaves, do, retain_graph=True)
    return call


def window(call, warm):
    """Kernel records by name and the ordinals of the launches without a
    kernel record, for one profiled call."""
    from torch.profiler import ProfilerActivity, profile, schedule
    plan = schedule(wait=0, warmup=1, active=1, repeat=1) if warm else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=plan) as prof:
        if warm:
            call()
            torch.cuda.synchronize()
            prof.step()
        call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kernels = [e for e in events if e.device_type == cuda
               and not e.name.startswith("ProfilerStep")]
    launches = sorted((e for e in events if e.device_type != cuda
                       and e.name.startswith("cu") and "Launch" in e.name),
                      key=lambda e: e.time_range.start)
    recorded = {k.id for k in kernels}
    records = {}
    for k in kernels:
        name = k.name.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("(")[0].split("<")[0].split("::")[-1][:40]
        records[name] = records.get(name, 0) + 1
    lost = [i for i, e in enumerate(launches) if e.id not in recorded]
    return {"records": records, "launches": len(launches), "lost": lost}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--windows", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, make in (("lstm", lstm_call), ("attention", attention_call)):
        call = make(card)
        call()
        torch.cuda.synchronize()
        for mode in ("bare", "warm"):
            rows = out.setdefault(name, {}).setdefault(mode, [])
            for w in range(args.windows):
                rows.append(window(call, mode == "warm"))
                print(f"{name} {mode} window {w}: {rows[-1]}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Probe whether the LSTM kernels' cooperative launches capture into a
CUDA graph and replay there.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/probe_graph_capture.py

One layer of the LSTM at the LSTM benchmark's training shape (T=256,
N=64, H=1024, fp32, both directions) runs forward and backward through
``ops/cuda/lstm.py:lstm_sequence_fused`` (the sequence kernel,
``cudaLaunchCooperativeKernel``) and its autograd Function (the register
backward kernel, ``cudaLaunchKernelExC`` with
``cudaLaunchAttributeCooperative``): once eagerly on a side stream (the
warm-up: the kernel library's build, its host queries), then captured
once in a ``torch.cuda.CUDAGraph`` and replayed on the same inputs and on
new ones copied into them. Each replay's outputs and gradients are held
bit for bit to an eager run on the same inputs. It also replays a graph
that draws a dropout mask from a ``torch.Generator`` of the card
registered with the graph, twice (the masks must differ), and counts the
kernels of one replay by name under ``torch.profiler``. It prints one
JSON line and exits non-zero where a check fails.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

T, N, H = 256, 64, 1024


def layer_inputs(seed, device):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    return {"xproj": rand(T, N, 4 * H, scale=0.5), "h0": rand(N, H, scale=0.1),
            "c0": rand(N, H, scale=0.1), "w": rand(4 * H, H, scale=H ** -0.5),
            "dout": rand(T, N, H, scale=0.01), "dh": rand(N, H, scale=0.01),
            "dc": rand(N, H, scale=0.01)}


def layer_step(static, reverse):
    """Forward and backward of one layer on the tensors of ``static``."""
    from mxnet_tpu_torch.ops.cuda.lstm import lstm_sequence_fused
    leaves = [static[k].detach().requires_grad_() for k in
              ("xproj", "h0", "c0", "w")]
    out, h_last, c_last = lstm_sequence_fused(*leaves, reverse=reverse)
    grads = torch.autograd.grad([out, h_last, c_last], leaves,
                                [static["dout"], static["dh"], static["dc"]])
    return [out.detach(), h_last.detach(), c_last.detach()] + list(grads)


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def probe_layer(reverse):
    device = torch.device("cuda")
    static = layer_inputs(0, device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = layer_step(static, reverse)  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = layer_step(static, reverse)
    graph.replay()
    torch.cuda.synchronize()
    first = same(captured, eager)
    fresh = layer_inputs(1, device)
    for k, v in fresh.items():
        static[k].copy_(v)
    graph.replay()
    again = [t.clone() for t in captured]
    eager_fresh = layer_step(static, reverse)
    torch.cuda.synchronize()
    second = same(again, eager_fresh)
    # a graph reads and writes the addresses it captured: its inputs and
    # outputs are kept alive with it
    return (graph, static, captured), {"replay_equals_eager": first,
                   "replay_on_new_inputs_equals_eager": second}


def probe_generator():
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x = torch.ones(1 << 16, device=device)
    out = torch.empty_like(x)

    def body():
        out.copy_(x * (torch.rand(x.shape, generator=gen,
                                  device=device) < 0.5))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        body()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    kept = float(out.mean())
    return {"masks_differ_across_replays": not torch.equal(first, out),
            "kept_share": kept}


def replay_kernels(kept):
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kept[0].replay()
        torch.cuda.synchronize()
    return {e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0}


def main():
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    result = {"torch": torch.__version__, "cuda": torch.version.cuda}
    kept = None
    for reverse in (False, True):
        kept, result[f"reverse={reverse}"] = probe_layer(reverse)
        print(json.dumps(result), flush=True)
    result["generator"] = probe_generator()
    print(json.dumps(result), flush=True)
    result["replay_kernels"] = replay_kernels(kept)
    print(json.dumps(result), flush=True)
    checks = [v for k, r in result.items() if isinstance(r, dict)
              and k != "replay_kernels" for v in r.values()
              if isinstance(v, bool)]
    return 0 if all(checks) else 1


if __name__ == "__main__":
    sys.exit(main())

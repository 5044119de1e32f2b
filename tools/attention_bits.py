"""Hold the bf16 attention kernels of one checkout to another's, bit for bit.

On the card, for seeds 0-59: the transformer's (B, S, H, D) bf16 views at
(2, 8, 64, 64), causal, through ``flash_attention`` and its autograd
backward (the wgmma/TMA kernels), and each seed's largest gradient error
against ``attention_backward_plain`` over the bound
``tests/test_torch_port_attention.py:test_kernel_takes_strided_views_and_refuses_grad``
holds it to (2**-6 of the gradient's largest magnitude). Run it from the
root of each checkout, the first with ``--save``:

    python tools/attention_bits.py --save OUT.pt     # one checkout
    python tools/attention_bits.py --compare OUT.pt  # the other

``--compare`` prints, for the output and each gradient, how many seeds
agree bit for bit with the saved run (dq's partial sums are added in no
fixed order, so dq may differ in its last bits between two runs of one
checkout).
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from mxnet_tpu_torch.ops.cuda.attention import (  # noqa: E402
    attention_backward_plain, attention_plain, flash_attention)

SEEDS = 60


def run(card):
    """[(out, dq, dk, dv)] on the host and the error ratio of each seed."""
    results, ratios = [], []
    for seed in range(SEEDS):
        torch.manual_seed(seed)
        x = torch.randn(2, 64, 8, 64, device=card, dtype=torch.bfloat16)
        q = x.transpose(1, 2)
        want = attention_plain(q, q, q, causal=True)
        do = torch.randn_like(want).transpose(1, 2).contiguous().transpose(
            1, 2)
        leaves = [q.detach().requires_grad_() for _ in range(3)]
        out = flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(out, leaves, do)
        plain = attention_backward_plain(q, q, q, want, do, causal=True)
        ratios.append(max(
            ((g.float() - p.float()).abs().max()
             / (2.0 ** -6 * p.float().abs().max())).item()
            for g, p in zip(grads, plain)))
        results.append([out.detach().cpu()] + [g.cpu() for g in grads])
    return results, ratios


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", metavar="PATH")
    mode.add_argument("--compare", metavar="PATH")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_bits: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    results, ratios = run(torch.device("cuda", 0))
    print(f"largest gradient error over its bound {max(ratios):.4f}; over "
          f"the bound on {sum(r > 1 for r in ratios)} of {SEEDS} seeds")
    if args.save:
        torch.save(results, args.save)
        return
    saved = torch.load(args.compare)
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        same = sum(torch.equal(a[i], b[i]) for a, b in zip(results, saved))
        worst = max((a[i].float() - b[i].float()).abs().max().item()
                    for a, b in zip(results, saved))
        print(f"{name}: {same} of {SEEDS} seeds bit for bit equal to the "
              f"saved run; largest difference {worst:.3e}")


if __name__ == "__main__":
    main()

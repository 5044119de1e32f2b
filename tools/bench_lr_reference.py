#!/usr/bin/env python3
"""The LSTM LM's training at the benchmark's learning rate, on the CPU,
through the JAX package and through the port.

Run from the root of a checkout (both packages importable, JAX on the
CPU):

    JAX_PLATFORMS=cpu python3 tools/bench_lr_reference.py [STEPS]

It trains ``chip_smoke.py`` phase 11's run (``chip_smoke.bench_lr_run``):
the 2 x 1024 LSTM LM of ``benchmarks/bench_lstm.py`` (V=10000, N=64,
T=256, fp32) from ``random.seed(0)`` and ``Xavier`` (the same bits in
both packages), a ``fit`` epoch over 4 seeded batches and STEPS (default
10) ``forward``/``backward``/``update`` steps on the first batch, all at
SGD lr 0.5 without momentum; once through ``mxnet_tpu`` (its fused step
on the CPU) and once through ``mxnet_tpu_torch`` on the CPU, whose LSTM
backward is the plain version the card's kernels are held to. It prints,
for each package and step, the cross-entropy, whether every parameter is
finite, and the largest parameter magnitude, one JSON line a package.
"""
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def run(mx, ctx, steps):
    """chip_smoke.bench_lr_run on ``ctx``, with each step's loss,
    finiteness and largest parameter magnitude."""
    net = cs.build_lm(mx, cs.V, cs.H, cs.LAYERS, cs.TRAIN_T, train=True)
    rng = np.random.RandomState(0)
    shape = (cs.TRAIN_BATCHES * cs.TRAIN_N, cs.TRAIN_T)
    data = rng.randint(0, cs.V, shape).astype(np.float32)
    label = rng.randint(0, cs.V, shape).astype(np.float32)
    batch = mx.io.DataBatch([mx.nd.array(data[:cs.TRAIN_N], ctx=ctx)],
                            [mx.nd.array(label[:cs.TRAIN_N], ctx=ctx)])
    mx.random.seed(0)
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (cs.TRAIN_N, cs.TRAIN_T))],
             label_shapes=[("softmax_label", (cs.TRAIN_N, cs.TRAIN_T))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=cs.TRAIN_SGD)
    mod.fit(mx.io.NDArrayIter(data, label, batch_size=cs.TRAIN_N),
            num_epoch=1, eval_metric=mx.metric.create("ce"))
    rows = []
    for step in range(steps):
        t0 = time.time()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        metric = mx.metric.CrossEntropy()
        mod.update_metric(metric, batch.label)
        params = [v.asnumpy() for v in mod.get_params()[0].values()]
        rows.append({"step": step + 1, "loss": float(metric.get()[1]),
                     "params_finite": bool(all(np.isfinite(p).all()
                                               for p in params)),
                     "max_abs_param": float(max(np.abs(p).max()
                                                for p in params)),
                     "seconds": round(time.time() - t0, 1)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else cs.TRAIN_STEPS
    import jax
    jax.config.update("jax_platforms", "cpu")
    import mxnet_tpu
    import mxnet_tpu_torch
    out = {}
    with jax.enable_x64(False):
        out["mxnet_tpu"] = run(mxnet_tpu, mxnet_tpu.cpu(), steps)
    out["mxnet_tpu_torch"] = run(mxnet_tpu_torch, mxnet_tpu_torch.cpu(),
                                 steps)
    for name, rows in out.items():
        first_bad = next((r["step"] for r in rows
                          if not (math.isfinite(r["loss"])
                                  and r["params_finite"])), None)
        print(json.dumps({"package": name, "losses":
                          [r["loss"] for r in rows],
                          "first_non_finite_step": first_bad}), flush=True)


if __name__ == "__main__":
    main()

"""Shape-bucketed warm-up: the TVM/nncase-style ahead-of-time answer to
first-request compile latency (PAPERS.md).

Counterpart of ``mxnet_tpu/serving/warmup.py``.

In the port a new input shape costs its first run on the card: cuBLAS
and cuDNN pick their algorithms, the caching allocator grows, and a
kernel library is built the first time it is launched — latency that
must never land on a live request. The server therefore declares its
batch-size *buckets* up front, runs each one at startup
(:meth:`~.server.InferenceServer.warm_up`), and at request time pads
any off-bucket batch up to the smallest bucket that fits, slicing the
padding back off the outputs. The steady-state request path then sees
only the declared shapes.

``pad_batch``/``slice_outputs`` run per request, so they are
``@hot_path``-annotated, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError
from ..analysis.annotations import hot_path

__all__ = ["ShapeBuckets", "coalescer_sizes", "suggest_buckets"]


def coalescer_sizes(max_batch: int) -> Tuple[int, ...]:
    """The batch sizes the coalescer can dispatch, all of which warm-up
    must pre-trace: 1, ``max_batch``, and every power of two between.
    A coalesced batch is padded up to the smallest of these that fits,
    so dispatch shapes are drawn from this closed set and a live
    coalesced batch never recompiles (asserted under
    ``MXTPU_RETRACE_STRICT=1``)."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    sizes = {1, int(max_batch)}
    p = 2
    while p < max_batch:
        sizes.add(p)
        p *= 2
    return tuple(sorted(sizes))


def suggest_buckets(shape_histogram, max_buckets: int = 4) -> dict:
    """Mine the admission-queue shape histogram
    (``serving.stats()[ep]["queue"]["shape_histogram"]``, which includes
    oversized *rejections* — the demand the current buckets turned away)
    into a declared-bucket recommendation: the first concrete
    measure->decide hook for bucket tuning (TVM, arxiv 1802.04799: the
    waste is a tracked number before anything optimizes it).

    Deterministic quantile mining over the per-request row counts: one
    bucket at each of the 50/90/99/100th weighted percentiles (rounded
    up to the next power of two below the max; the max observed row
    count is kept EXACT so rejected demand gets a bucket that actually
    fits it), deduped and capped at ``max_buckets``. Returns the bucket
    list, the weighted row histogram it was mined from, the fraction of
    observed requests the largest suggested bucket admits, and a
    ready-to-paste ``rules`` snippet."""
    rows_hist: dict = {}
    for key, count in (shape_histogram or {}).items():
        if not isinstance(key, str) or "r|" not in key:
            continue
        head = key.split("r|", 1)[0]
        if head.isdigit():
            rows_hist[int(head)] = rows_hist.get(int(head), 0) + int(count)
    if not rows_hist:
        return {"buckets": [], "rows_histogram": {}, "coverage": 0.0,
                "rules": "# no shape traffic observed yet"}
    total = sum(rows_hist.values())
    ordered = sorted(rows_hist.items())
    biggest = ordered[-1][0]

    def _quantile(q: float) -> int:
        need = q * total
        seen = 0
        for rows, count in ordered:
            seen += count
            if seen >= need:
                return rows
        return biggest

    def _pow2_ceil(n: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return p

    buckets = {biggest}
    for q in (0.5, 0.9, 0.99):
        buckets.add(min(_pow2_ceil(_quantile(q)), biggest))
    suggested = sorted(buckets)
    while len(suggested) > max(1, int(max_buckets)):
        # drop the densest interior pair's lower member; the exact max
        # is never dropped (it is what admits the rejected demand)
        suggested.pop(0)
    coverage = sum(c for r, c in ordered if r <= suggested[-1]) / total
    rules = (f"buckets={suggested}  "
             f"# mined from {total} requests; max_batch>={suggested[-1]}")
    return {"buckets": suggested, "rows_histogram": dict(ordered),
            "coverage": round(coverage, 4), "rules": rules}


class ShapeBuckets:
    """Declared batch-size buckets, padded along axis 0."""

    def __init__(self, sizes: Sequence[int]):
        if not sizes:
            raise ValueError("need at least one bucket size")
        cleaned = sorted({int(s) for s in sizes})
        if cleaned[0] < 1:
            raise ValueError("bucket sizes must be >= 1")
        self.sizes: Tuple[int, ...] = tuple(cleaned)

    def union(self, sizes: Sequence[int]) -> "ShapeBuckets":
        """A new bucket set extended with ``sizes`` — how the server
        folds the coalescer's dispatch sizes (:func:`coalescer_sizes`)
        into the caller-declared buckets before warm-up."""
        return ShapeBuckets(self.sizes + tuple(sizes))

    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest declared bucket that fits a batch of ``n`` rows
        (None when ``n`` exceeds the largest bucket)."""
        for size in self.sizes:
            if size >= n:
                return size
        return None

    @hot_path("per-request pad on the serving fast path")
    def pad_batch(self, batch: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pad ``batch`` up to its bucket; returns (padded, true_rows).
        An exact-bucket batch passes through untouched. A batch larger
        than the largest bucket is a contract violation — padding cannot
        help and retracing is exactly what warm-up exists to prevent."""
        n = batch.shape[0]
        bucket = self.bucket_for(n)
        if bucket is None:
            raise MXNetError(
                f"batch of {n} rows exceeds the largest declared "
                f"bucket {self.sizes[-1]}; declare a larger bucket "
                f"(retracing on a live request is not an option)")
        if bucket == n:
            return batch, n
        pad = np.zeros((bucket - n,) + batch.shape[1:], batch.dtype)
        return np.concatenate([batch, pad], axis=0), n

    @hot_path("per-request unpad on the serving fast path")
    def slice_outputs(self, outputs, true_rows: int):
        """Drop pad rows from each output (axis 0) after the forward."""
        return [out[:true_rows] if out.shape and out.shape[0] >= true_rows
                else out for out in outputs]

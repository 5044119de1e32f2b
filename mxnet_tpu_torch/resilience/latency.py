"""Bounded latency accounting for gray-failure defense.

Counterpart of ``LatencyRecorder`` in ``mxnet_tpu/resilience/latency.py``
(its ``StepTimeSentinel`` comes with the training supervisor, A13).

A replica or chip that is *alive but slow* passes every probe and
silently owns the p99, so the fleet router and the supervisor need a
bounded, injectable-clock latency model to detect it.
:class:`LatencyRecorder` is a fixed-bucket geometric histogram (bounded
memory, no per-sample allocation) yielding p50/p95/p99 and an EWMA.
Thread-safe; quantiles of sub-resolution samples read as 0.0 so an
all-fake-clock unit test (every latency exactly zero) never arms the
hedging machinery by accident.
"""
from __future__ import annotations

import math
import threading
from typing import List, Optional, Sequence

__all__ = ["LatencyRecorder", "default_bounds"]


def default_bounds(lo: float = 1e-4, ratio: float = 2.0,
                   n: int = 28) -> List[float]:
    """Geometric bucket upper bounds: 0.1ms doubling out to ~3.7 hours —
    every latency this runtime can see lands in a finite bucket."""
    return [lo * ratio ** i for i in range(n)]


class LatencyRecorder:
    """Fixed-bucket latency histogram + EWMA with an injectable scale.

    ``record()`` costs one bisect and a few adds under the lock; memory
    is O(len(bounds)) forever. Quantiles are read from the bucket upper
    bound (pessimistic, monotone); the FIRST bucket reads as 0.0 — a
    sample faster than the resolution floor carries no tail-latency
    evidence and must never arm a hedge threshold.
    """

    def __init__(self, alpha: float = 0.2,
                 bounds: Optional[Sequence[float]] = None):
        self._bounds = list(bounds) if bounds is not None \
            else default_bounds()
        self._lock = threading.Lock()
        # guarded by _lock
        self._counts = [0] * len(self._bounds)
        self._n = 0             # guarded by _lock
        self._total = 0.0       # guarded by _lock
        self._ewma = 0.0        # guarded by _lock
        self._alpha = float(alpha)

    def record(self, seconds: float):
        s = max(0.0, float(seconds))
        # bisect over the (immutable) bounds outside the lock
        lo, hi = 0, len(self._bounds) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if s <= self._bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._n += 1
            self._total += s
            self._ewma = s if self._n == 1 \
                else self._ewma + self._alpha * (s - self._ewma)

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def ewma(self) -> float:
        with self._lock:
            return self._ewma

    def counts(self) -> List[int]:
        """Snapshot of the bucket counters (for windowed deltas: hold a
        baseline and subtract)."""
        with self._lock:
            return list(self._counts)

    def quantile(self, q: float,
                 counts: Optional[Sequence[int]] = None) -> float:
        """The q-quantile latency in seconds, from the live histogram or
        an explicit ``counts`` vector (e.g. a windowed delta). 0.0 when
        empty or when the quantile lands in the sub-resolution first
        bucket."""
        if counts is None:
            counts = self.counts()
        n = sum(counts)
        if n <= 0:
            return 0.0
        rank = max(1, int(math.ceil(float(q) * n)))
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= rank:
                return 0.0 if i == 0 else self._bounds[i]
        return self._bounds[-1]

    def stats(self) -> dict:
        counts = self.counts()
        with self._lock:
            n, ewma = self._n, self._ewma
        return {"count": n,
                "p50_s": self.quantile(0.50, counts),
                "p95_s": self.quantile(0.95, counts),
                "p99_s": self.quantile(0.99, counts),
                "ewma_s": round(ewma, 6)}

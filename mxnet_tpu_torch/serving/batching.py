"""Dynamic batch coalescing: N callers, one dispatch.

Counterpart of ``mxnet_tpu/serving/batching.py``.

The dominant serving cost at high traffic is not the math — it is the
*dispatches*: N single-request forwards where one batched forward would
do (nncase, arxiv 2512.21571, is the deployment-plumbing exemplar). The :class:`BatchCoalescer` sits between the admission queue
and the workers and closes that gap:

1. a worker takes one request (the weighted-fair pick), then *gathers*
   every shape-compatible request already queued — same per-row shapes,
   same dtypes, same routing leg — up to ``MXTPU_MAX_BATCH`` total rows;
2. in threaded mode it may additionally *wait* up to
   ``MXTPU_BATCH_WAIT_MS`` (never past any member's deadline) for more
   traffic to coalesce — trading a bounded sliver of latency for
   amortized dispatch. The deterministic ``workers=0`` mode never waits:
   it batches exactly what is queued, so tests drive every path with a
   fake clock and zero real sleeps;
3. the merged rows are padded up to the nearest *warmed* bucket
   (``warm_up`` pre-traced 1, max, and the powers of two between —
   :func:`~.warmup.coalescer_sizes`), ONE forward runs, and the outputs
   are scattered back per request by row offsets.

Per-request deadlines survive coalescing: a member whose budget died
while queued is failed without riding the dispatch, and an abandoned
member's slice is discarded, never delivered. A dispatch failure fails
every member with the *retriable* :class:`~.errors.BatchFailed` (the
batch said nothing about any individual request) and charges the
circuit breaker ONCE — per dispatch, not per passenger.

Every dispatch signature is checked against the warmed set through a
:class:`~mxnet_tpu_torch.perf.CompileGuard` keyed on
:func:`~mxnet_tpu_torch.compiler.batch_signature`, so "this shape was
never warmed" is a guard trip (fatal under ``MXTPU_RETRACE_STRICT=1``),
not a silent latency spike: in both packages the guard counts distinct
dispatch signatures, which the JAX package compiles once each and the
port runs for the first time each.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.annotations import hot_path
from ..base import MXNetError
from ..compiler import batch_signature
from ..perf import CompileGuard
from .admission import AdmissionQueue, Request
from .errors import UnwarmedSignature

__all__ = ["BatchCoalescer", "request_signature"]


def request_signature(req: Request) -> Tuple:
    """Merge-compatibility key: routing leg + sorted per-input
    (name, row shape, dtype). Requests merge iff their keys are equal —
    concatenating their rows then yields one well-formed batch. Cached
    on the request: the gather scan recomputing it per queued request
    per wakeup, under the queue lock, would tax every submitter."""
    if req._sig is not None:
        return req._sig
    parts = []
    for name in sorted(req.inputs):
        batch = req.inputs[name]
        shape = tuple(getattr(batch, "shape", ()))
        dtype = str(getattr(batch, "dtype", type(batch).__name__))
        parts.append((name, shape[1:], dtype))
    req._sig = (bool(req.use_fallback), tuple(parts))
    return req._sig


class BatchCoalescer:
    """Merges shape-compatible queued requests into single dispatches.

    Parameters
    ----------
    max_batch : total row budget of one coalesced dispatch
        (``MXTPU_MAX_BATCH``); 1 disables coalescing.
    wait : seconds a gathering worker may hold the first request open
        for more traffic (``MXTPU_BATCH_WAIT_MS`` / 1000). Only the
        threaded mode waits; the deterministic mode batches what is
        already queued.
    clock : injectable time source for the wait budget.
    guard : the server's :class:`~mxnet_tpu_torch.perf.CompileGuard`; warmed
        signatures are registered via :meth:`expect_signature`, live
        dispatches via :meth:`observe_signature`.
    """

    def __init__(self, max_batch: int, wait: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 guard: Optional[CompileGuard] = None,
                 name: str = "default", packer=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.wait = float(wait)
        self.clock = clock
        self.name = name
        self.guard = guard or CompileGuard(f"serving.batched[{name}]",
                                           expected=0)
        # optional SequencePacker (serving/ragged.py): single-row
        # variable-length requests share padded rows with segment ids
        self.packer = packer

    # -- the warmed-signature contract ---------------------------------------

    def expect_signature(self, inputs: Dict, route: str = "primary",
                         symbolic: bool = False):
        """Register one warm-up probe's feed as a budgeted signature.
        ``symbolic=True`` registers the batch-axis-wildcarded form — one
        signature covering every row count up to ``max_batch``
        (symbolic-dim programs, serving/ragged.py)."""
        self.guard.expect(batch_signature(
            inputs, route,
            symbolic_rows=self.max_batch if symbolic else None))

    def observe_signature(self, inputs: Dict, route: str = "primary",
                          symbolic: bool = False):
        """Check one live dispatch's feed against the warmed set; a new
        signature counts as a compile. In strict mode the trip raises
        the typed :class:`~.errors.UnwarmedSignature` — a client/config
        error the server must NOT charge to the circuit breaker."""
        try:
            self.guard.observe(batch_signature(
                inputs, route,
                symbolic_rows=self.max_batch if symbolic else None))
        except MXNetError as err:
            raise UnwarmedSignature(str(err)) from err

    def _request_signature(self, req: Request) -> Tuple:
        """Merge key: the packer's pack-axis-wildcarded form when
        packing is active (different real lengths still merge),
        otherwise the exact-shape form."""
        if self.packer is not None:
            return self.packer.request_signature(req)
        return request_signature(req)

    # -- gather --------------------------------------------------------------

    def gather(self, first: Request, queue: AdmissionQueue,
               may_wait: bool = False) -> List[Request]:
        """Collect shape-mates of ``first`` from ``queue`` into one
        batch, bounded by ``max_batch`` rows, the ``wait`` budget, and
        every member's remaining deadline. ``may_wait=False`` (the
        deterministic mode) only drains what is already queued."""
        batch = [first]
        builder = None
        if self.packer is not None:
            # packed admission: a mate fits while the first-fit layout
            # still holds max_batch packed rows (several short requests
            # can share one row, so the member count may exceed it)
            builder = self.packer.builder(self.max_batch)
            builder.try_add(first)
        rows = first.rows
        if builder is None and (self.max_batch <= 1
                                or rows >= self.max_batch):
            return batch
        sig = self._request_signature(first)
        deadline = None
        if may_wait and self.wait > 0:
            deadline = self.clock() + self.wait
            rem = first.deadline.remaining()
            if rem is not None:
                # never gather past the point the first caller gives up
                deadline = min(deadline, self.clock() + max(0.0, rem))
        seen = queue.admitted
        while builder is not None or rows < self.max_batch:
            budget = self.max_batch - rows

            def fits(req, _sig=sig, _budget=budget, _builder=builder):
                if self._request_signature(req) != _sig:
                    return False
                if _builder is not None:
                    # commit-on-True: poll_compatible pops the request
                    # iff the predicate passed, so the reservation the
                    # builder just made is exactly the layout merge()
                    # will recompute
                    return req.rows == 1 and _builder.try_add(req)
                return req.rows <= _budget

            mate = queue.poll_compatible(fits)
            if mate is not None:
                batch.append(mate)
                rows += mate.rows
                if deadline is not None:
                    rem = mate.deadline.remaining()
                    if rem is not None:
                        # the hold is bounded by EVERY member's budget:
                        # a mate already gathered must not expire while
                        # the worker waits for more traffic
                        deadline = min(deadline,
                                       self.clock() + max(0.0, rem))
                continue
            if deadline is None:
                break
            left = deadline - self.clock()
            if left <= 0:
                break
            # bounded nap until NEW traffic arrives; re-scan on wakeup.
            # Keyed on arrivals (not queue-non-empty) and capped in real
            # wall time, so neither an incompatible backlog nor a
            # non-advancing injected clock can spin or wedge the worker
            # — a full wait with nothing new ends the gather.
            arrived = queue.wait_arrival(seen, min(left, 0.05))
            if arrived == seen:
                break
            seen = arrived
        return batch

    # -- merge / scatter (the per-dispatch hot path) -------------------------

    @hot_path("per-dispatch merge on the batched serving fast path")
    def merge(self, batch: Sequence[Request]
              ) -> Tuple[Dict[str, np.ndarray], List[Tuple[int, int]]]:
        """Concatenate the members' inputs along axis 0; returns the
        merged feed plus each member's (start, stop) row span.

        With a packer, the members are instead first-fit packed into
        shared rows (even a singleton: signature uniformity — every
        packed dispatch carries the same padded length and a
        ``segment_ids`` plane) and the span list is a
        :class:`~.ragged.PackPlan`; :meth:`scatter` dispatches on it."""
        if self.packer is not None:
            return self.packer.merge(batch)
        if len(batch) == 1:
            req = batch[0]
            return dict(req.inputs), [(0, req.rows)]
        spans: List[Tuple[int, int]] = []
        row = 0
        for req in batch:
            spans.append((row, row + req.rows))
            row += req.rows
        merged = {name: np.concatenate([req.inputs[name] for req in batch],
                                       axis=0)
                  for name in batch[0].inputs}
        return merged, spans

    @hot_path("per-dispatch scatter on the batched serving fast path")
    def scatter(self, outputs: Sequence, spans: Sequence[Tuple[int, int]]
                ) -> List[List]:
        """Slice each member's rows back out of every output (axis 0).
        Outputs without a batch axis (scalars, global stats) are
        replicated to every member unchanged."""
        from .ragged import PackPlan
        if isinstance(spans, PackPlan):
            return self.packer.scatter(outputs, spans)
        per_request: List[List] = []
        total = spans[-1][1] if spans else 0
        for start, stop in spans:
            per_request.append(
                [out[start:stop]
                 if getattr(out, "shape", None) and out.shape[0] >= total
                 else out
                 for out in outputs])
        return per_request

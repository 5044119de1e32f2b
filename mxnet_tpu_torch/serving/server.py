"""The serving runtime: admission -> deadline -> circuit -> batched forward.

Counterpart of ``mxnet_tpu/serving/server.py``.

Request lifecycle (docs/how_to/serving.md):

1. ``submit()`` — fast-fail checks first: server closed? circuit open
   with no fallback? Tenant over quota (``QuotaExceeded``, retriable)?
   Then the bounded admission queue (``QueueFull`` beyond capacity;
   ``serving.queue`` fault site). Nothing past this point ever blocks
   the submitter.
2. A worker (a daemon thread, or the caller itself via ``run_pending``
   in the deterministic ``workers=0`` mode) takes the weighted-fair
   pick from the queue and — with ``max_batch > 1`` — *coalesces* every
   shape-compatible queued request into ONE dispatch
   (:class:`~.batching.BatchCoalescer`): merged rows are padded to the
   nearest warmed bucket, one forward runs, outputs scatter back per
   request. Deadlines hold per member: a request whose budget died in
   queue never rides the dispatch.
3. ``result()`` — the caller waits at most the remaining deadline
   (injectable ``wait``). On timeout the request is abandoned: if it
   was wedged inside a forward, that worker is written off and a
   replacement is spawned (the watchdog), so one stuck backend call
   never shrinks the worker pool.

Failure accounting is per DISPATCH: a coalesced forward that dies fails
its members with the retriable :class:`~.errors.BatchFailed` and charges
the circuit breaker once — N passengers are not N pieces of evidence.

Degradation ladder: primary forward -> fallback model (circuit open or
primary failure) -> fast-fail. ``healthz()``/``readyz()`` expose the
whole state machine for probes; ``stats()`` mirrors
``resilience.retry.stats()`` per endpoint, now with a ``per_tenant``
breakdown and the batching counters.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

from ..base import MXNetError
from ..perf import CompileGuard
from ..resilience import RetryExhausted, faults, guarded_call
from .admission import (DEFAULT_TENANT, AdmissionQueue, Deadline, Request,
                        StrideScheduler, TenantPolicy)
from .batching import BatchCoalescer
from .breaker import CircuitBreaker, OPEN
from .errors import (BatchFailed, CircuitOpen, DeadlineExceeded, Draining,
                     QueueFull, QuotaExceeded, RequestTooLarge,
                     ServerClosed, UnwarmedSignature)
from .ragged import (PadWasteTracker, SequencePacker, dispatch_waste,
                     ragged_enabled)
from .warmup import ShapeBuckets, coalescer_sizes

__all__ = ["InferenceServer", "endpoint_stats", "endpoints"]

_ENDPOINTS: Dict[str, "InferenceServer"] = {}
_endpoints_lock = threading.Lock()


def endpoints() -> Dict[str, "InferenceServer"]:
    """Live endpoint registry (name -> server)."""
    with _endpoints_lock:
        return dict(_ENDPOINTS)


def endpoint_stats() -> Dict[str, Dict]:
    """Per-endpoint counters, the serving mirror of
    ``resilience.retry.stats()``."""
    return {name: srv.stats() for name, srv in endpoints().items()}


class _Worker(threading.Thread):
    """One queue-draining daemon thread. ``wedged`` is set by the
    watchdog when a caller abandons a request this worker is stuck
    inside; the worker then retires as soon as the stuck call returns
    (a replacement has already been spawned)."""

    _seq = 0

    def __init__(self, server: "InferenceServer"):
        _Worker._seq += 1
        super().__init__(name=f"serving-worker-{_Worker._seq}",
                         daemon=True)
        self.server = server
        self.wedged = False

    def run(self):
        while not self.wedged:
            batch = self.server._take_batch()
            if batch is None:     # queue closed
                return
            self.server._process_batch(batch, worker=self, counted=True)


class InferenceServer:
    """A production-posture server around one model backend.

    Parameters
    ----------
    backend : object with ``load()`` and ``infer(dict) -> [np.ndarray]``
    fallback : optional second backend served while the circuit is open
        (and on a primary forward failure) — degraded, but up.
    buckets : declared batch-size buckets for warm-up + padding; None
        disables shape management (the backend sees raw shapes) unless
        ``max_batch > 1`` turns it on at the coalescer's sizes.
    capacity / shed_policy : admission queue bound and overflow policy
        (``'reject'`` | ``'evict-oldest'``). Eviction is priority-safe:
        the victim is the oldest among the lowest-priority queued
        requests, never a strictly-higher-priority one.
    default_deadline : per-request budget in seconds when the caller
        does not pass one (None = unbounded).
    breaker : a :class:`~.breaker.CircuitBreaker`; defaults to one on
        ``clock``.
    workers : daemon worker threads; 0 = synchronous mode where the
        caller drives ``run_pending()`` (deterministic tests).
    max_batch : total rows one coalesced dispatch may carry (default:
        ``MXTPU_MAX_BATCH``; 1 = one request per dispatch, the pre-
        batching behavior). Warm-up then pre-traces every bucket at
        1, ``max_batch``, and the powers of two between, so a coalesced
        batch never compiles on a live request.
    batch_wait : seconds a threaded worker may hold the first request
        open for more traffic to coalesce (default:
        ``MXTPU_BATCH_WAIT_MS`` / 1000; the ``workers=0`` mode never
        waits). Bounded by every member's remaining deadline.
    tenants : a :class:`~.admission.TenantPolicy` (or its
        ``MXTPU_TENANT_QUOTAS`` string form) declaring per-tenant
        admission quotas and weighted fair shares; None (default knob)
        disables quotas and serves tenants FIFO.
    stride : an optional shared :class:`~.admission.StrideScheduler`.
        The fleet router passes one instance to every replica server so
        a tenant's weighted fair share is measured across the whole
        fleet instead of per queue (docs/how_to/fleet.md); standalone
        servers leave it None and keep their private per-queue clocks.
    clock / wait : injectable time source and event-wait, so every
        deadline/cool-down path is testable with zero real sleeps.
    """

    def __init__(self, backend, *, name: str = "default",
                 fallback=None, buckets: Optional[Sequence[int]] = None,
                 capacity: int = 64, shed_policy: str = "reject",
                 default_deadline: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 retry_policy=None, workers: int = 1,
                 max_batch: Optional[int] = None,
                 batch_wait: Optional[float] = None,
                 tenants: Optional[Union[TenantPolicy, str]] = None,
                 stride: Optional[StrideScheduler] = None,
                 ragged: Optional[bool] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wait: Optional[Callable] = None,
                 drain_grace: float = 30.0):
        from .. import config as _config
        self.name = name
        self.backend = backend
        self.fallback = fallback
        self.drain_grace = drain_grace
        # ragged rungs (serving/ragged.py): default MXTPU_RAGGED; each
        # rung additionally requires the backend's declaration, so a
        # backend that never opted in serves exactly as before
        self.ragged = ragged_enabled() if ragged is None else bool(ragged)
        self._pad_waste = PadWasteTracker()
        self._packer = self._build_packer(backend, _config)
        if max_batch is None:
            max_batch = _config.get("MXTPU_MAX_BATCH")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        if batch_wait is None:
            batch_wait = _config.get("MXTPU_BATCH_WAIT_MS") / 1000.0
        self.batch_wait = float(batch_wait)
        if tenants is None:
            tenants = TenantPolicy.parse(
                _config.get("MXTPU_TENANT_QUOTAS"))
        elif isinstance(tenants, str):
            tenants = TenantPolicy.parse(tenants)
        self.tenants = tenants
        declared = ShapeBuckets(buckets) if buckets else None
        if self.max_batch > 1:
            # the batch-dimension bucket satellite: every size the
            # coalescer can dispatch is a warmed bucket, so a coalesced
            # batch never recompiles (MXTPU_RETRACE_STRICT-asserted)
            sizes = coalescer_sizes(self.max_batch)
            self.buckets = (declared.union(sizes) if declared
                            else ShapeBuckets(sizes))
        else:
            self.buckets = declared
        self.default_deadline = default_deadline
        self.clock = clock
        self._wait = wait or (lambda event, timeout: event.wait(timeout))
        self.breaker = breaker or CircuitBreaker(clock=clock)
        self.retry_policy = retry_policy
        self._batch_guard = CompileGuard(f"serving.batched[{name}]",
                                         expected=0)
        self._coalescer = BatchCoalescer(
            self.max_batch, wait=self.batch_wait, clock=clock,
            guard=self._batch_guard, name=name, packer=self._packer)
        self._lock = threading.Lock()
        self._tenant_stats: Dict[str, Dict[str, int]] = {}  # guarded by _lock
        self._queue = AdmissionQueue(capacity, shed_policy, clock,
                                     tenants=tenants,
                                     on_tenant_event=self._tenant_count,
                                     stride=stride)
        self._stats: Dict[str, int] = {  # guarded by _lock
            "admitted": 0, "completed": 0, "failed": 0,
            "shed": 0, "evicted": 0, "rejected_open": 0,
            "deadline_queued": 0, "deadline_inflight": 0,
            "degraded": 0, "wedged_workers": 0, "abandoned": 0,
            "load_failures": 0, "warmed_buckets": 0,
            "warmup_cache_hits": 0, "warmup_compiles": 0,
            "drain_signals": 0, "drained_rejects": 0,
            "dispatches": 0, "coalesced_requests": 0,
            "batch_failures": 0, "quota_rejected": 0,
            "warmup_skipped_covered": 0, "packed_dispatches": 0}
        self._warmed = False
        self._load_ok = None          # None = not attempted yet
        self._fallback_ok = False     # fallback loaded and usable
        self._load_error = None
        self._closed = False
        self._draining = False
        self._inflight = 0  # guarded by _lock
        self._idle = threading.Event()
        self._idle.set()
        self._last_success: Optional[float] = None
        self._n_workers = workers
        self._workers = []
        for _ in range(workers):
            self._spawn_worker()
        with _endpoints_lock:
            _ENDPOINTS[name] = self

    # -- startup -------------------------------------------------------------

    def _build_packer(self, backend, _config) -> Optional[SequencePacker]:
        """Sequence packing activates only when the backend declares
        both a ``pack_axis`` and ``accepts_segment_ids`` (and ragged is
        on): the packed calling convention — shared rows + an int32
        segment-id plane — is the backend's contract to honor, never
        something the server can impose."""
        pack_axis = getattr(backend, "pack_axis", None)
        if (not self.ragged or pack_axis is None
                or not getattr(backend, "accepts_segment_ids", False)):
            return None
        specs = getattr(backend, "input_specs", None) or {}
        iname = getattr(backend, "input_name", "data")
        row = specs.get(iname, ())
        if len(row) < pack_axis:
            raise ValueError(
                f"backend declares pack_axis={pack_axis} but input "
                f"{iname!r} has per-row shape {row}")
        if self.fallback is not None and not getattr(
                self.fallback, "accepts_segment_ids", False):
            raise ValueError(
                "sequence packing needs the fallback backend to accept "
                "segment_ids too — a mid-flight fallback dispatch "
                "reuses the packed feed")
        return SequencePacker(
            pack_axis, int(row[pack_axis - 1]),
            segment_name=getattr(backend, "segment_name", "segment_ids"),
            max_segments=_config.get("MXTPU_PACK_MAX_SEGMENTS"))

    def _route_symbolic(self, backend) -> bool:
        """Symbolic-dim dispatch for this backend: one exported program
        serves every row count, so the batch axis needs no padding and
        one symbolic signature covers the burst."""
        return (self.ragged and self.buckets is not None
                and getattr(backend, "supports_symbolic_batch", False))

    def _spawn_worker(self):
        worker = _Worker(self)
        with self._lock:
            self._workers.append(worker)
        worker.start()

    def _count(self, key: str, n: int = 1):
        with self._lock:
            self._stats[key] = self._stats.get(key, 0) + n

    def _count_nolock(self, key: str, n: int = 1):
        """Counter bump for SIGNAL-HANDLER paths (the serving mirror of
        ``resilience.supervisor._count_nolock``): the interrupted thread
        may hold ``self._lock``, so ``_count`` here would self-deadlock
        the handler. A GIL-atomic dict update is enough for advisory
        counters."""
        self._stats[key] = self._stats.get(key, 0) + n

    def _tenant_count(self, tenant: str, key: str, n: int = 1):
        """Per-tenant counter hook (also handed to the queue, which
        credits expirations/evictions to the owning tenant)."""
        with self._lock:
            counters = self._tenant_stats.setdefault(tenant, {})
            counters[key] = counters.get(key, 0) + n

    def _load_one(self, backend, count_circuit: bool = True):
        """Load a backend behind the ``serving.load`` fault site +
        retry policy. A *primary* load exhaustion/corruption counts
        against the circuit (the retry-then-circuit path); a fallback's
        does not — the primary's error window must reflect only the
        primary's health."""
        try:
            guarded_call("serving.load", backend.load,
                         policy=self.retry_policy)
            return True
        except (MXNetError, RetryExhausted, OSError, ValueError) as err:
            self._count("load_failures")
            if count_circuit:
                self.breaker.record_failure()
            self._load_error = err
            return False

    def _fallback_ready(self) -> bool:
        """A fallback exists AND its load succeeded — a fallback whose
        artifact is itself corrupt must never be routed to."""
        return self.fallback is not None and self._fallback_ok

    def _warm_buckets(self, backend):
        specs = getattr(backend, "input_specs", None) or \
            {getattr(backend, "input_name", "data"):
             tuple(getattr(backend, "row_shape", ()))}
        # probes honor the backend's declared per-input dtypes (default
        # fp32): a quantized backend warms int8 buckets, so its warmed-
        # signature set matches live int8 traffic instead of tripping
        # the strict guard on the first real dispatch
        dtypes = getattr(backend, "input_dtypes", None) or {}
        sizes = self.buckets.sizes
        if self._route_symbolic(backend):
            # warm-up matrix dedupe: one symbolic-dim program subsumes
            # every (coalescer_size, bucket) combo along the batch axis
            # — probe once at the largest size (its symbolic signature
            # covers them all) and report what was skipped
            if backend is self.backend:
                self._count("warmup_skipped_covered", len(sizes) - 1)
            sizes = (sizes[-1],)
        for size in sizes:
            probe = {name: np.zeros((size,) + tuple(row),
                                    np.dtype(dtypes.get(name, "float32")))
                     for name, row in specs.items()}
            if self._packer is not None:
                # packed dispatches always carry the segment-id plane;
                # the probe must too, or live signatures would miss
                probe[self._packer.segment_name] = np.zeros(
                    (size, self._packer.bucket), np.int32)
            self._forward(backend, probe, warming=True)
            if backend is self.backend:
                self._count("warmed_buckets")

    def warm_up(self, strict: bool = True):
        """Load the backend(s) and pre-trace every declared bucket —
        for the fallback too, so degraded mode never eats a compile
        either. With ``strict`` (default) a primary-load failure raises
        unless the fallback loaded — in which case the server comes up
        degraded instead of down.

        With ``max_batch > 1`` the bucket set includes every size the
        coalescer can dispatch (1, max, powers of two between), and each
        probe's shape signature is budgeted into the batched-dispatch
        :class:`~mxnet_tpu_torch.perf.CompileGuard` — a live dispatch outside
        the warmed set is a guard trip (fatal under
        ``MXTPU_RETRACE_STRICT=1``), because it is exactly a production
        cold compile.

        ``warmup_cache_hits``/``warmup_compiles`` in this endpoint's
        stats count what :func:`mxnet_tpu_torch.compiler.stats` saw
        during the warm-up: kernel libraries found already built in the
        on-disk build directory, and kernel libraries ``nvcc`` built. The
        JAX package counts its persistent executable cache's hits and
        XLA compiles under the same keys."""
        from .. import compiler as _compiler
        before = _compiler.stats()
        try:
            return self._warm_up_impl(strict)
        finally:
            after = _compiler.stats()
            self._count("warmup_cache_hits",
                        after["cache"]["hits"] - before["cache"]["hits"])
            self._count("warmup_compiles",
                        after["programs"]["compiled"]
                        - before["programs"]["compiled"])

    def _warm_up_impl(self, strict: bool = True):
        self._load_error = None
        self._load_ok = self._load_one(self.backend)
        if self.fallback is not None:
            self._fallback_ok = self._load_one(self.fallback,
                                               count_circuit=False)
        if not self._load_ok:
            if strict and not self._fallback_ok:
                raise MXNetError(
                    f"serving endpoint {self.name!r}: backend load "
                    f"failed ({self._load_error}) and no fallback is "
                    f"available") from self._load_error
            if self.buckets is not None and self._fallback_ok:
                self._warm_buckets(self.fallback)
            self._warmed = self._fallback_ok
            return self
        if self.buckets is not None:
            self._warm_buckets(self.backend)
            if self._fallback_ok:
                self._warm_buckets(self.fallback)
        self._warmed = True
        return self

    # -- request path --------------------------------------------------------

    def _as_inputs(self, inputs) -> Dict:
        if isinstance(inputs, dict):
            return inputs
        name = getattr(self.backend, "input_name", "data")
        return {name: inputs}

    def submit(self, inputs, deadline: Optional[float] = None,
               tenant: str = DEFAULT_TENANT, priority: int = 0) -> Request:
        """Admit a request; returns immediately with a waitable
        :class:`~.admission.Request` or raises a fast-fail rejection
        (ServerClosed / CircuitOpen / QuotaExceeded / QueueFull).
        ``tenant`` feeds quota + fair-share accounting; higher
        ``priority`` dequeues first and is never evicted in favour of
        lower-priority work."""
        if self._closed:
            raise ServerClosed(f"endpoint {self.name!r} is shut down")
        if self._draining:
            # preemption drain: shed with the RETRIABLE rejection —
            # readyz() already flipped false, the client resubmits to
            # another replica (docs/how_to/preemption.md)
            self._count("drained_rejects")
            raise Draining(
                f"endpoint {self.name!r} is draining after a preemption "
                f"signal; retry against another replica")
        expired = self._queue.expire_queued()
        if expired:                   # dead deadlines don't hold capacity
            self._count("deadline_queued", expired)
        budget = self.default_deadline if deadline is None else deadline
        dl = Deadline(budget, self.clock)
        use_fallback = False
        if self.breaker.state == OPEN:
            if not self._fallback_ready():
                self._count("rejected_open")
                raise CircuitOpen(
                    f"endpoint {self.name!r}: circuit open "
                    f"(backend failing); no fallback available")
            use_fallback = True
        req = Request(self._as_inputs(inputs), dl,
                      use_fallback=use_fallback, tenant=tenant,
                      priority=priority)
        if self._packer is not None:
            length = self._packer.length_of(req)
            if req.rows != 1 or length > self._packer.bucket:
                # same posture as the oversized-rows reject below: a
                # client error, recorded as demand (the histogram is
                # what suggest_buckets mines), never circuit evidence
                self._queue.record_shape(req)
                self._count("shed")
                self._tenant_count(tenant, "shed")
                raise RequestTooLarge(
                    f"packed endpoint {self.name!r} serves single-row "
                    f"requests up to {self._packer.bucket} tokens along "
                    f"axis {self._packer.pack_axis}; got rows="
                    f"{req.rows}, length={length}")
        if self.buckets is not None:
            largest = max(self.buckets.sizes)
            if req.rows > largest:
                # a client error, rejected at admission: letting it ride
                # would fail at pad time AND charge the circuit breaker
                # — one oversized caller must never open the circuit
                # for everyone. Still DEMAND: the shape histogram must
                # see exactly these (they prove a larger bucket is
                # needed), even though the queue never will.
                self._queue.record_shape(req)
                self._count("shed")
                self._tenant_count(tenant, "shed")
                raise RequestTooLarge(
                    f"request of {req.rows} rows exceeds the largest "
                    f"warmed bucket ({largest}) on endpoint "
                    f"{self.name!r}; split the batch or declare a "
                    f"larger bucket")
        try:
            # the quota is enforced by the queue UNDER ITS LOCK — a
            # depth check out here would let concurrent submitters race
            # past the bound together
            evicted = self._queue.offer(req)
        except QuotaExceeded:
            self._count("quota_rejected")
            self._tenant_count(tenant, "quota_rejected")
            raise
        except QueueFull:
            self._count("shed")
            self._tenant_count(tenant, "shed")
            raise
        if evicted is not None:       # evict-oldest shed an older request
            self._count("shed")
            self._count("evicted")
        self._count("admitted")
        self._tenant_count(tenant, "admitted")
        return req

    def predict(self, inputs, deadline: Optional[float] = None,
                tenant: str = DEFAULT_TENANT, priority: int = 0):
        """Synchronous convenience: submit + (in workers=0 mode) drive
        the queue + wait out the deadline."""
        req = self.submit(inputs, deadline=deadline, tenant=tenant,
                          priority=priority)
        if self._n_workers == 0:
            self.run_pending()
        return self.result(req)

    def result(self, req: Request):
        """Wait for ``req`` at most its remaining deadline; on timeout
        abandon it (watchdog: a wedged worker is replaced) and raise
        DeadlineExceeded."""
        remaining = req.deadline.remaining()
        if self._wait(req._event, remaining):
            if req._error is not None:
                raise req._error
            return req._value
        prior = req.abandon()
        if prior == "done":           # raced a just-delivered result
            if req._error is not None:
                raise req._error
            return req._value
        self._count("abandoned")
        self._tenant_count(req.tenant, "abandoned")
        if prior == "running":
            self._count("deadline_inflight")
            self._watchdog_replace(req.worker)
            if not req.use_fallback:
                # a forward wedged past the deadline is failure evidence
                # — without this, a wedged half-open probe would leave
                # the circuit stuck and unreported
                self.breaker.record_failure()
        else:
            self._count("deadline_queued")
        raise DeadlineExceeded(
            f"deadline exceeded while {prior} "
            f"(budget ran out on endpoint {self.name!r})")

    def _watchdog_replace(self, worker):
        """A caller abandoned a request wedged inside ``worker``'s
        forward: write the worker off and keep the pool at strength.
        The wedged mark is check-and-set UNDER the lock — two callers
        abandoning two requests stuck in the SAME worker must spawn one
        replacement, not one each (the unlocked check-then-act would
        double-spawn)."""
        if worker is None:
            return
        with self._lock:
            if worker.wedged:
                return
            worker.wedged = True
            self._stats["wedged_workers"] = \
                self._stats.get("wedged_workers", 0) + 1
        if not self._closed:
            self._spawn_worker()

    def run_pending(self, max_items: Optional[int] = None) -> int:
        """Synchronously drain the queue (the workers=0 mode); returns
        how many requests were processed. Coalescing applies — what is
        queued together and shape-compatible rides one dispatch — but
        nothing ever waits for more traffic (deterministic mode)."""
        done = 0
        while max_items is None or done < max_items:
            first = self._queue.poll()
            if first is None:
                break
            batch = self._coalescer.gather(first, self._queue,
                                           may_wait=False)
            self._process_batch(batch, worker=None)
            done += len(batch)
        return done

    # -- worker side ---------------------------------------------------------

    def _begin_inflight(self, n: int):
        with self._lock:
            self._inflight += n
            self._idle.clear()

    def _take_batch(self, may_wait: bool = True):
        """Worker side: blocking fair pick + coalescing gather. The
        popped request is counted in-flight BEFORE the gather hold —
        a drain racing the take must see it, or it would close the
        server around a request that is neither queued nor dispatched
        yet (gathered mates get the same treatment as they leave the
        queue)."""
        first = self._queue.take(
            on_pop=lambda _r: self._begin_inflight(1))
        if first is None:
            return None
        batch = self._coalescer.gather(first, self._queue,
                                       may_wait=may_wait)
        if len(batch) > 1:
            self._begin_inflight(len(batch) - 1)
        return batch

    def _process_batch(self, batch, worker=None, counted=False):
        if not counted:
            self._begin_inflight(len(batch))
        try:
            self._process_batch_inner(batch, worker=worker)
        finally:
            # depth() is read OUTSIDE self._lock: take(on_pop) counts
            # in-flight under the queue lock, so holding self._lock
            # while taking the queue lock here would invert the order
            # and deadlock. A stale _idle wakeup is harmless — drain
            # re-checks its condition on every loop.
            with self._lock:
                self._inflight -= len(batch)
                inflight = self._inflight
            if inflight == 0 and self._queue.depth() == 0:
                self._idle.set()

    def _process_batch_inner(self, batch, worker=None):
        live = []
        for req in batch:
            if req.deadline.expired():
                # a dead member never rides the dispatch
                if req.fail(DeadlineExceeded(
                        "deadline expired while waiting in queue")):
                    # only count a delivered expiry — the caller-side
                    # watchdog already counted an abandoned one
                    self._count("deadline_queued")
                    self._tenant_count(req.tenant, "deadline_queued")
                continue
            if req.start(worker):     # caller may have abandoned it
                live.append(req)
        if not live:
            return
        # merge ONCE per logical batch: a fallback retry after a primary
        # failure reuses the merged feed, and the dispatch counters
        # count logical batches — never twice for the same passengers
        merged, spans = self._coalescer.merge(live)
        self._count("dispatches")
        if self._packer is not None:
            self._count("packed_dispatches")
        if len(live) > 1:
            self._count("coalesced_requests", len(live))
        try:
            if live[0].use_fallback:  # signature-homogeneous batch
                per_req = self._dispatch(self.fallback, merged, spans)
                self._count("degraded", len(live))
            else:
                per_req = self._try_primary_batch(live, merged, spans)
                if per_req is None:   # rejection already recorded
                    return
        except Exception as err:      # noqa: BLE001 — delivered to callers
            self._fail_batch(live, err)
            return
        self._count("completed", len(live))
        for req, outs in zip(live, per_req):
            self._tenant_count(req.tenant, "completed")
            req.complete(outs)

    def _fail_batch(self, live, err):
        """One dispatch died: every member fails, the multi-request case
        with the *retriable* BatchFailed (the batch says nothing about
        any individual request), the single-request case with the raw
        backend error (the pre-batching contract)."""
        self._count("failed", len(live))
        if len(live) > 1:
            self._count("batch_failures")
            for req in live:
                self._tenant_count(req.tenant, "failed")
                # an unwarmed signature is ABOUT every member (they all
                # share it): deliver the typed non-retriable error raw —
                # wrapping it retriable would invite a doomed resubmit
                req.fail(err if isinstance(err, UnwarmedSignature)
                         else BatchFailed(
                    f"coalesced dispatch of {len(live)} requests failed "
                    f"on endpoint {self.name!r}: {err}", cause=err))
        else:
            self._tenant_count(live[0].tenant, "failed")
            live[0].fail(err)

    def _try_primary_batch(self, live, merged, spans):
        """Primary forward under the circuit breaker, falling back to
        the fallback model on open-circuit or forward failure. Breaker
        evidence is PER DISPATCH — one success or one failure no matter
        how many requests rode it. Returns per-request outputs, or None
        after failing the members directly."""
        if not self.breaker.allow():
            if self._fallback_ready():
                for req in live:
                    req.use_fallback = True   # the watchdog must not
                self._count("degraded", len(live))  # charge the primary
                return self._dispatch(self.fallback, merged, spans)
            self._count("rejected_open", len(live))
            for req in live:
                req.fail(CircuitOpen(
                    f"endpoint {self.name!r}: circuit open; no fallback"))
            return None
        try:
            per_req = self._dispatch(self.backend, merged, spans)
        except UnwarmedSignature:
            # a client/config error (wrong dtype, undeclared input) —
            # not backend-health evidence; never charge the breaker
            raise
        except Exception:
            self.breaker.record_failure()     # once per dispatch
            if self._fallback_ready():
                for req in live:
                    req.use_fallback = True
                self._count("degraded", len(live))
                return self._dispatch(self.fallback, merged, spans)
            raise
        self.breaker.record_success()         # once per dispatch
        with self._lock:
            self._last_success = self.clock()
        return per_req

    def _dispatch(self, backend, merged, spans):
        """Run ONE forward over the merged feed, scatter the rows back
        per member."""
        outs = self._forward(backend, merged)
        return self._coalescer.scatter(outs, spans)

    def _forward(self, backend, inputs: Dict, warming: bool = False):
        """One backend forward with bucket padding/unpadding around it.
        The ``serving.forward`` fault site guards the *primary* backend
        only — the fallback is the degradation answer to that fault, so
        injecting into it would make degraded mode untestable. The
        padded feed's shape signature is checked against the warmed set
        (warm-up probes register it, live dispatches observe it).

        The ragged rungs hang here: a symbolic-dim backend skips the
        batch-axis padding entirely (one program serves any row count,
        the signature is the batch-axis-wildcarded form); a mask-
        accepting backend gets a 0/1 row mask so its pad rows are
        mask-dead; and every live dispatch's real-vs-padded rows x
        tokens land in the :class:`~.ragged.PadWasteTracker`."""
        if backend is self.backend:
            faults.fault_point("serving.forward")
        if self.buckets is None:
            if not warming:
                rows = next((int(b.shape[0]) for b in inputs.values()
                             if getattr(b, "shape", None)), 0)
                self._record_waste(backend, inputs, rows)
            return backend.infer(inputs)
        symbolic = self._route_symbolic(backend)
        if symbolic:
            fed = dict(inputs)
            true_rows = next((int(b.shape[0]) for b in fed.values()
                              if getattr(b, "shape", None)), 0)
        else:
            # all inputs are batch-major: pad each to the same bucket
            fed, true_rows = {}, None
            for name, batch in inputs.items():
                fed[name], rows = self.buckets.pad_batch(batch)
                true_rows = rows if true_rows is None else true_rows
        if (self.ragged and self._packer is None
                and getattr(backend, "accepts_mask", False)):
            # length-masked compute: 1.0 = real row, 0.0 = pad row —
            # warm-up probes take the same input (all-real at the
            # bucket size) so the signature sets agree
            padded = next((int(b.shape[0]) for b in fed.values()
                           if getattr(b, "shape", None)), 0)
            row_mask = np.zeros((padded,), np.float32)
            row_mask[:true_rows] = 1.0
            fed[getattr(backend, "mask_name", "mask")] = row_mask
        route = "primary" if backend is self.backend else "fallback"
        if self.max_batch > 1 or self._packer is not None or symbolic:
            # the warmed-signature contract is part of opting into
            # batching (or a ragged rung): a pre-batching bucketed
            # server whose backend never declared row specs must keep
            # serving exactly as it did (its probe shapes cannot match
            # live traffic)
            if warming:
                self._coalescer.expect_signature(fed, route,
                                                 symbolic=symbolic)
            else:
                self._coalescer.observe_signature(fed, route,
                                                  symbolic=symbolic)
        if not warming:
            self._record_waste(backend, fed, true_rows)
        outs = backend.infer(fed)
        return self.buckets.slice_outputs(outs, true_rows)

    def _record_waste(self, backend, fed: Dict, true_rows: int):
        """Pad-waste accounting for one LIVE dispatch (warm-up probes
        are synthetic traffic and never recorded)."""
        rr, pr, rt, pt = dispatch_waste(
            fed, true_rows,
            pack_axis=getattr(backend, "pack_axis", None),
            lengths_name=getattr(backend, "lengths_name", None),
            segment_name=getattr(backend, "segment_name", "segment_ids"))
        self._pad_waste.record(rr, pr, rt, pt)

    # -- fleet hooks (mxnet_tpu/serving/fleet.py) -----------------------------

    def load_factor(self) -> int:
        """Queued + in-flight requests — the router's least-loaded
        routing signal. Cheap enough to read per submit."""
        with self._lock:
            inflight = self._inflight
        return self._queue.depth() + inflight

    def shed_queued(self, make_error) -> int:
        """Fail every queued request with ``make_error(request)`` —
        the fleet eviction path: an evicted replica's backlog becomes
        typed retriable rejections the router re-dispatches on, never
        silently stranded work. Returns delivered failures."""
        shed = self._queue.shed_all(make_error)
        if shed:
            self._count("shed", shed)
        return shed

    # -- probes / introspection ----------------------------------------------

    def healthz(self) -> Dict:
        """Liveness + vitals: queue depth, circuit state, worker pool,
        age of the last successful primary forward."""
        alive = [w for w in self._workers if w.is_alive() and not w.wedged]
        with self._lock:
            last = self._last_success
        return {
            "ok": not self._closed,
            "draining": self._draining,
            "inflight": self._inflight,
            "queue_depth": self._queue.depth(),
            "queue_capacity": self._queue.capacity,
            "circuit": self.breaker.state,
            "workers": {"configured": self._n_workers,
                        "alive": len(alive),
                        "wedged": self._stats["wedged_workers"]},
            "last_success_age": (None if last is None
                                 else self.clock() - last),
            "warmed": self._warmed,
            "max_batch": self.max_batch,
            "degraded": self.breaker.state == OPEN
                        and self._fallback_ready(),
        }

    def readyz(self) -> Dict:
        """Readiness: warmed up, accepting, and able to serve — either
        the circuit is not open, or a fallback stands in."""
        reasons = []
        if self._closed:
            reasons.append("server closed")
        if self._draining:
            # flips false the INSTANT the signal lands — the balancer
            # stops routing here while in-flight requests finish
            reasons.append("draining (preemption signal)")
        if not self._warmed:
            reasons.append("not warmed up")
        if self.breaker.state == OPEN and not self._fallback_ready():
            reasons.append("circuit open with no fallback")
        if self._queue.depth() >= self._queue.capacity:
            reasons.append("admission queue full")
        return {"ready": not reasons, "reasons": reasons}

    def stats(self) -> Dict:
        with self._lock:
            counters = dict(self._stats)
            per_tenant = {t: dict(c) for t, c in self._tenant_stats.items()}
        counters["queue"] = {"depth": self._queue.depth(),
                             "admitted": self._queue.admitted,
                             "shed": self._queue.shed,
                             "evicted": self._queue.evicted,
                             # observed demand per (rows, shapes, dtype)
                             # — the bucket-mining feed
                             "shape_histogram":
                                 self._queue.shape_histogram()}
        counters["circuit"] = self.breaker.stats()
        counters["per_tenant"] = per_tenant
        # real vs padded rows x tokens, per dispatch and cumulative
        # (serving/ragged.py); pure observability, never logged
        counters["pad_waste"] = self._pad_waste.snapshot()
        counters["ragged"] = {
            "enabled": self.ragged,
            "packing": self._packer is not None,
            "symbolic": self._route_symbolic(self.backend),
            "pack_bucket": (self._packer.bucket
                            if self._packer is not None else None)}
        counters["batching"] = {
            "max_batch": self.max_batch,
            "batch_wait_ms": self.batch_wait * 1000.0,
            "dispatches": counters["dispatches"],
            "coalesced_requests": counters["coalesced_requests"],
            "warmed_signatures": self._batch_guard.expected,
            "unwarmed_dispatch_signatures": max(
                0, self._batch_guard.count - self._batch_guard.expected)}
        return counters

    # -- graceful drain (docs/how_to/preemption.md) ---------------------------

    def install_signal_handlers(self, signals=None):
        """Subscribe this endpoint to the shared preemption
        :class:`~mxnet_tpu_torch.resilience.SignalRuntime` (the one the
        training supervisor uses, so a process that trains AND serves
        handles one SIGTERM coherently). First signal: ``readyz()``
        flips false immediately, admission sheds with the retriable
        :class:`~.errors.Draining` error, a daemon thread finishes the
        in-flight requests within their deadlines and closes the
        server. Second signal: close immediately."""
        import signal as _signal

        from ..resilience.supervisor import signal_runtime
        self._signals = (tuple(signals) if signals is not None
                         else (_signal.SIGTERM, _signal.SIGINT))
        signal_runtime().subscribe(self, self._signals)
        return self

    def on_signal(self, signum: int):
        """SignalRuntime dispatch target (tests inject via
        ``signal_runtime().deliver(signum)``)."""
        if not self._draining:
            self._draining = True           # readyz false NOW
            # handler context: _count() takes self._lock, which the
            # interrupted thread may hold — the nolock bump is the
            # handler-safe form
            self._count_nolock("drain_signals")
            if self._n_workers == 0:
                # deterministic mode: the caller drives run_pending();
                # draining completes on its next predict/run_pending
                return
            # the grace bound matters: a WEDGED worker never decrements
            # the in-flight count, and an unbounded drain would then
            # hold the pod until the scheduler's SIGKILL
            threading.Thread(target=self.drain, daemon=True,
                             kwargs={"grace": self.drain_grace},
                             name=f"serving-drain-{self.name}").start()
            return
        self._count_nolock("drain_signals")
        # second signal: abort the drain NOW — but not from inside the
        # handler. close() takes the endpoint-registry lock and the
        # queue condition; if the interrupted thread holds either, a
        # handler-context close() self-deadlocks and the scheduler's
        # SIGKILL lands on a wedged process. The closed flag flips here
        # (GIL-atomic; submit fast-fails instantly), the lock-taking
        # teardown runs on its own thread.
        self._closed = True
        threading.Thread(target=self.close, daemon=True,
                         kwargs={"join_timeout": 0.1},
                         name=f"serving-abort-{self.name}").start()

    def drain(self, grace: Optional[float] = None, poll: float = 0.1):
        """Stop admission and finish the in-flight work — the in-flight
        COALESCED batch included: its members are counted in-flight
        until their outputs scatter — then ``close()``. Queued requests
        and expiry checks are deadline-bounded, but a request WEDGED
        inside a backend call is not (the deadline is only enforced
        around the call, not inside it) — so ``grace`` bounds the whole
        drain; the signal path passes ``drain_grace``. In ``workers=0``
        mode the caller's thread drains the queue synchronously —
        deterministic, zero sleeps."""
        self._draining = True
        start = self.clock()
        if self._n_workers == 0:
            self.run_pending()
        else:
            while self._queue.depth() > 0 or self._inflight > 0:
                if grace is not None and self.clock() - start > grace:
                    break
                self._idle.wait(poll)
        self.close()
        return self

    def close(self, join_timeout: float = 2.0):
        """Stop accepting, wake the workers, unregister the endpoint."""
        self._closed = True
        self._queue.close()
        with self._lock:
            workers = list(self._workers)   # _spawn_worker may append
        for worker in workers:
            if worker.is_alive() and not worker.wedged:
                worker.join(timeout=join_timeout)
        if getattr(self, "_signals", None):
            from ..resilience.supervisor import signal_runtime
            signal_runtime().unsubscribe(self)
            self._signals = None
        with _endpoints_lock:
            if _ENDPOINTS.get(self.name) is self:
                del _ENDPOINTS[self.name]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

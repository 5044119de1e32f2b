"""Admission control: deadlines, requests, tenants, and the bounded queue.

Counterpart of ``mxnet_tpu/serving/admission.py``, host logic held bit
for bit against it.

The queue is the only place a request may wait, and it is bounded:
beyond ``capacity`` the runtime *sheds* — either the new arrival
(``policy='reject'``, the default) or the oldest queued request
(``policy='evict-oldest'``, which favours fresh traffic whose deadline
still has budget). Shedding is immediate (:class:`~.errors.QueueFull`),
so burst overload degrades to fast-fail instead of unbounded latency.

Requests carry a ``tenant`` and a ``priority``. Eviction respects
priority strictly: the victim is the *oldest among the lowest-priority*
queued requests, and a strictly-higher-priority request is never
evicted while a lower-priority one is queued — an arrival that would
require that is itself shed instead. Dequeue order is priority-strict
too, with **weighted fair** selection between tenants at the same
priority (stride scheduling over :class:`TenantPolicy` weights), FIFO
within a tenant. Per-tenant quotas cap how much of the queue one tenant
may hold (:class:`~.errors.QuotaExceeded`, retriable).

Deadlines are absolute timestamps on an injectable clock
(``expires_at = clock() + budget``), so tests drive every expiry path —
including a backward clock jump, which *extends* the remaining budget
rather than spuriously expiring the request — with zero real sleeps.

The ``serving.queue`` fault site sits at the top of :meth:`offer` behind
the resilience retry policy
(:func:`~mxnet_tpu_torch.resilience.guarded_point`), mirroring
``io.next``: injected retriable faults exercise the backoff
path, then admission proceeds exactly once.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ..base import MXNetError
from ..resilience import guarded_point
from .errors import (DeadlineExceeded, QueueFull, QuotaExceeded,
                     ServerClosed)

__all__ = ["Deadline", "Request", "AdmissionQueue", "TenantPolicy",
           "StrideScheduler", "DEFAULT_TENANT"]

DEFAULT_TENANT = "default"


class Deadline:
    """An absolute expiry on an injectable clock (None = no budget)."""

    __slots__ = ("clock", "expires_at")

    def __init__(self, budget: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.expires_at = None if budget is None else clock() + budget

    def remaining(self) -> Optional[float]:
        """Seconds left, negative if already expired, None if unbounded.
        A backward clock jump makes this *grow* — a request is only ever
        expired by the clock moving past ``expires_at``."""
        if self.expires_at is None:
            return None
        return self.expires_at - self.clock()

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0


class Request:
    """One in-flight inference request: inputs + deadline + a settable
    result slot the caller waits on. States: queued -> running -> done.
    ``abandon()`` is the caller-side watchdog giving up — a late result
    from a wedged worker is then discarded, never delivered.

    ``tenant``/``priority`` feed admission accounting and dequeue order;
    ``rows`` is the leading-axis size of the inputs, what the batch
    coalescer budgets against ``MXTPU_MAX_BATCH``."""

    __slots__ = ("inputs", "deadline", "use_fallback", "state", "worker",
                 "enqueued_at", "tenant", "priority", "_event", "_value",
                 "_error", "_lock", "_sig")

    def __init__(self, inputs, deadline: Deadline, use_fallback=False,
                 tenant: str = DEFAULT_TENANT, priority: int = 0):
        self.inputs = inputs
        self.deadline = deadline
        self.use_fallback = use_fallback
        self.tenant = tenant
        self.priority = int(priority)
        self.state = "queued"
        self.worker = None
        self.enqueued_at = deadline.clock()
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._lock = threading.Lock()
        self._sig = None              # batching.request_signature cache

    @property
    def rows(self) -> int:
        """Leading-axis rows of the inputs (1 when unknown/scalar)."""
        if isinstance(self.inputs, dict):
            for batch in self.inputs.values():
                shape = getattr(batch, "shape", None)
                if shape:
                    return int(shape[0])
            return 1
        shape = getattr(self.inputs, "shape", None)
        return int(shape[0]) if shape else 1

    def complete(self, value) -> bool:
        """Deliver a result; False if the caller already abandoned."""
        with self._lock:
            delivered = self.state != "abandoned"
            if delivered:
                self._value = value
                self.state = "done"
            self._event.set()
            return delivered

    def fail(self, error: BaseException) -> bool:
        with self._lock:
            delivered = self.state != "abandoned"
            if delivered:
                self._error = error
                self.state = "done"
            self._event.set()
            return delivered

    def start(self, worker) -> bool:
        """Worker claims the request (queued -> running); False when the
        caller already abandoned it (the worker must then drop it)."""
        with self._lock:
            if self.state != "queued":
                return False
            self.worker = worker
            self.state = "running"
            return True

    def abandon(self) -> str:
        """Caller gives up (deadline hit while queued or in flight).
        Returns the state the request was in, so the server can tell a
        merely-queued request from one wedged inside a forward."""
        with self._lock:
            prior = self.state
            if prior != "done":
                self.state = "abandoned"
            return prior

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def peek(self):
        """Non-consuming outcome probe: ``('pending', None)`` until the
        request settles, then ``('value', v)`` or ``('error', e)``. The
        fleet router's re-dispatch dedupe reads this — a prior attempt
        that raced to a value must be delivered instead of re-running
        the request on another replica."""
        with self._lock:
            if self.state != "done" or not self._event.is_set():
                return ("pending", None)
            if self._error is not None:
                return ("error", self._error)
            return ("value", self._value)


class TenantPolicy:
    """Per-tenant admission quotas and fair-share weights.

    ``quota`` bounds how many requests a tenant may hold queued at once
    (None = unbounded); ``weight`` scales its share of the dequeue
    bandwidth at equal priority (stride scheduling: a weight-2 tenant is
    picked twice as often as a weight-1 tenant under contention).
    Unlisted tenants get the ``default_quota``/``default_weight``.

    Parsed from ``MXTPU_TENANT_QUOTAS`` by :meth:`parse`, either the
    compact form ``"name:quota[:weight],..."`` (quota ``*`` = unbounded)
    or a JSON object ``{"name": {"quota": n, "weight": w}, ...}``.
    """

    def __init__(self, tenants: Optional[Dict[str, Dict]] = None,
                 default_quota: Optional[int] = None,
                 default_weight: float = 1.0):
        self._tenants: Dict[str, Dict] = {}
        self.default_quota = default_quota
        self.default_weight = float(default_weight)
        for name, spec in (tenants or {}).items():
            quota = spec.get("quota")
            weight = float(spec.get("weight", default_weight))
            if quota is not None and int(quota) < 1:
                raise MXNetError(
                    f"tenant {name!r}: quota must be >= 1 or None/'*' "
                    f"(got {quota!r})")
            if weight <= 0:
                raise MXNetError(
                    f"tenant {name!r}: weight must be > 0 (got {weight!r})")
            self._tenants[name] = {"quota": (None if quota is None
                                             else int(quota)),
                                   "weight": weight}

    @classmethod
    def parse(cls, spec: Optional[str]) -> Optional["TenantPolicy"]:
        """Build a policy from the ``MXTPU_TENANT_QUOTAS`` string; None
        or empty disables tenant quotas (weights default to 1)."""
        if not spec or not spec.strip():
            return None
        spec = spec.strip()
        if spec.startswith("{"):
            try:
                table = json.loads(spec)
            except ValueError as err:
                raise MXNetError(
                    f"malformed MXTPU_TENANT_QUOTAS JSON: {err}") from err
            if not isinstance(table, dict) or not all(
                    isinstance(v, dict) for v in table.values()):
                raise MXNetError(
                    "MXTPU_TENANT_QUOTAS JSON must map tenant name -> "
                    '{"quota": n|null, "weight": w}')
            return cls(table)
        tenants: Dict[str, Dict] = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            parts = item.split(":")
            if len(parts) not in (2, 3) or not parts[0]:
                raise MXNetError(
                    f"malformed MXTPU_TENANT_QUOTAS entry {item!r}; "
                    f"expected name:quota[:weight]")
            try:
                quota = None if parts[1] in ("*", "") else int(parts[1])
                weight = float(parts[2]) if len(parts) == 3 else 1.0
            except ValueError as err:
                raise MXNetError(
                    f"malformed MXTPU_TENANT_QUOTAS entry {item!r}: "
                    f"{err}") from err
            tenants[parts[0]] = {"quota": quota, "weight": weight}
        return cls(tenants)

    def quota(self, tenant: str) -> Optional[int]:
        spec = self._tenants.get(tenant)
        return spec["quota"] if spec else self.default_quota

    def weight(self, tenant: str) -> float:
        spec = self._tenants.get(tenant)
        return spec["weight"] if spec else self.default_weight

    def tenants(self) -> Dict[str, Dict]:
        return {name: dict(spec) for name, spec in self._tenants.items()}


class StrideScheduler:
    """Weighted-fair stride state: one virtual clock per tenant, advanced
    by ``1/weight`` on every pick, smallest clock dispatches next.

    Extracted from the queue so the state is *shareable*: a single
    :class:`AdmissionQueue` owns a private instance (per-queue
    fairness), while the fleet router hands every replica's
    queue ONE instance — a tenant's fair share is then measured against
    its dispatches across the whole fleet, not per replica queue
    (docs/how_to/fleet.md). Thread-safe under its own lock; the lock
    order is queue -> stride, and the scheduler never calls back into a
    queue.

    A tenant first seen (or re-entering after idling/pruning) starts AT
    the incumbents' floor — its fair share runs from here on, never a
    monopoly refund of virtual time it did not spend waiting.
    """

    #: hard cap on the clock map in SHARED (fleet) mode, where one
    #: queue's queued-tenant set says nothing about the others'
    SHARED_CAP = 65536

    def __init__(self):
        self._vtime: Dict[str, float] = {}
        self._lock = threading.Lock()
        #: the fleet router flips this on the instance it shares: a
        #: per-queue ``prune_to`` must then be ignored — pruning against
        #: ONE queue's queued tenants would drop every other replica
        #: queue's clocks and refund heavy tenants to the floor
        self.shared = False

    def pick(self, candidates, weight: Callable[[str], float],
             prune_to=None, bound: int = 64) -> str:
        """Pick the candidate tenant with the smallest virtual clock
        (name-ordered tie break) and advance it by ``1/weight(tenant)``.
        ``prune_to``/``bound`` cap the clock map against client-invented
        tenant names: past ``bound`` entries, tenants outside
        ``prune_to`` are dropped (they re-enter at the floor anyway —
        the documented idle rule). In shared mode that per-queue prune
        is ignored; instead a hard cap drops the LOWEST clocks — a
        dropped tenant re-enters at (or above) the floor, so the prune
        can penalize an idle tenant slightly but never refund a heavy
        one."""
        with self._lock:
            existing = [self._vtime[t] for t in candidates
                        if t in self._vtime]
            floor = min(existing) if existing else 0.0
            tenant = min(candidates,
                         key=lambda t: (self._vtime.get(t, floor), t))
            self._vtime[tenant] = (max(self._vtime.get(tenant, floor),
                                       floor) + 1.0 / weight(tenant))
            if self.shared:
                if len(self._vtime) > self.SHARED_CAP:
                    keep = sorted(self._vtime.items(),
                                  key=lambda kv: kv[1],
                                  reverse=True)[:self.SHARED_CAP // 2]
                    self._vtime = dict(keep)
            elif prune_to is not None and len(self._vtime) > bound:
                self._vtime = {t: v for t, v in self._vtime.items()
                               if t in prune_to}
            return tenant

    def clocks(self) -> Dict[str, float]:
        """Snapshot of the per-tenant virtual clocks (introspection)."""
        with self._lock:
            return dict(self._vtime)


def _shape_key(req: Request) -> str:
    """Compact histogram key: leading-axis rows + sorted per-input
    (name, per-row shape, dtype) — the same facts
    ``batching.request_signature`` merges on, stringified for stats."""
    parts = []
    if isinstance(req.inputs, dict):
        for name in sorted(req.inputs):
            arr = req.inputs[name]
            shape = tuple(getattr(arr, "shape", ()))
            dtype = str(getattr(arr, "dtype", type(arr).__name__))
            parts.append(f"{name}:{shape[1:]}:{dtype}")
    return f"{req.rows}r|" + ";".join(parts)


class AdmissionQueue:
    """Bounded queue between submitters and workers.

    ``offer`` never blocks: at capacity it sheds (per policy) instead.
    ``take`` blocks until an item arrives or the queue is closed (then
    returns None); ``poll`` is the non-blocking variant that drives the
    deterministic ``workers=0`` mode. Dequeue order: highest priority
    first; at equal priority, weighted-fair across tenants (stride
    scheduling over ``tenants`` weights), FIFO within a tenant — plain
    FIFO when neither priorities nor tenant weights are in play.

    ``on_tenant_event(tenant, key, n)`` is the server's per-tenant
    counter hook: the queue credits expirations and evictions to the
    owning tenant through it (one counter surface, owned by the server).
    """

    POLICIES = ("reject", "evict-oldest")
    _SHAPE_HIST_CAP = 128
    _SHAPE_HIST_OVERFLOW = "__other__"

    def __init__(self, capacity: int = 64, policy: str = "reject",
                 clock: Callable[[], float] = time.monotonic,
                 tenants: Optional[TenantPolicy] = None,
                 on_tenant_event: Optional[Callable] = None,
                 stride: Optional[StrideScheduler] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}")
        self.capacity = capacity
        self.policy = policy
        self.clock = clock
        self.tenants = tenants
        self._on_tenant_event = on_tenant_event or (lambda *a, **k: None)
        self._cv = threading.Condition()
        self._items: deque = deque()  # guarded by _cv
        # observed request-shape histogram (rows + per-input row shape/
        # dtype -> arrivals): the raw demand distribution bucket mining
        # (warmup.suggest_buckets) feeds on — serving buckets are
        # static guesses; this records what traffic actually asks for.
        # Bounded: past _SHAPE_HIST_CAP distinct keys new shapes fold
        # into the overflow bucket (client-invented shapes must not
        # grow the map without bound).
        self._shape_hist: Dict[str, int] = {}  # guarded by _cv
        # private by default (per-queue fairness);
        # the fleet router passes one shared instance per replica queue
        # so fair shares are measured fleet-wide
        self.stride = stride or StrideScheduler()
        self.open = True
        self.admitted = 0
        self.shed = 0
        self.evicted = 0

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    depth = __len__

    # -- enqueue (with priority-safe shedding) -------------------------------

    def _victim_index(self) -> int:
        """Oldest among the lowest-priority queued requests — eviction
        must never take a strictly-higher-priority request while a
        lower-priority one is queued (the starvation fix)."""
        low = min(r.priority for r in self._items)
        for i, req in enumerate(self._items):
            if req.priority == low:
                return i
        raise AssertionError("unreachable: queue emptied under the lock")

    def offer(self, req: Request) -> Optional[Request]:
        """Admit ``req`` or shed. Raises QueueFull when the request
        itself is rejected; with evict-oldest the *evicted* request is
        failed with QueueFull and the new one is admitted — the evicted
        request is returned so the caller can account for it. A new
        arrival is also rejected (never admitted by eviction) when every
        queued request outranks it: eviction strictly favours priority.
        Tenant quotas are enforced HERE, under the queue lock — a
        check outside it would let concurrent submitters race past the
        bound (:class:`~.errors.QuotaExceeded`, retriable)."""
        guarded_point("serving.queue")
        evicted = None
        with self._cv:
            if not self.open:
                # closed != full: racing a shutdown must read as
                # shutdown, not as retryable overload
                raise ServerClosed("admission queue is closed")
            # every arrival that reached admission counts toward the
            # observed-shape histogram — shed requests included, because
            # bucket mining needs the DEMAND distribution, not just
            # what capacity happened to admit
            self._record_shape_locked(req)
            if self.tenants is not None:
                quota = self.tenants.quota(req.tenant)
                if quota is not None and sum(
                        1 for r in self._items
                        if r.tenant == req.tenant) >= quota:
                    raise QuotaExceeded(
                        f"tenant {req.tenant!r} is at its admission "
                        f"quota ({quota} queued); retry after earlier "
                        f"requests complete")
            if len(self._items) >= self.capacity:
                if self.policy == "reject":
                    self.shed += 1
                    raise QueueFull(
                        f"admission queue at capacity ({self.capacity}); "
                        f"request shed")
                idx = self._victim_index()
                victim = self._items[idx]
                if victim.priority > req.priority:
                    # every queued request outranks the arrival: shed
                    # the arrival, never the higher-priority work
                    self.shed += 1
                    raise QueueFull(
                        f"admission queue at capacity ({self.capacity}) "
                        f"with only higher-priority requests queued; "
                        f"request shed")
                del self._items[idx]
                evicted = victim
                self.shed += 1
                self.evicted += 1
            self._items.append(req)
            self.admitted += 1
            # wake EVERY waiter class: a single notify could land on a
            # gatherer in wait_arrival() that cannot use this request,
            # leaving an idle take() worker asleep with work queued
            self._cv.notify_all()
        if evicted is not None:
            self._on_tenant_event(evicted.tenant, "evicted")
            evicted.fail(QueueFull(
                f"shed from queue (evict-oldest, capacity "
                f"{self.capacity}): a newer request took the slot"))
        return evicted

    # -- fair pick -----------------------------------------------------------

    def _weight(self, tenant: str) -> float:
        return self.tenants.weight(tenant) if self.tenants else 1.0

    def _pick_locked(self) -> Optional[Request]:
        """Highest priority first; weighted-fair across tenants at that
        priority (stride scheduling: pick the smallest virtual time,
        advance it by 1/weight); FIFO within a tenant. Without a
        TenantPolicy, tenant labels carry no scheduling weight — the
        pick is plain FIFO within the top priority, as documented."""
        if not self._items:
            return None
        first = self._items[0]
        if all(r.priority == first.priority and r.tenant == first.tenant
               for r in self._items):
            # fast path — also keeps single-tenant order byte-stable
            # across the no-tenant and tenant-configured configurations
            self._items.popleft()
            return first
        top = max(r.priority for r in self._items)
        if self.tenants is None:
            # no policy: labels are accounting metadata, not weights
            for i, req in enumerate(self._items):
                if req.priority == top:
                    del self._items[i]
                    return req

        heads: Dict[str, int] = {}
        for i, req in enumerate(self._items):
            if req.priority == top and req.tenant not in heads:
                heads[req.tenant] = i
        tenant = self.stride.pick(
            heads, self._weight,
            prune_to={r.tenant for r in self._items},
            bound=4 * max(16, len(self._items)))
        idx = heads[tenant]
        req = self._items[idx]
        del self._items[idx]
        return req

    def take(self, on_pop: Optional[Callable] = None) -> Optional[Request]:
        """Worker side: block for the next request; None once closed.
        ``on_pop`` runs on the popped request UNDER THE QUEUE LOCK,
        before it is returned — the server counts the request in-flight
        there, so a drain polling depth/in-flight can never catch it in
        the gap between leaving the queue and being accounted."""
        with self._cv:
            while not self._items and self.open:
                self._cv.wait()
            req = self._pick_locked()
            if req is not None and on_pop is not None:
                on_pop(req)
            return req

    def poll(self) -> Optional[Request]:
        """Non-blocking take (drives the synchronous workers=0 mode)."""
        with self._cv:
            return self._pick_locked()

    def poll_compatible(self, predicate: Callable[[Request], bool]
                        ) -> Optional[Request]:
        """Pop the first queued request satisfying ``predicate`` (the
        batch coalescer's merge scan). Skipped requests keep their
        positions — coalescing pulls shape-mates out of line, everything
        else is untouched."""
        with self._cv:
            for i, req in enumerate(self._items):
                if predicate(req):
                    del self._items[i]
                    return req
            return None

    def wait_arrival(self, since: int, timeout: float) -> int:
        """Block until a NEW request is admitted (``admitted`` moves
        past ``since``), the queue closes, or ``timeout`` elapses;
        returns the current admitted count. The threaded coalescer's
        wait-for-more-traffic step: keyed on arrivals, not non-empty,
        so a backlog of merge-incompatible requests cannot busy-spin
        the gathering worker — and the wait is real wall time, so an
        injected non-advancing clock cannot wedge it either."""
        with self._cv:
            if self.admitted == since and self.open:
                self._cv.wait(timeout)
            return self.admitted

    def _record_shape_locked(self, req: Request):
        key = _shape_key(req)
        if (key not in self._shape_hist
                and len(self._shape_hist) >= self._SHAPE_HIST_CAP):
            key = self._SHAPE_HIST_OVERFLOW
        self._shape_hist[key] = self._shape_hist.get(key, 0) + 1

    def record_shape(self, req: Request):
        """Count a request that never reaches :meth:`offer` into the
        demand histogram — the server calls this for oversized requests
        rejected at submit: the shapes proving a larger bucket is
        needed are exactly the ones bucket mining must see."""
        with self._cv:
            self._record_shape_locked(req)

    def shape_histogram(self) -> Dict[str, int]:
        """Snapshot of the observed request-shape histogram (feeds the
        ``serving.stats()`` queue block; docs/how_to/serving.md)."""
        with self._cv:
            return dict(self._shape_hist)

    def expire_queued(self) -> int:
        """Fail every queued request whose deadline has passed, freeing
        their capacity slots; returns how many expiries were *delivered*
        (already-abandoned requests are reclaimed but not re-counted).
        Each expiry is credited to the owning tenant's counters. Called
        on every submit so dead deadlines never crowd out live traffic."""
        expired = []
        with self._cv:
            live = deque()
            for req in self._items:
                if req.deadline.expired():
                    expired.append(req)
                else:
                    live.append(req)
            self._items = live
        delivered = 0
        for req in expired:
            if req.fail(DeadlineExceeded(
                    "deadline expired while waiting in queue "
                    f"(queued {req.deadline.clock() - req.enqueued_at:.3f}s)")):
                # credited to the owning tenant only when delivered —
                # the caller-side abandon path already counted the rest
                self._on_tenant_event(req.tenant, "deadline_queued")
                delivered += 1
        return delivered

    def shed_all(self, make_error: Callable[[Request], BaseException]) -> int:
        """Pop EVERY queued request and fail it with
        ``make_error(request)`` — the eviction path of the fleet router:
        a replica leaving the fleet must turn its whole backlog into
        typed *retriable* rejections the waiting callers re-dispatch on,
        not silently strand it behind a closed queue. Returns how many
        failures were delivered (abandoned requests are reclaimed but
        not re-counted); each is credited to the owning tenant."""
        with self._cv:
            victims = list(self._items)
            self._items.clear()
            self._cv.notify_all()
        delivered = 0
        for req in victims:
            if req.fail(make_error(req)):
                self._on_tenant_event(req.tenant, "shed")
                delivered += 1
        return delivered

    def close(self):
        with self._cv:
            self.open = False
            self._cv.notify_all()

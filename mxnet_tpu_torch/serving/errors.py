"""Serving-runtime error taxonomy (docs/how_to/serving.md).

Counterpart of ``mxnet_tpu/serving/errors.py``, every class (the
fleet's included, for the fleet that follows).

Every rejection the runtime can produce is a distinct, catchable type so
callers (and the C predict ABI shim above them) can map them onto
transport-level status codes: ``QueueFull`` -> 429/503 shed,
``DeadlineExceeded`` -> 504, ``CircuitOpen`` -> 503 degraded,
``ServerClosed`` -> connection refused. All derive from
:class:`~mxnet_tpu_torch.base.MXNetError` so blanket MXNet error handling
still works, and none derive from OSError/TimeoutError — a rejection is
a *decision*, not a transient fault, and must never be swallowed by a
retry policy.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "QueueFull", "DeadlineExceeded", "CircuitOpen",
           "ServerClosed", "Draining", "QuotaExceeded", "BatchFailed",
           "SlotsFull", "RequestTooLarge", "UnwarmedSignature",
           "ReplicaEvicted", "FleetUnavailable"]


class ServingError(MXNetError):
    """Base class for serving-runtime rejections."""


class QueueFull(ServingError):
    """The admission queue is at capacity: the request was shed (or, with
    the evict-oldest policy, an older queued request was shed in its
    favour). Raised *immediately* at submit time — load shedding means
    fast-fail, never unbounded queueing latency."""


class DeadlineExceeded(ServingError):
    """The request's deadline budget ran out — while waiting in queue,
    or while its forward was in flight (the caller is released by the
    watchdog; the wedged worker is abandoned and replaced)."""


class CircuitOpen(ServingError):
    """The backend circuit breaker is open and no fallback model is
    configured: requests fast-fail until the cool-down elapses and a
    half-open probe succeeds."""


class ServerClosed(ServingError):
    """The server has been shut down; no further requests are accepted."""


class Draining(ServingError):
    """The endpoint received a preemption signal and is draining
    (docs/how_to/preemption.md): admission is closed, in-flight requests
    finish within their deadlines, then the server closes. *Retriable*:
    unlike the other rejections this one is a replica-local lifecycle
    decision, not a verdict on the request — a client (or the load
    balancer reading ``readyz()``, which flipped false the instant the
    signal landed) should resubmit to another replica. Maps to 503 +
    Retry-After on a transport."""

    retriable = True


class QuotaExceeded(ServingError):
    """The owning tenant is at its admission quota
    (``MXTPU_TENANT_QUOTAS``): this request was shed to protect the
    other tenants' share of the queue, not because of anything wrong
    with the request itself. *Retriable* — the tenant's own earlier
    requests completing frees the quota; resubmit after backoff. Maps
    to 429 + Retry-After on a transport."""

    retriable = True


class BatchFailed(ServingError):
    """The coalesced dispatch this request rode in failed as a whole
    (backend fault or worker death mid-batch). The failure says nothing
    about this *individual* request — it shared a dispatch with
    strangers — so the error is *retriable*: resubmitting gets a fresh
    batch. The circuit breaker was charged once for the dispatch, not
    once per passenger. ``cause`` carries the backend's exception."""

    retriable = True

    def __init__(self, msg, cause=None):
        super().__init__(msg)
        self.cause = cause


class RequestTooLarge(ServingError):
    """The request carries more rows than the largest warmed bucket: a
    *client* error, rejected at submit() — it could only fail at pad
    time, and must never charge the circuit breaker. Split the batch
    or declare a larger bucket. Maps to 413 on a transport."""


class UnwarmedSignature(ServingError):
    """A live dispatch's shape/dtype signature fell outside the warmed
    set — exactly a production cold compile, fatal under
    ``MXTPU_RETRACE_STRICT=1``. A client/config error (wrong dtype, an
    input warm-up never declared), NOT backend-health evidence: the
    circuit breaker is never charged for it — one misbehaving client
    must not open the circuit for everyone."""


class ReplicaEvicted(ServingError):
    """The replica holding this request was evicted from the serving
    fleet (failed health probes, breached error-rate bound, or killed
    outright — docs/how_to/fleet.md). The request itself is fine; it was
    simply parked on the wrong box. *Retriable*: the fleet router
    re-dispatches it to a surviving replica (idempotently — delivery is
    deduped on the fleet request id), and an external client should
    resubmit. Maps to 503 + Retry-After on a transport."""

    retriable = True


class FleetUnavailable(ServingError):
    """No ACTIVE replica can take the request right now — every replica
    is evicted, draining, or mid-promotion. Distinct from
    :class:`ServerClosed` (the fleet is not shut down, it is degraded)
    and *retriable*: a standby promotion or reload hand-off completing
    restores capacity. Maps to 503 + Retry-After on a transport."""

    retriable = True


class SlotsFull(ServingError):
    """Every decode slot in the in-flight batch is occupied
    (:class:`~.slots.SlotTable`): the sequence cannot join until one of
    the running sequences finishes. *Retriable* — slots free as
    sequences complete. Maps to 429 + Retry-After on a transport."""

    retriable = True

"""The model-serving runtime.

Counterpart of ``mxnet_tpu/serving``: it keeps serving up under
overload and backend failure with the port's own resilience primitives
(the injectable-clock :class:`~mxnet_tpu_torch.resilience.RetryPolicy`
and the seedable :class:`~mxnet_tpu_torch.resilience.FaultPlan`, sites
``serving.forward``, ``serving.load``, ``serving.queue``):

- **Admission control** (:mod:`.admission`) — a bounded queue that
  sheds (``QueueFull``) instead of building unbounded latency; optional
  oldest-first eviction, priorities, per-tenant quotas and
  weighted-fair shares.
- **Deadlines** — every request carries an absolute budget enforced in
  queue, in flight, and at the caller (watchdog).
- **Circuit breaking** (:mod:`.breaker`) — closed -> open on backend
  error rate -> half-open probe -> closed.
- **Coalescing and warm-up** (:mod:`.batching`, :mod:`.warmup`) —
  shape-compatible requests ride one dispatch, padded to a bucket that
  warm-up already ran, so no live request pays a first run at a new
  shape; pad waste is accounted (:mod:`.ragged`).
- **Probes, stats and drain** — ``healthz()``/``readyz()``, per-endpoint
  counters (:func:`endpoint_stats`), and a graceful drain on SIGTERM
  through the shared signal runtime.
- **Decode** (:mod:`.slots`) — the in-flight batcher over fixed-capacity
  per-slot recurrent state.

Backends: :class:`CallableBackend`, :class:`PredictorBackend`,
:class:`ModuleBackend` (``Module.as_serving_backend()``) and, for
decode, :class:`ModuleStepBackend` (``Module.as_decode_backend()``).
What waits: the fleet router (``fleet.py``: replicas, hedging, eviction,
version-aware reload) is A14's second half and needs A13's checkpoint
versions; :class:`SymbolicJitBackend` and ``as_serving_backend(quant=
True)`` need A12 and raise.
"""
from __future__ import annotations

from . import (admission, backends, batching, breaker, errors,  # noqa: F401
               ragged, server, slots, warmup)
from .admission import (AdmissionQueue, Deadline, Request,  # noqa: F401
                        StrideScheduler, TenantPolicy)
from .backends import (CallableBackend, ModuleBackend,  # noqa: F401
                       PredictorBackend, SymbolicJitBackend)
from .batching import BatchCoalescer, request_signature  # noqa: F401
from .breaker import CircuitBreaker  # noqa: F401
from .errors import (BatchFailed, CircuitOpen, DeadlineExceeded,  # noqa: F401
                     Draining, FleetUnavailable, QueueFull, QuotaExceeded,
                     ReplicaEvicted, RequestTooLarge, ServerClosed,
                     ServingError, SlotsFull, UnwarmedSignature)
from .ragged import (PadWasteTracker, SequencePacker,  # noqa: F401
                     ragged_enabled)
from .server import InferenceServer, endpoint_stats, endpoints  # noqa: F401
from .slots import (CallableStepBackend, InflightBatcher,  # noqa: F401
                    ModuleStepBackend, SlotTable)
from .warmup import ShapeBuckets, coalescer_sizes, suggest_buckets  # noqa: F401

__all__ = ["InferenceServer", "CallableBackend", "PredictorBackend",
           "ModuleBackend", "SymbolicJitBackend", "AdmissionQueue",
           "Deadline", "Request", "TenantPolicy", "StrideScheduler",
           "CircuitBreaker", "ShapeBuckets", "BatchCoalescer",
           "request_signature", "coalescer_sizes", "suggest_buckets",
           "PadWasteTracker", "SequencePacker", "ragged_enabled",
           "SlotTable", "InflightBatcher", "CallableStepBackend",
           "ModuleStepBackend", "ServingError", "QueueFull",
           "DeadlineExceeded", "CircuitOpen", "ServerClosed", "Draining",
           "QuotaExceeded", "BatchFailed", "SlotsFull", "RequestTooLarge",
           "UnwarmedSignature", "ReplicaEvicted", "FleetUnavailable",
           "endpoints", "endpoint_stats"]

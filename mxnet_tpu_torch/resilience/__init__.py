"""Fault tolerance for the runtime: the pieces serving needs.

Counterpart of ``mxnet_tpu/resilience``: :mod:`.faults` (deterministic
fault injection at named sites), :mod:`.retry` (exponential backoff with
jitter and a deadline, injectable clock and sleep), :mod:`.latency`
(bounded latency histograms) and the signal half of :mod:`.supervisor`
(:class:`~.supervisor.SignalRuntime`, which serving endpoints drain on).
Checkpointing, the data pipeline, elastic training, the integrity guard
and the training supervisor come with A13.
"""
from __future__ import annotations

from . import faults, latency, retry, supervisor  # noqa: F401
from .faults import (SITES, FaultPlan, InjectedFault,  # noqa: F401
                     InjectedKill, InjectedTimeout, fault_point)
from .latency import LatencyRecorder  # noqa: F401
from .retry import RetryExhausted, RetryPolicy, default_policy  # noqa: F401
from .supervisor import (ImmediateAbort, SignalRuntime,  # noqa: F401
                         signal_runtime)

__all__ = ["faults", "retry", "latency", "supervisor", "FaultPlan",
           "RetryPolicy", "RetryExhausted", "InjectedFault",
           "InjectedTimeout", "InjectedKill", "fault_point",
           "guarded_call", "guarded_point", "default_policy", "stats",
           "reset_stats", "SITES", "SignalRuntime", "signal_runtime",
           "ImmediateAbort", "LatencyRecorder"]


def guarded_call(site: str, fn, *args, policy=None, **kwargs):
    """Run ``fn`` behind fault site ``site`` under the default (or given)
    retry policy: each attempt first passes the fault point, so injected
    retriable faults exercise the same backoff path real transient I/O
    errors do. Non-retriable exceptions (StopIteration, MXNetError,
    InjectedKill, ...) propagate immediately."""
    pol = policy or retry.default_policy()

    def attempt():
        faults.fault_point(site)
        return fn(*args, **kwargs)

    return pol.call(attempt, label=site)


def guarded_point(site: str, policy=None):
    """Pass fault site ``site`` under the default (or given) retry policy
    WITHOUT wrapping the caller's work: injected retriable faults
    exercise the backoff path, but the real operation then runs exactly
    once (the guard for non-idempotent operations). With no plan armed
    this is a single ``is None`` check."""
    if faults.active_plan() is None:
        return
    pol = policy or retry.default_policy()
    pol.call(faults.fault_point, site, label=site)


def stats() -> dict:
    """Combined fault + retry + signal counters."""
    return {"faults": faults.stats(), "retry": retry.stats(),
            "supervisor": supervisor.stats()}


def reset_stats():
    faults.reset_stats()
    retry.reset_stats()
    supervisor.reset_stats()

"""Retry with exponential backoff + jitter + deadline.

Counterpart of ``mxnet_tpu/resilience/retry.py`` with its uniform
jitter schedule; the decorrelated and jitter-off modes (and the
``MXTPU_RETRY_JITTER`` knob) wait for ``serving/fleet.py``, their caller.

Reference analogue: ps-lite's resender/timeout machinery
(``van.cc`` resend loop, ``PS_RESEND_TIMEOUT``) — collapsed here into a
host-side policy object that wraps the I/O surfaces the SPMD port still
has (checkpoint files, kvstore entry points, data-iterator fetch).

The clock, sleep, and jitter RNG are injectable so tests verify the
backoff schedule with a fake clock and zero real sleeping. Transient
errors are ``OSError``/``TimeoutError``/``ConnectionError`` by default,
minus the permanent OSError subclasses (FileNotFoundError,
PermissionError, ...) that no amount of waiting fixes; anything else
(including :class:`~.faults.InjectedKill`, a BaseException) propagates
immediately.

Env overrides for the default policy (read once per process)::

    MXNET_TPU_RETRY_MAX=4        # attempts after the first (0 disables)
    MXNET_TPU_RETRY_BASE=0.05    # first backoff delay, seconds
    MXNET_TPU_RETRY_CAP=2.0      # per-delay cap, seconds
    MXNET_TPU_RETRY_DEADLINE=60  # total budget, seconds ('' = none)
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple

__all__ = ["RetryPolicy", "RetryExhausted", "default_policy", "stats",
           "reset_stats"]

_RETRIABLE = (OSError, TimeoutError, ConnectionError)

# OSError subclasses that no amount of waiting fixes: fail fast instead
# of sleeping through the whole backoff schedule
_PERMANENT = (FileNotFoundError, IsADirectoryError, NotADirectoryError,
              PermissionError)


class RetryExhausted(RuntimeError):
    """Raised when a RetryPolicy gives up; ``__cause__`` is the last
    underlying error."""


_lock = threading.Lock()
_retries: Dict[str, int] = {}   # label -> retry count (attempts beyond 1st)
_giveups: Dict[str, int] = {}   # label -> exhausted calls


def _count(table: Dict[str, int], label: str):
    with _lock:
        table[label] = table.get(label, 0) + 1


def stats() -> Dict[str, Dict[str, int]]:
    """Snapshot of per-label retry/give-up counters."""
    with _lock:
        return {"retries": dict(_retries), "giveups": dict(_giveups)}


def reset_stats():
    with _lock:
        _retries.clear()
        _giveups.clear()


class RetryPolicy:
    """Exponential backoff: delay_i = min(cap, base * mult**i), each
    scaled by a jitter factor drawn uniformly from [1-jitter, 1+jitter].

    ``max_retries`` bounds attempts beyond the first; ``deadline`` bounds
    total elapsed time including the upcoming sleep (the policy never
    starts a sleep that would overrun it)."""

    def __init__(self, max_retries: int = 4, base_delay: float = 0.05,
                 max_delay: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.1, deadline: Optional[float] = None,
                 retry_on: Tuple = _RETRIABLE,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: Optional[int] = None):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.max_retries = max_retries
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.deadline = deadline
        self.retry_on = tuple(retry_on)
        self.clock = clock
        self.sleep = sleep
        self._rng = random.Random(seed)

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based), jitter applied."""
        raw = min(self.max_delay,
                  self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            raw *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, raw)

    def call(self, fn: Callable, *args, label: str = "call", **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying transient failures."""
        start = self.clock()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except self.retry_on as err:
                if isinstance(err, _PERMANENT):
                    raise
                attempt += 1
                if attempt > self.max_retries:
                    _count(_giveups, label)
                    raise RetryExhausted(
                        f"{label}: gave up after {attempt} attempts "
                        f"({err!r})") from err
                pause = self.delay(attempt)
                if (self.deadline is not None
                        and self.clock() - start + pause > self.deadline):
                    _count(_giveups, label)
                    raise RetryExhausted(
                        f"{label}: deadline {self.deadline}s exceeded "
                        f"after {attempt} attempts ({err!r})") from err
                _count(_retries, label)
                logging.warning("%s failed (%r); retry %d/%d in %.3fs",
                                label, err, attempt, self.max_retries, pause)
                self.sleep(pause)

    def wrap(self, fn: Callable, label: Optional[str] = None) -> Callable:
        """Decorator form of :meth:`call`."""
        tag = label or getattr(fn, "__name__", "call")

        def wrapped(*args, **kwargs):
            return self.call(fn, *args, label=tag, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


_default: Optional[RetryPolicy] = None


def default_policy() -> RetryPolicy:
    """Process-wide policy for runtime I/O surfaces (env-configurable)."""
    global _default
    if _default is None:
        env = os.environ.get
        deadline = env("MXNET_TPU_RETRY_DEADLINE", "")
        _default = RetryPolicy(
            max_retries=int(env("MXNET_TPU_RETRY_MAX", "4")),
            base_delay=float(env("MXNET_TPU_RETRY_BASE", "0.05")),
            max_delay=float(env("MXNET_TPU_RETRY_CAP", "2.0")),
            deadline=float(deadline) if deadline else None)
    return _default


def set_default_policy(policy: Optional[RetryPolicy]):
    """Install (or with None, reset to env-derived) the default policy."""
    global _default
    _default = policy

"""Circuit breaker around backend forward/load failures.

Counterpart of ``mxnet_tpu/serving/breaker.py``.

State machine (docs/how_to/serving.md):

    closed --[error rate >= threshold over the window]--> open
    open   --[cool-down elapsed on the injectable clock]--> half-open
    half-open --[probe success x probes]--> closed
    half-open --[probe failure]--> open (cool-down restarts)

While open, requests fast-fail (:class:`~.errors.CircuitOpen`) or are
served by the fallback model — a wedged or crashing backend never takes
the caller population down with it. The clock is injectable so every
transition is deterministic in tests; the breaker itself never sleeps.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Error-rate breaker over a sliding window of recent outcomes.

    Trips when at least ``min_calls`` of the last ``window`` outcomes
    exist and the failure fraction reaches ``failure_rate``; after
    ``cooldown`` seconds it admits up to ``probes`` concurrent probe
    requests, and recloses once ``probes`` of them succeed.
    """

    def __init__(self, window: int = 20, min_calls: int = 5,
                 failure_rate: float = 0.5, cooldown: float = 30.0,
                 probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if not 0.0 < failure_rate <= 1.0:
            raise ValueError("failure_rate must be in (0, 1]")
        if min_calls < 1 or window < min_calls:
            raise ValueError("need window >= min_calls >= 1")
        self.window = window
        self.min_calls = min_calls
        self.failure_rate = failure_rate
        self.cooldown = cooldown
        self.probes = probes
        self.clock = clock
        self._lock = threading.Lock()
        self._outcomes: deque = deque(maxlen=window)  # True = failure
        self._state = CLOSED
        self._opened_at = None
        self._probes_inflight = 0
        self._probe_successes = 0
        self._probe_granted_at = None
        self.opened_count = 0
        self.last_transition = None   # (state, clock()) of the last change

    # -- state ---------------------------------------------------------------

    def _tick(self):
        """Time-driven transitions (lock held): a half-open probe that
        never reports within ``cooldown`` counts as a failure — a
        wedged/abandoned probe must re-open the circuit, not leave it
        stuck half-open rejecting forever. Then open -> half-open once
        the cool-down elapses."""
        if (self._state == HALF_OPEN and self._probes_inflight > 0
                and self._probe_granted_at is not None
                and self.clock() - self._probe_granted_at >= self.cooldown):
            self._trip()
        if (self._state == OPEN and self._opened_at is not None
                and self.clock() - self._opened_at >= self.cooldown):
            self._set(HALF_OPEN)
            self._probes_inflight = 0
            self._probe_successes = 0
            self._probe_granted_at = None

    def _set(self, state: str):
        self._state = state
        self.last_transition = (state, self.clock())

    @property
    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    # -- request-path API ----------------------------------------------------

    def allow(self) -> bool:
        """May this request attempt the primary backend? In half-open,
        consumes one of the ``probes`` concurrent probe slots."""
        with self._lock:
            self._tick()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return False
            if self._probes_inflight < self.probes:
                if self._probes_inflight == 0:
                    self._probe_granted_at = self.clock()
                self._probes_inflight += 1
                return True
            return False

    def record_success(self):
        with self._lock:
            self._tick()
            if self._state == CLOSED:
                self._outcomes.append(False)
            elif self._state == HALF_OPEN:
                self._probes_inflight = max(0, self._probes_inflight - 1)
                if self._probes_inflight == 0:
                    self._probe_granted_at = None
                self._probe_successes += 1
                if self._probe_successes >= self.probes:
                    self._outcomes.clear()
                    self._set(CLOSED)
            # OPEN: a straggler finishing after the trip — ignore

    def record_failure(self):
        with self._lock:
            self._tick()
            if self._state == CLOSED:
                self._outcomes.append(True)
                n = len(self._outcomes)
                fails = sum(self._outcomes)
                if n >= self.min_calls and fails / n >= self.failure_rate:
                    self._trip()
            elif self._state == HALF_OPEN:
                # the probe failed: back to open, cool-down restarts
                self._trip()
            # OPEN: already open, nothing to learn

    def _trip(self):
        self._outcomes.clear()
        self._probes_inflight = 0
        self._probe_successes = 0
        self._probe_granted_at = None
        self._opened_at = self.clock()
        self.opened_count += 1
        self._set(OPEN)

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            self._tick()
            n = len(self._outcomes)
            return {"state": self._state,
                    "window_calls": n,
                    "window_failures": sum(self._outcomes),
                    "opened_count": self.opened_count,
                    "opened_at": self._opened_at,
                    "probe_successes": self._probe_successes}

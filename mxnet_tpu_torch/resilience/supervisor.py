"""Preemption signals: the process-wide :class:`SignalRuntime`.

Counterpart of the signal half of ``mxnet_tpu/resilience/supervisor.py``
(``SignalRuntime``, ``signal_runtime``, ``ImmediateAbort`` and the
handler-safe counters). Serving endpoints subscribe to it
(``InferenceServer.install_signal_handlers``) and drain on the first
SIGTERM. The training supervisor itself (stall watchdog, crash-loop
guard, preemption checkpoints) comes with A13.
"""
from __future__ import annotations

import logging
import signal as _signal
import threading
from typing import Dict, Optional, Sequence

__all__ = ["SignalRuntime", "ImmediateAbort", "signal_runtime", "stats",
           "reset_stats", "EXIT_ABORTED"]

EXIT_ABORTED = 84     #: second signal: immediate abort, no checkpoint


class ImmediateAbort(BaseException):
    """Second signal during the grace window: abort NOW. Deliberately a
    BaseException (like :class:`~.faults.InjectedKill`) so it sails
    through ``except Exception`` and retry loops exactly like the
    SIGKILL that would follow."""

    def __init__(self, msg, exit_code: int = EXIT_ABORTED):
        super().__init__(msg)
        self.exit_code = exit_code


_lock = threading.Lock()
_counters: Dict[str, int] = {}


def _count_nolock(key: str, n: int = 1):
    """Counter bump for SIGNAL-HANDLER paths: the interrupted thread may
    hold ``_lock``, so taking it here could self-deadlock the handler. A
    GIL-atomic dict update is enough for advisory counters."""
    _counters[key] = _counters.get(key, 0) + n


def stats() -> dict:
    """Snapshot of the signal counters."""
    with _lock:
        return {"signals": _counters.get("signals", 0)}


def reset_stats():
    with _lock:
        _counters.clear()


class SignalRuntime:
    """One process-wide owner of the preemption signal handlers.

    Serving endpoints (and, with A13, training supervisors) subscribe
    listeners; the runtime installs each OS handler once (main thread
    only — the CPython rule) and fans every delivery out to all
    subscribers. :meth:`deliver` is the injectable path: tests (and
    non-main-thread embedders) call it with a signum and get the exact
    dispatch a real signal takes.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._listeners: list = []          # [(listener, frozenset sigs)]
        self._installed: Dict[int, object] = {}

    def subscribe(self, listener, signals: Sequence[int]):
        """Register ``listener.on_signal(signum)`` for ``signals``,
        installing OS handlers for any not yet owned. An EMPTY signal
        set means "no OS wiring, receive every injected delivery" (the
        test hook); a non-empty set also *filters* dispatch. Off the
        main thread the OS install is skipped (CPython forbids it) and
        only injected delivery reaches the listener."""
        with self._lock:
            if all(entry[0] is not listener for entry in self._listeners):
                self._listeners.append((listener, frozenset(signals)))
            if threading.current_thread() is not threading.main_thread():
                logging.warning(
                    "SignalRuntime: not on the main thread; OS signal "
                    "handlers not installed (injected deliver() only)")
                return
            for signum in signals:
                if signum in self._installed:
                    continue
                try:
                    prev = _signal.signal(signum, self._handler)
                except (ValueError, OSError) as err:
                    logging.warning("SignalRuntime: cannot install handler "
                                    "for signal %s: %s", signum, err)
                    continue
                self._installed[signum] = prev

    def unsubscribe(self, listener):
        """Drop ``listener``; when no listeners remain, restore every
        original OS handler."""
        with self._lock:
            self._listeners = [e for e in self._listeners
                               if e[0] is not listener]
            if self._listeners:
                return
            if threading.current_thread() is threading.main_thread():
                for signum, prev in self._installed.items():
                    try:
                        _signal.signal(signum, prev)
                    except (ValueError, OSError, TypeError):
                        pass
                self._installed.clear()

    def _handler(self, signum, frame):    # real OS delivery (main thread)
        self.deliver(signum)

    def deliver(self, signum: int):
        """Dispatch one signal to every subscriber whose set includes
        ``signum`` (empty set = all) — the injectable equivalent of the
        OS handler. Handler-safe: no locks, and an
        :class:`ImmediateAbort` from one listener is held until every
        other listener has seen the signal."""
        _count_nolock("signals")
        abort = None
        for listener, sigs in list(self._listeners):
            if sigs and signum not in sigs:
                continue
            try:
                listener.on_signal(signum)
            except ImmediateAbort as err:
                abort = abort or err
        if abort is not None:
            raise abort


_runtime: Optional[SignalRuntime] = None
_runtime_lock = threading.Lock()


def signal_runtime() -> SignalRuntime:
    """The process-wide :class:`SignalRuntime` singleton."""
    global _runtime
    if _runtime is None:
        with _runtime_lock:
            if _runtime is None:
                _runtime = SignalRuntime()
    return _runtime

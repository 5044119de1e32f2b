"""Deterministic fault injection for the training runtime.

Counterpart of ``mxnet_tpu/resilience/faults.py``, ported whole: the
same sites, rules, environment spelling and counters.

Reference analogue: ps-lite's ``SimpleApp`` test hooks and the reference's
``tests/nightly/dist_sync_kvstore.py`` kill/relaunch scripts — but made
deterministic and in-process so the recovery paths (atomic checkpoint,
retry/backoff, ``fit(resume='auto')``) can be proven in unit tests.

A :class:`FaultPlan` arms named *sites*; production code marks those
sites with :func:`fault_point`.  When the armed condition is met (the
Nth call to the site, or a seeded coin flip), the site raises one of the
injected-fault exceptions below.  With no plan armed a fault point is a
single ``is None`` check, so the instrumentation is free on hot paths.

Arming from the environment (no code changes required)::

    MXNET_TPU_FAULT_PLAN="checkpoint.write:2:kill;kvstore.push:1:ioerror"
    MXNET_TPU_FAULT_SEED=7   # seeds probabilistic rules

Each rule is ``site:nth:kind`` (fail the Nth call and every one of the
``count`` following; default count 1) or ``site:p=0.1:kind`` (each call
fails with probability 0.1, drawn from the plan's seeded RNG).
Kinds: ``ioerror`` (retriable OSError), ``timeout`` (retriable
TimeoutError), ``kill`` (a BaseException — simulates process death, never
retried, escapes ``except Exception``), and ``delay`` — the gray-failure
kind: nothing raises, the call is simply made SLOW.  A delay rule takes a
fourth field, the milliseconds to burn (``site:nth:delay:ms`` /
``site:p=X:delay:ms``), spent through the plan's injectable ``sleep``
(``time.sleep`` by default; unit tests wire a fake clock's ``advance`` so
zero real time passes).  ``fault_point`` returns the seconds burned so
instrumented callers can attribute the slowness (the fleet dispatch path
pins it on the replica whose forward it was).
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional, Set

__all__ = ["FaultPlan", "InjectedFault", "InjectedTimeout", "InjectedKill",
           "arm", "disarm", "active_plan", "fault_point", "stats",
           "reset_stats", "observed_sites", "SITES"]

# Sites instrumented by the runtime (documentation; fault_point accepts any
# name so downstream code can add its own).
SITES = ("checkpoint.write", "checkpoint.read", "kvstore.init",
         "kvstore.push", "kvstore.pull", "kvstore.barrier", "io.next",
         "trainer.step",
         # data pipeline (recordio.py + resilience/data.py,
         # docs/how_to/data_resilience.md)
         "io.open_shard", "io.read_record", "io.decode",
         # serving runtime (mxnet_tpu/serving, docs/how_to/serving.md)
         "serving.forward", "serving.load", "serving.queue",
         # elastic training (resilience/elastic.py,
         # docs/how_to/elastic_training.md): device-enumeration probe +
         # in-step collective — injected faults simulate device loss
         "mesh.probe", "mesh.collective",
         # persistent compilation cache (mxnet_tpu/compiler/cache.py,
         # docs/how_to/compiler.md): a failed/corrupt entry read is
         # quarantined and falls back to recompile, never fails a bind
         "compiler.cache.read",
         # training supervisor (resilience/supervisor.py,
         # docs/how_to/preemption.md): an injected fault at
         # supervisor.signal simulates a delivered SIGTERM, one at
         # supervisor.heartbeat simulates a stalled step (drives the
         # retry → rebind → re-mesh → abort escalation ladder)
         "supervisor.signal", "supervisor.heartbeat",
         # quantization calibration sidecar (mxnet_tpu/quant/calibration
         # .py, docs/how_to/quantization.md): a corrupt/missing/faulted
         # sidecar read falls back to recalibration, never a crash
         "quant.sidecar.read",
         # serving fleet (mxnet_tpu/serving/fleet.py,
         # docs/how_to/fleet.md): the replica-health probe and the
         # per-replica dispatch — an injected fault at fleet.probe kills
         # one seeded replica (the MeshHealth pattern at fleet scope), a
         # fault at fleet.dispatch kills the replica whose forward it
         # was, mid-burst
         "fleet.probe", "fleet.dispatch",
         # async + sharded checkpointing (resilience/async_checkpoint.py,
         # docs/how_to/fault_tolerance.md): the host snapshot, each
         # per-shard file write, the manifest commit rename, the flush
         # barrier the preemption path waits on, and the stale-stem
         # sweeper — a kill at any of these must leave the last
         # committed checkpoint discoverable and loadable
         "checkpoint.snapshot", "checkpoint.shard_write",
         "checkpoint.commit", "checkpoint.flush", "checkpoint.sweep",
         # silent-failure integrity guard (resilience/integrity.py,
         # docs/how_to/integrity.md): mesh.silent_corrupt injects a
         # deterministic single-device bitflip into the update seam (a
         # flaky chip that lies — every health probe still passes), and
         # integrity.checksum faults the cross-replica checksum-voting
         # round itself (vote infrastructure failure)
         "mesh.silent_corrupt", "integrity.checksum")

ENV_PLAN = "MXNET_TPU_FAULT_PLAN"
ENV_SEED = "MXNET_TPU_FAULT_SEED"


class InjectedFault(OSError):
    """Injected transient I/O failure (retriable: an OSError)."""


class InjectedTimeout(TimeoutError):
    """Injected timeout (retriable: a TimeoutError)."""


class InjectedKill(BaseException):
    """Injected process death. Deliberately a BaseException: it must sail
    through ``except Exception`` handlers and retry loops exactly like a
    SIGKILL would, leaving partial state (e.g. a checkpoint tmp file)
    behind for the recovery path to deal with."""


_KINDS = {"ioerror": InjectedFault, "timeout": InjectedTimeout,
          "kill": InjectedKill}


class _Rule:
    __slots__ = ("nth", "count", "prob", "exc", "delay_ms")

    def __init__(self, nth=None, count=1, prob=None, exc=InjectedFault,
                 delay_ms=None):
        self.nth = nth          # 1-based call number to start failing at
        self.count = count      # how many consecutive calls fail
        self.prob = prob        # alternatively: per-call probability
        self.exc = exc          # None for a delay rule (nothing raises)
        self.delay_ms = delay_ms


class FaultPlan:
    """A seedable set of armed fault rules, keyed by site name."""

    def __init__(self, seed: int = 0, sleep=time.sleep):
        self.seed = seed
        self.sleep = sleep      # burns delay rules; injectable for tests
        self._rng = random.Random(seed)
        self._rules: Dict[str, List[_Rule]] = {}

    def arm(self, site: str, nth: Optional[int] = None, count: int = 1,
            prob: Optional[float] = None, exc="ioerror",
            delay_ms: Optional[float] = None) -> "FaultPlan":
        """Arm ``site`` to fail on the Nth call (``nth``, 1-based, for
        ``count`` consecutive calls) or with per-call probability
        ``prob``. ``exc`` is a kind name from {ioerror, timeout, kill,
        delay} or an exception class; kind ``delay`` raises nothing and
        instead burns ``delay_ms`` milliseconds through the plan's
        ``sleep``. Returns self for chaining."""
        if (nth is None) == (prob is None):
            raise ValueError("arm() needs exactly one of nth= or prob=")
        if exc == "delay":
            if delay_ms is None:
                raise ValueError("fault kind 'delay' needs delay_ms=")
            exc = None
        elif delay_ms is not None:
            raise ValueError("delay_ms= only applies to exc='delay'")
        elif isinstance(exc, str):
            if exc not in _KINDS:
                raise ValueError(f"unknown fault kind {exc!r}; "
                                 f"choose from {sorted(_KINDS) + ['delay']}")
            exc = _KINDS[exc]
        self._rules.setdefault(site, []).append(
            _Rule(nth=nth, count=count, prob=prob, exc=exc,
                  delay_ms=delay_ms))
        return self

    def sites(self) -> Set[str]:
        return set(self._rules)

    def _check(self, site: str, ncall: int) -> Optional[_Rule]:
        """Return the rule firing on this call, or None."""
        for rule in self._rules.get(site, ()):
            if rule.nth is not None:
                if rule.nth <= ncall < rule.nth + rule.count:
                    return rule
            elif rule.prob is not None:
                if self._rng.random() < rule.prob:
                    return rule
        return None

    @classmethod
    def from_env(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse a ``site:nth:kind;site:p=0.1:kind`` spec string (the
        ``delay`` kind takes a fourth field: ``site:nth:delay:ms``)."""
        plan = cls(seed=seed)
        for part in spec.replace(",", ";").split(";"):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if not (len(fields) in (2, 3)
                    or (len(fields) == 4 and fields[2] == "delay")):
                raise ValueError(f"bad fault rule {part!r} "
                                 "(want site:nth[:kind], site:p=X[:kind] "
                                 "or site:nth:delay:ms)")
            site, when = fields[0], fields[1]
            kind = fields[2] if len(fields) >= 3 else "ioerror"
            delay_ms = float(fields[3]) if len(fields) == 4 else None
            if when.startswith("p="):
                plan.arm(site, prob=float(when[2:]), exc=kind,
                         delay_ms=delay_ms)
            else:
                plan.arm(site, nth=int(when), exc=kind, delay_ms=delay_ms)
        return plan


_lock = threading.Lock()
_active: Optional[FaultPlan] = None
_env_checked = False
_calls: Dict[str, int] = {}     # site -> total fault_point() invocations
_fired: Dict[str, int] = {}     # site -> injected faults raised
_delayed: Dict[str, int] = {}   # site -> injected delays burned


def arm(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` as the active fault plan (replacing any)."""
    global _active, _env_checked
    with _lock:
        _active = plan
        _env_checked = True     # explicit arming overrides the env var
        _calls.clear()
        _fired.clear()
        _delayed.clear()
    return plan


def disarm():
    """Deactivate fault injection (counters keep their values)."""
    global _active, _env_checked
    with _lock:
        _active = None
        _env_checked = True


def active_plan() -> Optional[FaultPlan]:
    """The active plan; lazily arms from MXNET_TPU_FAULT_PLAN once."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        with _lock:
            if _active is None and not _env_checked:
                spec = os.environ.get(ENV_PLAN)
                if spec:
                    seed = int(os.environ.get(ENV_SEED, "0"))
                    _active = FaultPlan.from_env(spec, seed=seed)
                _env_checked = True
    return _active


def fault_point(site: str) -> Optional[float]:
    """Mark a fault-injectable site. No-op unless a plan arms ``site``.

    Raising kinds raise; the ``delay`` kind burns its milliseconds
    through the plan's ``sleep`` (outside the module lock — a real sleep
    must never serialize every other fault point behind it) and returns
    the seconds burned so callers can attribute the slowness. Returns
    None when nothing fired."""
    plan = active_plan()
    if plan is None:
        return None
    with _lock:
        n = _calls.get(site, 0) + 1
        _calls[site] = n
        rule = plan._check(site, n)
        if rule is not None:
            if rule.exc is not None:
                _fired[site] = _fired.get(site, 0) + 1
            else:
                _delayed[site] = _delayed.get(site, 0) + 1
    if rule is not None:
        if rule.exc is not None:
            raise rule.exc(f"injected fault at {site} (call #{n})")
        burned = float(rule.delay_ms) / 1000.0
        plan.sleep(burned)
        return burned
    return None


def observed_sites() -> Set[str]:
    """Sites where an injected fault has actually fired."""
    with _lock:
        return {s for s, n in _fired.items() if n} \
            | {s for s, n in _delayed.items() if n}


def stats() -> Dict[str, Dict[str, int]]:
    """Snapshot of per-site fault-point call and fire counters."""
    with _lock:
        return {"calls": dict(_calls), "fired": dict(_fired),
                "delayed": dict(_delayed)}


def reset_stats():
    with _lock:
        _calls.clear()
        _fired.clear()
        _delayed.clear()

"""Runtime-visible markers of the hot paths and the single-threaded ones.

Counterpart of ``mxnet_tpu/analysis/annotations.py``. The JAX package's
linter reads them as roots of its host-sync and lock-discipline audits;
the port keeps the same markers on the same functions. At runtime each
decorator is an identity function: zero overhead, no behavior change.

Kept dependency-free (stdlib only).
"""
from __future__ import annotations

__all__ = ["hot_path", "single_threaded"]


def hot_path(reason=None):
    """Mark a function as part of the per-step training hot path.

    Usable bare (``@hot_path``) or with a justification string
    (``@hot_path("per-batch metric update")``). The JAX package's
    linter audits marked functions for host syncs; the runtime behavior
    is untouched.
    """
    if callable(reason):        # bare @hot_path
        return reason

    def deco(fn):
        return fn

    return deco


def single_threaded(reason=None):
    """Declare a function (or class) deliberately single-threaded.

    The JAX package's lock-discipline checker exempts marked code:
    construction/warm-up phases, test-only drivers, and control-plane
    paths that one thread owns by design. Usable bare
    (``@single_threaded``) or with the justification string the review
    contract asks for (``@single_threaded("driven by run_pending() on
    the caller's thread only")``). Identity at runtime — zero overhead.
    """
    if callable(reason):        # bare @single_threaded
        return reason

    def deco(fn):
        return fn

    return deco

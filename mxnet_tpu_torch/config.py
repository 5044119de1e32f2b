"""Runtime environment-variable config registry.

Counterpart of ``mxnet_tpu/config.py``: every knob is declared once with
its type, default and doc; readers call ``config.get(name)`` (or
``base.getenv`` directly). ``MXTPU_`` is the canonical prefix; a matching
``MXNET_`` spelling is accepted (``base.getenv``). The table holds the
knobs the port's serving runtime reads so far, with the JAX package's
defaults and parsing.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

from .base import MXNetError, getenv

__all__ = ["register_knob", "get", "describe", "KNOBS"]


class Knob(NamedTuple):
    name: str
    typ: type
    default: Any
    doc: str


KNOBS: Dict[str, Knob] = {}


def register_knob(name: str, typ, default, doc: str):
    KNOBS[name] = Knob(name, typ, default, doc)
    return KNOBS[name]


def get(name: str):
    """Read a declared knob from the environment (typed, defaulted)."""
    if name not in KNOBS:
        raise MXNetError(f"unknown config knob {name}; see config.describe()")
    k = KNOBS[name]
    return getenv(k.name, k.default, k.typ)


def describe() -> str:
    """Human-readable table of every knob (env_var.md analogue)."""
    lines = ["{:<36} {:<8} {:<12} {}".format("name", "type", "default",
                                             "doc")]
    for k in sorted(KNOBS.values()):
        lines.append("{:<36} {:<8} {:<12} {}".format(
            k.name, k.typ.__name__, repr(k.default), k.doc))
    return "\n".join(lines)


# -- declared knobs ---------------------------------------------------------

register_knob("MXTPU_MAX_BATCH", int, 1,
              "total rows one coalesced serving dispatch may carry "
              "(serving/batching.py) — 1 disables continuous batching; "
              "warm-up then runs every bucket at 1, max, and the powers "
              "of two between")
register_knob("MXTPU_BATCH_WAIT_MS", float, 2.0,
              "milliseconds a threaded serving worker may hold the "
              "first request open for more traffic to coalesce "
              "(bounded by every member's remaining deadline; the "
              "deterministic workers=0 mode never waits)")
register_knob("MXTPU_RAGGED", int, 1,
              "master switch for the ragged serving rungs "
              "(serving/ragged.py): length-masked compute, symbolic-dim "
              "programs, and sequence packing — each only activates on "
              "backends that declare support; 0 restores the dense "
              "padded path bitwise (pad-waste observability stays on "
              "either way)")
register_knob("MXTPU_PACK_MAX_SEGMENTS", int, 0,
              "cap on requests sharing one packed row in the sequence "
              "packer (segment-masked attention pays per resident "
              "segment); 0 = unbounded — first-fit packs until the row "
              "is full")
register_knob("MXTPU_TENANT_QUOTAS", str, None,
              "per-tenant serving admission quotas + fair-share "
              "weights: 'name:quota[:weight],...' (quota '*' = "
              "unbounded) or JSON {name: {quota, weight}} — unset "
              "disables quotas")
register_knob("MXTPU_RETRACE_STRICT", int, 0,
              "raise instead of warn when a CompileGuard counts a "
              "program past its budget (a new CUDA-graph capture, or a "
              "serving dispatch signature outside the warmed set)")

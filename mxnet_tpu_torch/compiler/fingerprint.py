"""Dispatch signatures of batched feeds.

Counterpart of ``batch_signature`` in ``mxnet_tpu/compiler/fingerprint.py``
(line 185). The serving coalescer and the decode batcher key their
:class:`~mxnet_tpu_torch.perf.CompileGuard` on it. A host (numpy) feed
gets the JAX package's string character for character: sorted
``name=shape:dtype:w0:-`` pairs after the routing leg. Graph
fingerprints and program keys come with A12.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["batch_signature"]


def _leaf_sig(x) -> str:
    """One leaf: shape, dtype, weak type (never, here) and placement:
    ``-`` for a host array, ``<device>`` for a tensor."""
    shape = tuple(getattr(x, "shape", ()))
    dtype = str(getattr(x, "dtype", type(x).__name__))
    dev = getattr(x, "device", None)
    place = "-" if dev is None or isinstance(dev, str) else str(dev)
    return f"{shape}:{dtype}:w0:{place}"


def batch_signature(arrays: Dict, route: str = "primary",
                    symbolic_rows: Optional[int] = None) -> str:
    """Canonical signature of one batched-dispatch feed: sorted
    ``name=shape:dtype`` pairs plus the routing leg (primary/fallback).
    Two feeds with equal signatures run the same shapes; a signature
    outside the warmed set is a shape the backend never ran.

    ``symbolic_rows`` renders the leading (batch) dim of every
    non-scalar leaf as the symbolic token ``B<=N`` (the JAX package's
    symbolic-dim programs; A12 in the port)."""
    parts = []
    for name, arr in sorted(arrays.items()):
        sig = _leaf_sig(arr)
        if symbolic_rows is not None and getattr(arr, "shape", ()):
            shape = tuple(arr.shape)
            sym = "(" + ", ".join([f"B<={int(symbolic_rows)}"]
                                  + [str(d) for d in shape[1:]]) + ")"
            sig = sym + sig[len(str(shape)):]
        parts.append(f"{name}={sig}")
    return f"{route}|" + ";".join(parts)

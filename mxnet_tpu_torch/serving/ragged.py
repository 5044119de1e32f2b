"""Ragged serving: pad-waste accounting + sequence packing.

Counterpart of ``mxnet_tpu/serving/ragged.py``.

Every serving win so far still pays the *pad tax*: requests pad to the
nearest warmed bucket, un-fed decode slots ride as zero rows, and a
coalesced batch burns FLOPs proportional to its longest member. Per the
TVM measure->decide discipline (arxiv 1802.04799) the waste must first
be a tracked number — :class:`PadWasteTracker` records real vs padded
rows x tokens per dispatch and cumulatively, surfaced as
``serving.stats()[ep]["pad_waste"]`` (and ``InflightBatcher.stats()``
for the decode loop). It is pure observability: no logging, no monitor
noise when healthy — the number exists for bucket tuning to read.

The optimization rungs that drive the number down, each independently
kill-switched by ``MXTPU_RAGGED=0`` (today's dense path, bitwise):

a. **length-masked compute** — backends that declare ``accepts_mask``
   receive a 0/1 row mask (stateless forward) or a fed-slot mask (the
   decode step), so pad rows are mask-dead instead of
   zero-compute-full-cost;
b. **symbolic-dim programs** — backends that declare
   ``supports_symbolic_batch`` serve every batch size through ONE
   program (the JAX package's ``compiler.symbolic``; A12 in the port),
   so the bucket axis needs no padding and the warm-up matrix
   collapses;
c. **sequence packing** — :class:`SequencePacker`: multiple short
   requests share one padded row along the backend's declared
   ``pack_axis`` with segment-id bookkeeping and bitwise-correct
   scatter back to members.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.annotations import hot_path
from ..base import MXNetError

__all__ = ["ragged_enabled", "PadWasteTracker", "PackPlan",
           "SequencePacker", "dispatch_waste"]


def ragged_enabled() -> bool:
    """The master kill switch: ``MXTPU_RAGGED=0`` restores today's
    dense padded path bitwise (masking, symbolic dims, and packing all
    off; pad-waste *observability* stays on — measuring the tax is not
    an optimization)."""
    from .. import config as _config
    return bool(_config.get("MXTPU_RAGGED"))


class PadWasteTracker:
    """Real vs padded rows x tokens, per dispatch and cumulative.

    ``record()`` is called once per live dispatch (warm-up probes are
    excluded — they are synthetic traffic) from serving worker threads;
    the counters live under one lock. ``snapshot()`` returns the block
    ``serving.stats()`` publishes:

    - ``dispatches`` plus cumulative ``real_rows``/``padded_rows`` and
      ``real_tokens``/``padded_tokens``;
    - ``ratio`` — cumulative padded/real tokens, THE pad-waste number
      (1.0 = no waste);
    - ``rows_ratio`` — the batch-axis component alone;
    - ``last`` — the most recent dispatch's record, for per-dispatch
      debugging.

    Deliberately silent when healthy: no logging on any path, so a
    ``ResilienceMonitor``-style movement test never wakes on it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # cumulative counters + the last dispatch, guarded by _lock
        self._c = {"dispatches": 0, "real_rows": 0, "padded_rows": 0,
                   "real_tokens": 0, "padded_tokens": 0}
        self._last: Optional[Dict[str, int]] = None  # guarded by _lock

    @hot_path("per-dispatch pad-waste accounting on the serving fast path")
    def record(self, real_rows: int, padded_rows: int,
               real_tokens: Optional[int] = None,
               padded_tokens: Optional[int] = None):
        if real_tokens is None:
            real_tokens = real_rows
        if padded_tokens is None:
            padded_tokens = padded_rows
        rec = {"real_rows": int(real_rows), "padded_rows": int(padded_rows),
               "real_tokens": int(real_tokens),
               "padded_tokens": int(padded_tokens)}
        with self._lock:
            self._c["dispatches"] += 1
            for key, val in rec.items():
                self._c[key] += val
            self._last = rec

    @staticmethod
    def _ratio(padded: int, real: int) -> float:
        return round(padded / real, 4) if real else 1.0

    def snapshot(self) -> Dict:
        with self._lock:
            c = dict(self._c)
            last = dict(self._last) if self._last else None
        c["ratio"] = self._ratio(c["padded_tokens"], c["real_tokens"])
        c["rows_ratio"] = self._ratio(c["padded_rows"], c["real_rows"])
        c["last"] = last
        return c


def dispatch_waste(fed: Dict, true_rows: int,
                   pack_axis: Optional[int] = None,
                   lengths_name: Optional[str] = None,
                   segment_name: str = "segment_ids"
                   ) -> Tuple[int, int, int, int]:
    """(real_rows, padded_rows, real_tokens, padded_tokens) of one
    padded dispatch feed.

    Token accounting uses the best evidence available, in order:

    - a packed feed's ``segment_ids`` (pad positions are 0) — exact;
    - a declared ``lengths_name`` input plus ``pack_axis`` — real
      tokens are the per-row lengths summed over the true rows, padded
      tokens the full (rows x sequence) plane a dense backend computes;
    - otherwise tokens == rows (no sequence axis declared: the batch
      axis is the only padding the server introduced).
    """
    padded_rows = 0
    primary = None
    for name, arr in fed.items():
        if name == segment_name:
            continue
        shape = getattr(arr, "shape", None)
        if shape:
            padded_rows = max(padded_rows, int(shape[0]))
            if primary is None or len(shape) > len(primary.shape):
                primary = arr
    seg = fed.get(segment_name)
    if seg is not None:
        return (int(true_rows), padded_rows,
                int(np.count_nonzero(np.asarray(seg))),
                int(np.asarray(seg).size))
    if (pack_axis is not None and lengths_name is not None
            and lengths_name in fed and primary is not None
            and len(primary.shape) > pack_axis):
        lengths = np.asarray(fed[lengths_name]).reshape(-1)[:true_rows]
        seq = int(primary.shape[pack_axis])
        return (int(true_rows), padded_rows,
                int(lengths.sum()), padded_rows * seq)
    return int(true_rows), padded_rows, int(true_rows), padded_rows


class PackPlan:
    """One packed dispatch's bookkeeping: per-member (row, start, stop)
    spans along the pack axis, the packed row count, and the exact
    real-token total — what :meth:`SequencePacker.scatter` slices by
    and what pad-waste accounting reads."""

    __slots__ = ("spans", "rows", "real_tokens", "pack_axis", "bucket")

    def __init__(self, spans: List[Tuple[int, int, int]], rows: int,
                 real_tokens: int, pack_axis: int, bucket: int):
        self.spans = spans
        self.rows = rows
        self.real_tokens = real_tokens
        self.pack_axis = pack_axis
        self.bucket = bucket


class SequencePacker:
    """First-fit packing of single-row variable-length requests into
    shared padded rows with segment ids.

    Parameters
    ----------
    pack_axis : the sequence axis of the *batched* arrays (>= 1; axis 0
        is the batch axis the coalescer already manages).
    bucket : the padded length of one row along ``pack_axis`` — the
        backend's declared per-row sequence length.
    segment_name : name of the synthesized int32 ``(rows, bucket)``
        segment-id input (0 = pad, members numbered 1.. per row in pack
        order) the backend consumes for segment-masked compute.
    max_segments : cap on members sharing one row
        (``MXTPU_PACK_MAX_SEGMENTS``; 0/None = unbounded) — segment-
        masked attention pays per resident segment, so deployments can
        bound it.
    """

    def __init__(self, pack_axis: int, bucket: int,
                 segment_name: str = "segment_ids",
                 max_segments: Optional[int] = None):
        if pack_axis < 1:
            raise ValueError("pack_axis must be >= 1 (axis 0 is the "
                             "batch axis)")
        if bucket < 1:
            raise ValueError("pack bucket must be >= 1")
        self.pack_axis = int(pack_axis)
        self.bucket = int(bucket)
        self.segment_name = segment_name
        self.max_segments = int(max_segments) if max_segments else 0

    # -- request-side helpers ------------------------------------------------

    def length_of(self, req) -> int:
        """A request's real token count along the pack axis (its
        inputs all share it; validated at merge)."""
        for arr in req.inputs.values():
            shape = getattr(arr, "shape", ())
            if len(shape) > self.pack_axis:
                return int(shape[self.pack_axis])
        return 1

    def request_signature(self, req) -> Tuple:
        """Merge key with the pack axis wildcarded: two requests that
        differ ONLY in their real length pack into one dispatch. Cached
        on the request like :func:`~.batching.request_signature` (one
        server owns a request, so one signature flavour is ever
        cached)."""
        if req._sig is not None:
            return req._sig
        parts = []
        for name in sorted(req.inputs):
            arr = req.inputs[name]
            shape = tuple(getattr(arr, "shape", ()))
            row = shape[1:]
            axis = self.pack_axis - 1
            if len(row) > axis:
                row = row[:axis] + ("*",) + row[axis + 1:]
            dtype = str(getattr(arr, "dtype", type(arr).__name__))
            parts.append((name, row, dtype))
        req._sig = (bool(req.use_fallback), "packed", tuple(parts))
        return req._sig

    # -- planning ------------------------------------------------------------

    def plan(self, batch: Sequence) -> PackPlan:
        """Deterministic first-fit: each member lands in the first row
        with enough remaining length (and segment headroom), else a new
        row opens. Same member order -> same plan, which is what makes
        packed-vs-unpacked bitwise tests possible."""
        free: List[int] = []          # remaining length per open row
        segs: List[int] = []          # members resident per row
        spans: List[Tuple[int, int, int]] = []
        total = 0
        for req in batch:
            length = self.length_of(req)
            if length > self.bucket:
                raise MXNetError(
                    f"request length {length} exceeds the pack bucket "
                    f"{self.bucket}; reject at admission")
            placed = False
            for row in range(len(free)):
                if free[row] >= length and (
                        not self.max_segments
                        or segs[row] < self.max_segments):
                    start = self.bucket - free[row]
                    spans.append((row, start, start + length))
                    free[row] -= length
                    segs[row] += 1
                    placed = True
                    break
            if not placed:
                spans.append((len(free), 0, length))
                free.append(self.bucket - length)
                segs.append(1)
            total += length
        return PackPlan(spans, len(free), total, self.pack_axis,
                        self.bucket)

    class Builder:
        """Incremental admission bound for the coalescer's gather: a
        request is only pulled out of the queue if the pack still fits
        ``max_rows`` packed rows. Mirrors :meth:`plan`'s first-fit so
        the admission decision and the final layout agree."""

        def __init__(self, packer: "SequencePacker", max_rows: int):
            self._p = packer
            self.max_rows = max(1, int(max_rows))
            self._free: List[int] = []
            self._segs: List[int] = []

        def try_add(self, req) -> bool:
            length = self._p.length_of(req)
            if length > self._p.bucket:
                return False
            for row in range(len(self._free)):
                if self._free[row] >= length and (
                        not self._p.max_segments
                        or self._segs[row] < self._p.max_segments):
                    self._free[row] -= length
                    self._segs[row] += 1
                    return True
            if len(self._free) >= self.max_rows:
                return False
            self._free.append(self._p.bucket - length)
            self._segs.append(1)
            return True

    def builder(self, max_rows: int) -> "SequencePacker.Builder":
        return SequencePacker.Builder(self, max_rows)

    # -- merge / scatter (the per-dispatch hot path) -------------------------

    @hot_path("per-dispatch pack merge on the ragged serving fast path")
    def merge(self, batch: Sequence) -> Tuple[Dict[str, np.ndarray],
                                              PackPlan]:
        """Pack the members' inputs into shared rows padded to
        ``bucket`` along the pack axis, plus the synthesized
        ``segment_ids`` plane."""
        plan = self.plan(batch)
        names = sorted(batch[0].inputs)
        merged: Dict[str, np.ndarray] = {}
        for name in names:
            ref = np.asarray(batch[0].inputs[name])
            if ref.ndim <= self.pack_axis:
                raise MXNetError(
                    f"packed input {name!r} needs the pack axis "
                    f"{self.pack_axis} (got shape {ref.shape})")
            shape = list(ref.shape)
            shape[0] = plan.rows
            shape[self.pack_axis] = self.bucket
            merged[name] = np.zeros(shape, ref.dtype)
        seg = np.zeros((plan.rows, self.bucket), np.int32)
        seg_in_row = [0] * plan.rows
        for req, (row, start, stop) in zip(batch, plan.spans):
            length = stop - start
            seg_in_row[row] += 1
            seg[row, start:stop] = seg_in_row[row]
            for name in names:
                arr = np.asarray(req.inputs[name])
                if arr.shape[self.pack_axis] != length:
                    raise MXNetError(
                        f"packed input {name!r} length "
                        f"{arr.shape[self.pack_axis]} disagrees with "
                        f"the request's pack length {length}")
                dst = ((row,)
                       + (slice(None),) * (self.pack_axis - 1)
                       + (slice(start, stop),))
                merged[name][dst] = arr[0]
        merged[self.segment_name] = seg
        return merged, plan

    @hot_path("per-dispatch pack scatter on the ragged serving fast path")
    def scatter(self, outputs: Sequence, plan: PackPlan) -> List[List]:
        """Slice each member's tokens back out of every output. An
        output carrying both the packed row axis and the pack axis is
        sliced bitwise by the member's span (leading axis restored to
        1, the member's own row count); anything else (scalars, global
        stats) is replicated unchanged."""
        per_request: List[List] = []
        for row, start, stop in plan.spans:
            outs = []
            for out in outputs:
                shape = getattr(out, "shape", None)
                if (shape and len(shape) > self.pack_axis
                        and shape[0] >= plan.rows
                        and shape[self.pack_axis] == self.bucket):
                    idx = ((row,)
                           + (slice(None),) * (self.pack_axis - 1)
                           + (slice(start, stop),))
                    outs.append(out[idx][None])
                else:
                    outs.append(out)
            per_request.append(outs)
        return per_request

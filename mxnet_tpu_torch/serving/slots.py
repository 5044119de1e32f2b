"""Stateful in-flight batching: decode slots over per-slot RNN state.

Counterpart of ``mxnet_tpu/serving/slots.py``.

Autoregressive serving (our RNN decode; an LLM's KV-cache decode is the
same shape) cannot use the stateless coalescer: each sequence carries
*state* between steps — for an RNN the hidden/cell tensors, this tree's
KV-cache analog. Serving sequences one at a time wastes the device
exactly like unbatched stateless traffic; re-tracing every time the set
of live sequences changes wastes it worse.

The :class:`SlotTable` + :class:`InflightBatcher` pair solves both the
way production LLM servers do (continuous/in-flight batching):

- the batch dimension is a fixed-capacity table of **slots**; the
  compiled step program only ever sees ``(capacity, ...)`` shapes, so it
  compiles ONCE (guarded by a :class:`~mxnet_tpu_torch.perf.CompileGuard`,
  fatal on retrace under ``MXTPU_RETRACE_STRICT=1``);
- each slot holds one sequence's state rows; sequences **join** a free
  slot (state zero-initialized or caller-provided) and **leave** it
  between decode steps — no recompile, no barrier on the other
  sequences;
- one :meth:`~InflightBatcher.step` gathers the fed slots' inputs into
  the fixed batch (empty slots ride as zero rows — padding, exactly the
  warm-up pad/slice stance of :mod:`.warmup`), dispatches the step
  program once, scatters outputs per slot, and writes the *stepped*
  slots' next-state rows back into the table. Rows are computed
  independently by every per-row op an inference RNN uses, so a slot's
  decode is **bitwise identical** to running that sequence alone at the
  same capacity — batching is free of numerical cross-talk. On the card
  this holds because every step runs at the one ``(capacity, ...)``
  shape, for which cuBLAS picks one algorithm whichever rows are live:
  the batched decode and a solo decode at that capacity share it.

Backends implement ``load()``, ``input_specs``/``state_specs`` (name ->
per-row shape) and ``step(inputs, states) -> (outputs, next_states)``
where every array is batch-major at the slot capacity:
:class:`CallableStepBackend` wraps a function, :class:`ModuleStepBackend`
drives a bound forward-only :class:`~mxnet_tpu_torch.module.Module` whose last
outputs are the next states (``module.as_decode_backend()``).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.annotations import hot_path
from ..base import MXNetError
from ..compiler import batch_signature
from ..perf import CompileGuard
from .errors import SlotsFull

__all__ = ["SlotTable", "InflightBatcher", "CallableStepBackend",
           "ModuleStepBackend"]


class SlotTable:
    """Fixed-capacity per-slot state storage (the KV-cache analog).

    ``arrays`` maps state name -> one ``(capacity,) + row_shape`` array;
    slot ``i`` owns row ``i`` of every state. Join/leave recycle rows
    without touching the others — the compiled step program's shapes
    never change.
    """

    def __init__(self, capacity: int, state_specs: Dict[str, Sequence[int]],
                 dtype=np.float32):
        if capacity < 1:
            raise ValueError("slot capacity must be >= 1")
        if not state_specs:
            raise ValueError("need at least one state tensor "
                             "(stateless workloads use the BatchCoalescer)")
        self.capacity = int(capacity)
        self.state_specs = {name: tuple(int(d) for d in shape)
                            for name, shape in state_specs.items()}
        self.arrays: Dict[str, np.ndarray] = {
            name: np.zeros((self.capacity,) + shape, dtype)
            for name, shape in self.state_specs.items()}
        self._free = list(range(self.capacity - 1, -1, -1))
        self._active: set = set()

    @property
    def active(self) -> Tuple[int, ...]:
        return tuple(sorted(self._active))

    def __len__(self) -> int:
        return len(self._active)

    def join(self, init_state: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Claim a free slot; its state rows are zeroed (a fresh
        sequence) or set from ``init_state`` (a migrated/resumed one).
        Raises the retriable :class:`~.errors.SlotsFull` at capacity."""
        if not self._free:
            raise SlotsFull(
                f"all {self.capacity} decode slots are occupied; retry "
                f"after a running sequence finishes")
        slot = self._free.pop()
        self._active.add(slot)
        for name, arr in self.arrays.items():
            if init_state is not None and name in init_state:
                row = np.asarray(init_state[name], arr.dtype)
                if row.shape != arr.shape[1:]:
                    self._release(slot)
                    raise MXNetError(
                        f"init state {name!r} row shape {row.shape} != "
                        f"declared {arr.shape[1:]}")
                arr[slot] = row
            else:
                arr[slot] = 0
        return slot

    def _release(self, slot: int):
        self._active.discard(slot)
        self._free.append(slot)

    def leave(self, slot: int) -> Dict[str, np.ndarray]:
        """Free a slot; returns the final state rows (copies) so a
        sequence can migrate to another replica or be checkpointed."""
        if slot not in self._active:
            raise MXNetError(f"slot {slot} is not active")
        final = {name: arr[slot].copy() for name, arr in self.arrays.items()}
        self._release(slot)
        return final

    def read_state(self, slot: int) -> Dict[str, np.ndarray]:
        if slot not in self._active:
            raise MXNetError(f"slot {slot} is not active")
        return {name: arr[slot].copy() for name, arr in self.arrays.items()}

    @hot_path("per-step state write-back on the decode fast path")
    def write_rows(self, next_states: Dict[str, np.ndarray],
                   slots: Sequence[int]):
        """Scatter the stepped slots' rows of ``next_states`` back into
        the table. Only the stepped rows move — an active slot that sat
        this step out keeps its state untouched."""
        idx = list(slots)
        for name, arr in self.arrays.items():
            arr[idx] = np.asarray(next_states[name])[idx]


class CallableStepBackend:
    """Wrap ``fn(inputs, states) -> (outputs, next_states)`` — all
    arrays batch-major at the slot capacity (tests, jitted toys).

    ``accepts_mask=True`` declares the ragged decode contract
    (serving/ragged.py): the wrapped fn takes a third ``mask`` argument
    — a ``(capacity,)`` float32 0/1 vector of the FED slots — and is
    free to make un-fed rows mask-dead (skip their compute) as long as
    fed rows are bitwise identical to the unmasked step; the batcher
    only ever writes back and returns fed rows, so un-fed garbage never
    escapes."""

    def __init__(self, fn: Callable, input_specs: Dict[str, Sequence[int]],
                 state_specs: Dict[str, Sequence[int]],
                 accepts_mask: bool = False):
        self.fn = fn
        self.input_specs = {k: tuple(v) for k, v in input_specs.items()}
        self.state_specs = {k: tuple(v) for k, v in state_specs.items()}
        self.accepts_mask = accepts_mask

    def load(self):
        pass

    def step(self, inputs: Dict[str, np.ndarray],
             states: Dict[str, np.ndarray],
             mask: Optional[np.ndarray] = None):
        if self.accepts_mask and mask is not None:
            outs, next_states = self.fn(inputs, states, mask)
        else:
            outs, next_states = self.fn(inputs, states)
        if isinstance(outs, np.ndarray):
            outs = [outs]
        return list(outs), dict(next_states)


class ModuleStepBackend:
    """One decode step through a bound, forward-only Module.

    The module's data names must include every state name; its symbol's
    LAST ``len(state_names)`` outputs are the next states, in
    ``state_names`` order (the natural shape of
    ``out, next_states = cell(inputs, states)`` grouped as
    ``sym.Group([out] + next_states)``). Also reachable as
    ``module.as_decode_backend(state_names)``.
    """

    def __init__(self, module, state_names: Sequence[str]):
        self.module = module
        self.state_names = list(state_names)
        specs = {d[0]: tuple(d[1][1:]) for d in module.data_shapes}
        missing = [n for n in self.state_names if n not in specs]
        if missing:
            raise MXNetError(
                f"state names {missing} are not data inputs of the "
                f"module (data: {sorted(specs)})")
        self.state_specs = {n: specs[n] for n in self.state_names}
        self.input_specs = {n: s for n, s in specs.items()
                            if n not in self.state_specs}
        self.capacity = int(module.data_shapes[0][1][0])

    def load(self):
        if not (self.module.binded and self.module.params_initialized):
            raise MXNetError(
                "ModuleStepBackend needs a bound module with initialized "
                "params (bind + init_params/set_params first)")
        n_out = len(self.module.output_names)
        if n_out <= len(self.state_names):
            raise MXNetError(
                f"module has {n_out} outputs but {len(self.state_names)} "
                f"state outputs are expected plus at least one payload")

    def step(self, inputs: Dict[str, np.ndarray],
             states: Dict[str, np.ndarray]):
        import torch

        from ..io import DataBatch
        from ..ndarray import NDArray
        feed = {**inputs, **states}
        # host tensors: the executor copies them onto the module's device
        data = [NDArray(torch.from_numpy(
            np.ascontiguousarray(feed[d[0]], np.float32)))
            for d in self.module.data_shapes]
        self.module.forward(DataBatch(data=data), is_train=False)
        outs = [o.asnumpy() for o in self.module.get_outputs()]
        n = len(self.state_names)
        return outs[:-n], dict(zip(self.state_names, outs[-n:]))


class InflightBatcher:
    """Drives decode steps over a :class:`SlotTable`: sequences join and
    leave between steps, every step is ONE fixed-shape dispatch.

    ``step(feeds)`` takes ``{slot: {input_name: row}}`` — the fed slots
    advance one token, the rest (active but idle, or empty) ride as
    zero-padding rows whose results are discarded. Thread-safe for the
    join/leave-vs-step interleaving a server does; the dispatch itself
    is serialized (one step program, one table).
    """

    def __init__(self, backend, capacity: Optional[int] = None,
                 name: str = "decode",
                 clock: Callable[[], float] = time.monotonic,
                 guard: Optional[CompileGuard] = None,
                 ragged: Optional[bool] = None):
        from .ragged import PadWasteTracker, ragged_enabled
        self.backend = backend
        self.capacity = int(capacity if capacity is not None
                            else getattr(backend, "capacity"))
        self.name = name
        self.clock = clock
        self.guard = guard or CompileGuard(f"serving.slots[{name}]",
                                           expected=0)
        self.table = SlotTable(self.capacity, backend.state_specs)
        # ragged decode (serving/ragged.py): pass the fed-slot mask to
        # backends that declare accepts_mask, so un-fed slots are
        # mask-dead instead of zero-compute-full-cost; MXTPU_RAGGED=0
        # (or an undeclared backend) keeps today's call shape exactly
        self.ragged = ragged_enabled() if ragged is None else bool(ragged)
        self._masked = (self.ragged
                        and getattr(backend, "accepts_mask", False))
        self._pad_waste = PadWasteTracker()
        self._lock = threading.Lock()
        self._loaded = False
        self._stats = {"joined": 0, "left": 0, "steps": 0, "tokens": 0,
                       "slots_full": 0}

    # -- lifecycle -----------------------------------------------------------

    def warm_up(self) -> "InflightBatcher":
        """Load the backend and pre-trace the ONE step shape the batcher
        will ever dispatch — after this, a live decode step can never
        compile (the signature is budgeted into the guard)."""
        self.backend.load()
        inputs = self._zero_inputs()
        self.guard.expect(batch_signature({**inputs, **self.table.arrays}))
        if self._masked:
            # mask rides as a kwarg, outside the batch signature: its
            # (capacity,) shape is as fixed as the table itself
            self.backend.step(inputs, dict(self.table.arrays),
                              mask=np.zeros((self.capacity,), np.float32))
        else:
            self.backend.step(inputs, dict(self.table.arrays))
        self._loaded = True
        return self

    def _zero_inputs(self) -> Dict[str, np.ndarray]:
        return {name: np.zeros((self.capacity,) + shape, np.float32)
                for name, shape in self.backend.input_specs.items()}

    def join(self, init_state: Optional[Dict] = None) -> int:
        with self._lock:
            try:
                slot = self.table.join(init_state)
            except SlotsFull:
                self._stats["slots_full"] += 1
                raise
            self._stats["joined"] += 1
            return slot

    def leave(self, slot: int) -> Dict[str, np.ndarray]:
        with self._lock:
            final = self.table.leave(slot)
            self._stats["left"] += 1
            return final

    # -- the decode step -----------------------------------------------------

    @hot_path("per-step gather on the decode fast path")
    def _gather(self, feeds: Dict[int, Dict]) -> Dict[str, np.ndarray]:
        inputs = self._zero_inputs()
        for slot, row_feed in feeds.items():
            for name, arr in inputs.items():
                row = np.asarray(row_feed[name], arr.dtype)
                if row.shape != arr.shape[1:]:
                    raise MXNetError(
                        f"slot {slot} input {name!r} row shape "
                        f"{row.shape} != declared {arr.shape[1:]}")
                arr[slot] = row
        return inputs

    def step(self, feeds: Dict[int, Dict]) -> Dict[int, List[np.ndarray]]:
        """Advance the fed slots one decode step in ONE dispatch;
        returns ``{slot: [output rows]}`` for exactly the fed slots."""
        with self._lock:
            if not self._loaded:
                raise MXNetError(
                    f"InflightBatcher {self.name!r}: warm_up() first — "
                    f"a cold decode step is a live-request compile")
            if not feeds:
                return {}
            stale = [s for s in feeds if s not in self.table._active]
            if stale:
                raise MXNetError(
                    f"cannot step inactive slots {sorted(stale)}; "
                    f"join() them first")
            inputs = self._gather(feeds)
            states = dict(self.table.arrays)
            self.guard.observe(batch_signature({**inputs, **states}))
            if self._masked:
                fed_mask = np.zeros((self.capacity,), np.float32)
                fed_mask[sorted(feeds)] = 1.0
                outs, next_states = self.backend.step(inputs, states,
                                                      mask=fed_mask)
            else:
                outs, next_states = self.backend.step(inputs, states)
            self.table.write_rows(next_states, sorted(feeds))
            self._stats["steps"] += 1
            self._stats["tokens"] += len(feeds)
            # the decode pad tax: capacity rows dispatched, len(feeds)
            # of them real (recorded healthy-silent, like the server's)
            self._pad_waste.record(len(feeds), self.capacity)
            return {slot: [np.asarray(out)[slot] for out in outs]
                    for slot in feeds}

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            out = dict(self._stats)
        out["capacity"] = self.capacity
        out["active"] = len(self.table)
        out["compiles"] = self.guard.count
        out["retraced"] = self.guard.retraced
        out["masked"] = self._masked
        out["pad_waste"] = self._pad_waste.snapshot()
        return out

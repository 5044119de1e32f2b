"""Model backends the serving runtime can front.

Counterpart of ``mxnet_tpu/serving/backends.py``. A backend is anything
with ``load()`` (parse/bind; raises
:class:`~mxnet_tpu_torch.base.MXNetError` on corrupt artifacts; the
server guards it behind the ``serving.load`` fault site and its retry
policy) and ``infer(arrays) -> [np.ndarray, ...]`` where ``arrays`` maps
input name to a host batch whose leading axis is the batch dimension.

- :class:`CallableBackend` — any python callable;
- :class:`PredictorBackend` — the C predict ABI's python half, one bound
  :class:`~mxnet_tpu_torch.c_predict.Predictor` per bucket size;
- :class:`ModuleBackend` — a bound :class:`~mxnet_tpu_torch.module.Module`
  driven forward-only (``module.as_serving_backend()``).

What waits: :class:`SymbolicJitBackend` (one symbolic-batch program
for every row count) needs the compiler's symbolic programs, A12, and
raises; so does ``as_serving_backend(quant=True)`` (int8, A12). The
fleet router is A14's second half.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["CallableBackend", "PredictorBackend", "ModuleBackend",
           "SymbolicJitBackend"]


class CallableBackend:
    """Wrap ``fn(arrays: dict) -> list[np.ndarray] | np.ndarray``.

    The keyword-only flags are the *ragged capability declarations*
    (serving/ragged.py) any backend object may carry — the server only
    activates a ragged rung on backends that declare it:

    - ``accepts_mask``/``mask_name`` — the forward consumes a 0/1 row
      mask input (pad rows are mask-dead, not zero-compute-full-cost);
    - ``pack_axis``/``accepts_segment_ids``/``segment_name`` — the
      forward consumes packed rows along ``pack_axis`` (>= 1, an axis
      of the *batched* arrays) with an int32 segment-id plane, enabling
      sequence packing in the coalescer;
    - ``lengths_name`` — which input carries per-row real lengths, so
      pad-waste accounting can count tokens on the dense leg;
    - ``supports_symbolic_batch`` — the forward runs ANY row count
      through one program, so the server can skip batch-axis padding
      and collapse bucket warm-up (a declaration only: the server
      trusts it);
    - ``input_dtypes`` — per-input dtype overrides for warm-up probes
      (default float32), e.g. int32 lengths.
    """

    def __init__(self, fn: Callable, input_name: str = "data",
                 input_specs: Optional[Dict[str, Sequence[int]]] = None,
                 input_dtypes: Optional[Dict[str, object]] = None,
                 accepts_mask: bool = False, mask_name: str = "mask",
                 pack_axis: Optional[int] = None,
                 accepts_segment_ids: bool = False,
                 segment_name: str = "segment_ids",
                 lengths_name: Optional[str] = None,
                 supports_symbolic_batch: bool = False):
        self.fn = fn
        self.input_name = input_name
        # name -> per-row shape, used by bucketed warm-up probes
        self.input_specs = ({k: tuple(v) for k, v in input_specs.items()}
                            if input_specs else {input_name: ()})
        if input_dtypes:
            self.input_dtypes = {k: np.dtype(v)
                                 for k, v in input_dtypes.items()}
        self.accepts_mask = accepts_mask
        self.mask_name = mask_name
        self.pack_axis = pack_axis
        self.accepts_segment_ids = accepts_segment_ids
        self.segment_name = segment_name
        self.lengths_name = lengths_name
        self.supports_symbolic_batch = supports_symbolic_batch

    def load(self):
        pass

    def infer(self, arrays: Dict[str, np.ndarray]) -> List[np.ndarray]:
        out = self.fn(arrays)
        if isinstance(out, np.ndarray):
            return [out]
        return list(out)


class PredictorBackend:
    """Serve a symbol-JSON + .params artifact through the C predict ABI's
    python half. Each batch-size bucket gets its own bound
    :class:`~mxnet_tpu_torch.c_predict.Predictor`; ``load()`` validates the
    artifact bytes eagerly so corruption surfaces at startup.

    ``dev_type`` defaults to 2, the GPU, where the JAX package's default
    is 1: the port's entry points run on the card unless the caller asks
    for the CPU (``dev_type=1``)."""

    def __init__(self, symbol_json: str, param_bytes: bytes,
                 row_shape: Sequence[int], input_name: str = "data",
                 dev_type: int = 2, dev_id: int = 0):
        self.symbol_json = symbol_json
        self.param_bytes = param_bytes
        self.row_shape = tuple(int(d) for d in row_shape)
        self.input_name = input_name
        self.input_specs = {input_name: self.row_shape}
        self.dev_type = dev_type
        self.dev_id = dev_id
        self._predictors: Dict[int, object] = {}

    def load(self):
        """Validate the artifact (symbol JSON + param bytes). Raises
        MXNetError on corrupt/truncated inputs."""
        from .. import c_predict
        from .. import symbol as _sym
        c_predict._params_from_bytes(self.param_bytes)
        _sym.load_json(self.symbol_json)

    def bind_bucket(self, batch_size: int):
        """Create (or return) the bound predictor for one bucket size."""
        from .. import c_predict
        if batch_size not in self._predictors:
            self._predictors[batch_size] = c_predict.Predictor(
                self.symbol_json, self.param_bytes,
                self.dev_type, self.dev_id,
                {self.input_name: (batch_size,) + self.row_shape})
        return self._predictors[batch_size]

    def infer(self, arrays: Dict[str, np.ndarray]) -> List[np.ndarray]:
        batch = arrays[self.input_name]
        pred = self.bind_bucket(int(batch.shape[0]))
        buf = np.ascontiguousarray(batch, np.float32)
        pred.set_input(self.input_name, memoryview(buf.reshape(-1)),
                       buf.shape)
        pred.forward()
        outs = []
        for i in range(pred.num_outputs()):
            shape = pred.output_shape(i)
            out = np.empty(int(np.prod(shape, dtype=np.int64)), np.float32)
            pred.get_output(i, memoryview(out))
            outs.append(out.reshape(shape))
        return outs


class SymbolicJitBackend:
    """One symbolic-batch program for every row count: needs the
    compiler's symbolic programs (A12), which the port does not have
    yet. Constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "SymbolicJitBackend needs compiler.symbolic.SymbolicBatchProgram "
            "(queue A12), not ported yet; serve through CallableBackend or "
            "ModuleBackend with bucketed warm-up")


class ModuleBackend:
    """Forward-only adapter over a bound, initialized Module.

    A batch of another row count than the module was bound at runs at
    its own rows (the executor replaces the bound input), so the server
    feeds every bucket size through one module. ``infer`` holds a lock
    around the forward and the outputs' read: the module's executor
    keeps its inputs and outputs on itself, and a replacement worker
    spawned by the server's watchdog may share the module with a wedged
    one. The JAX package's ``ModuleBackend`` takes no lock, and two
    threads there can read each other's outputs; here they cannot."""

    def __init__(self, module, input_name: Optional[str] = None):
        self.module = module
        names = [d[0] for d in module.data_shapes]
        self.input_names = names
        self.input_name = input_name or names[0]
        # every declared input, so multi-input modules warm up whole
        self.input_specs = {d[0]: tuple(d[1][1:])
                            for d in module.data_shapes}
        self.row_shape = self.input_specs[self.input_name]
        self._lock = threading.Lock()

    def load(self):
        if not (self.module.binded and self.module.params_initialized):
            raise MXNetError(
                "ModuleBackend needs a bound module with initialized "
                "params (bind + init_params/set_params first)")

    def infer(self, arrays: Dict[str, np.ndarray]) -> List[np.ndarray]:
        from ..io import DataBatch
        with self._lock:
            data = [NDArray(torch.from_numpy(
                np.ascontiguousarray(arrays[name], np.float32)))
                for name in self.input_names]
            self.module.forward(DataBatch(data=data), is_train=False)
            return [o.asnumpy() for o in self.module.get_outputs()]

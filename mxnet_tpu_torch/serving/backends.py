"""Model backends the serving runtime can front.

Counterpart of ``CallableBackend`` and ``PredictorBackend`` in
``mxnet_tpu/serving/backends.py``. A backend is anything with ``load()``
(parse/bind; raises :class:`~mxnet_tpu_torch.base.MXNetError` on corrupt
artifacts) and ``infer(arrays) -> [np.ndarray, ...]`` where ``arrays`` maps
input name to a host batch whose leading axis is the batch dimension.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["CallableBackend", "PredictorBackend"]


class CallableBackend:
    """Wrap ``fn(arrays: dict) -> list[np.ndarray] | np.ndarray``.

    The JAX package's ragged-batching declarations (masks, packed rows,
    symbolic batch) are read only by its ``InferenceServer``, which comes
    with a later slice; they are not taken here yet.
    """

    def __init__(self, fn: Callable, input_name: str = "data",
                 input_specs: Optional[Dict[str, Sequence[int]]] = None):
        self.fn = fn
        self.input_name = input_name
        # name -> per-row shape, as PredictorBackend declares it
        self.input_specs = ({k: tuple(v) for k, v in input_specs.items()}
                            if input_specs else {input_name: ()})

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

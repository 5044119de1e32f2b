"""Python half of the C predict ABI, on torch.

Counterpart of ``mxnet_tpu/c_predict.py`` (reference:
include/mxnet/c_predict_api.h + src/c_api/c_predict_api.cc). A
:class:`Predictor` binds a loaded symbol and its params once and then
serves ``set_input``/``forward``/``get_output`` calls. The ``.params``
format is the JAX package's: an npz container with ``arg:``/``aux:`` keys.
"""
from __future__ import annotations

import io as _io
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import symbol as _sym_mod
from .base import MXNetError
from .context import Context

__all__ = ["Predictor", "load_ndarray_file"]


def _corrupt(what: str, err: BaseException) -> MXNetError:
    """One catchable error for np.load's many failures on corrupt bytes."""
    return MXNetError(
        f"corrupt or truncated {what}: cannot parse as an "
        f"npz/NDArray container ({type(err).__name__}: {err})")


def _params_from_bytes(param_bytes: bytes):
    """Parse an in-memory .params (npz container with arg:/aux: keys)."""
    arg_params, aux_params = {}, {}
    if not param_bytes:
        return arg_params, aux_params
    try:
        with np.load(_io.BytesIO(param_bytes)) as f:
            for k in f.keys():
                tp, name = k.split(":", 1) if ":" in k else ("arg", k)
                (arg_params if tp == "arg" else aux_params)[name] = f[k]
    except Exception as err:
        raise _corrupt(".params bytes", err) from err
    return arg_params, aux_params


def load_ndarray_file(nd_bytes: bytes):
    """MXNDListCreate's loader: returns (keys, arrays) from file bytes."""
    try:
        with np.load(_io.BytesIO(nd_bytes)) as f:
            keys = list(f.keys())
            if all(k.isdigit() for k in keys):
                keys_sorted = sorted(keys, key=int)
                return [""] * len(keys_sorted), [f[k] for k in keys_sorted]
            arrays = [f[k] for k in keys]
            names = [k.split(":", 1)[1] if ":" in k else k for k in keys]
            return names, arrays
    except Exception as err:
        raise _corrupt("NDArray-file bytes", err) from err


def _context(dev_type: int, dev_id: int) -> Context:
    """dev_type as in c_predict_api.h: 1 = cpu, 2 = gpu."""
    if dev_type not in (1, 2):
        raise MXNetError(f"dev_type {dev_type} unsupported: 1 = cpu, 2 = gpu")
    return Context(Context.devtype2str[dev_type], dev_id)


class Predictor:
    """A bound, inference-only executor (reference c_predict_api.cc:83).

    Parameters: symbol JSON string, raw .params bytes, device spec
    (dev_type 1 = cpu, 2 = gpu; the GPU raises MXNetError where there is no
    card), and the input shapes dict. ``output_keys`` selects internal
    outputs (MXPredCreatePartialOut).
    """

    def __init__(self, symbol_json: str, param_bytes: bytes,
                 dev_type: int, dev_id: int,
                 input_shapes: Dict[str, Sequence[int]],
                 output_keys: Optional[List[str]] = None):
        ctx = _context(dev_type, dev_id)
        ctx.torch_device()  # raises before any work where the card is missing
        # fp32 products stay fp32 on the card (no TF32), as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sym = _sym_mod.load_json(symbol_json)
        if output_keys:
            internals = sym.get_internals()
            out_names = internals.list_outputs()
            picked = []
            for key in output_keys:
                for cand in (key, key + "_output"):
                    if cand in out_names:
                        picked.append(internals[cand])
                        break
                else:
                    raise MXNetError(
                        f"output {key!r} not found in graph; have "
                        f"{out_names[:20]}...")
            sym = _sym_mod.Group(picked)
        self._symbol = sym
        arg_params, aux_params = _params_from_bytes(param_bytes)

        self._input_names = list(input_shapes.keys())
        shapes = {k: tuple(int(d) for d in v)
                  for k, v in input_shapes.items()}
        self._exec = sym.simple_bind(ctx, grad_req="null", **shapes)
        for name, arr in self._exec.arg_dict.items():
            if name not in shapes and name in arg_params:
                arr[:] = arg_params[name]
        for name, arr in self._exec.aux_dict.items():
            if name in aux_params:
                arr[:] = aux_params[name]
        self._outputs: List[np.ndarray] = []
        # one forward at bind, as the JAX package's compile warm-up
        self.forward()

    # -- C-boundary methods -------------------------------------------------
    def num_outputs(self) -> int:
        return len(self._exec.outputs)

    def output_shape(self, index: int):
        return tuple(int(d) for d in self._outputs[index].shape)

    def set_input(self, key: str, data: memoryview, shape):
        if key not in self._exec.arg_dict:
            raise MXNetError(
                f"unknown input {key!r}; inputs: {self._input_names}")
        arr = np.frombuffer(data, dtype=np.float32).reshape(
            tuple(int(d) for d in shape))
        self._exec.arg_dict[key][:] = arr

    def forward(self):
        """Run the graph and copy its outputs to the host (float32)."""
        self._exec.forward(is_train=False)
        self._outputs = [np.ascontiguousarray(o.asnumpy(), np.float32)
                         for o in self._exec.outputs]

    def get_output(self, index: int, out: memoryview):
        flat = self._outputs[index].reshape(-1)
        dst = np.frombuffer(out, dtype=np.float32)
        if dst.size != flat.size:
            raise MXNetError(
                f"output buffer size {dst.size} != output size {flat.size}")
        np.copyto(dst, flat)

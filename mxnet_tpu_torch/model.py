"""Checkpoints and the update helpers shared by the trainers.

Counterpart of the parts of ``mxnet_tpu/model.py`` that ``Module`` needs
(reference python/mxnet/model.py: save_checkpoint:340,
load_checkpoint:370, _create_kvstore:57, _update_params:117). A checkpoint
is the JAX package's: ``prefix-symbol.json``, ``prefix-%04d.params`` (or
``prefix.params`` for ``epoch=None``) with ``arg:``/``aux:`` keys in the
``.npz`` container of ``nd.save``, an optional ``.states`` file of
optimizer state, and a ``.manifest.json`` with each file's size and
SHA-256, so that a checkpoint written by either package loads in the
other. Each file is written to a temporary name and renamed into place.
The fallback to an older checkpoint, iterator state and async or sharded
checkpoints are queue A13; a KVStore is queue A11.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
from typing import Optional, Tuple

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .callback import BatchEndParam  # noqa: F401  (reference keeps it here)
from .context import cpu

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]

MANIFEST_VERSION = 1


def _stem(prefix: str, epoch: Optional[int]) -> str:
    return prefix if epoch is None else "%s-%04d" % (prefix, epoch)


def checkpoint_paths(prefix: str, epoch: Optional[int]):
    stem = _stem(prefix, epoch)
    return {"params": stem + ".params", "states": stem + ".states",
            "symbol": prefix + "-symbol.json",
            "manifest": stem + ".manifest.json"}


def _file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_atomic(path: str, write):
    """``write(tmp_path)``, then rename the temporary file over ``path``."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write_bytes(path: str, data: bytes):
    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)
    _write_atomic(path, write)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    states=None):
    """Write the symbol JSON, the params (and ``states`` bytes, when
    given), then the manifest that covers them."""
    paths = checkpoint_paths(prefix, epoch)
    files = {}
    if symbol is not None:
        _write_atomic(paths["symbol"], symbol.save)
        files["symbol"] = paths["symbol"]
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    _write_atomic(paths["params"], lambda tmp: nd.save(tmp, save_dict))
    files["params"] = paths["params"]
    if states is not None:
        _write_bytes(paths["states"], states)
        files["states"] = paths["states"]
    doc = {"format_version": MANIFEST_VERSION, "epoch": epoch, "step": None,
           "files": {role: {"file": os.path.basename(path),
                            "size": os.path.getsize(path),
                            "sha256": _file_digest(path)}
                     for role, path in files.items()}}
    _write_bytes(paths["manifest"],
                 json.dumps(doc, indent=1, sort_keys=True).encode("utf-8"))
    logging.info("Saved checkpoint to \"%s\"", paths["params"])
    return paths


def _verify_manifest(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))
    for role, entry in doc.get("files", {}).items():
        fpath = os.path.join(base_dir, entry["file"])
        if (not os.path.exists(fpath)
                or os.path.getsize(fpath) != entry["size"]
                or _file_digest(fpath) != entry["sha256"]):
            raise MXNetError(f"{path}: {role} file {entry['file']} is missing "
                             "or does not match its size and digest")
    return doc


def _newest_epoch(prefix: str) -> int:
    base_dir = os.path.dirname(os.path.abspath(prefix))
    pattern = re.compile(re.escape(os.path.basename(prefix))
                         + r"-(\d{4,})\.params$")
    epochs = [int(m.group(1)) for m in map(pattern.match, os.listdir(base_dir))
              if m]
    if not epochs:
        raise FileNotFoundError(f"no checkpoint found at prefix {prefix!r}")
    return max(epochs)


def _load_checkpoint_ex(prefix, epoch=None):
    """(epoch, symbol, arg_params, aux_params, states path or None); with
    ``epoch=None`` the epoch-less ``prefix.params`` where it exists, else
    the newest numbered one. A manifest, where there is one, is verified
    first."""
    if epoch is None and not os.path.exists(
            checkpoint_paths(prefix, None)["params"]):
        epoch = _newest_epoch(prefix)
    paths = checkpoint_paths(prefix, epoch)
    doc = None
    if os.path.exists(paths["manifest"]):
        doc = _verify_manifest(paths["manifest"])
    symbol = (sym.load(paths["symbol"]) if os.path.exists(paths["symbol"])
              else None)
    arg_params, aux_params = {}, {}
    for key, value in nd.load(paths["params"], ctx=cpu()).items():
        kind, _, name = key.partition(":")
        if kind == "arg":
            arg_params[name] = value
        elif kind == "aux":
            aux_params[name] = value
    if doc is not None:
        states = paths["states"] if "states" in doc.get("files", {}) else None
    else:
        states = paths["states"] if os.path.exists(paths["states"]) else None
    return epoch, symbol, arg_params, aux_params, states


def load_checkpoint(prefix, epoch=None) -> Tuple:
    """(symbol, arg_params, aux_params) of a checkpoint: the port's or the
    JAX package's. The arrays are host (CPU) arrays; binding copies them
    onto the module's device."""
    _, symbol, arg_params, aux_params, _ = _load_checkpoint_ex(prefix, epoch)
    return symbol, arg_params, aux_params


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore): one device and no ``dist`` store needs
    none (reference: model.py:57-94); any other store is queue A11."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            return None, False
        raise MXNetError(f"kvstore {kvstore!r} needs the KVStore of queue "
                         "A11, not ported yet")
    raise MXNetError("a KVStore object needs queue A11, not ported yet")


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The local updater path (reference: model.py:117). Where the
    optimizer has a functional rule, the whole parameter set is updated
    as one step (``perf.fused_update_params``: the fused step's rules, one
    captured graph on the card, the updater's bookkeeping); otherwise, or
    with
    ``MXTPU_FUSED_STEP=0``, one updater call a parameter that has a
    gradient."""
    if kvstore is not None:
        raise MXNetError("updates through a KVStore are queue A11")
    if num_device == 1:
        from .perf import fused_update_params
        if fused_update_params(param_arrays, grad_arrays, updater,
                               param_names):
            return
    for index, (weight, grad) in enumerate(zip(param_arrays, grad_arrays)):
        if grad is None:
            continue
        updater(index * num_device, grad, weight)

"""Pretrained-weight cache (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``; reference
gluon/model_zoo/model_store.py).

``get_model_file`` never downloads: it reads ``<name>.params`` from the
cache directory (``root``, else ``MXTPU_MODEL_ZOO_DIR``, else
``~/.mxnet/models``) and raises with instructions when it is not there.
The JAX package pins no sha1 for any model, so neither does the port.
"""
from __future__ import annotations

import os

__all__ = ["get_model_file", "purge"]


def _default_root():
    return os.environ.get(
        "MXTPU_MODEL_ZOO_DIR",
        os.path.join(os.path.expanduser("~"), ".mxnet", "models"))


def get_model_file(name, root=None):
    """The path of the cached ``<root>/<name>.params``."""
    root = os.path.expanduser(root or _default_root())
    path = os.path.join(root, f"{name}.params")
    if os.path.exists(path):
        return path
    raise FileNotFoundError(
        f"No cached weights for {name!r} under {root}; weights are never "
        f"downloaded: seed the cache by copying a .params file to {path} "
        "(or set MXTPU_MODEL_ZOO_DIR).")


def purge(root=None):
    """Remove all cached model files (reference model_store.py purge)."""
    root = os.path.expanduser(root or _default_root())
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))

"""Base utilities: the framework error type and declarative attr parsing.

Counterpart of ``mxnet_tpu/base.py``. The attr grammar is copied, not
imported, so that symbol JSON parses to the same python values in both
packages.
"""
from __future__ import annotations

import ast
import os
from typing import Any, Callable, Dict, Optional

__all__ = ["MXNetError", "AttrSpec", "Registry", "numeric_types",
           "getenv", "__version__"]

# written into symbol JSON as "mxnet_tpu_version", as the JAX package does
__version__ = "0.11.0"

numeric_types = (float, int)


class MXNetError(RuntimeError):
    """Framework error type (reference: python/mxnet/base.py MXNetError)."""


def getenv(name: str, default=None, typ=str):
    """A runtime knob from the environment, as the JAX package reads it:
    ``MXTPU_*``, with the reference's ``MXNET_*`` spelling as a fallback."""
    for key in (name, name.replace("MXTPU_", "MXNET_")):
        val = os.environ.get(key)
        if val is not None:
            if typ is bool:
                return val not in ("0", "false", "False", "")
            return typ(val)
    return default


def _parse_tuple(s):
    if isinstance(s, (tuple, list)):
        return tuple(s)
    if isinstance(s, (int, float)):
        return (s,)
    s = s.strip()
    if s.startswith("(") or s.startswith("["):
        v = ast.literal_eval(s.replace("L", ""))
        # "(2)" evaluates to a bare scalar; shapes stay 1-tuples (the
        # reference's TShape parser accepts both spellings)
        return tuple(v) if isinstance(v, (tuple, list)) else (v,)
    return tuple(ast.literal_eval("(" + s + ",)"))


def _parse_bool(s):
    if isinstance(s, bool):
        return s
    if isinstance(s, (int, float)):
        return bool(s)
    return s.strip() in ("1", "true", "True", "yes")


class AttrSpec:
    """Declarative per-op parameter spec: declared fields with types and
    defaults, parsed from python values or strings (strings arrive from
    symbol JSON round-trips)."""

    _REQUIRED = object()

    PARSERS: Dict[str, Callable] = {
        "int": int,
        "float": float,
        "bool": _parse_bool,
        "str": str,
        "tuple": _parse_tuple,
        "any": lambda x: x,
    }

    def __init__(self, **fields):
        # fields: name -> (typename, default) or (typename,) for required
        self.fields = {}
        for k, v in fields.items():
            if isinstance(v, tuple) and len(v) == 2:
                typ, default = v
            else:
                typ, default = v[0], AttrSpec._REQUIRED
            self.fields[k] = (typ, default)

    def parse(self, attrs: Dict[str, Any], op_name: str = "") -> Dict[str, Any]:
        out = {}
        for k, (typ, default) in self.fields.items():
            if k in attrs:
                raw = attrs[k]
                out[k] = None if raw is None else self.PARSERS[typ](raw)
            elif default is AttrSpec._REQUIRED:
                raise MXNetError(
                    f"Required parameter {k} of operator {op_name} is missing")
            else:
                out[k] = default
        unknown = set(attrs) - set(self.fields)
        if unknown:
            raise MXNetError(
                f"Unknown parameters {sorted(unknown)} for operator {op_name}; "
                f"valid: {sorted(self.fields)}")
        return out

    def serialize(self, attrs: Dict[str, Any]) -> Dict[str, str]:
        """Stringify parsed attrs for symbol JSON (all attrs are strings in
        the graph JSON)."""
        return {k: str(v) for k, v in attrs.items() if v is not None}


class Registry:
    """Generic name->object registry with alias support.

    Reference: dmlc registry pattern (python/mxnet/registry.py:158) used for
    optimizers, metrics, initializers, io iterators.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._map: Dict[str, Any] = {}

    def register(self, obj=None, name: Optional[str] = None):
        def do(o):
            key = (name or getattr(o, "__name__", None) or str(o)).lower()
            self._map[key] = o
            return o

        if obj is None:
            return do
        return do(obj)

    def alias(self, name, target):
        self._map[name.lower()] = self._map[target.lower()]

    def get(self, name: str):
        key = name.lower()
        if key not in self._map:
            raise MXNetError(f"Unknown {self.kind}: {name}. Known: {sorted(self._map)}")
        return self._map[key]

    def find(self, name: str):
        return self._map.get(name.lower())

    def keys(self):
        return list(self._map)

"""Base utilities: the framework error type and declarative attr parsing.

Counterpart of ``mxnet_tpu/base.py``. The attr grammar is copied, not
imported, so that symbol JSON parses to the same python values in both
packages.
"""
from __future__ import annotations

import ast
from typing import Any, Callable, Dict

__all__ = ["MXNetError", "AttrSpec", "numeric_types", "__version__"]

# written into symbol JSON as "mxnet_tpu_version", as the JAX package does
__version__ = "0.11.0"

numeric_types = (float, int)


class MXNetError(RuntimeError):
    """Framework error type (reference: python/mxnet/base.py MXNetError)."""


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

"""Model families of the port: the decoder-only transformer LM."""
from . import transformer  # noqa: F401
from .transformer import TransformerConfig, TransformerLM  # noqa: F401

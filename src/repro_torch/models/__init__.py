"""Ported model families."""
from .transformer_lm import TransformerLM  # noqa: F401

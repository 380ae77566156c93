"""Synthetic data (the token stream the serving driver prompts with)."""
from .pipeline import synthetic_batch

__all__ = ["synthetic_batch"]

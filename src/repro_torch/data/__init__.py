"""Deterministic token pipeline (numpy only)."""
from .pipeline import DataConfig, SyntheticLM, make_source

__all__ = ["DataConfig", "SyntheticLM", "make_source"]

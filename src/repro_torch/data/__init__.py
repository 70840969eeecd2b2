"""Deterministic token pipeline (numpy only)."""
from .pipeline import (DataConfig, FileTokens, SyntheticLM, batches, host_batch_slice,
                       make_source)

__all__ = ["DataConfig", "FileTokens", "SyntheticLM", "batches", "host_batch_slice",
           "make_source"]

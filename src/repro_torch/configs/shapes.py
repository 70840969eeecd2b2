"""Assigned input-shape cells (LM-family: seq_len x global_batch).

``decode_32k`` / ``long_500k`` lower ``serve_step`` (one new token against a
KV cache / recurrent state of ``seq_len``), not ``train_step``.  ``long_500k``
requires sub-quadratic attention and is skipped for pure full-attention archs
(DESIGN.md S5).
"""
from .base import ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                          kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                         kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                        kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

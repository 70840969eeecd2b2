"""Architecture/shape registry: ``--arch <id>`` resolution and the 40-cell
(arch x shape) enumeration used by the dry-run and roofline reports."""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from .base import ModelConfig, ShapeConfig
from .shapes import SHAPES
from . import (deepseek_67b, deepseek_moe_16b, gemma_7b, internvl2_1b,
               llama3_405b, qwen2_5_3b, qwen3_moe_30b_a3b, rwkv6_3b,
               seamless_m4t_medium, zamba2_1p2b)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (gemma_7b, qwen2_5_3b, llama3_405b, deepseek_67b, rwkv6_3b,
              zamba2_1p2b, internvl2_1b, qwen3_moe_30b_a3b, deepseek_moe_16b,
              seamless_m4t_medium)
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(ARCHS)}") from e


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the cell runs; otherwise the documented skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("long_500k needs sub-quadratic attention; "
                f"{cfg.name} is pure full-attention (DESIGN.md S5)")
    return None


def cells(include_skipped: bool = False
          ) -> Iterator[Tuple[ModelConfig, ShapeConfig, Optional[str]]]:
    """All 40 (arch x shape) cells, with skip annotations."""
    for cfg in ARCHS.values():
        for shape in SHAPES.values():
            reason = cell_skip_reason(cfg, shape)
            if reason is None or include_skipped:
                yield cfg, shape, reason

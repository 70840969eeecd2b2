# One config per assigned architecture (+ the shared shape cells).
from .base import ModelConfig, ShapeConfig, TrainConfig
from .registry import ARCHS, cells, cell_skip_reason, get_config, get_shape
from .shapes import SHAPES

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "ARCHS", "SHAPES",
           "cells", "cell_skip_reason", "get_config", "get_shape"]

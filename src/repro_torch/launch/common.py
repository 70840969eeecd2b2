"""What the launchers share: the model config an entry point runs."""
from __future__ import annotations

from dataclasses import replace

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig


def launch_config(arch: str, *, reduced: bool = False,
                  kernels_path: str = "cuda") -> ModelConfig:
    """The config ``launch/serve.py`` and ``launch/train.py`` run:
    ``kernels_path`` is ``"cuda"`` (attention, MoE experts and the RWKV6
    prompt scan through ``repro_torch.kernels``, forward and backward) or
    ``"plain"`` (dense PyTorch)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return replace(cfg, kernels=kernels_path)

"""Model/runtime configuration dataclasses shared by the whole framework."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # -- dense options ---------------------------------------------------
    mlp_activation: str = "silu"     # silu (SwiGLU) | gelu (GeGLU)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # -- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0               # mamba2 heads (0 -> derived)
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0              # hybrid: shared attn every k blocks
    # -- encoder-decoder -------------------------------------------------------
    n_encoder_layers: int = 0
    is_encoder_decoder: bool = False
    # -- modality frontend stubs -------------------------------------------------
    frontend: str = "none"           # none | vision_stub | audio_stub
    frontend_dim: int = 0            # patch/frame embedding width
    frontend_len: int = 0            # patches/frames per sample
    # -- numerics / runtime -------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kernels: str = "xla"             # xla | pallas
    remat: bool = True
    # sub-quadratic attention available (long_500k eligibility)
    subquadratic: bool = False

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so TP can shard the embedding
        and LM head (standard practice; logits over pad ids are never used
        as labels).  151655 -> 151680, 256206 -> 256256; others unchanged."""
        return -(-self.vocab_size // 256) * 256

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 if self.attn_every == 0
                         else 2 * self.attn_every),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads,
                                  4 * self.n_kv_heads // max(1, self.n_heads)
                                  or 1)),
            d_ff=256,
            vocab_size=512,
            head_dim=32 if self.head_dim else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            moe_d_ff=64 if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            frontend_len=min(self.frontend_len, 16) if self.frontend_len else 0,
            name=self.name + "-reduced",
        )
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    optimizer: str = "adamw"         # adamw | adafactor
    opt_state_dtype: str = "float32"  # bfloat16 for very large models
    microbatches: int = 1
    grad_compression: str = "none"   # none | int8
    seed: int = 0

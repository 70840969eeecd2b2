"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) 64 routed experts
top-6 + 2 shared, fine-grained d_ff=1408 [arXiv:2401.06066]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    n_experts=64, experts_per_token=6, n_shared_experts=2, moe_d_ff=1408,
)

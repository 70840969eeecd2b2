"""rwkv6-3b "Finch" [ssm]: 32L d_model=2560 (attn-free, 40 heads of 64)
d_ff=8960 vocab=65536, data-dependent decay [arXiv:2404.05892]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536, head_dim=64,
    subquadratic=True,
)

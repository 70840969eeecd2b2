"""zamba2-1.2b [hybrid]: 38 Mamba2 blocks (ssm_state=64) + a shared attention
block (32H, d_ff=8192) applied every 2 SSM layers [arXiv:2411.15242].
attn_every=2 chosen so 38 % attn_every == 0 (DESIGN.md S5)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, conv_kernel=4, attn_every=2,
    subquadratic=True,
)

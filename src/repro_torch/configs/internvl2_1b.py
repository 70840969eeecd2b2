"""internvl2-1b [vlm]: InternLM2-ish 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 [arXiv:2404.16821].  InternViT frontend is a STUB: input_specs
provides 256 precomputed patch embeddings of width 1024."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655,
    rope_theta=1_000_000.0, tie_embeddings=True,
    frontend="vision_stub", frontend_dim=1024, frontend_len=256,
)

"""seamless-m4t-medium [audio]: enc-dec, 12L enc + 12L dec, d_model=1024 16H
d_ff=4096 vocab=256206 [arXiv:2308.11596].  The speech frontend is a STUB:
input_specs provides 1024 precomputed frame embeddings of width 160."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    n_encoder_layers=12, is_encoder_decoder=True,
    frontend="audio_stub", frontend_dim=160, frontend_len=1024,
)

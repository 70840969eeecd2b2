"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 [arXiv:2407.21783].  bf16 params (800 GB): the dry-run shards
them TP x ZeRO over the pod; optimizer state dtype bf16 (TrainConfig)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128,
    rope_theta=500_000.0, param_dtype="bfloat16",
)

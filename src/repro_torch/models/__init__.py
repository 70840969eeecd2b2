# Model zoo of the port: the dense decoder, MoE and RWKV6 families so far.
from .api import ModelAPI, attention_calls, build_model

__all__ = ["ModelAPI", "attention_calls", "build_model"]

# Model zoo of the port: the dense decoder family so far.
from .api import ModelAPI, build_model

__all__ = ["ModelAPI", "build_model"]

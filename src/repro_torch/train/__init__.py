# Serving / training substrate of the port: the serve-step factory so far.
from . import serve_step

__all__ = ["serve_step"]

# Serving / training substrate of the port: the serve-step factory, the
# optimizers, int8 gradient compression and the train step.
from . import grad_compress, optimizer, serve_step, train_step

__all__ = ["grad_compress", "optimizer", "serve_step", "train_step"]

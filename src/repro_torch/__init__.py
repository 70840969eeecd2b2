"""TileLoom on PyTorch + CUDA: the port of the ``repro`` JAX package to an
NVIDIA H100.  The planner (``core``, ``plancache``, ``obs``, ``configs``,
``parallel.search_exec``) is a text copy of the reference's framework-free
modules; the kernels under ``kernels/csrc`` are CUDA C++ for ``sm_90a``.
This package imports ``torch`` and never ``jax`` or ``repro``."""
__version__ = "0.1.0"

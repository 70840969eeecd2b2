"""Carry weights and caches across from the reference package.

The port never sees a JAX object: the caller turns the reference's trees into
nested dicts of **numpy arrays** first (``jax.tree.map(np.asarray, tree)``),
and these functions return the port's trees: same keys, same shapes, same
stacked ``layers`` leading dimension.  Parameters and serving caches carry
across here; the training state, in ``train/train_step.py``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16 from JAX
        return torch.from_numpy(a.astype(np.float32)).to(device).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_reference(params_numpy: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference's parameter tree (nested dicts of numpy arrays) as the
    port's tree on ``device``."""
    if isinstance(params_numpy, dict):
        return {k: from_reference(v, device) for k, v in params_numpy.items()}
    return _to_tensor(params_numpy, device)


def cache_from_reference(cache_numpy: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference's serving cache as the port's: every tensor with the same
    shape (``k``/``v`` of the attention families, ``state``/``shift_tm``/
    ``shift_cm`` of RWKV6), ``index`` as a Python int."""
    return {name: int(np.asarray(x)) if name == "index" else _to_tensor(x, device)
            for name, x in cache_numpy.items()}

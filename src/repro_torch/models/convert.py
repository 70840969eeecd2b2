"""Carry weights and caches across from the reference package.

The port never sees a JAX object: the caller turns the reference's trees into
nested dicts of **numpy arrays** first (``jax.tree.map(np.asarray, tree)``),
and these functions return the port's trees: same keys, same shapes, same
stacked ``layers`` leading dimension.
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
    """The reference's ``{"k", "v", "index"}`` serving cache as the port's:
    the same (layers, batch, T, kv_heads, head_dim) tensors, ``index`` as a
    Python int."""
    return {"k": _to_tensor(cache_numpy["k"], device),
            "v": _to_tensor(cache_numpy["v"], device),
            "index": int(np.asarray(cache_numpy["index"]))}

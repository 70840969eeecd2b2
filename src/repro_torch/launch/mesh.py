"""Mesh construction.

Counterpart of ``repro/launch/mesh.py``.  :func:`make_production_mesh`
returns the cluster's :class:`~repro_torch.parallel.sharding.Mesh` record
and touches no device and no process group (the planner and the placement
functions need only the axis names and sizes).  :func:`make_host_mesh`
builds a ``DeviceMesh`` over the process group the caller initialised
(``torch.distributed.init_process_group`` with its address, world size and
rank: nothing here discovers a cluster), plus one process group for every
set of mesh axes, which the train step's collectives run on.
"""
from __future__ import annotations

import itertools
import math

import torch

from repro_torch.parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """32x8 single cluster (256 cards: 32 nodes of 8 NVLink-joined H100s)
    or 2x32x8 over two clusters (512 cards) — the shape of
    ``core.lower_torch.h100_cluster``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 32, 8))
    return Mesh(("data", "model"), (32, 8))


def _axis_groups(mesh: Mesh) -> dict:
    """This rank's process group for every non-empty set of mesh axes
    whose group holds more than one rank.  ``new_group`` is collective:
    every rank creates every group, in the same order."""
    import torch.distributed as dist
    groups = {}
    names = mesh.axis_names
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(names, n):
            if math.prod(mesh.shape[a] for a in axes) <= 1:
                continue
            seen = set()
            for r in range(mesh.size):
                ranks = mesh.peers(axes, r)
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = dist.new_group(list(ranks))
                if mesh.rank in ranks:
                    groups[axes] = g
    return groups


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda") -> Mesh:
    """A (data, model) mesh over the initialised process group, clamped to
    its world size as the reference clamps to its devices.  ``device_type``
    is ``cuda`` (each rank on card ``rank % device_count``; raises without
    a card) or ``cpu`` (the ``gloo`` tests)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs torch.distributed.init_process_group "
                           "first (its address, world size and rank given by the caller)")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh(device_type='cuda') was asked for but "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    elif device_type != "cpu":
        raise ValueError(f"device_type {device_type!r}: cuda or cpu")
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // max(1, data)))
    if data * model != n:
        raise ValueError(f"a {data}x{model} mesh does not cover the {n} ranks of the "
                         f"process group")
    dm = init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
    mesh = Mesh(("data", "model"), (data, model), device_mesh=dm, rank=dist.get_rank())
    mesh.groups.update(_axis_groups(mesh))
    return mesh

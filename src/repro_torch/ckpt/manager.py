"""Checkpoint manager: retention, cadence, async save, auto-resume.

Counterpart of ``repro/ckpt/manager.py``.  The restart contract: a job
killed at ANY point resumes from ``manager.restore_latest()`` with at most
``save_every`` steps of lost work; the data pipeline is deterministic in
(seed, step) so no data state needs saving.  Async saves overlap the file
writing with the next training steps.

The port's train step updates the state in place, where the reference's
arrays are immutable: a snapshot that still pointed at the device, or a copy
still in flight, would be written with a later step's values under this
step's name.  So :meth:`save` returns only once every leaf has a completed
host copy; only the file writing goes to the thread.  :meth:`restore_latest`
first waits for a save still being written, which is the newest checkpoint.
"""
from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import is_sharding_leaf

from . import checkpoint as C


def snapshot(tree):
    """A completed host copy of every leaf of ``tree``."""
    return C.map_leaves(lambda x: (x.detach().to("cpu", copy=True)
                                   if isinstance(x, torch.Tensor) else np.array(x)), tree)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, save_every: int = 100,
                 keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.save_every = save_every
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._failures = 0

    # -- save ---------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, tree, step: int, extra: Optional[Dict] = None,
             block: bool = False) -> None:
        self.wait()                                  # one in-flight save max
        snap = snapshot(tree)

        def _do():
            try:
                C.save(snap, self.dir, step=step, extra=extra)
                self._gc()
            except Exception:                        # pragma: no cover
                self._failures += 1

        if self.async_save and not block:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()

    def save_sharded(self, tree, shardings, step: int, extra: Optional[Dict] = None) -> None:
        """Save a plan-sharded tree in the reference's format, fully gathered:
        every rank calls this (each leaf is gathered over the ranks that
        split it, one leaf at a time), rank 0 writes, and every rank returns
        once the checkpoint is published.  ``shardings`` is the matching
        tree of ``parallel.sharding.Sharding`` (None: the leaf is whole)."""
        import torch.distributed as dist
        from repro_torch.parallel import spmd
        sh_by_key = dict(C._flatten_with_paths(shardings,
                                               is_leaf=is_sharding_leaf))
        rank = dist.get_rank() if dist.is_initialized() else 0

        def gathered(key, x):
            sh = sh_by_key.get(key)
            if sh is None or not isinstance(x, torch.Tensor):
                return x
            full = tuple(n * k for n, k in zip(x.shape, sh.shard_counts(x.dim())))
            out = spmd.gather_blocks(x, sh.mesh, sh.spec, full, sh.mesh_axes())
            return out.detach().to("cpu", copy=True) if rank == 0 else None

        flat = C._flatten_with_paths(tree)
        host = [gathered(key, x) for key, x in flat]
        if rank == 0:
            self.save(C._rebuild(tree, iter(host)), step, extra, block=True)
        if dist.is_initialized():
            dist.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = C.list_steps(self.dir)
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore_latest(self, target_tree=None, shardings=None, device="cuda"):
        """(tree, step) from the newest checkpoint, or (None, 0).  A real
        tensor in ``target_tree`` is restored in place, a ``meta`` one on
        ``device`` (:func:`checkpoint.restore`)."""
        self.wait()
        path = C.latest(self.dir)
        if path is None:
            return None, 0
        tree, manifest = C.restore(path, target_tree, shardings, device=device)
        return tree, int(manifest["step"])

"""Sharded checkpointing (torch + numpy).

Counterpart of ``repro/ckpt/checkpoint.py``, with its on-disk format byte
for byte, so that a checkpoint crosses between the two packages both ways.
One directory per step containing

* ``manifest.json``   — format version, step, save wall-time, ``extra``, and
                        per leaf its shape, dtype name, shard and npz key;
* ``shard_<k>.npz``   — leaf arrays, chunked so no single file exceeds
                        ``max_shard_bytes`` (object-store friendly).

Leaf keys are the reference's: the path of each leaf joined by ``/``, with
dict keys in sorted order, a NamedTuple's field names (``AdamWState``'s
``step``, ``mu``, ``nu``), a sequence's indices, and a dataclass's field
indices (``TrainState`` is ``0``, ``1``, ``2``, as the reference registers
it); ``None`` holds no leaf.  A bfloat16 leaf is stored as the reference's
numpy writes it, 2-byte records (``<V2``) with ``"dtype": "bfloat16"`` in
the manifest, and restored as ``torch.bfloat16`` from that name (the
reference's own ``restore`` cannot place such a leaf; ROADMAP.md Queue 3).

Durability: writes go to ``.tmp_step_*`` and are atomically renamed — a
crash mid-save never corrupts the latest checkpoint (the restore path simply
sees the previous step).  The leaves are saved fully gathered: a sharded
state is gathered to rank 0, which writes (``CheckpointManager.save_sharded``).

Restoring into a target tree checks every leaf's presence and shape before
any data is read, then reads one shard at a time: a leaf whose target is a
real tensor is copied into it in place (the train state on the card stays
where it is, with no second copy beside it), a ``meta`` target is allocated
on the device the caller names.  With ``shardings`` each rank keeps its
slice of every stored leaf (the elastic-rescale path: the mesh at restore
time may differ from the mesh at save time).
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import time
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.sharding import is_sharding_leaf

FORMAT_VERSION = 2
BF16_DESCR = "<V2"          # what numpy writes for the reference's bfloat16 arrays
_CHUNK = 16 << 20           # bytes a write hands to the zip stream at a time


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """``(key, child)`` pairs of a container in the reference's flattening
    order, or None for a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(str(i), getattr(tree, f.name)) for i, f in enumerate(dataclasses.fields(tree))]
    return None


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = (),
                        is_leaf: Optional[Callable] = None) -> List[Tuple[str, Any]]:
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    out = []
    for key, child in kids:
        out.extend(_flatten_with_paths(child, prefix + (key,), is_leaf))
    return out


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves taken from ``leaves`` in
    flattening order."""
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if tree is None:
        return None
    new = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(tree, dict):
        by_key = dict(zip(sorted(tree), new))
        return {k: by_key[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*new)
    if isinstance(tree, (list, tuple)):
        return type(tree)(new)
    return dataclasses.replace(tree, **{f.name: v for f, v in
                                        zip(dataclasses.fields(tree), new)})


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in flattening order."""
    return [leaf for _, leaf in _flatten_with_paths(tree)]


def map_leaves(fn: Callable, tree):
    """``fn`` applied to every leaf of ``tree``, structure kept."""
    return _rebuild(tree, iter([fn(leaf) for leaf in leaves(tree)]))


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """``leaf`` on the host as a contiguous numpy array (a bfloat16 tensor
    as its int16 bits) and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(leaf)
    return arr, str(arr.dtype)


def _write_npy(f, arr: np.ndarray, dtype: str) -> None:
    """``arr`` as one ``.npy`` member: the header ``np.save`` writes (the
    reference's ``<V2`` for bfloat16), then the data in chunks."""
    descr = BF16_DESCR if dtype == "bfloat16" else np.lib.format.dtype_to_descr(arr.dtype)
    np.lib.format.write_array_header_1_0(
        f, {"descr": descr, "fortran_order": False, "shape": arr.shape})
    flat = arr.reshape(-1)
    step = max(_CHUNK // max(arr.itemsize, 1), 1)
    for i in range(0, flat.size, step):
        f.write(flat[i:i + step])


def _write_npz(path: Path, arrays: Dict[str, Tuple[np.ndarray, str]]) -> None:
    """The zip ``np.savez`` writes: stored, zip64, one ``<key>.npy`` each."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                _write_npy(f, arr, dtype)


def _host_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded array as a CPU tensor of the dtype the manifest names."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(tree, directory: str | Path, *, step: int,
         extra: Optional[Dict] = None,
         max_shard_bytes: int = 2 << 30) -> Path:
    """Atomically save a tree of tensors.  Returns the final directory.
    Leaves on the device are copied to the host one at a time."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest: Dict[str, Any] = {
        "format": FORMAT_VERSION, "step": step,
        "saved_at": time.time(), "extra": extra or {},
        "leaves": {}, "shards": [],
    }
    shard: Dict[str, Tuple[np.ndarray, str]] = {}
    shard_bytes = 0
    shard_idx = 0

    def flush():
        nonlocal shard, shard_bytes, shard_idx
        if not shard:
            return
        name = f"shard_{shard_idx:05d}.npz"
        _write_npz(tmp / name, shard)
        manifest["shards"].append(name)
        shard = {}
        shard_bytes = 0
        shard_idx += 1

    for key, leaf in _flatten_with_paths(tree):
        arr, dtype = _host_array(leaf)
        # npz keys cannot contain '/', escape deterministically
        safe = key.replace("/", "__")
        manifest["leaves"][key] = {
            "shape": list(arr.shape), "dtype": dtype,
            "shard": shard_idx, "npz_key": safe,
        }
        shard[safe] = (arr, dtype)
        shard_bytes += arr.nbytes
        if shard_bytes >= max_shard_bytes:
            flush()
    flush()
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish
    return final


def load_manifest(ckpt_dir: str | Path) -> Dict:
    return json.loads((Path(ckpt_dir) / "manifest.json").read_text())


def restore(ckpt_dir: str | Path, target_tree=None, shardings=None, *,
            device="cuda") -> Tuple[Any, Dict]:
    """Restore a tree.  Without ``target_tree``: ``{key: CPU tensor}`` and
    the manifest.  With it, the stored leaves are mapped back into that
    structure: a real tensor in the target is overwritten in place
    (``copy_``) and returned, a ``meta`` tensor (or any other leaf) becomes
    a tensor of the stored dtype on ``device``.  Every leaf's presence and
    shape are checked before any data is read.

    With ``shardings`` (a tree of ``parallel.sharding.Sharding`` matching
    ``target_tree``; a None entry keeps its leaf whole) every rank reads each
    fully gathered stored leaf and keeps its slice: a target leaf may have
    the stored shape or the slice's, and a real target of the slice's shape
    is filled in place."""
    ckpt_dir = Path(ckpt_dir)
    manifest = load_manifest(ckpt_dir)
    stored = manifest["leaves"]
    by_path = {} if shardings is None else dict(_flatten_with_paths(
        shardings, is_leaf=is_sharding_leaf))

    if target_tree is None:
        flat: List[Tuple[str, Any]] = [(key, None) for key in stored]
    else:
        flat = _flatten_with_paths(target_tree)
        for key, leaf in flat:
            if key not in stored:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            have = tuple(stored[key]["shape"])
            want_shape = tuple(getattr(leaf, "shape", have))
            sh = by_path.get(key)
            if have != want_shape and (sh is None or sh.local_shape(have) != want_shape):
                raise ValueError(f"{key}: checkpoint shape {have} != "
                                 f"target {want_shape}")

    by_shard: Dict[int, List[int]] = {}
    for i, (key, _) in enumerate(flat):
        by_shard.setdefault(stored[key]["shard"], []).append(i)
    placed: List[Any] = [None] * len(flat)
    for shard, idxs in sorted(by_shard.items()):
        with np.load(ckpt_dir / manifest["shards"][shard]) as z:
            for i in idxs:
                key, leaf = flat[i]
                meta = stored[key]
                host = _host_tensor(z[meta["npz_key"]], meta["dtype"])
                if key in by_path and by_path[key] is not None:
                    host = by_path[key].local(host)
                placed[i] = host if target_tree is None else _place(leaf, host, device)
    if target_tree is None:
        return {key: t for (key, _), t in zip(flat, placed)}, manifest
    return _rebuild(target_tree, iter(placed)), manifest


def _place(target, host: torch.Tensor, device) -> torch.Tensor:
    if isinstance(target, torch.Tensor) and target.device.type != "meta" \
            and target.shape == host.shape:
        with torch.no_grad():
            target.copy_(host)
        return target
    return host.contiguous().to(device)


def list_steps(directory: str | Path) -> List[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_"):
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def latest(directory: str | Path) -> Optional[Path]:
    steps = list_steps(directory)
    if not steps:
        return None
    return Path(directory) / f"step_{steps[-1]:08d}"

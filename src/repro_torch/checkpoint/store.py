"""Atomic, checksummed, keep-last-k checkpoints of tensor trees
(counterpart of ``repro.checkpoint.store``), in the reference's format,
so that a checkpoint written by either package restores in the other:

  * step-atomic: writes go to ``step_XXXXXXXX.tmp``, renamed to
    ``step_XXXXXXXX`` only after the manifest is written and fsynced —
    a killed writer never corrupts the latest checkpoint;
  * one ``.npy`` file per leaf, keyed in the manifest by the leaf's
    path (``params/units/layers/0/attn/wq``), with its shape, dtype and
    the adler32 checksum of its bytes; leaves are numbered in the
    reference's order (dict keys sorted, sequences by index);
  * bf16 leaves are written as their raw 2-byte patterns (numpy dtype
    ``V2``, manifest dtype ``bfloat16``), which is how numpy writes the
    reference's ``ml_dtypes`` arrays, and read back through an int16
    view, bit-exactly;
  * the manifest also holds user metadata (step, data state);
  * keep-last-k garbage collection.

A leaf placed on a mesh (``models.shardings.ShardedTensor``) is written
as its global array, as the reference writes a sharded ``jax.Array``.
``restore`` takes, in place of the reference's shardings, a target per
leaf: a memory kind (``device``, ``pinned_host``, ``unpinned_host``) of
an engine on ``device``, a torch device, or a
``models.shardings.NamedSharding`` (a spec on a mesh), which re-shards
the global array onto that mesh whatever mesh wrote it (elastic).
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.interleave import _path_part
from ..core.tiered_array import (DeviceLike, LOGICAL_KINDS, resolve_device,
                                 to_kind)
from ..models.shardings import NamedSharding, ShardedTensor


def _leaf_key(path) -> str:
    return "/".join(str(_path_part(p)) for p in path)


def _adler32(arr: np.ndarray) -> int:
    return zlib.adler32(np.ascontiguousarray(arr).reshape(-1).view(
        np.uint8)) & 0xFFFFFFFF


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array and its manifest dtype name."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.full()
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.kind == "V":
        # the raw patterns of a dtype numpy does not know
        if dtype != "bfloat16":
            raise TypeError(f"cannot read a leaf of dtype {dtype!r}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str | Path, step: int, tree: Any,
         metadata: Optional[Dict] = None, keep_last: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat, spec = pytree.tree_flatten_with_path(tree)
    flat.sort(key=lambda pl: tuple(_path_part(p) for p in pl[0]))
    manifest = {"step": step, "metadata": metadata or {},
                "treedef": str(spec), "leaves": {}}
    for i, (path, leaf) in enumerate(flat):
        arr, dtype = _to_numpy(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(tmp / fn, arr)
        manifest["leaves"][_leaf_key(path)] = {
            "file": fn, "index": i, "shape": list(arr.shape),
            "dtype": dtype, "adler32": _adler32(arr),
        }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit

    # GC old checkpoints
    steps = sorted(p for p in ckpt_dir.glob("step_????????")
                   if p.is_dir())
    for old in steps[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(ckpt_dir.glob("step_????????"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def _destination(t: torch.Tensor, target, leaf, device: DeviceLike
                 ) -> torch.Tensor:
    """``t`` (CPU) moved to its target: a memory kind of an engine on
    ``device``, a torch device, a ``NamedSharding``, or (None) the
    target leaf's own placement: its mesh and spec where it is placed,
    else its device (``device`` where that leaf has no storage)."""
    if target is None and isinstance(leaf, ShardedTensor):
        target = NamedSharding(leaf.mesh, leaf.spec)
    if isinstance(target, NamedSharding):
        return target.place(t)
    if isinstance(target, str) and target in LOGICAL_KINDS:
        return to_kind(t, target, resolve_device(device))
    if target is None:
        dev = getattr(leaf, "device", None)
        target = dev if dev is not None and dev.type != "meta" \
            else resolve_device(device)
    return t.to(torch.device(target))


def restore(ckpt_dir: str | Path, target_tree: Any,
            step: Optional[int] = None, placement: Any = None,
            device: DeviceLike = None, verify: bool = True
            ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree`` (shapes must match;
    its leaves may be ``meta`` tensors).  Returns (tree, metadata).

    ``placement``: one target for every leaf, or a tree of the target's
    structure holding one per leaf (None for the default).  A target is
    a memory kind of an engine on ``device`` (CUDA unless ``"cpu"``), a
    torch device, or a ``NamedSharding`` (elastic re-shard onto its
    mesh); by default a leaf lands where the target leaf is placed."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())

    flat, spec = pytree.tree_flatten_with_path(target_tree)
    if placement is None or isinstance(placement, (str, torch.device,
                                                   NamedSharding)):
        targets = [placement] * len(flat)
    else:
        targets = spec.flatten_up_to(placement)
    leaves = []
    for (path, leaf), target in zip(flat, targets):
        key = _leaf_key(path)
        ent = manifest["leaves"].get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(d / ent["file"])
        if verify and _adler32(arr) != ent["adler32"]:
            raise IOError(f"checksum mismatch for {key!r}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key!r}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        leaves.append(_destination(_to_tensor(arr, ent["dtype"]), target,
                                   leaf, device))
    return pytree.tree_unflatten(leaves, spec), manifest["metadata"]

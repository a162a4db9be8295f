"""Dependency-free checkpointing of nested dicts of tensors and arrays: one
``leaves.npz`` plus a ``manifest.json`` holding the key paths, shapes and
dtypes — the reference's layout (``repro.train.checkpoint``), so a
snapshot either package writes loads through the other.

A leaf is named by its ``/``-joined key path (``stats/age``), dict keys in
sorted order and sequence items by index, as ``jax.tree_util`` flattens a
tree. A bfloat16 leaf is stored widened to float32 (numpy has no bf16;
the widening is lossless) and cast back to the template's dtype on load.

Writes are ATOMIC: every file lands under a temporary name and is
``os.replace``d into place, the manifest LAST — readers take its presence
as the commit marker, so a writer killed mid-snapshot leaves the previous
complete snapshot or no manifest at all, never a torn one.
``write_latest``/``latest_checkpoint`` keep the ``LATEST`` pointer a
directory of ``round_*`` snapshots resolves through, falling back to the
newest complete snapshot when the pointer is stale.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array numpy can save (bf16 widened to f32)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or "bfloat16" in str(arr.dtype):
        arr = arr.astype(np.float32)
    return arr


def _atomic_savez(path: str, **arrays) -> None:
    """``np.savez`` through a temporary file and ``os.replace`` (one
    directory, so the rename is atomic on POSIX); an open file keeps savez
    from appending ``.npz`` to the temporary name."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _atomic_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    extra: dict = None) -> None:
    """Write ``tree`` (nested dicts and sequences of tensors or arrays)
    to the snapshot directory ``path``; ``extra`` (JSON) rides in the
    manifest."""
    os.makedirs(path, exist_ok=True)
    leaves: Dict[str, np.ndarray] = {name: _host(leaf)
                                     for name, leaf in _leaves(tree)}
    _atomic_savez(os.path.join(path, "leaves.npz"), **leaves)
    manifest = {
        "step": step,
        "keys": sorted(leaves.keys()),
        "dtypes": {k: str(v.dtype) for k, v in leaves.items()},
        "shapes": {k: list(v.shape) for k, v in leaves.items()},
        "extra": extra or {},
    }
    # the manifest commits the snapshot: written last, atomically
    _atomic_json(os.path.join(path, "manifest.json"), manifest)


def _restore(tree, loaded, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _restore(tree[k], loaded, f"{prefix}{k}/")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(v, loaded, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    name = prefix[:-1]
    arr = loaded[name]
    if tuple(arr.shape) != tuple(tree.shape):
        raise ValueError(f"checkpoint leaf {name!r} is {tuple(arr.shape)}; "
                         f"the template's is {tuple(tree.shape)}")
    if isinstance(tree, torch.Tensor):
        return torch.as_tensor(arr).to(dtype=tree.dtype, device=tree.device)
    return arr.astype(np.asarray(tree).dtype)


def load_checkpoint(path: str, template: Any):
    """The snapshot at ``path`` in the structure, dtypes and devices of
    ``template`` (its leaf names must match the snapshot's)."""
    with np.load(os.path.join(path, "leaves.npz")) as data:
        loaded = {k: data[k] for k in data.files}
    return _restore(template, loaded)


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["step"]


def checkpoint_extra(path: str) -> dict:
    """The ``extra`` dict of a snapshot's manifest."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("extra", {})


def is_checkpoint(path: str) -> bool:
    """A directory is a complete snapshot iff its manifest committed."""
    return os.path.isfile(os.path.join(path, "manifest.json"))


def write_latest(directory: str, name: str) -> None:
    """Atomically point ``directory/LATEST`` at the snapshot ``name``."""
    tmp = os.path.join(directory, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(name + "\n")
    os.replace(tmp, os.path.join(directory, "LATEST"))


def latest_checkpoint(directory: str) -> str:
    """Resolve a checkpoint reference: ``directory`` is a snapshot itself,
    or a parent of ``round_*`` snapshots resolved through its ``LATEST``
    pointer, else the newest COMPLETE snapshot (its manifest committed)."""
    if is_checkpoint(directory):
        return directory
    pointer = os.path.join(directory, "LATEST")
    if os.path.isfile(pointer):
        with open(pointer) as f:
            cand = os.path.join(directory, f.read().strip())
        if is_checkpoint(cand):
            return cand
    if os.path.isdir(directory):
        for name in sorted(os.listdir(directory), reverse=True):
            if name.startswith("round_") and not name.endswith(".tmp"):
                cand = os.path.join(directory, name)
                if is_checkpoint(cand):
                    return cand
    raise FileNotFoundError(
        f"no complete checkpoint found under {directory!r}")

"""Checkpoints as plain ``.npz`` archives (port of
``repro/runtime/checkpoint.py``).

Arrays are stored under the reference's key paths (``params/conv0``,
``ef/s0b0_conv1``, ``mom/w0``: dict keys joined by "/"), with the JSON
metadata embedded in the same archive under ``__meta_json__``, so a
checkpoint written by the JAX package loads into the port and back.
Writes go to a hidden temporary file, are fsynced and renamed into place;
an unreadable checkpoint raises ``CheckpointError``.
"""
from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

META_KEY = "__meta_json__"


class CheckpointError(RuntimeError):
    """The checkpoint file is unreadable (torn write or corruption)."""


def _flatten(tree, prefix=""):
    """Nested dicts of tensors -> [(key path, leaf)], keys sorted as
    jax.tree_util orders dict keys."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(_flatten(v, key + "/"))
        else:
            out.append((key, v))
    return out


def _atomic_write(path: Path, write_fn) -> None:
    """write_fn(tmp_path); then fsync and rename into place."""
    tmp = path.parent / f".{path.name}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        with open(tmp, "rb+") as f:
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def save_pytree(path: Path, tree: Any, meta: Optional[Dict] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for key, leaf in _flatten(tree):
        if key == META_KEY:
            raise ValueError(f"tree key collides with {META_KEY!r}")
        arrays[key] = leaf.detach().cpu().numpy()
    if meta is not None:
        arrays[META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)

    def _write_npz(tmp):
        with open(tmp, "wb") as f:  # a handle: np.savez would add ".npz"
            np.savez(f, **arrays)
    _atomic_write(path, _write_npz)
    if meta is not None:  # human-readable sidecar (not authoritative)
        _atomic_write(path.with_suffix(".meta.json"),
                      lambda tmp: tmp.write_text(json.dumps(meta, indent=1)))


def load_pytree(path: Path, template: Any) -> Tuple[Any, Optional[Dict]]:
    """Restore into the structure of ``template`` (nested dicts of
    tensors): shapes are checked, each array takes its template leaf's
    dtype and device."""
    path = Path(path)
    meta = None
    out: Dict = {}
    try:
        with np.load(path) as data:
            for key, leaf in _flatten(template):
                if key not in data:
                    raise CheckpointError(
                        f"{path}: missing array {key!r} (torn or "
                        f"incompatible checkpoint)")
                arr = data[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise CheckpointError(
                        f"{path}: array {key!r} has shape {arr.shape}, "
                        f"expected {tuple(leaf.shape)}")
                node = out
                *parents, name = key.split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                    device=leaf.device, dtype=leaf.dtype)
            if META_KEY in data:
                meta = json.loads(bytes(data[META_KEY]).decode())
    except CheckpointError:
        raise
    except (zipfile.BadZipFile, ValueError, OSError, EOFError,
            KeyError) as e:
        raise CheckpointError(f"{path}: unreadable checkpoint ({e})") from e
    if meta is None:  # checkpoints without the embedded meta: the sidecar
        meta_path = path.with_suffix(".meta.json")
        meta = (json.loads(meta_path.read_text())
                if meta_path.exists() else None)
    return out, meta

"""Checkpoints as plain ``.npz`` archives (port of
``repro/runtime/checkpoint.py``).

Arrays are stored under the reference's key paths (``params/conv0``,
``ef/s0b0_conv1``, ``mom/w0``: dict keys joined by "/"), with the JSON
metadata embedded in the same archive under ``__meta_json__``, so a
checkpoint written by the JAX package loads into the port and back.
Writes go to a hidden temporary file, are fsynced and renamed into place;
an unreadable checkpoint raises ``CheckpointError``.

numpy has no bfloat16: a bf16 leaf is written as its 16-bit patterns in
the two-byte void type, the layout ``np.savez`` gives the reference's
ml_dtypes bfloat16 arrays (the header's ``|V2`` where ml_dtypes writes
``<V2``; both load as ``V2``), and a ``V2`` or ``uint16`` array loads
into a bf16 template leaf bit for bit.
"""
from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten

META_KEY = "__meta_json__"


class CheckpointError(RuntimeError):
    """The checkpoint file is unreadable (torn write or corruption)."""


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


_BITS_OF_BF16 = (np.dtype("V2"), np.dtype(np.uint16))


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the archive stores: bf16 as ``|V2`` patterns."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
    return leaf.numpy()


def _to_leaf(arr: np.ndarray, leaf) -> torch.Tensor:
    """An archived array as a tensor of ``leaf``'s type and device; 16-bit
    patterns into a bf16 leaf as they are."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # 0-d stays 0-d
    if leaf.dtype == torch.bfloat16 and arr.dtype in _BITS_OF_BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=leaf.device, dtype=leaf.dtype)


def save_pytree(path: Path, tree: Any, meta: Optional[Dict] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for key, leaf in flatten(tree).items():
        if key == META_KEY:
            raise ValueError(f"tree key collides with {META_KEY!r}")
        arrays[key] = _to_numpy(leaf)
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
            for key, leaf in flatten(template).items():
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
                node[name] = _to_leaf(arr, leaf)
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


def latest_checkpoint(ckpt_dir: Path, prefix: str = "ckpt_"
                      ) -> Optional[Path]:
    """The last ``{prefix}*.npz`` of ``ckpt_dir`` in name order, never a
    torn temporary file (None if there is none)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    cands = sorted(p for p in ckpt_dir.glob(f"{prefix}*.npz")
                   if ".tmp" not in p.name)
    return cands[-1] if cands else None

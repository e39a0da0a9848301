"""The paper's compression operator Q on stacked-replica parameter dicts
(port of ``repro/core/compression.py``, its plain branch).

Each leaf of the per-replica delta (R, *shape) is flattened to (R, L),
padded with zeros to a multiple of the block, compressed with the
block-local top-k kernel with fused error feedback (``ops.topk_compress``:
the CUDA kernel for CUDA tensors, its plain version on the CPU) and
unpadded.  The reference's per-shard ``shard_map`` branch waits for the
multi-GPU slice (ROADMAP.md, multi-GPU mesh path).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def _compress_flat(flat, theta, block, ef=None):
    """flat, ef: (R, L); theta: (R,) float32.  The pad goes through the
    kernel like any other data and is sliced off after it (:32)."""
    L = flat.shape[1]
    pad = (-L) % block
    if pad:
        flat = F.pad(flat, (0, pad))
        if ef is not None:
            ef = F.pad(ef, (0, pad))
    masked, resid = ops.topk_compress(flat, theta, block=block, ef=ef)
    return masked[:, :L], resid[:, :L]


def _leaf(d, e, theta, block, error_feedback):
    R = d.shape[0]
    flat = d.reshape(R, -1)
    ef = e.reshape(R, -1) if error_feedback and e is not None else None
    masked, resid = _compress_flat(flat, theta, block, ef=ef)
    return (masked.reshape(d.shape).to(d.dtype),
            resid.reshape(d.shape).to(e.dtype if e is not None
                                      else d.dtype))


def compress_delta(delta: Dict[str, torch.Tensor],
                   ef: Optional[Dict[str, torch.Tensor]], theta, *,
                   block: int = 1024,
                   error_feedback: bool = True) -> Tuple[Dict, Dict]:
    """delta, ef: dicts of (R, *shape) tensors; theta: (R,) float32 tensor.

    Returns (compressed, new_ef) with compressed + new_ef == delta + ef,
    exact in f32.  As in the reference, the residual is returned as the new
    EF buffer even with ``error_feedback=False`` (then ef is not added)."""
    comp, new_ef = {}, {}
    for name, d in delta.items():
        comp[name], new_ef[name] = _leaf(
            d, None if ef is None else ef[name], theta, block,
            error_feedback)
    return comp, new_ef


def quantize_theta(theta, levels):
    """Round each theta UP to the nearest level (:117).  A theta above the
    largest level raises: rounding down would ship fewer coordinates than
    Q kept.  numpy in, float32 numpy out."""
    lv = np.sort(np.unique(np.asarray(levels, np.float64)))
    th = np.asarray(theta, np.float64)
    if np.any(th > lv[-1] + 1e-9):
        raise ValueError(
            f"theta {float(np.max(th))} above the largest level "
            f"{float(lv[-1])}: the theta_levels grid must cover every "
            f"theta the controller can emit (rounding DOWN would ship "
            f"fewer coordinates than Q kept)")
    idx = np.minimum(np.searchsorted(lv, th, side="left"), len(lv) - 1)
    return lv[idx].astype(np.float32)


def cluster_levels_from_theta(theta, levels, cluster_of):
    """Per-cluster wire levels (:139): each device's theta quantized up to
    the grid, then the max over the cluster's members, as exact grid
    floats."""
    q = quantize_theta(theta, levels)
    lv = np.sort(np.unique(np.asarray(levels, np.float64)))
    cl = np.asarray(cluster_of)
    out = []
    for c in range(int(cl.max()) + 1):
        m = np.max(q[cl == c])
        out.append(float(lv[int(np.argmin(np.abs(lv - m)))]))
    return tuple(out)

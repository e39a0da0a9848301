"""The paper's compression operator Q on stacked-replica parameter dicts
(port of ``repro/core/compression.py``).

Each leaf of the per-replica delta (R, *shape) is flattened to (R, L),
and all of them are compressed together with the block-local top-k kernel
with fused error feedback (``ops.topk_compress_leaves``: on the card one
launch per (delta type, EF type) pair of the leaves, its plain version on
the CPU), the compressed delta written over the delta and the residual
over the EF buffer.  A leaf whose L is not a multiple of the block is
compressed as if zero-padded to it, as the reference pads it.

The reference's per-shard branch (``compress_delta(mesh=, specs=)``,
:86-105: a ``shard_map`` a leaf, each device compressing the blocks of
its own shard's (R_local, -1) flattening) is this function given a
rank's storage slabs (``convert.shard_slabs``: its R_local rows and its
1 / n of each leaf's ``Policy.leaf_split`` dim, contiguous in the
shard-local layout): the slab's flattening is the shard's, padded to the
block where the shard's is.  Where the split leaves runs of whole blocks
(the reference's ``block_align``), the blocks are the unsharded leaf's;
elsewhere the partition shifts, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


def compress_delta(delta: Dict[str, torch.Tensor],
                   ef: Dict[str, torch.Tensor], theta, *,
                   block: int = 1024, error_feedback: bool = True,
                   impl=None) -> Tuple[Dict, Dict]:
    """delta, ef: dicts of contiguous (R, *shape) tensors; theta: (R,)
    float32 tensor.

    Writes the compressed delta over ``delta`` and the residual over
    ``ef``, and returns them as (compressed, new_ef): compressed + new_ef
    == delta + ef, exact in f32.  As in the reference, the residual is the
    new EF buffer even with ``error_feedback=False`` (then ef is not
    added).  ef holds delta's type, or float32 with error feedback on; the
    round step's memory at full width has no room for a second copy of
    either.  ``impl`` routes the top-k (``ops.topk_compress_leaves``)."""
    flat = [d.view(d.shape[0], -1) for d in delta.values()]
    res = [ef[name].view(d.shape[0], -1) for name, d in delta.items()]
    ops.topk_compress_leaves(flat, theta, block=block,
                             efs=res if error_feedback else None,
                             outs=list(zip(flat, res)), impl=impl)
    return delta, ef


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

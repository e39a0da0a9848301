"""Where the round step's aggregation runs (port of
``repro/dist/policies.py:make_train_policy``).

A training policy places the stacked replica dim R on a ``RankMesh``: its
``replica_axes`` are the data axes R is split over, contiguously (R_local
= R / their size a rank), and ``policy is not None`` selects the fused
branch of the round step: each leaf is compressed in place, added to the
round's start, reduced to its cluster means (``mix_local`` over the
replica axes), and on gossip rounds mixed through the sparse wire.  A
1-rank mesh holds all R replicas in one process.

A "model" axis of n > 1 ranks splits every stacked (R, *shape) leaf of
the state on one more dim (``leaf_split``, the reference's ``_leaf_spec``
with ``stacked=True``, policies.py:64-86): the LAST dim i >= 1 whose
per-shard run (shape[i] / n) * prod(shape[i + 1:]) is a multiple of
``BLOCK_ALIGN`` (the top-k block), else the last dim n divides, else
none.  A rank's slab of a leaf (its storage) is its R_local rows and its
1 / n of that dim, contiguous (``convert.shard_slabs``), so that Q's
shard-local (R_local, -1) flattening is the reference's.  Where the run is
aligned, the shard's blocks are the unsharded leaf's; elsewhere (smollm's
norms) the block partition shifts, as in the reference.  How the model
computes on that axis is the model's (its module's ``tensor_dims``): the
dense decoder with internvl2-2b's ViT stub and seamless-m4t's encoder
and cross-attention (``models/lm.py``), mamba2 (``models/mamba2.py``)
and griffin (``models/griffin.py``) run on it here, and so do the
overlap engine, the population store and chaos masks;
``check_model_axis`` names what does not: MoE (ROADMAP.md item 5.3, with
its sequence-sharded routing blocks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import FLTopology
from repro_torch.dist.collectives import MULTI_RANK
from repro_torch.dist.mesh import RankMesh


# the run a shard's leaf should span a whole number of: the reference
# policy's ``block_align``, the top-k block it is built for (1024; no
# caller sets another)
BLOCK_ALIGN = 1024


@dataclass(frozen=True)
class Policy:
    """``replicas`` FL devices on ``mesh``, R split over ``replica_axes``
    (() : every rank holds all of them); ``tensor_axes`` the model axes,
    over which each stacked leaf splits on its ``leaf_split`` dim."""

    mesh: RankMesh
    replicas: int
    replica_axes: Tuple[str, ...] = ()
    tensor_axes: Tuple[str, ...] = ()

    @property
    def model(self) -> int:
        """Ranks of the tensor axes."""
        return self.mesh.size(self.tensor_axes)

    @property
    def model_index(self) -> int:
        """This rank's flat index over the tensor axes."""
        return self.mesh.flat_index(self.tensor_axes)

    def leaf_split(self, shape) -> Optional[int]:
        """The dim of a stacked (R, *shape) leaf the tensor axes split
        (None: every model rank holds it whole)."""
        return leaf_split(shape, self.model)

    def storage_dims(self, tree):
        """``leaf_split`` of every stacked leaf of ``tree`` (nested dicts of
        tensors or shapes), the same dicts of dims (the reference's
        ``param_shardings(tree, stacked=True)``, :88-97)."""
        if isinstance(tree, dict):
            return {k: self.storage_dims(v) for k, v in tree.items()}
        return self.leaf_split(tuple(getattr(tree, "shape", tree)))

    @property
    def ranks(self) -> int:
        """Ranks the replica dim is split over."""
        return self.mesh.size(self.replica_axes)

    @property
    def local_replicas(self) -> int:
        return self.replicas // self.ranks

    @property
    def first_replica(self) -> int:
        """This rank's first row of the stacked replica dim."""
        return self.mesh.flat_index(self.replica_axes) * self.local_replicas


def leaf_split(shape, n: int) -> Optional[int]:
    """The reference's ``_leaf_spec(shape, stacked=True)`` model dim over
    ``n`` ranks: the last dim i >= 1 that n divides (shape[i] >= n) whose
    per-shard run (shape[i] / n) * prod(shape[i + 1:]) is a multiple of
    BLOCK_ALIGN, else the last dim n divides; None where none does or n
    is 1."""
    if n <= 1:
        return None
    shape = tuple(int(s) for s in shape)
    divisible = [i for i in range(1, len(shape))
                 if shape[i] % n == 0 and shape[i] >= n]
    aligned = [i for i in divisible
               if (shape[i] // n) * int(np.prod(shape[i + 1:], initial=1))
               % BLOCK_ALIGN == 0]
    if aligned:
        return aligned[-1]
    return divisible[-1] if divisible else None


def model_axis_refusal(cfg, n: int) -> Optional[str]:
    """Why a model axis of ``n`` ranks cannot run ``cfg``, naming
    ROADMAP.md item 5.3; None where it can (n of 1, or a config without
    experts: every other family's model module has its ``tensor_dims``)."""
    if n <= 1:
        return None
    where = f"a model axis of {n} ranks"
    if cfg.num_experts:
        return (f"{cfg.name} ({cfg.family}, {cfg.num_experts} experts) on "
                f"{where}: MoE on the tensor axis goes with item 5.3's "
                f"sequence-sharded routing blocks (the reference routes in "
                f"one block a model rank there) and is not ported yet: "
                f"{MULTI_RANK}")
    return None


def check_model_axis(policy, cfg):
    """Raises NotImplementedError with ``model_axis_refusal``'s reason
    where the policy's model axis cannot run ``cfg``."""
    why = model_axis_refusal(cfg, 1 if policy is None else policy.model)
    if why is not None:
        raise NotImplementedError(why)


def make_train_policy(mesh, topo: FLTopology = None, *, dp_axes=None
                      ) -> Policy:
    """The training policy: R over ``dp_axes`` of ``mesh``, tensor over
    "model" (reference :151).  R must tile the data axes; an ``inner_dp``
    topology whose R * inner_dp fills them keeps the replica dim
    replicated on every rank; anything else raises here.

    ``make_train_policy(topo)``: all R in this process, the policy of a
    1-rank ("data", "model") mesh."""
    if isinstance(mesh, FLTopology):
        if topo is not None or dp_axes is not None:
            raise TypeError("make_train_policy(topo) takes no mesh "
                            "arguments")
        mesh, topo, dp_axes = RankMesh((1, 1), ("data", "model")), mesh, \
            ("data",)
    if dp_axes is None:
        raise TypeError("make_train_policy(mesh, topo) needs dp_axes=")
    dp = tuple(dp_axes)
    dp_size = mesh.size(dp)
    R = topo.num_devices
    if dp and R > 1 and R % dp_size != 0:
        if R * topo.inner_dp == dp_size:
            dp = ()  # replicated replica dim (inner_dp consumes the slots)
        else:
            raise ValueError(
                f"R={R} FL replicas do not tile dp axes {dp} of size "
                f"{dp_size} (inner_dp={topo.inner_dp})")
    tensor = ("model",) if "model" in mesh.axis_names else ()
    return Policy(mesh=mesh, replicas=R, replica_axes=dp,
                  tensor_axes=tensor)

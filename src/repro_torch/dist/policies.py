"""Where the round step's aggregation runs (port of
``repro/dist/policies.py:make_train_policy``).

A training policy places the stacked replica dim R on a ``RankMesh``: its
``replica_axes`` are the data axes R is split over, contiguously (R_local
= R / their size a rank), and ``policy is not None`` selects the fused
branch of the round step: each leaf is compressed in place, added to the
round's start, reduced to its cluster means (``mix_local`` over the
replica axes), and on gossip rounds mixed through the sparse wire.  A
1-rank mesh holds all R replicas in one process.  The tensor ("model")
axis larger than 1 raises and names what is left of ROADMAP.md item 5.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import FLTopology
from repro_torch.dist.collectives import MULTI_RANK
from repro_torch.dist.mesh import RankMesh


@dataclass(frozen=True)
class Policy:
    """``replicas`` FL devices on ``mesh``, R split over ``replica_axes``
    (() : every rank holds all of them); ``tensor_axes`` the model axes
    (of size 1)."""

    mesh: RankMesh
    replicas: int
    replica_axes: Tuple[str, ...] = ()
    tensor_axes: Tuple[str, ...] = ()

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


def make_train_policy(mesh, topo: FLTopology = None, *, dp_axes=None
                      ) -> Policy:
    """The training policy: R over ``dp_axes`` of ``mesh``, tensor over
    "model" (reference :149).  R must tile the data axes; an ``inner_dp``
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
    if mesh.size(tensor) > 1:
        raise NotImplementedError(
            f"a model axis of {mesh.size(tensor)} ranks: the tensor axis is "
            f"not ported yet: {MULTI_RANK}")
    return Policy(mesh=mesh, replicas=R, replica_axes=dp,
                  tensor_axes=tensor)

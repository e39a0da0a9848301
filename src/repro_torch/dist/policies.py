"""Where the round step's aggregation runs (port of
``repro/dist/policies.py:make_train_policy`` at one process).

In the reference a training policy places the replica dim on a mesh, and
``policy.mesh is not None`` selects the fused branch of the round step:
each leaf is compressed in place, added to the round's start, reduced to
its cluster means, and on gossip rounds mixed through the sparse wire.  At
one process there is no sharding to describe: the policy says that one
process holds all R replicas, and its presence selects that branch.  More
than one rank raises and names what is left of ROADMAP.md item 5.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import FLTopology
from repro_torch.dist.collectives import MULTI_RANK


@dataclass(frozen=True)
class Policy:
    """All ``replicas`` FL devices of the topology live in this process."""

    replicas: int


def make_train_policy(topo: FLTopology, world_size: int = 1) -> Policy:
    """The training policy for ``topo`` on ``world_size`` processes; only
    one is ported."""
    if world_size != 1:
        raise NotImplementedError(
            f"world_size {world_size}: the multi-rank mesh is not ported "
            f"yet: {MULTI_RANK}")
    return Policy(replicas=topo.num_devices)

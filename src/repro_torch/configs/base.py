"""Configuration dataclasses (own copy of ``repro/configs/base.py``).

``ModelConfig`` keeps the fields of the families the port runs: the dense
decoder (served) and the ``ssm`` family (mamba2, trained by the HCEF round
step); the MoE, encoder-decoder and hybrid families are not ported
(``models/registry.py``).  ``FLTopology`` and ``HCEFConfig`` keep the
fields the off-mesh round step reads; the sparse gossip wire, wire error
feedback and the overlapped engine raise and name the ROADMAP.md item
that brings them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (dense and ssm families)."""

    name: str
    family: str  # dense | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 8
    expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    # --- attention ---
    window: int = 0  # local-attention window (0 = full/global)
    qkv_bias: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    logits_softcap: float = 0.0
    # --- dtypes ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    state_dtype: str = "float32"  # optimizer momentum dtype ("" = none)
    remat: bool = True  # recompute each layer's forward in the backward

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's padding);
        padded logit columns are masked to -1e30."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FLTopology:
    """The CFEL cluster/device structure: ``clusters`` edge servers, each
    with ``devices_per_cluster`` devices, joined by ``backhaul``."""

    clusters: int
    devices_per_cluster: int
    backhaul: str = "ring"  # ring | complete | erdos_renyi

    @property
    def num_devices(self) -> int:
        return self.clusters * self.devices_per_cluster


def validate_theta_levels(theta_levels) -> None:
    """Sparse-gossip level grid (base.py:120): non-empty, in (0, 1], and
    reaching 1.0, since ``quantize_theta`` rounds up and raises above the
    largest level."""
    if not theta_levels:
        raise ValueError("sparse_gossip requires theta_levels")
    if any(not 0.0 < float(t) <= 1.0 for t in theta_levels):
        raise ValueError(
            f"theta_levels must lie in (0, 1], got {theta_levels}")
    if max(float(t) for t in theta_levels) < 1.0:
        raise ValueError(
            f"theta_levels {theta_levels} do not cover [theta_min, 1.0]: "
            f"the largest level must be 1.0")


_NOT_PORTED = {
    "sparse_gossip": "ROADMAP.md, modules to port, item 5 (multi-GPU mesh "
                     "path: sparse_neighbor_exchange and the wire kernels)",
    "wire_ef": "ROADMAP.md, modules to port, item 5 (multi-GPU mesh path: "
               "CHOCO wire error feedback)",
    "overlap": "ROADMAP.md, modules to port, item 3 (overlap engine)",
    "staleness": "ROADMAP.md, modules to port, item 3 (overlap engine)",
}


@dataclass(frozen=True)
class HCEFConfig:
    """Round structure and controller knobs (paper Sec. 3/5)."""

    tau: int = 4  # local iterations per edge round
    q: int = 4  # edge rounds per global round
    eta: float = 0.05  # local learning rate
    momentum: float = 0.9
    block_size: int = 1024  # block-local top-k block length
    theta_min: float = 0.05
    rho_min: float = 0.1
    # budgets (seconds / joules); None = un-budgeted
    time_budget: Optional[float] = None
    energy_budget: Optional[float] = None
    error_feedback: bool = True
    # not ported: asking for any of these raises (see _NOT_PORTED)
    sparse_gossip: bool = False
    wire_ef: bool = False
    overlap: bool = False
    staleness: int = 0

    def __post_init__(self):
        for name, where in _NOT_PORTED.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"HCEFConfig.{name} is not ported yet: {where}")


@dataclass(frozen=True)
class ArchBundle:
    """What the launchers need of one architecture."""

    model: ModelConfig
    hcef: HCEFConfig = field(default_factory=HCEFConfig)
    source: str = ""

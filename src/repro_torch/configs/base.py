"""Configuration dataclasses (own copy of ``repro/configs/base.py``).

``ModelConfig`` keeps the fields of every family the reference runs: the
dense decoder and the ``moe`` family (trained by the HCEF round step and
served), the ``ssm`` family (mamba2), the ``hybrid`` family (griffin:
RG-LRU blocks and local MQA) and the ``encdec`` family (seamless: an
encoder and cross-attention), with the modality frontend stubs, all
trained by the HCEF round step.  ``FLTopology`` and ``HCEFConfig`` keep the
fields the round step reads, the sparse gossip wire and its error
feedback and the overlapped engine's bounded staleness included.
``ShapeConfig``, ``LM_SHAPES`` and ``ArchBundle``'s topologies and shape
cells are what the dry run (``launch/dryrun.py``) lowers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (dense, moe, ssm, hybrid and encdec
    families)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_ff: int = 0  # arctic-style parallel dense residual FFN width
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 8
    expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (recurrentgemma / griffin) ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0
    # --- encoder-decoder ---
    enc_layers: int = 0
    cross_attention: bool = False
    # --- modality frontend stubs ---
    frontend: str = ""  # "" | "vit_stub" | "audio_stub"
    frontend_tokens: int = 0  # number of precomputed embedding positions
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
class ShapeConfig:
    """One input-shape cell: (kind, seq, batch) (base.py:79)."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)


@dataclass(frozen=True)
class FLTopology:
    """The CFEL cluster/device structure: ``clusters`` edge servers, each
    with ``devices_per_cluster`` devices, joined by ``backhaul``.  On the
    reference's mesh each device spans ``inner_dp`` data-parallel slots
    (one process here: ``inner_dp`` only sizes the dry run's cells)."""

    clusters: int
    devices_per_cluster: int
    inner_dp: int = 1
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
    # --- sparse gossip wire (base.py:159-174) ---
    # gossip through sparse_neighbor_exchange on the fused branch (a
    # policy); theta is quantized up to theta_levels
    sparse_gossip: bool = False
    theta_levels: Tuple[float, ...] = (0.05, 0.1, 0.2, 0.4, 0.6, 0.8, 1.0)
    wire_dtype: str = "f32"  # f32 | bf16 | int8 | int4 | fp8
    wire_block: int = 1024  # wire-encode slab length
    error_feedback: bool = True
    # CHOCO wire error feedback: payloads carry the difference to a shared
    # estimate of each cluster's mean
    wire_ef: bool = False
    wire_ef_gamma: float = 1.0  # consensus step size (1.0 = plain mix)
    # the overlapped engine (core/round.make_overlap_round_step):
    # staleness 0 folds this round's means, 1 lets stale clusters ship
    # their start-of-round model
    overlap: bool = False
    staleness: int = 0

    def __post_init__(self):
        if self.wire_dtype not in ("f32", "bf16", "int8", "int4", "fp8"):
            raise ValueError(f"wire_dtype {self.wire_dtype!r}")
        if self.wire_dtype == "int8" and self.wire_block > 32768:
            raise ValueError(  # int16 block-local offsets wrap past 2^15-1
                f"int8 wire needs wire_block <= 32768, got {self.wire_block}")
        if self.sparse_gossip:
            validate_theta_levels(self.theta_levels)
        if self.staleness not in (0, 1):
            raise ValueError(
                f"staleness must be 0 (synchronous fold) or 1 (bounded "
                f"stale), got {self.staleness}")
        if self.staleness and not self.overlap:
            raise ValueError("staleness > 0 requires overlap=True")
        if self.wire_ef:
            if not self.sparse_gossip:
                raise ValueError("wire_ef requires sparse_gossip=True (the "
                                 "estimates track wire-encoded payloads)")
            if self.staleness:
                raise ValueError(
                    "wire_ef is incompatible with overlap staleness: a "
                    "stale payload would update neighbors' estimates with "
                    "a buffer the sender's own estimate never saw")
        if self.wire_ef_gamma <= 0.0 or self.wire_ef_gamma > 1.0:
            raise ValueError(f"wire_ef_gamma must lie in (0, 1], got "
                             f"{self.wire_ef_gamma}")


@dataclass(frozen=True)
class ArchBundle:
    """What the launchers and the dry run need of one architecture
    (base.py:214): the topologies of the reference's single-pod (16 data
    rows) and multi-pod (2 x 16) meshes, the shape cells and the ones
    skipped, with the reason."""

    model: ModelConfig
    fl_single: FLTopology
    fl_multi: FLTopology
    shapes: Tuple[ShapeConfig, ...] = LM_SHAPES
    skip_shapes: Tuple[str, ...] = ()
    skip_reason: str = ""
    hcef: HCEFConfig = field(default_factory=HCEFConfig)
    source: str = ""


# Skip reason shared by all pure full-attention archs (base.py:228): the
# long_500k cell runs only for sub-quadratic families.
FULL_ATTN_LONG_SKIP = (
    "long_500k requires sub-quadratic attention; this arch is pure "
    "full-attention (see DESIGN.md Arch-applicability)")

"""Model configuration (own copy of ``repro/configs/base.py:ModelConfig``).

Only the fields the dense family reads are kept; the other families are
not ported yet (``models/registry.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of a dense decoder LM."""

    name: str
    family: str  # dense (the only family ported so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    window: int = 0  # local-attention window (0 = full/global)
    qkv_bias: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    logits_softcap: float = 0.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's padding);
        padded logit columns are masked to -1e30."""
        return ((self.vocab_size + 255) // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ArchBundle:
    """What the serving launcher needs of one architecture."""

    model: ModelConfig
    source: str = ""

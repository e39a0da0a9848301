"""Family -> model module resolution (port of ``repro/models/registry.py``).

Every family of the reference: the dense, moe and encdec families
(``models/lm.py``, with the frontend stubs), the ssm family
(``models/mamba2.py``) and the hybrid family (``models/griffin.py``), each
with init, forward and loss for the HCEF round step and the static
serving path (init_cache, prefill, decode_step); ``lm`` also has the
paged serving path of the configs without an encoder.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import griffin, lm, mamba2


def get_model(cfg: ModelConfig):
    """The module of ``cfg.family``: ``lm`` for dense, moe and encdec,
    ``mamba2`` for ssm and ``griffin`` for hybrid.  An ``lm`` config
    that ``lm.check_config`` refuses raises here."""
    if cfg.family in lm.FAMILIES:
        lm.check_config(cfg)
        return lm
    if cfg.family == "ssm":
        return mamba2
    if cfg.family == "hybrid":
        return griffin
    raise ValueError(f"unknown family {cfg.family}")

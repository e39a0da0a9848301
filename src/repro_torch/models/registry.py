"""Family -> model module resolution (port of ``repro/models/registry.py``).

Only the dense family is ported; the others raise and name the ROADMAP.md
item that brings them.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

_NOT_PORTED = {
    "moe": "ROADMAP.md, modules to port, 'Other architectures' (MoE FFN)",
    "encdec": "ROADMAP.md, modules to port, 'Other architectures' "
              "(encoder-decoder)",
    "ssm": "ROADMAP.md, modules to port, 'Other architectures' (mamba2, "
           "with the SSD kernel)",
    "hybrid": "ROADMAP.md, modules to port, 'Other architectures' (griffin)",
}


def get_model(cfg: ModelConfig):
    """Returns the module implementing init / prefill_paged /
    decode_step_paged for ``cfg.family``."""
    if cfg.family == "dense":
        return lm
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: "
            f"{_NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family}")

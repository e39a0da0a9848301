"""Family -> model module resolution (port of ``repro/models/registry.py``).

Ported: the dense and moe families (``models/lm.py``: init, forward and
loss for the HCEF round step, and the paged serving path), the ssm family
(``models/mamba2.py``) and the hybrid family (``models/griffin.py``), both
with init, forward and loss for the HCEF round step.  The encoder-decoder
family raises and names the ROADMAP.md item that brings it.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import griffin, lm, mamba2

_NOT_PORTED = {
    "encdec": "ROADMAP.md, modules to port, 'Other architectures' "
              "(encoder-decoder)",
}


def get_model(cfg: ModelConfig):
    """The module of ``cfg.family``: ``lm`` for dense and moe (init,
    forward, loss_fn, prefill_paged, decode_step_paged), ``mamba2`` for
    ssm and ``griffin`` for hybrid (init, forward, loss_fn)."""
    if cfg.family in ("dense", "moe"):
        return lm
    if cfg.family == "ssm":
        return mamba2
    if cfg.family == "hybrid":
        return griffin
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: "
            f"{_NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family}")

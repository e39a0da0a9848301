"""Config registry (own copy of ``repro/configs/__init__.py``), limited to
the architectures the port serves."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchBundle, ModelConfig

ARCH_IDS: List[str] = ["qwen2_7b", "smollm_135m"]

_ALIASES = {
    "qwen2-7b": "qwen2_7b",
    "smollm-135m": "smollm_135m",
}


def get_config(name: str) -> ArchBundle:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in ARCH_IDS:
        raise ValueError(f"architecture {name!r} is not ported; "
                         f"have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def smoke_model(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests (the reference's dense
    branch of ``smoke_model``)."""
    return cfg.replace(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=257,
        param_dtype="float32",
        compute_dtype="float32",
    )

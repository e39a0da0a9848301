"""Config registry (own copy of ``repro/configs/__init__.py``): every
architecture of the reference and the paper's two vision models."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchBundle, ModelConfig
from repro_torch.configs.vision import VISION_CONFIGS, VisionBundle

ARCH_IDS: List[str] = ["mamba2_1p3b", "internvl2_2b", "qwen2_7b",
                       "phi3_medium_14b", "smollm_135m", "codeqwen1p5_7b",
                       "seamless_m4t_large_v2", "arctic_480b",
                       "granite_moe_1b_a400m", "recurrentgemma_9b"]
PAPER_IDS: List[str] = list(VISION_CONFIGS)

_ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "internvl2-2b": "internvl2_2b",
    "qwen2-7b": "qwen2_7b",
    "phi3-medium-14b": "phi3_medium_14b",
    "smollm-135m": "smollm_135m",
    "codeqwen1.5-7b": "codeqwen1p5_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "arctic-480b": "arctic_480b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def get_config(name: str) -> ArchBundle:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in ARCH_IDS:
        raise ValueError(f"architecture {name!r} is not ported; "
                         f"have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def smoke_model(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests (the reference's
    ``smoke_model``)."""
    kw = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=257,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
    if cfg.num_experts:
        kw.update(num_experts=4,
                  experts_per_token=min(cfg.experts_per_token, 2),
                  d_ff=64, moe_dense_ff=64 if cfg.moe_dense_ff else 0)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_groups=1, ssm_chunk=16,
                  num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0)
    if cfg.family == "hybrid":
        kw.update(block_pattern=cfg.block_pattern, num_layers=3,
                  window=16, lru_width=64, num_kv_heads=1)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, num_kv_heads=4)
    if cfg.frontend:
        kw.update(frontend_tokens=8)
    return cfg.replace(**kw)


def get_vision_config(name: str) -> VisionBundle:
    """The paper's vision configurations by id (``PAPER_IDS``)."""
    key = name.replace("-", "_")
    if key not in VISION_CONFIGS:
        raise ValueError(f"vision config {name!r} not in {PAPER_IDS}")
    return VISION_CONFIGS[key]

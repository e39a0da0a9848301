"""Family -> model module resolution (port of ``repro/models/registry.py``).

Every family of the reference: the dense, moe and encdec families
(``models/lm.py``, with the frontend stubs), the ssm family
(``models/mamba2.py``) and the hybrid family (``models/griffin.py``), each
with init, forward and loss for the HCEF round step and the static
serving path (init_cache, prefill, decode_step); ``lm`` also has the
paged serving path of the configs without an encoder.  ``input_specs``
and ``cache_specs`` give a shape cell's inputs and static cache as
tensors on ``meta`` (the reference's ``ShapeDtypeStruct`` stand-ins): the
dry run's arguments, with nothing allocated.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
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


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, Any]:
    """Every model input of a shape cell, as empty tensors on ``device``
    (registry.py:24): train and prefill the token batch (B, S) int32, with
    the ``vit_stub`` frontend's ``patch_embeds`` (B, frontend_tokens, D)
    and the encoder's ``frames`` (B, S, D), both bf16; decode one new
    token a sequence, (B, 1) (the cache comes from ``cache_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    empty = lambda shp, dt: torch.empty(shp, dtype=dt, device=device)
    if shape.kind == "decode":
        return {"tokens": empty((B, 1), torch.int32)}
    specs: Dict[str, Any] = {"tokens": empty((B, S), torch.int32)}
    if cfg.frontend == "vit_stub":
        specs["patch_embeds"] = empty((B, cfg.frontend_tokens, cfg.d_model),
                                      torch.bfloat16)
    if cfg.family == "encdec":
        specs["frames"] = empty((B, S, cfg.d_model), torch.bfloat16)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta"):
    """The family's ``init_cache`` for a shape cell on ``device``
    (registry.py:44): B = global_batch, S = seq_len positions, and for the
    encoder ``enc_len = S``."""
    B, S = shape.global_batch, shape.seq_len
    return get_model(cfg).init_cache(
        cfg, B, S, enc_len=S if cfg.family == "encdec" else 0,
        device=device)

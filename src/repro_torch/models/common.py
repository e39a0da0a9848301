"""Shared model components (port of ``repro/models/common.py``)."""
from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float64": torch.float64}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def rms_norm(x, w, eps=1e-6):
    """RMS norm in f32, cast back to x's type (common.py:21-25)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def rope(x, positions, theta=10_000.0):
    """Rotary embedding with f32 angles and a split-half rotation.

    x: (B, S, H, Dh); positions: (B, S) or (S,)."""
    B, S, H, Dh = x.shape
    half = Dh // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(float(theta), exps)  # f32, as the reference
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(generator, shape, dtype, device, scale=0.02):
    """Normal(0, scale^2) weights drawn in f32 from ``generator``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (scale * w).to(dtype)


def softcap(logits, cap):
    if not cap:
        return logits
    lf = logits.float()
    return (torch.tanh(lf / cap) * cap).to(logits.dtype)


def cross_entropy(logits, labels, mask=None):
    """Mean token cross entropy in f32 (common.py:51).  logits (B, S, V),
    labels (B, S).  The label's logit is gathered where the reference sums
    logits times a one-hot: the same value, without a (B, S, V) one-hot."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    ce = lse - ll
    if mask is not None:
        m = mask.float()
        return torch.sum(ce * m) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.mean(ce)


def mask_padded_logits(cfg, logits):
    """Padded vocab columns to -1e30 (common.py:72)."""
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    keep = torch.arange(cfg.vocab_padded, device=logits.device) < \
        cfg.vocab_size
    return torch.where(keep, logits,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device))

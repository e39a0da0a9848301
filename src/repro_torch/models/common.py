"""Shared model components (port of ``repro/models/common.py``)."""
from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float64": torch.float64}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def rms_norm(x, w, eps=1e-6):
    """RMS norm in f32, cast back to x's type (common.py:21-25).  The f32
    product with a bf16 w promotes w exactly, as ``w.float()`` would,
    without a launch of its own."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w).to(x.dtype)


def rope_tables(positions, head_dim, theta=10_000.0):
    """(cos, sin) of the rotary embedding, f32 angles, each (B, S, 1,
    head_dim / 2) for positions (B, S) or (1, S, 1, ...) for (S,):
    computed once a forward and shared by q, k and every layer.  The
    reference recomputes them in each ``rope`` call, to the same bits."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(float(theta), exps)  # f32, as the reference
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rope(x, tables):
    """Rotary embedding with a split-half rotation (common.py:28-40).
    x: (B, S, H, Dh); tables: ``rope_tables`` at x's positions."""
    cos, sin = tables
    half = x.shape[-1] // 2
    # x's halves times the f32 tables: promoted to f32 exactly, as the
    # reference's casts, with no cast launched
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def seeded_generator(device: torch.device, seed: int):
    """A generator on ``device`` seeded with ``seed``; None on ``meta``,
    where nothing is drawn (``abstract_state``'s shapes alone)."""
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


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


def stack_list(layers):
    """A stack of layers as a list of per-layer dicts: views of the stacked
    leaves (L, ...), or the list itself (the round step differentiates
    with respect to each layer's slices)."""
    if isinstance(layers, (list, tuple)):
        return list(layers)
    L = next(iter(layers.values())).shape[0]
    return [{k: v[l] for k, v in layers.items()} for l in range(L)]


def layer_list(params):
    """params["layers"] as a list of per-layer dicts (``stack_list``)."""
    return stack_list(params["layers"])

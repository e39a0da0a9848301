"""Plain PyTorch versions of the attention functions (port of
``repro/kernels/ref.py`` and ``gather_kv_pages`` of
``repro/kernels/flash_attention.py``).

They compute what the reference's oracles compute, line for line, and are
what the CPU runs and what the CUDA kernels are held against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Finite "minus infinity", as in the reference (ref.py:18): rows with
# nothing live keep exp(m_old - m_new) = 1 and never produce NaN.
NEG_INF = -1e30


def _mask(Sq, Skv, k0, *, causal, window, q_offset, device):
    qpos = q_offset + torch.arange(Sq, device=device)
    kpos = k0 + torch.arange(Skv, device=device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask, kpos


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0, kv_len=None,
                  softmax_scale=None):
    """Naive dense softmax attention with GQA (ref.py:25).  Oracle only.

    q: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh); H % KH == 0.
    """
    B, Sq, H, Dh = q.shape
    _, Skv, KH, _ = k.shape
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qf = q.float().reshape(B, Sq, KH, G, Dh) * scale
    s = torch.einsum("bqkgd,bjkd->bqkgj", qf, k.float())
    mask, kpos = _mask(Sq, Skv, 0, causal=causal, window=window,
                       q_offset=q_offset, device=q.device)
    mask = mask[None].expand(B, Sq, Skv)
    if kv_len is not None:
        mask = mask & (kpos[None, None, :] < kv_len[:, None, None])
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgj,bjkd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def flash_attention_blockwise(q, k, v, *, causal=True, window=0, q_offset=0,
                              kv_len=None, softmax_scale=None, block_kv=512):
    """Blockwise (flash) attention over KV blocks with f32 accumulators
    (port of ``ref.flash_attention_jnp``, ref.py:55)."""
    B, Sq, H, Dh = q.shape
    _, Skv, KH, _ = k.shape
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5

    block_kv = min(block_kv, Skv)
    pad = (-Skv) % block_kv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
    nb = (Skv + pad) // block_kv

    qf = q.float().reshape(B, Sq, KH, G, Dh) * scale
    m = torch.full((B, Sq, KH, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, KH, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KH, G, Dh), dtype=torch.float32,
                      device=q.device)
    for ib in range(nb):
        k0 = ib * block_kv
        kb = k[:, k0:k0 + block_kv].float()
        vb = v[:, k0:k0 + block_kv].float()
        s = torch.einsum("bqkgd,bjkd->bqkgj", qf, kb)
        mask, kpos = _mask(Sq, block_kv, k0, causal=causal, window=window,
                           q_offset=q_offset, device=q.device)
        mask = mask[None].expand(B, Sq, block_kv)
        if kv_len is not None:
            mask = mask & (kpos[None, None, :] < kv_len[:, None, None])
        maskx = mask[:, :, None, None, :]
        s = torch.where(maskx, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(maskx, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgj,bjkd->bqkgd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def decode_attention_direct(q, k, v, *, kv_len=None, window=0,
                            softmax_scale=None, return_stats=False):
    """Single-token decode attention, direct (non-blockwise) form (port of
    ``ref.decode_attention_jnp``, ref.py:110).

    q: (B, 1, H, Dh); k, v: (B, Skv, KH, Dh); kv_len: (B,) current lengths
    (entries >= kv_len masked out).  As in the reference, ``q * scale`` is
    rounded back to q's type and p to v's type before the products, which
    accumulate in f32.
    """
    B, Sq, H, Dh = q.shape
    _, Skv, KH, _ = k.shape
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qf = (q.float() * scale).to(q.dtype).reshape(B, Sq, KH, G, Dh)
    s = torch.einsum("bqkgd,bjkd->bqkgj", qf.float(), k.float())
    kpos = torch.arange(Skv, device=q.device)
    mask = None
    if kv_len is not None:
        mask = kpos[None, :] < kv_len[:, None]  # (B, Skv)
        if window:
            mask &= kpos[None, :] >= kv_len[:, None] - window
        s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask[:, None, None, None, :], p, 0.0)
    out = torch.einsum("bqkgj,bjkd->bqkgd", p.to(v.dtype).float(), v.float())
    l = torch.clamp_min(p.sum(dim=-1), 1e-20)
    out = out / l[..., None]
    out = out.reshape(B, Sq, H, Dh).to(q.dtype)
    if return_stats:  # (out, running max, sumexp) for streaming combines
        return out, m[..., 0], l
    return out


def decode_attention_combine(q, out_old, m_old, l_old, k_new, v_new, *,
                             softmax_scale=None):
    """Fold ONE new (k, v) into a decode-attention partial result
    (ref.py:149).  q: (B, 1, H, Dh); k_new, v_new: (B, 1, KH, Dh);
    (out_old, m_old, l_old) as returned with ``return_stats=True``."""
    B, Sq, H, Dh = q.shape
    KH = k_new.shape[2]
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, KH, G, Dh)
    s_new = torch.einsum("bqkgd,bqkd->bqkg", qf, k_new.float())  # (B,1,KH,G)
    m_c = torch.maximum(m_old, s_new)
    corr = torch.exp(m_old - m_c) * l_old
    w_new = torch.exp(s_new - m_c)
    l_c = corr + w_new
    oo = out_old.float().reshape(B, Sq, KH, G, Dh)
    vn = v_new.float()[:, :, :, None, :]  # (B, 1, KH, 1, Dh)
    out = (oo * corr[..., None] + vn * w_new[..., None]) / l_c[..., None]
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def gather_kv_pages(pages, page_table):
    """Assemble per-request KV views from the paged pool
    (flash_attention.py:28-47, gather form).

    pages: (NP, ps, ...) physical page pool (page 0 = null); page_table:
    (B, P) int32 physical page ids per request.  Returns (B, P * ps, ...):
    request b's logical positions in order.
    """
    B, P = page_table.shape
    ps = pages.shape[1]
    tail = pages.shape[2:]
    flat = torch.index_select(pages, 0, page_table.reshape(-1))
    return flat.reshape((B, P * ps) + tuple(tail))


# ---------------------------------------------------------------------------
# Block-local top-k compression (the paper's Q operator)
# ---------------------------------------------------------------------------

BISECT_ITERS = 16


def _blocks(x, block):
    L = x.shape[-1]
    if L % block:
        raise ValueError(f"last dim {L} is not a multiple of block {block}")
    return x.reshape(*x.shape[:-1], L // block, block)


def topk_mask_exact(x, theta, *, block=1024):
    """Exact per-block top-k by sort (ref.py:356).  Oracle only.

    x: (..., L), L % block == 0; theta broadcasts against (..., L // block).
    Keeps every entry whose magnitude reaches the k-th largest,
    k = clip(ceil(theta * block), 1, block).  Returns (masked, keep)."""
    xb = _blocks(x, block)
    mag = xb.abs()
    k = torch.clamp(torch.ceil(theta * block).to(torch.int64), 1, block)
    srt = torch.sort(mag, dim=-1).values  # ascending
    idx = torch.broadcast_to(block - k, srt.shape[:-1])[..., None]
    thr = torch.gather(srt, -1, idx)
    keep = mag >= thr
    masked = torch.where(keep, xb, torch.zeros((), dtype=xb.dtype,
                                               device=xb.device))
    return masked.reshape(x.shape), keep.reshape(x.shape)


def topk_mask_bisect(x, theta, *, block=1024, iters=BISECT_ITERS):
    """Bisection-threshold block top-k (``ref.topk_mask_bisect_jnp``,
    ref.py:378): the plain version of the top-k kernel, op for op.

    Per block, ``iters`` halvings of [0, max|x|] on the count of
    ``|x| > mid`` against k = clip(ceil(theta * block), 1, block) in f32;
    keeps ``|x| > lo`` (the lower bound, so ties are kept) and, in an
    all-zero block, its maximum.  Returns (masked, keep)."""
    xb = _blocks(x, block)
    mag = xb.float().abs()
    k = torch.clamp(torch.ceil(theta * block), 1.0, float(block))
    lo = torch.zeros(mag.shape[:-1], dtype=torch.float32, device=x.device)
    hi0 = mag.amax(dim=-1)
    hi = hi0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = (mag > mid[..., None]).sum(dim=-1).float()
        lo = torch.where(cnt > k, mid, lo)
        hi = torch.where(cnt > k, hi, mid)
    keep = mag > lo[..., None]
    keep |= (mag >= hi0[..., None]) & (hi0 == 0.0)[..., None]
    masked = torch.where(keep, xb, torch.zeros((), dtype=xb.dtype,
                                               device=xb.device))
    return masked.reshape(x.shape), keep.reshape(x.shape)

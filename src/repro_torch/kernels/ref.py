"""Plain PyTorch versions of the kernels' functions (port of
``repro/kernels/ref.py`` and ``gather_kv_pages`` of
``repro/kernels/flash_attention.py``): attention, block top-k and the
Mamba2 SSD scan, and the exact top-k wire encode.

They compute what the reference's oracles compute, line for line, and are
what the CPU runs and what the CUDA kernels are held against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wire_pack import quantize_vals

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
                              kv_len=None, softmax_scale=None, block_kv=512,
                              return_lse=False):
    """Blockwise (flash) attention over KV blocks with f32 accumulators
    (port of ``ref.flash_attention_jnp``, ref.py:55).  ``return_lse`` also
    returns the row log-sum-exp of the scaled scores, (B, H, Sq) f32 in
    natural-log units: m + log(max(l, 1e-20)), what the kernels write."""
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
    out = out.reshape(B, Sq, H, Dh).to(q.dtype)
    if not return_lse:
        return out
    lse = m + torch.log(torch.clamp_min(l, 1e-20))  # (B, Sq, KH, G)
    return out, lse.reshape(B, Sq, H).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window=0, softmax_scale=None):
    """Plain version of the attention backward kernels
    (``csrc/flash_attention_bwd.cu``), step by step in f32: D = rowsum(dO
    o O), P = exp(scale q.k - lse) on the live pairs, dV = P^T dO, dP =
    dO V^T, dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T Q, dK and
    dV summed over each KV head's G query heads.  lse: (B, H, Sq) f32, the
    forward's.  Returns (dq, dk, dv) in q's, k's and v's types."""
    B, Sq, H, Dh = q.shape
    _, Skv, KH, _ = k.shape
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qf = q.float().reshape(B, Sq, KH, G, Dh)
    of = out.float().reshape(B, Sq, KH, G, Dh)
    gf = dout.float().reshape(B, Sq, KH, G, Dh)
    kf, vf = k.float(), v.float()
    mask, _ = _mask(Sq, Skv, 0, causal=causal, window=window, q_offset=0,
                    device=q.device)
    maskx = mask[None, :, None, None, :]
    lsex = lse.float().transpose(1, 2).reshape(B, Sq, KH, G)[..., None]
    s = torch.einsum("bqkgd,bjkd->bqkgj", qf, kf) * scale
    p = torch.where(maskx, torch.exp(s - lsex), 0.0)
    dv = torch.einsum("bqkgj,bqkgd->bjkd", p, gf)
    dp = torch.einsum("bqkgd,bjkd->bqkgj", gf, vf)
    dsum = (gf * of).sum(dim=-1)
    ds = p * (dp - dsum[..., None])
    dq = torch.einsum("bqkgj,bjkd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bqkgj,bqkgd->bjkd", ds, qf) * scale
    return (dq.reshape(B, Sq, H, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
    vn = v_new[:, :, :, None, :]  # (B, 1, KH, 1, Dh), promoted to f32 below
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


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality)
# ---------------------------------------------------------------------------

def _work_dtype(x):
    """The scan's arithmetic type: f32 for f32 and bf16 inputs, as the
    reference computes; f64 for f64 inputs (a more exact evaluation of the
    same sums, which the kernels' checks use as an oracle)."""
    return torch.promote_types(x.dtype, torch.float32)


def _heads(t, rep):
    """(b, s, g, n) -> (b, s, g * rep, n) in ``_work_dtype``: each group's
    B or C for its ``rep`` heads (``jnp.repeat`` on the group axis).  Cast
    before the repeat, the same values as the reference's repeat-then-cast;
    the gradient then sums a group's heads in f32 and rounds once, as the
    backward kernel does."""
    return torch.repeat_interleave(t.to(_work_dtype(t)), rep, dim=2)


def ssd_ref(x, dt, A, B, C, *, initial_state=None):
    """Sequential SSD recurrence (ref.py:178).  Oracle only.

    x: (b, s, h, p); dt: (b, s, h) f32; A: (h,) f32 (negative); B, C:
    (b, s, g, n).  Returns y (b, s, h, p) in x's type and the final state
    (b, h, p, n) f32."""
    b, s, h, p = x.shape
    n = B.shape[3]
    rep = h // B.shape[2]
    Bh, Ch = _heads(B, rep), _heads(C, rep)
    decay = torch.exp(dt * A[None, None, :]).float()
    xdt = (x * dt[..., None]).float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state)
    ys = []
    for t in range(s):
        state = state * decay[:, t, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", xdt[:, t], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), state


def _segsum(x):
    """x: (..., L) -> (..., L, L) with out[..., i, j] = cs_i - cs_j for
    i >= j (cs the inclusive cumsum of x) and -inf above the diagonal
    (ref.py:211)."""
    return _seg(torch.cumsum(x, dim=-1))


def _seg(cs):
    """cs: (..., L) -> (..., L, L), cs_i - cs_j for i >= j, -inf above."""
    L = cs.shape[-1]
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=cs.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, *, chunk=64, initial_state=None):
    """Chunked SSD in the dual (matmul) form (``ssd_chunked_jnp``,
    ref.py:221): the plain version of the SSD forward kernel.

    Within each chunk y_diag = C (L o B^T) (x dt) with L = exp(segsum(dt
    A)); each chunk's final state carries into the next, whose y_off = C
    S_prev exp(cs).  A length that is not a multiple of ``chunk`` is padded
    with dt = 0 (decay 1, no contribution) and cut back.  The inter-chunk
    recurrence is a loop over chunks where the reference runs an
    associative scan: the same sums in another order.  Returns y (x's
    type) and the final state (b, h, p, n) f32 (f64 for f64 inputs)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        y, st = ssd_chunked(x, dt, A, B, C, chunk=chunk,
                            initial_state=initial_state)
        return y[:, :s], st
    nc = s // chunk
    wt = _work_dtype(x)
    Bh = _heads(B, rep).reshape(b, nc, chunk, h, n)
    Ch = _heads(C, rep).reshape(b, nc, chunk, h, n)
    xdt = (x * dt[..., None]).to(wt).reshape(b, nc, chunk, h, p)
    dA = (dt * A[None, None, :]).to(wt).reshape(b, nc, chunk, h)
    dA = dA.permute(0, 1, 3, 2)  # (b, nc, h, L)

    # 1. within-chunk (diagonal blocks)
    Lm = torch.exp(_segsum(dA))  # (b, nc, h, L, L)
    G = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)
    y_diag = torch.einsum("bchls,bcshp->bclhp", G * Lm, xdt)

    # 2. chunk-final states
    dA_cum = torch.cumsum(dA, dim=-1)  # (b, nc, h, L)
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", Bh, decay_states, xdt)

    # 3. inter-chunk recurrence: S_c = exp(cs_last) S_{c-1} + states_c
    chunk_decay = torch.exp(dA_cum[..., -1])  # (b, nc, h)
    prev = (torch.zeros((b, h, p, n), dtype=wt, device=x.device)
            if initial_state is None else initial_state.to(wt))
    prev_states = []
    for c in range(nc):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev_states, dim=1)  # (b, nc, h, p, n)

    # 4. off-diagonal contribution from the carried state
    decay_in = torch.exp(dA_cum)  # (b, nc, h, L)
    y_off = torch.einsum("bclhn,bchl,bchpn->bclhp", Ch, decay_in,
                         prev_states)

    y = (y_diag + y_off).reshape(b, s, h, p).to(x.dtype)
    return y, prev


# ---------------------------------------------------------------------------
# The chunked scan in the stages the bf16 kernels run (csrc/ssd_scan.cu):
# (a) G = C B^T per (b, chunk, group); (b) each chunk's own state terms;
# (c) the pass over chunks; (d) y.  The backward mirrors them.  Plain torch
# for the tests: composed, they give ssd_chunked's y and chunk states and
# its autograd gradients.  ``op`` is applied to every f32 operand that the
# kernels feed the tensor cores as a bf16 hi + lo pair (``bf16_pair``), so
# the tests can emulate that rounding; by default it is the identity.
# ---------------------------------------------------------------------------

def bf16_pair(v):
    """v as the tensor cores see a bf16 hi + lo pair: hi = bf16(v), lo =
    bf16(v - hi), summed back in v's type (about 16 mantissa bits)."""
    hi = v.to(torch.bfloat16).to(v.dtype)
    return hi + (v - hi).to(torch.bfloat16).to(v.dtype)


def _same(v):
    return v


def _chunked(t, chunk):
    """(b, s, ...) -> (b, nc, L, ...), zero-padded to whole chunks."""
    pad = (-t.shape[1]) % chunk
    if pad:
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, chunk, *t.shape[2:])


def ssd_stage_cs(dt, A, chunk):
    """cs (b, h, nc, L): the cumsum of dt A within each chunk; steps past
    the sequence add 0."""
    dA = _chunked(dt * A[None, None, :], chunk)  # (b, nc, L, h)
    return torch.cumsum(dA, dim=2).permute(0, 3, 1, 2)


def ssd_stage_gram(B, C, chunk):
    """(a) G[b, c, g, l, s] = C[l] . B[s], once per group (K = n)."""
    wt = _work_dtype(B)
    return torch.einsum("bclgn,bcsgn->bcgls", _chunked(C, chunk).to(wt),
                        _chunked(B, chunk).to(wt))


def _decay(cs):
    """exp(cs[l] - cs[s]) for s <= l, else 0: (b, h, nc, L, L), always
    formed from the difference (exp(cs) alone underflows, exp(-cs) would
    overflow)."""
    return torch.exp(_seg(cs))


def ssd_stage_chunk_states(x, dt, B, cs, *, op=_same):
    """(b) each chunk's own contribution to the state it hands on,
    sum_s exp(cs[L-1] - cs[s]) dt[s] x[s] B[s]^T: (b, nc, h, p, n).  The
    f32 operand is x[s] times that factor."""
    L = cs.shape[-1]
    wt = _work_dtype(x)
    rep = x.shape[2] // B.shape[2]
    w = _chunked(dt, L).to(wt) * torch.exp(
        cs[..., -1:] - cs).permute(0, 2, 3, 1)        # (b, nc, L, h)
    xw = op(_chunked(x, L).to(wt) * w[..., None])
    return torch.einsum("bcshp,bcshn->bchpn", xw,
                        _chunked(_heads(B, rep), L))


def ssd_stage_pass(contrib, cs):
    """(c) the state at the start of every chunk, S[c + 1] = exp(cs[L-1]
    of c) S[c] + contrib[c] from S[0] = 0: (b, h, nc, p, n).  Elementwise
    over (p, n), in order over the chunks."""
    S = torch.zeros_like(contrib[:, 0])
    out = []
    for c in range(contrib.shape[1]):
        out.append(S)
        S = torch.exp(cs[:, :, c, -1])[..., None, None] * S + contrib[:, c]
    return torch.stack(out, dim=2)


def ssd_stage_y(x, dt, C, G, cs, states, *, op=_same):
    """(d) y[l] = exp(cs[l]) C[l] S^T + sum_{s <= l} G[l, s] exp(cs[l] -
    cs[s]) dt[s] x[s], with S the chunk's start state: (b, nc, L, h, p)
    in the work type.  The f32 operands are S and W = G o decay o dt."""
    L = cs.shape[-1]
    wt = _work_dtype(x)
    rep = x.shape[2] // C.shape[2]
    Gh = torch.repeat_interleave(G, rep, dim=2)       # (b, nc, h, L, L)
    dtc = _chunked(dt, L).to(wt).permute(0, 1, 3, 2)  # (b, nc, h, L)
    W = op(Gh * _decay(cs).transpose(1, 2) * dtc[..., None, :])
    y_diag = torch.einsum("bchls,bcshp->bclhp", W, _chunked(x, L).to(wt))
    Ch = _chunked(_heads(C, rep), L)
    y_off = torch.einsum("bclhn,bhcpn->bclhp", Ch, op(states))
    return y_diag + y_off * torch.exp(cs).permute(0, 2, 3, 1)[..., None]


def ssd_fwd_stages(x, dt, A, B, C, *, chunk=64, op=_same):
    """The forward in stages (a)-(d): y (x's type) and the state at the
    start of every chunk, (b, h, nc, p, n) in the work type, as the
    forward kernel writes them."""
    cs = ssd_stage_cs(dt, A, chunk)
    states = ssd_stage_pass(ssd_stage_chunk_states(x, dt, B, cs, op=op), cs)
    y = ssd_stage_y(x, dt, C, ssd_stage_gram(B, C, chunk), cs, states, op=op)
    b, s, h, p = x.shape
    return y.reshape(b, -1, h, p)[:, :s].to(x.dtype), states


def ssd_stage_dstates(dy, C, cs):
    """The gradient that each chunk's y sends to its start state,
    sum_l exp(cs[l]) dy[l]^T C[l]: (b, nc, h, p, n)."""
    L = cs.shape[-1]
    wt = _work_dtype(dy)
    rep = dy.shape[2] // C.shape[2]
    dyw = _chunked(dy, L).to(wt) * torch.exp(cs).permute(0, 2, 3, 1)[..., None]
    return torch.einsum("bclhp,bclhn->bchpn", dyw,
                        _chunked(_heads(C, rep), L))


def ssd_stage_dpass(dcontrib, cs):
    """The gradient of each chunk's final state, passed in reverse:
    dS[nc-1] = 0, dS[c] = exp(cs[L-1] of c + 1) dS[c + 1] + dcontrib[c +
    1]: (b, h, nc, p, n)."""
    nc = dcontrib.shape[1]
    D = torch.zeros_like(dcontrib[:, 0])
    out = [D]
    for c in range(nc - 2, -1, -1):
        D = (torch.exp(cs[:, :, c + 1, -1])[..., None, None] * D
             + dcontrib[:, c + 1])
        out.append(D)
    return torch.stack(out[::-1], dim=2)


def ssd_stage_chunk_grads(dy, x, dt, B, C, cs, states, dS):
    """dx, dB, dC and dcs (the gradient of cs, (b, h, nc, L)) of every
    chunk, given its start state and the gradient of its final state."""
    L = cs.shape[-1]
    wt = _work_dtype(x)
    b, s, h, p = x.shape
    g = B.shape[2]
    rep = h // g
    Bh = _chunked(_heads(B, rep), L)                  # (b, nc, L, h, n)
    Ch = _chunked(_heads(C, rep), L)
    xc = _chunked(x, L).to(wt)                        # (b, nc, L, h, p)
    dyc = _chunked(dy, L).to(wt)
    dtc = _chunked(dt, L).to(wt)                      # (b, nc, L, h)
    csc = cs.permute(0, 2, 3, 1)                      # (b, nc, L, h)
    S = states.transpose(1, 2)                        # (b, nc, h, p, n)
    D = dS.transpose(1, 2)
    Lm = _decay(cs).transpose(1, 2)                   # (b, nc, h, L, L)
    W = torch.einsum("bclhn,bcshn->bchls", Ch, Bh) * Lm
    dW = (torch.einsum("bclhp,bcshp->bchls", dyc, xc)
          * dtc.permute(0, 1, 3, 2)[..., None, :])
    dG = dW * Lm
    Q = dW * W
    dec = torch.exp(csc[:, :, -1:] - csc)             # (b, nc, L, h)
    DB = torch.einsum("bchpn,bcshn->bcshp", D, Bh)    # dS B[s]
    dxdt = torch.einsum("bchls,bclhp->bcshp", W, dyc) + dec[..., None] * DB
    dx = dxdt * dtc[..., None]
    ein = torch.exp(csc)
    dyS = torch.einsum("bclhp,bchpn->bclhn", dyc, S)  # dy[l] S
    dCh = torch.einsum("bchls,bcshn->bclhn", dG, Bh) + ein[..., None] * dyS
    dBh = (torch.einsum("bchls,bclhn->bcshn", dG, Ch)
           + (dec * dtc)[..., None] * torch.einsum("bcshp,bchpn->bcshn", xc,
                                                   D))
    u = dec * dtc * (xc * DB).sum(-1)                 # (b, nc, L, h)
    off = ein * (Ch * dyS).sum(-1)
    dcs = (Q.sum(-1) - Q.sum(-2)).permute(0, 1, 3, 2) + off - u
    last = torch.exp(csc[:, :, -1]) * (D * S).sum((-1, -2)) + u.sum(2)
    dcs = torch.cat([dcs[:, :, :-1], dcs[:, :, -1:] + last[:, :, None]], 2)
    ddx = (dxdt * xc).sum(-1)                         # (b, nc, L, h)
    group = lambda t: t.reshape(b, -1, g, rep, t.shape[-1]).sum(3)
    dB = group(dBh.reshape(b, -1, h, dBh.shape[-1]))[:, :s]
    dC = group(dCh.reshape(b, -1, h, dCh.shape[-1]))[:, :s]
    return (dx.reshape(b, -1, h, p)[:, :s], dB, dC,
            dcs.permute(0, 3, 1, 2), ddx.permute(0, 3, 1, 2))


def ssd_stage_dcs(dcs, ddx, dt, A):
    """ddt and dA from dcs: d(dt A) is the reverse cumsum of dcs within
    each chunk; ddt = d(dt A) A + the x dt term ``ddx``, dA = sum d(dt A)
    dt."""
    b, s, h = dt.shape
    dda = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    dda = dda.permute(0, 2, 3, 1).reshape(b, -1, h)[:, :s]
    ddx = ddx.permute(0, 2, 3, 1).reshape(b, -1, h)[:, :s]
    return dda * A + ddx, (dda * dt).sum((0, 1))


def ssd_bwd_stages(dy, x, dt, A, B, C, states, *, chunk=64):
    """The backward in stages, from the start states ``ssd_fwd_stages``
    returned: (dx, ddt, dA, dB, dC) in the inputs' types."""
    cs = ssd_stage_cs(dt, A, chunk)
    dS = ssd_stage_dpass(ssd_stage_dstates(dy, C, cs), cs)
    dx, dB, dC, dcs, ddx = ssd_stage_chunk_grads(dy, x, dt, B, C, cs,
                                                 states, dS)
    ddt, dA = ssd_stage_dcs(dcs, ddx, dt, A)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype))


# ---------------------------------------------------------------------------
# The wire encode's exact oracle
# ---------------------------------------------------------------------------

def encode_blocks_topk(xb, k_b: int, *, wire_dtype: str):
    """Exact per-block top-k_b wire encode (``encode_blocks_jnp``,
    wire_pack.py:91): xb (m, nb, wb) f32 -> (vals, off, scale), offsets
    ascending.  ``lax.top_k`` breaks ties toward the lower index; a stable
    descending sort does the same, so the kept set is the reference's, bit
    for bit.  The encode kernel's bisection may keep other members of a
    threshold band (``wire_pack.encode_blocks_plain``)."""
    x = xb.float()
    order = torch.sort(x.abs(), dim=-1, descending=True, stable=True).indices
    off = torch.sort(order[..., :k_b], dim=-1).values
    vals = torch.gather(x, -1, off)
    scale = x.abs().amax(dim=-1)
    return quantize_vals(vals, scale, wire_dtype), off.to(torch.int32), scale

"""Attention kernels for Hopper and their plain versions.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (the port of
``repro/kernels/flash_attention.py:flash_attention_pallas``): bf16 runs
``flash_fwd_tc`` (wgmma on the tensor cores), f32 the exact
``flash_fwd_simt``; with ``return_lse`` both also write the row
log-sum-exp.  ``flash_attention_bwd_cuda`` launches
``csrc/flash_attention_bwd.cu`` (no TPU counterpart: the reference cannot
differentiate its Pallas kernel; bf16 runs wgmma on TMA-fed tiles, f32
exact SIMT kernels), and ``FlashAttention`` ties the two
together as an autograd Function, the training path's attention.
``paged_decode_attention_cuda`` launches ``csrc/paged_decode.cu`` (the
port of ``paged_decode_attention_pallas``) over (KV head, request, split
of the KV length): bf16 runs
``paged_decode_tc`` (mma.sync on the tensor cores), f32 and other shapes
``paged_decode_simt``, and the last live split of each (request, KV head)
merges the others.  Each sits beside its plain PyTorch version, which
computes the same function with the reference's oracles; the decode's
split and merge passes also have plain versions of their own.

A wrapper takes CUDA tensors only: it checks device, type, shape and
contiguity, allocates its outputs, launches on the current stream, raises
if the launch failed, and adds one to its entry of ``LAUNCHES``.  Layouts
are the reference's: q (B, S, H, Dh), k/v (B, S, KH, Dh), pages
(NP, ps, KH, Dh).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (NEG_INF, decode_attention_direct,
                                     flash_attention_blockwise,
                                     flash_attention_bwd_plain,  # noqa: F401
                                     gather_kv_pages)

# Launches of each kernel since the last reset_launches(); a plain integer
# per kernel, bumped only where the kernel is launched.  The backward
# counts one a call (D, then dK, dV and dQ in one launch for bf16 or two
# for f32).
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0,
            "paged_decode_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh
FLASH_HEAD_DIMS = (16, 32, 64, 128)  # instantiated in flash_attention.cu


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name, *tensors, dtype):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: CUDA kernel given a tensor on "
                             f"{t.device}; the plain version serves the CPU")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{tensors[0].device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             f"not contiguous")


def _check_aligned(name, *tensors):
    for t in tensors:  # the kernels copy 16 bytes at a time
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             f"not 16-byte aligned")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# flash-attention prefill
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0,
                          softmax_scale=None, return_lse=False):
    """Plain version of the prefill kernel: ``ref.flash_attention_jnp``
    (with ``return_lse``, also the row log-sum-exp the kernel writes)."""
    return flash_attention_blockwise(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset,
                                     softmax_scale=softmax_scale,
                                     return_lse=return_lse)


def _check_qkv(name, q, k, v):
    """Type, device, layout and shape checks shared by both directions;
    returns (B, Sq, H, Dh, Skv, KH)."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODE)}")
    _check(name, q, k, v, dtype=q.dtype)
    B, Sq, H, Dh = q.shape
    Bk, Skv, KH, Dk = k.shape
    if k.shape != v.shape or Bk != B or Dk != Dh or H % KH:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {Dh} not in {FLASH_HEAD_DIMS}")
    return B, Sq, H, Dh, Skv, KH


def flash_attention_cuda(q, k, v, *, causal=True, window=0, q_offset=0,
                         softmax_scale=None, return_lse=False):
    """Blockwise attention forward on the card.

    q: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh); f32 or bf16, contiguous
    (bf16: 16-byte aligned, for TMA); Dh in FLASH_HEAD_DIMS.  Any Sq and
    Skv (the ragged edge is masked in the kernel).  bf16 runs
    ``flash_fwd_tc``, f32 ``flash_fwd_simt``.  Returns out (B, Sq, H, Dh)
    in q's type, and with ``return_lse`` (out, lse): lse (B, H, Sq) f32,
    the row log-sum-exp of the scaled scores in natural-log units.
    """
    B, Sq, H, Dh, Skv, KH = _check_qkv("flash_attention", q, k, v)
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_attention", q, k, v)
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = build.lib().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), _DTYPE_CODE[q.dtype], B,
        Sq, Skv, H, KH, Dh, int(bool(causal)), int(window), int(q_offset),
        float(scale), torch._C._cuda_getCurrentRawStream(q.get_device()))
    _raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# flash-attention backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal=True,
                             window=0, softmax_scale=None):
    """dQ, dK and dV of the attention forward on the card.

    q, out, dout: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh); one type (f32 or
    bf16), contiguous, 16-byte aligned; lse: (B, H, Sq) f32 from
    ``flash_attention_cuda(..., return_lse=True)``.  First D = rowsum(dO o
    O); then bf16 runs ``flash_bwd_wgmma`` (wgmma on TMA-fed tiles, the
    dK/dV and the dQ CTAs in one launch), f32 the exact SIMT kernels (dK
    and dV, then dQ); the call is counted as one launch.  Queries start at
    position 0 (no query
    offset: training's case).  Returns (dq, dk, dv) in q's type, f32
    accumulation, the same bits from run to run.
    """
    name = "flash_attention_bwd"
    B, Sq, H, Dh, Skv, KH = _check_qkv(name, q, k, v)
    _check(name, out, dout, dtype=q.dtype)
    _check(name, lse, dtype=torch.float32)
    if (out.shape != q.shape or dout.shape != q.shape
            or tuple(lse.shape) != (B, H, Sq) or out.device != q.device
            or dout.device != q.device or lse.device != q.device):
        raise ValueError(f"{name}: q {tuple(q.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse.shape)}")
    _check_aligned(name, q, k, v, out, dout)
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = build.lib().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], B, Sq, Skv, H,
        KH, Dh, int(bool(causal)), int(window), float(scale),
        torch._C._cuda_getCurrentRawStream(q.get_device()))
    _raise_on(err, name)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention on the card with its hand-written gradient: the forward
    kernel keeps the row log-sum-exp, the backward kernel recomputes P
    from it.  apply(q, k, v, causal, window, softmax_scale) -> out."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softmax_scale):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window,
                                        softmax_scale=softmax_scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window,
                      softmax_scale=softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse,
                                              dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

# Positions of the chunks a split streams through shared memory (kChunk in
# csrc/paged_decode.cu), and the CTAs a decode launch aims at: two a
# streaming multiprocessor.  More splits cost more than they hide on a
# long context, because the last live split merges every partial alone.
DECODE_CHUNK = 64
DECODE_CTAS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS = {}  # (device, stream) -> int32 counters, zero between launches


def _tickets(device, stream, n):
    """Address of n zeroed int32 counters for the launches of one stream
    (each launch leaves them zero again)."""
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32,
                        device=torch.device("cuda", device))
        _TICKETS[(device, stream)] = t
    return t.data_ptr()


def decode_split(B, KH, P, ps, sms=132):
    """(cps, n_split) of the split decode, from shapes alone: a split owns
    cps chunks of DECODE_CHUNK positions, and n_split splits cover the
    table's P * ps positions, enough of them for about DECODE_CTAS_PER_SM
    * sms CTAs over the (KV head, request) pairs."""
    n_chunks = max(1, -(-P * ps // DECODE_CHUNK))
    want = max(1, -(-DECODE_CTAS_PER_SM * sms // max(B * KH, 1)))
    cps = -(-n_chunks // min(n_chunks, want))
    return cps, -(-n_chunks // cps)


def paged_decode_split_plain(q, k_pages, v_pages, page_table, kv_len, *,
                             span, softmax_scale=None):
    """Plain version of the kernel's split pass: each run of ``span``
    positions of every request gives its partial (acc (B, KH, n_split, G,
    Dh) f32, not divided by l; m, l (B, KH, n_split, G) f32).  A split
    with nothing live: acc 0, m -1e30, l 0 (the kernel skips it)."""
    B, _, H, Dh = q.shape
    KH = k_pages.shape[2]
    G = H // KH
    k = gather_kv_pages(k_pages, page_table).float()  # (B, T, KH, Dh)
    v = gather_kv_pages(v_pages, page_table).float()
    T = k.shape[1]
    n_split = max(1, -(-T // span))
    pad = n_split * span - T
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    k = k.reshape(B, n_split, span, KH, Dh)
    v = v.reshape(B, n_split, span, KH, Dh)
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    qf = (q.float() * scale).to(q.dtype).float().reshape(B, KH, G, Dh)
    s = torch.einsum("bkgd,bnjkd->bkngj", qf, k)
    pos = torch.arange(n_split * span, device=q.device).reshape(n_split,
                                                                span)
    n_live = torch.clamp_max(kv_len.long(), T)  # the table holds T at most
    live = (pos[None] < n_live[:, None, None])[:, None, :, None, :]
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bkngj,bnjkd->bkngd", p.to(v_pages.dtype).float(), v)
    return acc, m, p.sum(dim=-1)


def paged_decode_merge_plain(acc, m, l, dtype):
    """Plain version of the kernel's merge (its last live split of each
    (request, KV head)): the partials of ``paged_decode_split_plain`` ->
    (out (B, 1, H, Dh) in ``dtype``, m, l (B, 1, KH, G) f32).  With
    nothing live, exactly out 0, m -1e30 and l 1e-20."""
    B, KH, _, G, Dh = acc.shape
    M = m.amax(dim=2)  # (B, KH, G)
    w = torch.exp(m - M[:, :, None])
    L = torch.clamp_min((l * w).sum(dim=2), 1e-20)
    out = (acc * w[..., None]).sum(dim=2) * (1.0 / L)[..., None]
    return (out.reshape(B, 1, KH * G, Dh).to(dtype), M[:, None],
            L[:, None])


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_len, *,
                                 softmax_scale=None):
    """Plain version of the decode kernel: ``gather_kv_pages`` then the
    direct-form decode of ``ref.decode_attention_jnp``, with its stats."""
    k = gather_kv_pages(k_pages, page_table)
    v = gather_kv_pages(v_pages, page_table)
    return decode_attention_direct(q, k, v, kv_len=kv_len,
                                   softmax_scale=softmax_scale,
                                   return_stats=True)


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, kv_len, *,
                                softmax_scale=None):
    """Decode attention over the paged pool on the card.

    q: (B, 1, H, Dh); k_pages, v_pages: (NP, ps, KH, Dh) in q's type (f32
    or bf16; rows of a multiple of 16 bytes, 16-byte aligned); page_table:
    (B, P) int32; kv_len: (B,) int32.  Returns (out (B, 1, H, Dh), m
    (B, 1, KH, G) f32, l (B, 1, KH, G) f32), the contract of
    ``decode_attention_combine``.  The split over the KV length comes from
    the shapes: nothing of kv_len or page_table is read on the host.
    """
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"paged_decode_attention: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODE)}")
    _check("paged_decode_attention", q, k_pages, v_pages, dtype=q.dtype)
    _check("paged_decode_attention", page_table, kv_len, dtype=torch.int32)
    if page_table.device != q.device or kv_len.device != q.device:
        raise ValueError("paged_decode_attention: page_table and kv_len must "
                         "be on q's device")
    B, Sq, H, Dh = q.shape
    NP, ps, KH, Dk = k_pages.shape
    if (Sq != 1 or k_pages.shape != v_pages.shape or Dk != Dh or H % KH
            or page_table.ndim != 2 or page_table.shape[0] != B
            or tuple(kv_len.shape) != (B,)):
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, page_table "
            f"{tuple(page_table.shape)}, kv_len {tuple(kv_len.shape)}")
    if (Dh * q.element_size()) % 16:
        raise ValueError(f"paged_decode_attention: rows of {Dh} "
                         f"{q.dtype} elements are not a multiple of 16 "
                         f"bytes")
    _check_aligned("paged_decode_attention", q, k_pages, v_pages)
    G = H // KH
    P = page_table.shape[1]
    dev = q.get_device()
    cps, n_split = decode_split(B, KH, P, ps, _sm_count(dev))
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    out = torch.empty_like(q)
    m, l = torch.empty((2, B, 1, KH, G), dtype=torch.float32,
                       device=q.device).unbind(0)
    # scratch: acc (B, KH, n_split, G, Dh), then m and l (B, KH, n_split, G)
    n_part = B * KH * n_split * G
    part = torch.empty(n_part * (Dh + 2), dtype=torch.float32,
                       device=q.device)
    p_acc = part.data_ptr()
    p_m = p_acc + 4 * n_part * Dh
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = build.lib().repro_paged_decode_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), p_acc, p_m, p_m + 4 * n_part,
        _tickets(dev, stream, B * KH), _DTYPE_CODE[q.dtype], B, H, KH, Dh,
        ps, P, cps, n_split, float(scale), stream)
    _raise_on(err, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out, m, l

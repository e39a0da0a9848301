"""Attention kernels for Hopper and their plain versions.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (the port of
``repro/kernels/flash_attention.py:flash_attention_pallas``) and
``paged_decode_attention_cuda`` launches ``csrc/paged_decode.cu`` (the port
of ``paged_decode_attention_pallas``).  Each sits beside its plain PyTorch
version, which computes the same function with the reference's oracles.

A wrapper takes CUDA tensors only: it checks device, type, shape and
contiguity, allocates its outputs, launches on the current stream, raises
if the launch failed, and adds one to its entry of ``LAUNCHES``.  Layouts
are the reference's: q (B, S, H, Dh), k/v (B, S, KH, Dh), pages
(NP, ps, KH, Dh).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (decode_attention_direct,
                                     flash_attention_blockwise,
                                     gather_kv_pages)

# Launches of each kernel since the last reset_launches(); a plain integer
# per kernel, bumped only where the kernel is launched.
LAUNCHES = {"flash_attention": 0, "paged_decode_attention": 0}

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


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# flash-attention prefill
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0,
                          softmax_scale=None):
    """Plain version of the prefill kernel: ``ref.flash_attention_jnp``."""
    return flash_attention_blockwise(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset,
                                     softmax_scale=softmax_scale)


def flash_attention_cuda(q, k, v, *, causal=True, window=0, q_offset=0,
                         softmax_scale=None):
    """Blockwise attention forward on the card.

    q: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh); f32 or bf16, contiguous;
    Dh in FLASH_HEAD_DIMS.  Any Sq and Skv (the ragged edge is masked in
    the kernel).  Returns out (B, Sq, H, Dh) in q's type.
    """
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODE)}")
    _check("flash_attention", q, k, v, dtype=q.dtype)
    B, Sq, H, Dh = q.shape
    Bk, Skv, KH, Dk = k.shape
    if k.shape != v.shape or Bk != B or Dk != Dh or H % KH:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {Dh} not in "
                         f"{FLASH_HEAD_DIMS}")
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    out = torch.empty_like(q)
    err = build.lib().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], B, Sq, Skv, H, KH, Dh, int(bool(causal)),
        int(window), int(q_offset), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

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
    or bf16); page_table: (B, P) int32; kv_len: (B,) int32.  Returns
    (out (B, 1, H, Dh), m (B, 1, KH, G) f32, l (B, 1, KH, G) f32), the
    contract of ``decode_attention_combine``.
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
    G = H // KH
    P = page_table.shape[1]
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    out = torch.empty_like(q)
    m = torch.empty((B, 1, KH, G), dtype=torch.float32, device=q.device)
    l = torch.empty((B, 1, KH, G), dtype=torch.float32, device=q.device)
    err = build.lib().repro_paged_decode_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), _DTYPE_CODE[q.dtype], B, H, KH, Dh, ps,
        P, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out, m, l

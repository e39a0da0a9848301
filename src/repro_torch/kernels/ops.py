"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors (port of ``repro/kernels/ops.py``).

Every op takes ``impl`` in {None, "kernel", "plain"} (plus "ref" for
flash attention, top-k, the SSD scan and the wire encodes); None picks by the device of the first
tensor, as the reference's ``_route`` picks by backend.  ``impl="plain"`` runs the plain
version on any device (the card-side comparison uses it); ``impl="kernel"``
on a CPU tensor raises.  Nothing catches a kernel's failure and falls back.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    FlashAttention, flash_attention_cuda, flash_attention_plain,
    paged_decode_attention_cuda, paged_decode_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_plain
from repro_torch.kernels.topk_compress import (
    compress_with, leaves_with, topk_compress_cuda, topk_compress_leaves_cuda,
    topk_compress_leaves_plain, topk_compress_plain)
from repro_torch.kernels.wire_pack import (
    decode_mix_cuda, decode_mix_plain, encode_blocks_cuda,
    encode_blocks_plain, encode_rows_cuda, encode_rows_plain,
    pack_offsets_cuda, pack_offsets_plain, pad_rows, unpack_offsets_cuda,
    unpack_offsets_plain)


def _route(impl, x):
    if impl in ("kernel", "plain", "ref"):
        return impl
    if impl is not None:
        raise ValueError(f"impl {impl!r} not in (None, 'kernel', 'plain', "
                         f"'ref')")
    return "kernel" if x.is_cuda else "plain"


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_len=None, softmax_scale=None, impl=None):
    """Attention forward (port of ``ops.py:31``).  On the card the kernel;
    where autograd records (a training forward) it goes through
    ``FlashAttention``, which keeps the row log-sum-exp for the backward
    kernel, and a forward under ``torch.no_grad`` (the serve) does not pay
    for it.  On the CPU the plain blockwise version, differentiated by
    autograd, as ``ssd`` is."""
    r = _route(impl, q)
    if r == "kernel" and kv_len is None:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            if q_offset:
                raise ValueError("flash_attention: the backward kernel "
                                 "takes no q_offset (training attends from "
                                 "position 0)")
            return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal, window,
                                        softmax_scale)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset,
                                    softmax_scale=softmax_scale)
    if r == "ref":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len,
                                 softmax_scale=softmax_scale)
    if r == "kernel":
        raise ValueError("flash_attention: the kernel takes no kv_len "
                         "(use impl='plain')")
    return ref.flash_attention_blockwise(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        kv_len=kv_len, softmax_scale=softmax_scale)


def decode_attention_combine(q, out_old, m_old, l_old, k_new, v_new, *,
                             softmax_scale=None):
    return ref.decode_attention_combine(q, out_old, m_old, l_old, k_new,
                                        v_new, softmax_scale=softmax_scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len, *,
                           softmax_scale=None, impl=None):
    """Decode attention over the paged KV pool.  Returns (out, m, l) so the
    caller folds the current token's (k, v) in with
    ``decode_attention_combine`` and the page write stays write-only.

    Only the dense-type, gathered case is ported (the reference's kernel
    case at ops.py:84); int8 KV and ``contiguous=True`` are not.
    """
    if _route(impl, q) == "kernel":
        return paged_decode_attention_cuda(q, k_pages, v_pages, page_table,
                                           kv_len,
                                           softmax_scale=softmax_scale)
    if impl == "ref":
        raise ValueError("paged_decode_attention has no 'ref' impl")
    return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                        kv_len, softmax_scale=softmax_scale)


def ssd(x, dt, A, B, C, *, chunk=64, impl=None):
    """y of the Mamba2 SSD scan (port of ``ops.py:100``).  x: (b, s, h, p);
    dt: (b, s, h) f32; A: (h,) f32; B, C: (b, s, g, n).  The kernels on
    the card, differentiable through the hand-written backward; the plain
    chunked version (autograd through it) on the CPU; ``impl="ref"`` the
    sequential oracle."""
    r = _route(impl, x)
    if r == "kernel":
        return ssd_cuda(x, dt, A, B, C, chunk=chunk)
    if r == "ref":
        return ref.ssd_ref(x, dt, A, B, C)[0]
    return ssd_plain(x, dt, A, B, C, chunk=chunk)


def topk_compress(x, theta, *, block=1024, impl=None, ef=None, out=None):
    """Q(x + ef) per (row, block) (port of ``ops.py:111``).  x, ef: (R, L);
    theta: (R,) float32.  Returns (masked, residual): the kernel or its
    plain version (bisection), or with ``impl="ref"`` the exact-sort
    oracle; all add ef in f32 before masking.  ``out=(masked, residual)``
    writes the results there (they may be x and ef themselves)."""
    r = _route(impl, x)
    if r == "kernel":
        return topk_compress_cuda(x, theta, ef=ef, block=block, out=out)
    if r == "plain":
        res = topk_compress_plain(x, theta, ef=ef, block=block)
    else:
        res = compress_with(ref.topk_mask_exact, x, theta, ef=ef,
                            block=block)
    if out is None:
        return res
    for o, v in zip(out, res):
        o.copy_(v)
    return out


def topk_compress_leaves(xs, theta, *, block=1024, efs=None, outs=None,
                         impl=None):
    """``topk_compress`` on every leaf of ``xs`` ((R, L_i), any L_i; a
    leaf whose L_i is not a multiple of the block compressed as the
    reference's ``compress_delta`` pads it).  The kernel on the card, one
    launch per (x type, ef type) pair of the table; its plain version (the
    per-leaf loop, padded) on the CPU; ``impl="ref"`` the exact-sort
    oracle leaf by leaf.  ``efs``: None or one tensor a leaf; ``outs``:
    each leaf's (masked, residual), which may be the leaf and its ef.
    Returns [(masked, residual)]."""
    if not xs:
        return []
    r = _route(impl, xs[0])
    if r == "kernel":
        return topk_compress_leaves_cuda(xs, theta, block=block, efs=efs,
                                         outs=outs)
    if r == "plain":
        res = topk_compress_leaves_plain(xs, theta, block=block, efs=efs)
    else:
        res = leaves_with(functools.partial(compress_with,
                                            ref.topk_mask_exact),
                          xs, theta, block=block, efs=efs)
    if outs is None:
        return res
    for out, got in zip(outs, res):
        for o, v in zip(out, got):
            o.copy_(v)
    return list(outs)


def encode_blocks(xb, k_b, *, wire_dtype, impl=None):
    """The fused wire encode (port of ``ops.py:155``): (m, nb, wb) f32 ->
    (vals, off, scale) with ascending offsets and the values quantized for
    the wire dtype.  The kernel on the card, its plain version (the same
    bisection) on the CPU; ``impl="ref"`` the exact top-k oracle, which is
    the reference's CPU route (``encode_blocks_jnp``)."""
    r = _route(impl, xb)
    if r == "kernel":
        return encode_blocks_cuda(xb, k_b, wire_dtype=wire_dtype)
    if r == "ref":
        return ref.encode_blocks_topk(xb, k_b, wire_dtype=wire_dtype)
    return encode_blocks_plain(xb, k_b, wire_dtype=wire_dtype)


def encode_rows(x, rows, k_b, *, wb, wire_dtype, omode="i32", impl=None):
    """The wire encode of rows ``rows`` (None: all) of x (C, L) f32 in
    wire blocks of ``wb``, the last one zero-padded: (vals, off, scale) of
    ``encode_blocks`` on those rows, the offsets in the form ``omode``:
    int32 ("i32"), or ``pack_offsets`` of them ("u8", "p4").  The kernel
    reads the rows where they lie and writes the packed form itself (one
    launch); the plain version and ``impl="ref"`` (the exact top-k) select
    and pad the rows first and pack after."""
    r = _route(impl, x)
    if r == "kernel":
        return encode_rows_cuda(x, rows, k_b, wb=wb, wire_dtype=wire_dtype,
                                omode=omode)
    if r == "ref":
        vals, off, scale = ref.encode_blocks_topk(
            pad_rows(x, rows, wb), k_b, wire_dtype=wire_dtype)
    else:
        vals, off, scale = encode_rows_plain(x, rows, k_b, wb=wb,
                                             wire_dtype=wire_dtype)
    if omode != "i32":
        off = pack_offsets_plain(off, wb=wb, mode=omode)
    return vals, off, scale


def wire_decode_mix(y, steps, *, wb, wire_dtype, diag=None, impl=None):
    """The gossip's decode and mix of one column chunk (no reference
    counterpart: the reference's ``wire_decode`` and adds in jnp): y (C,
    Lc) f32, times ``diag`` first where given, plus coef * decode of each
    ``wire_pack.MixStep`` in order; y itself is not written.  The kernel
    on the card (one launch per ``MIX_STEPS`` steps), its plain version
    (the zero fill, roll, decode and add chain) on the CPU; "ref" is
    "plain"."""
    if _route(impl, y) == "kernel":
        return decode_mix_cuda(y, steps, wb=wb, wire_dtype=wire_dtype,
                               diag=diag)
    return decode_mix_plain(y, steps, wb=wb, wire_dtype=wire_dtype,
                            diag=diag)


def pack_offsets(off, *, wb, mode, impl=None):
    """Ascending (m, nb, k_b) int32 offsets -> packed uint8 (port of
    ``ops.py:135``).  u8 is a cast; p4 is the kernel on the card.  The
    plain version is lossless, so "plain" and "ref" are one route."""
    if mode == "u8":
        return off.to(torch.uint8)
    if _route(impl, off) == "kernel":
        return pack_offsets_cuda(off, wb=wb)
    return pack_offsets_plain(off, wb=wb, mode=mode)


def unpack_offsets(packed, *, wb, k_b, mode, impl=None):
    """Packed uint8 -> (m, nb, k_b) int32 ascending offsets (port of
    ``ops.py:145``), the inverse of ``pack_offsets``."""
    if mode == "u8":
        return packed.to(torch.int32)
    if _route(impl, packed) == "kernel":
        return unpack_offsets_cuda(packed, wb=wb, k_b=k_b)
    return unpack_offsets_plain(packed, wb=wb, k_b=k_b, mode=mode)

"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors (port of ``repro/kernels/ops.py``).

Every op takes ``impl`` in {None, "kernel", "plain"} (plus "ref" for
flash attention and top-k); None picks by the device of the first
tensor, as the reference's ``_route`` picks by backend.  ``impl="plain"`` runs the plain
version on any device (the card-side comparison uses it); ``impl="kernel"``
on a CPU tensor raises.  Nothing catches a kernel's failure and falls back.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda, flash_attention_plain, paged_decode_attention_cuda,
    paged_decode_attention_plain)
from repro_torch.kernels.topk_compress import (compress_with,
                                               topk_compress_cuda,
                                               topk_compress_plain)


def _route(impl, x):
    if impl in ("kernel", "plain", "ref"):
        return impl
    if impl is not None:
        raise ValueError(f"impl {impl!r} not in (None, 'kernel', 'plain', "
                         f"'ref')")
    return "kernel" if x.is_cuda else "plain"


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_len=None, softmax_scale=None, impl=None):
    r = _route(impl, q)
    if r == "kernel" and kv_len is None:
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


def topk_compress(x, theta, *, block=1024, impl=None, ef=None):
    """Q(x + ef) per (row, block) (port of ``ops.py:111``).  x, ef: (R, L);
    theta: (R,) float32.  Returns (masked, residual): the kernel or its
    plain version (bisection), or with ``impl="ref"`` the exact-sort
    oracle; all add ef in f32 before masking."""
    r = _route(impl, x)
    if r == "kernel":
        return topk_compress_cuda(x, theta, ef=ef, block=block)
    if r == "plain":
        return topk_compress_plain(x, theta, ef=ef, block=block)
    return compress_with(ref.topk_mask_exact, x, theta, ef=ef, block=block)

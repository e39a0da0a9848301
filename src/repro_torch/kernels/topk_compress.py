"""Block top-k compression Q with fused error feedback, on the card, and
its plain version.

``topk_compress_cuda`` launches ``csrc/topk_compress.cu``, the port of
``repro/kernels/topk_compress.py:topk_compress_pallas``;
``topk_compress_plain`` computes the same function with
``ref.topk_mask_bisect`` (the reference's ``ops.topk_compress`` jnp
route, op for op), and is what the CPU runs and what the kernel is held
against, bit for bit.

The wrapper takes CUDA tensors only: it checks device, type, shape and
contiguity, allocates its outputs, launches on the current stream, raises
if the launch failed, and adds one to ``LAUNCHES["topk_compress"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import topk_mask_bisect

# Launches since the last reset_launches(), bumped only where the kernel
# is launched.
LAUNCHES = {"topk_compress": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh


def reset_launches() -> None:
    LAUNCHES["topk_compress"] = 0


def _resid_dtype(x, ef):
    return x.dtype if ef is None else ef.dtype


def compress_with(mask_fn, x, theta, *, ef=None, block=1024):
    """Q(x + ef) with a block mask function (``ref.topk_mask_bisect`` or
    ``ref.topk_mask_exact``), as the reference's ``ops.topk_compress``
    computes it: ef added in f32, masked cast to x's type, the residual
    to ef's type (x's without ef)."""
    xf = x.float()
    if ef is not None:
        xf = xf + ef.float()
    masked, keep = mask_fn(xf, theta[:, None], block=block)
    # where(keep, 0, xf) is xf - masked bit for bit (ops.py:131)
    resid = torch.where(keep, torch.zeros((), device=x.device), xf)
    return masked.to(x.dtype), resid.to(_resid_dtype(x, ef))


def topk_compress_plain(x, theta, *, ef=None, block=1024):
    """x, ef: (R, L), L % block == 0; theta: (R,) f32.  Returns (masked,
    residual) with masked + residual == x + ef, summed in f32."""
    return compress_with(topk_mask_bisect, x, theta, ef=ef, block=block)


def topk_compress_cuda(x, theta, *, ef=None, block=1024):
    """The kernel.  x: (R, L) f32 or bf16; ef: None, x's type or f32;
    theta: (R,) f32; block a multiple of 32 in [32, 1024] dividing L; all
    contiguous on one CUDA device."""
    tensors = [x, theta] + ([] if ef is None else [ef])
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"topk_compress: CUDA kernel given a tensor on "
                             f"{t.device}; the plain version serves the CPU")
        if t.device != x.device:
            raise ValueError(f"topk_compress: tensors on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"topk_compress: tensor of shape "
                             f"{tuple(t.shape)} is not contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"topk_compress: x dtype {x.dtype} not in "
                         f"{tuple(_DTYPE_CODE)}")
    if ef is not None and ef.dtype not in (x.dtype, torch.float32):
        raise ValueError(f"topk_compress: ef dtype {ef.dtype} is neither "
                         f"x's ({x.dtype}) nor float32")
    if theta.dtype != torch.float32:
        raise ValueError(f"topk_compress: theta dtype {theta.dtype}, "
                         f"expected float32 (k is computed in f32)")
    if x.ndim != 2:
        raise ValueError(f"topk_compress: x of shape {tuple(x.shape)}, "
                         f"expected (R, L)")
    R, L = x.shape
    if tuple(theta.shape) != (R,) or (ef is not None and ef.shape != x.shape):
        raise ValueError(f"topk_compress: x {tuple(x.shape)}, theta "
                         f"{tuple(theta.shape)}, ef "
                         f"{None if ef is None else tuple(ef.shape)}")
    if block % 32 or not 32 <= block <= 1024 or L % block:
        raise ValueError(f"topk_compress: block {block} must be a multiple "
                         f"of 32 in [32, 1024] dividing L = {L}")
    masked = torch.empty_like(x)
    resid = torch.empty(x.shape, dtype=_resid_dtype(x, ef), device=x.device)
    err = build.lib().repro_topk_compress(
        x.data_ptr(), None if ef is None else ef.data_ptr(),
        theta.data_ptr(), masked.data_ptr(), resid.data_ptr(),
        _DTYPE_CODE[x.dtype], -1 if ef is None else _DTYPE_CODE[ef.dtype],
        R, L, block, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_compress kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["topk_compress"] += 1
    return masked, resid

"""Block top-k compression Q with fused error feedback, on the card, and
its plain version.

``topk_compress_leaves_cuda`` launches ``csrc/topk_compress.cu``, the port
of ``repro/kernels/topk_compress.py:topk_compress_pallas``, once over every
leaf of a table that shares an (x, ef) type pair; ``topk_compress_cuda`` is
its one-leaf case.  A leaf whose L is not a multiple of the block is
compressed as if zero-padded to it (the reference's ``compress_delta``
pads, compresses and slices), with nothing padded or copied.  The plain
versions compute the same functions: ``topk_compress_plain`` with
``ref.topk_mask_bisect`` (the reference's ``ops.topk_compress`` jnp route,
op for op), and ``topk_compress_leaves_plain`` leaf by leaf, padded as the
reference pads.  They are what the CPU runs and what the kernel is held
against, bit for bit.

The wrappers take CUDA tensors only: they check device, type, shape and
contiguity, allocate the outputs, launch on the current stream, raise if
a launch failed, and add one to ``LAUNCHES["topk_compress"]`` a launch.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import topk_mask_bisect

# Launches since the last reset_launches(), bumped only where the kernel
# is launched.
LAUNCHES = {"topk_compress": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh
MAX_LEAVES = 64  # leaves a launch takes as kernel parameters


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


def leaves_with(compress, xs, theta, *, block=1024, efs=None):
    """``compress`` (``topk_compress_plain`` or an oracle of its
    signature) on each (R, L) leaf: a leaf whose L is not a multiple of
    the block is zero-padded to it and the results sliced back, as the
    reference's ``compress_delta`` does (compression.py:36-42)."""
    out = []
    for i, x in enumerate(xs):
        ef = None if efs is None else efs[i]
        L = x.shape[1]
        pad = (-L) % block
        if not pad:
            out.append(compress(x, theta, ef=ef, block=block))
            continue
        masked, resid = compress(
            F.pad(x, (0, pad)), theta, block=block,
            ef=None if ef is None else F.pad(ef, (0, pad)))
        out.append((masked[:, :L], resid[:, :L]))
    return out


def topk_compress_leaves_plain(xs, theta, *, block=1024, efs=None):
    """The grouped kernel's function: [(masked, residual)] of each leaf of
    ``xs`` ((R, L_i), any L_i), leaf by leaf and padded as the reference
    pads."""
    return leaves_with(topk_compress_plain, xs, theta, block=block, efs=efs)


class _TopkLeaf(ctypes.Structure):  # csrc/topk_compress.cu:TopkLeaf
    _fields_ = [("x", ctypes.c_void_p), ("ef", ctypes.c_void_p),
                ("masked", ctypes.c_void_p), ("resid", ctypes.c_void_p),
                ("L", ctypes.c_longlong), ("pair0", ctypes.c_int),
                ("nb", ctypes.c_int)]


class _TopkArgs(ctypes.Structure):  # csrc/topk_compress.cu:TopkArgs
    _fields_ = [("theta", ctypes.c_void_p), ("R", ctypes.c_int),
                ("pairs", ctypes.c_int), ("block", ctypes.c_int),
                ("nleaves", ctypes.c_int),
                ("leaf", _TopkLeaf * MAX_LEAVES)]


def _check_leaf(x, ef, out, theta):
    """Checks one leaf against theta (the card's device); returns its
    (masked, resid), allocated where ``out`` is None."""
    dev = theta.device
    for t in (x, ef) + tuple(out or ()):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(
                f"topk_compress: CUDA kernel given a tensor on {t.device}; "
                f"the plain version serves the CPU" if not t.is_cuda else
                f"topk_compress: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"topk_compress: tensor of shape "
                             f"{tuple(t.shape)} is not contiguous")
    rd = x.dtype if ef is None else ef.dtype
    if x.dtype not in _DTYPE_CODE or rd not in (x.dtype, torch.float32):
        raise ValueError(f"topk_compress: x dtype {x.dtype} not in "
                         f"{tuple(_DTYPE_CODE)}, or ef dtype {rd} neither "
                         f"x's nor float32")
    if x.ndim != 2 or x.shape[0] != theta.shape[0] or (
            ef is not None and ef.shape != x.shape):
        raise ValueError(f"topk_compress: x {tuple(x.shape)}, theta "
                         f"{tuple(theta.shape)}, ef "
                         f"{None if ef is None else tuple(ef.shape)}")
    if out is None:
        return (torch.empty_like(x),
                torch.empty(x.shape, dtype=rd, device=dev))
    masked, resid = out
    if (masked.shape != x.shape or resid.shape != x.shape
            or masked.dtype != x.dtype or resid.dtype != rd):
        raise ValueError(f"topk_compress: out {tuple(masked.shape)} "
                         f"{masked.dtype}, {tuple(resid.shape)} "
                         f"{resid.dtype} for x {tuple(x.shape)} {x.dtype}")
    return masked, resid


def topk_compress_leaves_cuda(xs, theta, *, block=1024, efs=None,
                              outs=None):
    """The kernel over a table of leaves: ``topk_compress_leaves_plain``'s
    result, bit for bit.  xs: (R, L_i) f32 or bf16 tensors, any L_i; efs:
    None or one tensor a leaf, of its x's type or f32; theta: (R,) f32;
    block a multiple of 32 in [32, 1024]; all contiguous on one CUDA
    device.  ``outs`` gives each leaf's (masked, resid) (x's type, and
    ef's or x's); they may be x and ef themselves, since each warp reads
    its block whole before it writes it.  One launch per (x type, ef
    type) pair of the table and MAX_LEAVES leaves; the table goes into
    the kernel's parameters, so nothing is copied to the card."""
    if not theta.is_cuda:
        raise ValueError(f"topk_compress: CUDA kernel given a tensor on "
                         f"{theta.device}; the plain version serves the CPU")
    if theta.dtype != torch.float32 or theta.ndim != 1:
        raise ValueError(f"topk_compress: theta {theta.dtype} "
                         f"{tuple(theta.shape)}, expected (R,) float32 (k "
                         f"is computed in f32)")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"topk_compress: block {block} must be a multiple "
                         f"of 32 in [32, 1024]")
    n = len(xs)
    efs = [None] * n if efs is None else list(efs)
    if len(efs) != n or (outs is not None and len(outs) != n):
        raise ValueError(f"topk_compress: {n} leaves, {len(efs)} efs, "
                         f"{None if outs is None else len(outs)} outs")
    res = [_check_leaf(xs[i], efs[i], None if outs is None else outs[i],
                       theta) for i in range(n)]
    groups = {}
    for i in range(n):
        e = efs[i]
        groups.setdefault((xs[i].dtype, None if e is None else e.dtype),
                          []).append(i)
    lib = build.lib()
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    R = theta.shape[0]
    for (xd, ed), idx in groups.items():
        for i0 in range(0, len(idx), MAX_LEAVES):
            part = idx[i0:i0 + MAX_LEAVES]
            a = _TopkArgs(theta=theta.data_ptr(), R=R, block=block,
                          nleaves=len(part))
            pairs = 0
            for leaf, i in zip(a.leaf, part):
                L = xs[i].shape[1]
                leaf.x = xs[i].data_ptr()
                leaf.ef = None if efs[i] is None else efs[i].data_ptr()
                leaf.masked = res[i][0].data_ptr()
                leaf.resid = res[i][1].data_ptr()
                leaf.L = L
                leaf.pair0 = pairs
                leaf.nb = -(-L // block)
                pairs += R * leaf.nb
            if pairs > 2**31 - 9:
                raise ValueError(f"topk_compress: {pairs} (row, block) "
                                 f"pairs in one launch; at most 2^31 - 9")
            a.pairs = pairs
            err = lib.repro_topk_compress_leaves(
                ctypes.addressof(a), ctypes.sizeof(a), _DTYPE_CODE[xd],
                -1 if ed is None else _DTYPE_CODE[ed], stream)
            if err != 0:
                raise RuntimeError(f"topk_compress kernel launch failed: "
                                   f"cudaError {err}")
            LAUNCHES["topk_compress"] += 1
    return res


def topk_compress_cuda(x, theta, *, ef=None, block=1024, out=None):
    """The kernel on one leaf x (R, L): ``topk_compress_leaves_cuda`` on a
    table of one, so one launch.  With L a multiple of the block it is
    ``topk_compress_plain``'s result, bit for bit."""
    return topk_compress_leaves_cuda(
        [x], theta, block=block, efs=None if ef is None else [ef],
        outs=None if out is None else [out])[0]

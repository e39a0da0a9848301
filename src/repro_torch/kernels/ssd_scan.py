"""The Mamba2 SSD chunked scan on the card, forward and backward, and their
plain versions.

``ssd_fwd_cuda`` launches the forward of ``csrc/ssd_scan.cu``, the port of
``repro/kernels/ssd_scan.py:ssd_pallas``; ``ssd_bwd_cuda`` launches its
backward, which the reference does not have (``jax.grad`` through the
Pallas kernel fails; ROADMAP.md section 3).  ``ssd_cuda`` binds the two as
one ``torch.autograd.Function``: the forward keeps the state at the start
of every chunk for the backward.  ``ssd_plain`` is
``ref.ssd_chunked`` (the reference's ``ssd_chunked_jnp``), and the plain
backward is autograd through it: what the CPU runs and what the kernels
are held against.  ``ref.ssd_fwd_stages`` and ``ref.ssd_bwd_stages`` are
the same scan in the stages the bf16 kernels run, for the tests.

Each C entry chooses its kernels by dtype and shape (``plan``): bf16 with
p and n multiples of 8 and at most 8 heads a group runs the tensor-core
kernels (several launches a call), everything else the SIMT kernels.

The wrappers take CUDA tensors only: they check device, type, shape,
contiguity and 16-byte alignment, allocate outputs and scratch, launch on
the current stream, raise if a launch failed, and add one to
``LAUNCHES["ssd_scan_fwd"]`` or ``LAUNCHES["ssd_scan_bwd"]`` a call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_chunked

LAUNCHES = {"ssd_scan_fwd": 0, "ssd_scan_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh
MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 256  # csrc/ssd_scan.cu


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name, x, dt, A, B, C, chunk, extra=()):
    """Validate the inputs the kernels take; return (b, s, h, p, g, n)."""
    for t in (x, dt, A, B, C, *extra):
        if not t.is_cuda:
            raise ValueError(f"{name}: CUDA kernel given a tensor on "
                             f"{t.device}; the plain version serves the CPU")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             f"not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             f"not 16-byte aligned")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"{name}: x, B, C dtypes {x.dtype}, {B.dtype}, "
                         f"{C.dtype}: one of {tuple(_DTYPE_CODE)} for all")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"{name}: dt and A must be float32, got {dt.dtype}"
                         f" and {A.dtype}")
    if x.ndim != 4 or B.ndim != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)}, B {tuple(B.shape)}: "
                         f"expected (b, s, h, p) and (b, s, g, n)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape[:2]) != (b, s) or C.shape != B.shape):
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    if h % g or p > MAX_HEAD_DIM or n > MAX_STATE or not 1 <= chunk <= \
            MAX_CHUNK:
        raise ValueError(f"{name}: needs g | h, p <= {MAX_HEAD_DIM}, n <= "
                         f"{MAX_STATE}, 1 <= chunk <= {MAX_CHUNK}; got h={h}"
                         f" g={g} p={p} n={n} chunk={chunk}")
    return b, s, h, p, g, n


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


class Plan(NamedTuple):
    """What a call runs, as ``csrc/ssd_scan.cu:repro_ssd_plan`` decides it
    by dtype and shape."""
    route: str      # "tc" (the tensor-core kernels) or "simt"
    launches: int   # kernel launches a call
    scratch: int    # f32 values of scratch a call needs


@functools.lru_cache(maxsize=None)
def plan(dtype, b, s, h, p, g, n, chunk, *, backward=False):
    """The ``Plan`` of a forward or backward call of these shapes (asked of
    the C side once a shape)."""
    out = (ctypes.c_longlong * 3)()
    err = build.lib().repro_ssd_plan(_DTYPE_CODE[dtype], b, s, h, p, g, n,
                                     chunk, int(backward), out)
    if err != 0:
        raise ValueError(f"ssd: shapes the kernels do not take (cudaError "
                         f"{err}): b={b} s={s} h={h} p={p} g={g} n={n} "
                         f"chunk={chunk}")
    return Plan(("simt", "tc")[out[0]], out[1], out[2])


def _scratch(x, n):
    return torch.empty(max(n, 1), dtype=torch.float32, device=x.device)


def _aligned(t):
    """t, or a copy of it if its data is not 16-byte aligned (a view into
    a larger tensor): the kernels copy rows 16 bytes at a time."""
    return t.clone() if t.data_ptr() % 16 else t


def ssd_fwd_cuda(x, dt, A, B, C, *, chunk=64):
    """The forward kernel.  x: (b, s, h, p); dt: (b, s, h) f32; A: (h,)
    f32; B, C: (b, s, g, n) of x's type (f32 or bf16).  Returns y (x's
    shape and type) and the state at the start of each chunk, (b, h, nc,
    p, n) f32."""
    b, s, h, p, g, n = _check("ssd_fwd", x, dt, A, B, C, chunk)
    nc = -(-s // chunk)
    y = torch.empty_like(x)
    states = torch.empty((b, h, nc, p, n), dtype=torch.float32,
                         device=x.device)
    scratch = _scratch(x, plan(x.dtype, b, s, h, p, g, n, chunk).scratch)
    err = build.lib().repro_ssd_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), states.data_ptr(), scratch.data_ptr(),
        scratch.numel(), _DTYPE_CODE[x.dtype], b, s, h, p, g, n, chunk,
        _stream(x))
    if err != 0:
        raise RuntimeError(f"ssd forward kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["ssd_scan_fwd"] += 1
    return y, states


def ssd_bwd_cuda(dy, x, dt, A, B, C, states, *, chunk=64):
    """The backward kernel: the gradients of sum(y * dy) with respect to
    (x, dt, A, B, C), in their types; ``states`` as ``ssd_fwd_cuda``
    returned them."""
    b, s, h, p, g, n = _check("ssd_bwd", x, dt, A, B, C, chunk,
                              extra=(dy, states))
    nc = -(-s // chunk)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} {dy.dtype}, x "
                         f"{tuple(x.shape)} {x.dtype}")
    if (tuple(states.shape) != (b, h, nc, p, n)
            or states.dtype != torch.float32):
        raise ValueError(f"ssd_bwd: states {tuple(states.shape)} "
                         f"{states.dtype}, expected {(b, h, nc, p, n)} f32")
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA, dB, dC = torch.empty_like(A), torch.empty_like(B), torch.empty_like(C)
    scratch = _scratch(x, plan(x.dtype, b, s, h, p, g, n, chunk,
                               backward=True).scratch)
    err = build.lib().repro_ssd_bwd(
        dy.data_ptr(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(), states.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        scratch.data_ptr(), scratch.numel(), _DTYPE_CODE[x.dtype], b, s, h,
        p, g, n, chunk, _stream(x))
    if err != 0:
        raise RuntimeError(f"ssd backward kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, states = ssd_fwd_cuda(x, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C, states = ctx.saved_tensors
        grads = ssd_bwd_cuda(_aligned(dy.contiguous()), x, dt, A, B, C,
                             states, chunk=ctx.chunk)
        return (*grads, None)


def ssd_cuda(x, dt, A, B, C, *, chunk=64):
    """y of the SSD scan through the kernels, differentiable: the forward
    kernel now, the backward kernel when autograd asks for gradients."""
    return _SSD.apply(*(_aligned(t.contiguous()) for t in (x, dt, A, B, C)),
                      chunk)


def ssd_plain(x, dt, A, B, C, *, chunk=64):
    """y of ``ref.ssd_chunked``; autograd through it is the plain
    backward."""
    return ssd_chunked(x, dt, A, B, C, chunk=chunk)[0]

"""The v2 gossip wire's kernels on the card, and their plain versions (port
of ``repro/kernels/wire_pack.py``).

Three functions, each a CUDA kernel in ``csrc/wire_pack.cu`` beside its
plain PyTorch version:

``encode_blocks``
  per wire block of ``wb`` f32 entries: a 16-step bisection of the
  magnitude threshold, exactly ``k_b`` entries kept (the threshold band
  filled in index order), the kept offsets compacted in ascending order,
  the block's max |x| as its scale, and the kept values quantized to the
  wire dtype (f32, bf16, int8, int4 nibbles two per byte, or fp8 e4m3
  bits).  Port of ``encode_blocks_pallas`` (``_encode_kernel``):
  ``encode_blocks_plain`` computes its function op for op.  The exact
  top-k (``ref.encode_blocks_topk``, the reference's ``encode_blocks_jnp``)
  may keep other members of a threshold band: entries within max|x| *
  2^-16 of the threshold are ties to the bisection.
``pack_offsets`` / ``unpack_offsets``
  ascending block-local offsets <-> the p4 bytes: the low nibbles two per
  byte, then the delta-unary bitmap with bit (off_i >> 4) + i set for kept
  entry i (bit b of byte j is position 8j + b).  Ports of
  ``pack_offsets_pallas`` / ``unpack_offsets_pallas``; the plain versions
  are the reference's ``pack_offsets_jnp`` / ``unpack_offsets_jnp``.  Both
  are lossless, and an all-zero payload (the zero fill of a partial
  rotation) decodes to offset 0.  The u8 mode is a cast, no kernel.

The wrappers take CUDA tensors only: they check device, type, shape and
contiguity, allocate the outputs, launch on the current stream, raise if
the launch failed, and add one to their entry of ``LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.core.wire_format import WIRE_DTYPES
from repro_torch.kernels import build

BISECT_ITERS = 16
_WIRE_CODE = {d: i for i, d in enumerate(WIRE_DTYPES)}  # csrc/wire_pack.cu
_VAL_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8, "int4": torch.uint8, "fp8": torch.uint8}
# the encode keeps a block's wb f32 entries in shared memory (227 KB)
MAX_ENCODE_BLOCK = 232448 // 4

# Launches since the last reset_launches(), bumped only where a kernel is
# launched.
LAUNCHES = {"wire_encode": 0, "wire_pack": 0, "wire_unpack": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _p4_sizes(wb: int, k_b: int):
    """(lo_bytes, bitmap_bytes) of the p4 encoding."""
    lo_bytes = -(-k_b // 2)
    nbits = k_b + -(-wb // 16)
    return lo_bytes, -(-nbits // 8)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def pack_nibbles(q):
    """q: (..., k) int in [0, 15] -> (..., ceil(k/2)) uint8, low nibble
    first."""
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    return (q[..., 0::2] | (q[..., 1::2] << 4)).to(torch.uint8)


def unpack_nibbles(b, k: int):
    """(..., ceil(k/2)) uint8 -> (..., k) int32 in [0, 15]."""
    b = b.to(torch.int32)
    q = torch.stack([b & 15, (b >> 4) & 15], dim=-1)
    return q.reshape(b.shape[:-1] + (2 * b.shape[-1],))[..., :k]


def pack_offsets_plain(off, *, wb: int, mode: str):
    """off: (..., k_b) int32 sorted ascending -> (..., nbytes) uint8."""
    if mode == "u8":
        return off.to(torch.uint8)
    assert mode == "p4", mode
    off = off.to(torch.int32)
    k_b = off.shape[-1]
    _, bm_bytes = _p4_sizes(wb, k_b)
    pos = (off >> 4) + torch.arange(k_b, dtype=torch.int32,
                                    device=off.device)
    # bits[..., p] = any(pos == p): a scatter of ones (pos < 8 bm_bytes)
    bits = torch.zeros(off.shape[:-1] + (bm_bytes * 8,), dtype=torch.int32,
                       device=off.device)
    bits.scatter_(-1, pos.long(), 1)
    shifts = torch.arange(8, dtype=torch.int32, device=off.device)
    bm = (bits.reshape(off.shape[:-1] + (bm_bytes, 8)) << shifts).sum(-1)
    return torch.cat([pack_nibbles(off & 15), bm.to(torch.uint8)], dim=-1)


def unpack_offsets_plain(packed, *, wb: int, k_b: int, mode: str):
    """(..., nbytes) uint8 -> (..., k_b) int32 sorted ascending."""
    if mode == "u8":
        return packed.to(torch.int32)
    assert mode == "p4", mode
    lo_bytes, bm_bytes = _p4_sizes(wb, k_b)
    lo = unpack_nibbles(packed[..., :lo_bytes], k_b)
    bm = packed[..., lo_bytes:].to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = ((bm[..., None] >> shifts) & 1).reshape(
        bm.shape[:-1] + (bm_bytes * 8,))
    # positions of the k_b set bits in ascending order: a stable sort
    # puts the one-bits first, in index order
    pos = torch.argsort(1 - bits, dim=-1, stable=True)[..., :k_b]
    hi = pos.to(torch.int32) - torch.arange(k_b, dtype=torch.int32,
                                            device=packed.device)
    return hi * 16 + lo


def quantize_vals(vals, scale, wire_dtype: str):
    """(m, nb, k_b) f32 values + (m, nb) scales -> the wire value array
    (``_quantize_vals``): round half to even, int4 as two's-complement
    nibbles, fp8 as the e4m3 bits in uint8."""
    if wire_dtype == "f32":
        return vals.float()
    if wire_dtype == "bf16":
        return vals.to(torch.bfloat16)
    r = vals / torch.clamp_min(scale, 1e-30)[..., None]
    if wire_dtype == "int8":
        return torch.round(r * 127.0).to(torch.int8)
    if wire_dtype == "fp8":
        return r.to(torch.float8_e4m3fn).view(torch.uint8)
    assert wire_dtype == "int4", wire_dtype
    return pack_nibbles(torch.round(r * 7.0).to(torch.int32) & 15)


def dequantize_vals(vals, scale, k_b: int, *, wire_dtype: str):
    """Wire value array -> (m, nb, k_b) f32, the inverse of
    ``quantize_vals`` in the reference's arithmetic order
    (``dequantize_vals_jnp``).  No kernel: plain torch is its port."""
    if wire_dtype in ("f32", "bf16"):
        return vals.float()
    s = scale.float()[..., None]
    if wire_dtype == "int8":
        return vals.float() * (s / 127.0)
    if wire_dtype == "fp8":
        return vals.view(torch.float8_e4m3fn).float() * s
    assert wire_dtype == "int4", wire_dtype
    q = unpack_nibbles(vals, k_b)
    q = q - 16 * (q > 7).to(torch.int32)  # two's-complement nibble
    return q.float() * (s / 7.0)


def encode_blocks_plain(xb, k_b: int, *, wire_dtype: str):
    """xb: (m, nb, wb) f32 -> (vals, off, scale), the encode kernel's
    function: the bisection, index-order fill of the threshold band and
    compaction of ``_encode_kernel`` (wire_pack.py:284), op for op.
    off: (m, nb, k_b) int32 ascending; scale: (m, nb) f32 block max |x|."""
    x = xb.float()
    mag = x.abs()
    lo = torch.zeros(mag.shape[:-1] + (1,), dtype=torch.float32,
                     device=x.device)
    hi0 = mag.amax(dim=-1, keepdim=True)
    hi = hi0
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        more = (mag > mid).sum(dim=-1, keepdim=True) > k_b
        lo = torch.where(more, mid, lo)
        hi = torch.where(more, hi, mid)
    primary = mag > hi  # <= k_b of them
    nprim = primary.sum(dim=-1, keepdim=True)
    band = ~primary & ((mag > lo) | (lo == 0.0))
    keep = primary | (band & (band.cumsum(dim=-1) <= k_b - nprim))
    # exactly k_b kept per block, so the kept indices reshape
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(keep)
    off = idx[keep].reshape(x.shape[:-1] + (k_b,))
    # + 0 as the reference's one-hot sum gives it: a kept -0 becomes +0
    vals = torch.gather(x, -1, off) + 0.0
    scale = hi0[..., 0]
    return quantize_vals(vals, scale, wire_dtype), off.to(torch.int32), scale


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if not t.is_cuda:
            raise ValueError(f"{name}: CUDA kernel given a tensor on "
                             f"{t.device}; the plain version serves the CPU")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             f"not contiguous")
        if t.dtype != dt:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dt}")
        if t.ndim != 3:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"(m, nb, n)")


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def encode_blocks_cuda(xb, k_b: int, *, wire_dtype: str):
    """The encode kernel.  xb: (m, nb, wb) f32 contiguous on the card, wb
    up to MAX_ENCODE_BLOCK; 1 <= k_b <= wb.  Returns (vals, off, scale) as
    ``encode_blocks_plain`` does, bit for bit."""
    _check("wire_encode", [xb], [torch.float32])
    if wire_dtype not in _WIRE_CODE:
        raise ValueError(f"wire_encode: wire_dtype {wire_dtype!r} not in "
                         f"{WIRE_DTYPES}")
    m, nb, wb = xb.shape
    if not 1 <= k_b <= wb or wb > MAX_ENCODE_BLOCK:
        raise ValueError(f"wire_encode: k_b {k_b}, wb {wb}: need 1 <= k_b "
                         f"<= wb <= {MAX_ENCODE_BLOCK}")
    k_out = -(-k_b // 2) if wire_dtype == "int4" else k_b
    vals = torch.empty((m, nb, k_out), dtype=_VAL_DTYPE[wire_dtype],
                       device=xb.device)
    off = torch.empty((m, nb, k_b), dtype=torch.int32, device=xb.device)
    scale = torch.empty((m, nb), dtype=torch.float32, device=xb.device)
    err = build.lib().repro_wire_encode(
        xb.data_ptr(), vals.data_ptr(), off.data_ptr(), scale.data_ptr(),
        _WIRE_CODE[wire_dtype], m * nb, wb, k_b,
        torch.cuda.current_stream(xb.device).cuda_stream)
    _launched("wire_encode", err)
    return vals, off, scale


def pack_offsets_cuda(off, *, wb: int):
    """The p4 pack kernel.  off: (m, nb, k_b) int32 ascending block-local
    offsets (< wb) on the card -> (m, nb, nbytes) uint8."""
    _check("wire_pack", [off], [torch.int32])
    m, nb, k_b = off.shape
    lo_bytes, bm_bytes = _p4_sizes(wb, k_b)
    out = torch.empty((m, nb, lo_bytes + bm_bytes), dtype=torch.uint8,
                      device=off.device)
    err = build.lib().repro_wire_pack_p4(
        off.data_ptr(), out.data_ptr(), m * nb, wb, k_b,
        torch.cuda.current_stream(off.device).cuda_stream)
    _launched("wire_pack", err)
    return out


def unpack_offsets_cuda(packed, *, wb: int, k_b: int):
    """The p4 unpack kernel.  packed: (m, nb, nbytes) uint8 on the card ->
    (m, nb, k_b) int32; an all-zero payload decodes to offset 0."""
    _check("wire_unpack", [packed], [torch.uint8])
    m, nb, nbytes = packed.shape
    if nbytes != sum(_p4_sizes(wb, k_b)):
        raise ValueError(f"wire_unpack: {nbytes} bytes a block, expected "
                         f"{sum(_p4_sizes(wb, k_b))} for wb {wb}, k_b {k_b}")
    off = torch.empty((m, nb, k_b), dtype=torch.int32, device=packed.device)
    err = build.lib().repro_wire_unpack_p4(
        packed.data_ptr(), off.data_ptr(), m * nb, wb, k_b,
        torch.cuda.current_stream(packed.device).cuda_stream)
    _launched("wire_unpack", err)
    return off

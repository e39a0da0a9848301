"""The v2 gossip wire's kernels on the card, and their plain versions (port
of ``repro/kernels/wire_pack.py``).

Four functions, each a CUDA kernel in ``csrc/wire_pack.cu`` beside its
plain PyTorch version:

``encode_blocks`` / ``encode_rows``
  per wire block of ``wb`` f32 entries: a 16-step bisection of the
  magnitude threshold, exactly ``k_b`` entries kept (the threshold band
  filled in index order), the kept offsets compacted in ascending order,
  the block's max |x| as its scale, and the kept values quantized to the
  wire dtype (f32, bf16, int8, int4 nibbles two per byte, or fp8 e4m3
  bits).  Port of ``encode_blocks_pallas`` (``_encode_kernel``):
  ``encode_blocks_plain`` computes its function op for op.  The exact
  top-k (``ref.encode_blocks_topk``, the reference's ``encode_blocks_jnp``)
  may keep other members of a threshold band: entries within max|x| *
  2^-16 of the threshold are ties to the bisection.  ``encode_rows``
  encodes some rows of a (C, L) matrix where they lie, the last block
  zero-padded; a wire block of at most ``WARP_ENCODE_MAX`` entries runs
  the warp-per-block kernel, a larger one the CTA-per-block kernel
  (``encode_route``).  Both write the offsets in the form ``omode`` asks:
  int32 ("i32"), or the wire's packed forms "u8" and "p4", which are
  ``pack_offsets_plain`` of the int32 offsets, bit for bit, with no second
  launch (the p4 pack fused into the encode).
``pack_offsets`` / ``unpack_offsets``
  ascending block-local offsets <-> the p4 bytes: the low nibbles two per
  byte, then the delta-unary bitmap with bit (off_i >> 4) + i set for kept
  entry i (bit b of byte j is position 8j + b).  Ports of
  ``pack_offsets_pallas`` / ``unpack_offsets_pallas``; the plain versions
  compute the reference's ``pack_offsets_jnp`` / ``unpack_offsets_jnp``,
  except that a rank past the bitmap's set bits decodes to hi = 0 (its
  low nibble), as the Pallas kernel clamps (the jnp version takes the
  position of a clear bit there): so an all-zero payload (the zero fill of
  a partial rotation) decodes to offset 0 in all four.  Both are lossless.
  A wire block of at most ``WARP_ENCODE_MAX`` entries runs a warp-per-block
  kernel, a larger one a CTA-per-block kernel (``encode_route``, as the
  encode).  The u8 mode is a cast, no kernel.  The gossip packs inside the
  encode and unpacks inside the decode-and-mix; these kernels serve
  ``ops.pack_offsets`` / ``ops.unpack_offsets`` and ``wire_decode``.
``decode_mix``
  the gossip's decode and mix of one column chunk: for each ``MixStep``
  (a band offset o of H and one wire plan's payload) in order, y[c] +=
  coef[c] * decode(the payload row of cluster (c - o) mod C), a cluster
  that sends nothing in that plan contributing a zero payload.  No TPU
  kernel: the reference decodes in jnp (``wire_decode``,
  ``dequantize_vals_jnp``); the kernel holds the p4 unpack and
  ``decode_mix_plain`` is the chain of zero fill, roll, decode and mix
  that the gossip ran before it.

The wrappers take CUDA tensors only: they check device, type, shape and
contiguity, allocate the outputs, launch on the current stream, raise if
the launch failed, and add one to their entry of ``LAUNCHES`` a launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.wire_format import WIRE_DTYPES, offset_mode
from repro_torch.kernels import build

BISECT_ITERS = 16
_WIRE_CODE = {d: i for i, d in enumerate(WIRE_DTYPES)}  # csrc/wire_pack.cu
_DENSE_CODE = {torch.float32: 5, torch.bfloat16: 6, torch.float16: 7}
_OFF_CODE = {"i32": 0, "i16": 1, "u8": 2, "p4": 3}
_VAL_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8, "int4": torch.uint8, "fp8": torch.uint8}
_OFF_DTYPE = {"i32": torch.int32, "i16": torch.int16, "u8": torch.uint8,
              "p4": torch.uint8}
# the CTA-per-block encode keeps a block's wb f32 entries in shared memory
# (227 KB); the warp-per-block encode holds 32 entries a lane in registers
MAX_ENCODE_BLOCK = 232448 // 4
WARP_ENCODE_MAX = 1024
MAX_ENCODE_ROWS = 32   # sender rows an encode launch takes by value
MIX_STEPS = 8          # steps a decode-and-mix launch takes by value
MIX_ROWS = 32          # destination rows a decode-and-mix launch covers

# Launches since the last reset_launches(), bumped only where a kernel is
# launched.
LAUNCHES = {"wire_encode": 0, "wire_pack": 0, "wire_unpack": 0,
            "wire_decode_mix": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _p4_sizes(wb: int, k_b: int):
    """(lo_bytes, bitmap_bytes) of the p4 encoding."""
    lo_bytes = -(-k_b // 2)
    nbits = k_b + -(-wb // 16)
    return lo_bytes, -(-nbits // 8)


def encode_route(wb: int) -> str:
    """Which encode kernel a wire block of wb entries runs: "warp" (one
    warp a block, the entries in registers) or "block" (one CTA a block,
    the entries in shared memory).  By shape only."""
    return "warp" if wb <= WARP_ENCODE_MAX else "block"


class MixStep(NamedTuple):
    """One term of the gossip mix: band offset ``offset``, ``coef`` (C
    floats, destination c's coefficient), one plan's ``payload`` (the
    ``Wire`` fields (vals, off, scale), or ``(rows,)`` for a dense plan,
    ``k_b`` None) and ``senders`` (C ints: the payload row cluster s sends,
    -1 where it sends none)."""
    offset: int
    coef: Tuple[float, ...]
    payload: tuple
    k_b: Optional[int]
    senders: Tuple[int, ...]


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
    # positions of the first k_b set bits in ascending order: a stable
    # sort puts the one-bits first, in index order; a rank past the set
    # bits takes hi = 0
    pos = torch.argsort(1 - bits, dim=-1, stable=True)[..., :k_b]
    rank = torch.arange(k_b, dtype=torch.int32, device=packed.device)
    hi = torch.where(rank < bits.sum(dim=-1, keepdim=True),
                     pos.to(torch.int32) - rank, 0)
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
    (``dequantize_vals_jnp``), the v1 formats' values as ``_decode`` forms
    them.  s / 127 and s / 7 divide by a tensor on s's device: a CUDA
    division by a host scalar multiplies by its reciprocal instead, which
    can differ in the last bit from the CPU's division and the kernel's."""
    if wire_dtype in ("f32", "bf16"):
        return vals.float()
    s = scale.float()[..., None]
    if wire_dtype == "int8":
        return vals.float() * (s / s.new_full((), 127.0))
    if wire_dtype == "fp8":
        return vals.view(torch.float8_e4m3fn).float() * s
    assert wire_dtype == "int4", wire_dtype
    q = unpack_nibbles(vals, k_b)
    q = q - 16 * (q > 7).to(torch.int32)  # two's-complement nibble
    return q.float() * (s / s.new_full((), 7.0))


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


def pad_rows(x, rows, wb: int):
    """Rows ``rows`` (None: all) of x (C, L), zero-padded to whole wire
    blocks: (m, nb, wb) f32."""
    if rows is not None:
        x = x.index_select(0, torch.as_tensor(rows, dtype=torch.long,
                                              device=x.device))
    m, L = x.shape
    pad = (-L) % wb
    return torch.nn.functional.pad(x.float(), (0, pad)).reshape(
        m, (L + pad) // wb, wb)


def encode_rows_plain(x, rows, k_b: int, *, wb: int, wire_dtype: str):
    """The encode of rows ``rows`` (None: all) of x (C, L) f32 in wire
    blocks of wb, the last one zero-padded: ``index_select``, the pad and
    ``encode_blocks_plain``."""
    return encode_blocks_plain(pad_rows(x, rows, wb), k_b,
                               wire_dtype=wire_dtype)


def decode_rows(payload, L: int, wb: int, wire_dtype, k_b, unpack=None):
    """A payload -> dense (m, L) f32: a dense plan's ``(rows,)`` cast up,
    or a wire's values dequantized and scattered into zeroed blocks.  The
    v1 formats describe themselves (``wire_dtype`` may be None; int8
    carries a scale); ``unpack`` turns the v2 formats' packed offsets into
    int32 ones (default the plain version)."""
    if len(payload) == 1:
        return payload[0].float()
    vals, off, scale = payload
    m, nb = vals.shape[:2]
    if wire_dtype in ("int4", "fp8"):
        unpack = unpack or unpack_offsets_plain
        off = unpack(off, wb=wb, k_b=k_b,
                     mode=offset_mode(wb, k_b, wire_dtype))
    else:
        wire_dtype = "f32" if scale is None else "int8"
    v = dequantize_vals(vals, scale, k_b, wire_dtype=wire_dtype)
    dense = torch.zeros((m, nb, wb), dtype=torch.float32, device=v.device)
    dense.scatter_(-1, off.long(), v)
    return dense.reshape(m, nb * wb)[:, :L]


def _zero_filled(payload, senders):
    """The C-row payload: cluster s's row where it sends one, zeros
    elsewhere."""
    C = len(senders)
    if tuple(senders) == tuple(range(C)):
        return payload
    dst = [s for s in range(C) if senders[s] >= 0]
    out = []
    for p in payload:
        if p is None:
            out.append(None)
            continue
        idx = lambda v: torch.as_tensor(v, dtype=torch.long, device=p.device)
        full = torch.zeros((C,) + tuple(p.shape[1:]), dtype=p.dtype,
                           device=p.device)
        out.append(full.index_copy_(0, idx(dst), p.index_select(
            0, idx([senders[s] for s in dst]))))
    return tuple(out)


def decode_mix_plain(y, steps, *, wb: int, wire_dtype: str, diag=None,
                     unpack=None):
    """The gossip's decode and mix in plain torch: y (C, Lc) f32, first
    ``diag * y`` where ``diag`` (C floats) is given; then for each step in
    order the plan's payload zero-filled to C rows, rolled by the band
    offset and decoded, and y + coef * decode, as the gossip's band loop
    ran it."""
    C, L = y.shape
    col = lambda v: torch.as_tensor(np.asarray(v, np.float64),
                                    dtype=torch.float32,
                                    device=y.device)[:, None]
    if diag is not None:
        y = col(diag) * y
    for st in steps:
        rolled = tuple(None if p is None else torch.roll(p, st.offset, dims=0)
                       for p in _zero_filled(st.payload, st.senders))
        y = y + col(st.coef) * decode_rows(rolled, L, wb, wire_dtype,
                                           st.k_b, unpack)
    return y


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(name, tensors, dtypes, ndim=3):
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
        if t.ndim != ndim:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{ndim} dims")


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _encode_launch(x, rows, L, k_b, wb, wire_dtype, omode, out):
    """Encode rows ``rows`` of x (row stride x.stride(0)) into ``out``
    (vals, off, packed, scale) with leading dim len(rows): one launch per
    MAX_ENCODE_ROWS rows.  Returns (vals, the offsets in form ``omode``,
    scale)."""
    vals, off, packed, scale = out
    warp = int(encode_route(wb) == "warp")
    ptr = lambda t, i: None if t is None else t[i].data_ptr()
    for i0 in range(0, len(rows), MAX_ENCODE_ROWS):
        part = rows[i0:i0 + MAX_ENCODE_ROWS]
        idx = (ctypes.c_int * len(part))(*part)
        err = build.lib().repro_wire_encode_rows(
            x.data_ptr(), x.stride(0), idx, len(part), L,
            vals[i0].data_ptr(), ptr(off, i0), ptr(packed, i0),
            scale[i0].data_ptr(), _WIRE_CODE[wire_dtype], _OFF_CODE[omode],
            wb, k_b, warp, _stream(x))
        _launched("wire_encode", err)
    return _encoded(out, omode)


def _encode_outputs(m, nb, k_b, wb, wire_dtype, omode, device):
    """(vals, int32 offsets or None, packed offsets or None, scale) of an
    encode; the CTA-per-block kernel keeps int32 offsets in every form."""
    if wire_dtype not in _WIRE_CODE:
        raise ValueError(f"wire_encode: wire_dtype {wire_dtype!r} not in "
                         f"{WIRE_DTYPES}")
    if not 1 <= k_b <= wb or wb > MAX_ENCODE_BLOCK:
        raise ValueError(f"wire_encode: k_b {k_b}, wb {wb}: need 1 <= k_b "
                         f"<= wb <= {MAX_ENCODE_BLOCK}")
    if omode not in ("i32", "u8", "p4") or (omode == "u8" and wb > 256):
        raise ValueError(f"wire_encode: offset form {omode!r} at wb {wb}: "
                         f"need i32, p4, or u8 with wb <= 256")
    empty = lambda n, dt: torch.empty((m, nb, n), dtype=dt, device=device)
    k_out = -(-k_b // 2) if wire_dtype == "int4" else k_b
    off = (empty(k_b, torch.int32)
           if omode == "i32" or encode_route(wb) == "block" else None)
    packed = None if omode == "i32" else empty(
        k_b if omode == "u8" else sum(_p4_sizes(wb, k_b)), torch.uint8)
    return (empty(k_out, _VAL_DTYPE[wire_dtype]), off, packed,
            torch.empty((m, nb), dtype=torch.float32, device=device))


def _encoded(out, omode):
    """An encode's (vals, the offsets in form ``omode``, scale)."""
    vals, off, packed, scale = out
    return vals, off if omode == "i32" else packed, scale


def encode_blocks_cuda(xb, k_b: int, *, wire_dtype: str, omode: str = "i32"):
    """The encode kernel.  xb: (m, nb, wb) f32 contiguous on the card, wb
    up to MAX_ENCODE_BLOCK; 1 <= k_b <= wb.  Returns (vals, off, scale) as
    ``encode_blocks_plain`` does, bit for bit, the offsets in the form
    ``omode`` ("i32"; "u8" or "p4": ``pack_offsets_plain`` of them)."""
    _check("wire_encode", [xb], [torch.float32])
    m, nb, wb = xb.shape
    out = _encode_outputs(m, nb, k_b, wb, wire_dtype, omode, xb.device)
    if m * nb == 0:
        return _encoded(out, omode)
    # the blocks as one row of m * nb * wb entries
    return _encode_launch(xb.view(1, -1), [0], m * nb * wb, k_b, wb,
                          wire_dtype, omode, out)


def encode_rows_cuda(x, rows, k_b: int, *, wb: int, wire_dtype: str,
                     omode: str = "i32"):
    """The encode kernel on rows ``rows`` (None: all) of x (C, L) f32 on
    the card, read where they lie (unit column stride, any row stride):
    ``encode_rows_plain``'s result, bit for bit, with no copy of the rows,
    and the offsets in the form ``omode`` as ``encode_blocks_cuda``
    gives them."""
    name = "wire_encode"
    if not x.is_cuda:
        raise ValueError(f"{name}: CUDA kernel given a tensor on "
                         f"{x.device}; the plain version serves the CPU")
    if x.dtype != torch.float32 or x.ndim != 2 or (
            x.shape[1] > 1 and x.stride(1) != 1):
        raise ValueError(f"{name}: need a (C, L) f32 matrix with unit "
                         f"column stride, got {x.dtype} {tuple(x.shape)} "
                         f"strides {x.stride()}")
    C, L = x.shape
    rows = list(range(C)) if rows is None else [int(r) for r in rows]
    if any(not 0 <= r < C for r in rows):
        raise ValueError(f"{name}: rows {rows} outside [0, {C})")
    nb = -(-L // wb)
    out = _encode_outputs(len(rows), nb, k_b, wb, wire_dtype, omode,
                          x.device)
    if not rows or L == 0:
        return _encoded(out, omode)
    return _encode_launch(x, rows, L, k_b, wb, wire_dtype, omode, out)


def _p4_warp(name, wb, k_b, force_block):
    """The C entries' ``warp`` argument: the route by shape
    (``encode_route``), or the CTA-per-block kernel with ``force_block``
    (it runs on any wb)."""
    if not 1 <= k_b <= wb:
        raise ValueError(f"{name}: k_b {k_b}, wb {wb}: need 1 <= k_b <= wb")
    return int(not force_block and encode_route(wb) == "warp")


def pack_offsets_cuda(off, *, wb: int, _force_block: bool = False):
    """The p4 pack kernel.  off: (m, nb, k_b) int32 ascending block-local
    offsets (< wb) on the card -> (m, nb, nbytes) uint8.
    ``_force_block`` runs the CTA-per-block kernel at any wb (a test hook:
    it checks and times that kernel beside the warp one)."""
    _check("wire_pack", [off], [torch.int32])
    m, nb, k_b = off.shape
    warp = _p4_warp("wire_pack", wb, k_b, _force_block)
    lo_bytes, bm_bytes = _p4_sizes(wb, k_b)
    out = torch.empty((m, nb, lo_bytes + bm_bytes), dtype=torch.uint8,
                      device=off.device)
    err = build.lib().repro_wire_pack_p4(
        off.data_ptr(), out.data_ptr(), m * nb, wb, k_b, warp, _stream(off))
    _launched("wire_pack", err)
    return out


def unpack_offsets_cuda(packed, *, wb: int, k_b: int,
                        _force_block: bool = False):
    """The p4 unpack kernel.  packed: (m, nb, nbytes) uint8 on the card ->
    (m, nb, k_b) int32, ``unpack_offsets_plain``'s result bit for bit on
    any bytes; an all-zero payload decodes to offset 0.  ``_force_block``
    as for ``pack_offsets_cuda``."""
    _check("wire_unpack", [packed], [torch.uint8])
    m, nb, nbytes = packed.shape
    warp = _p4_warp("wire_unpack", wb, k_b, _force_block)
    if nbytes != sum(_p4_sizes(wb, k_b)):
        raise ValueError(f"wire_unpack: {nbytes} bytes a block, expected "
                         f"{sum(_p4_sizes(wb, k_b))} for wb {wb}, k_b {k_b}")
    off = torch.empty((m, nb, k_b), dtype=torch.int32, device=packed.device)
    err = build.lib().repro_wire_unpack_p4(
        packed.data_ptr(), off.data_ptr(), m * nb, wb, k_b, warp,
        _stream(packed))
    _launched("wire_unpack", err)
    return off


class _MixStep(ctypes.Structure):  # csrc/wire_pack.cu:MixStep
    _fields_ = [("vals", ctypes.c_void_p), ("off", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("vtype", ctypes.c_int),
                ("omode", ctypes.c_int), ("k_b", ctypes.c_int),
                ("off_bytes", ctypes.c_int),
                ("coef", ctypes.c_float * MIX_ROWS),
                ("row", ctypes.c_int * MIX_ROWS)]


class _MixArgs(ctypes.Structure):  # csrc/wire_pack.cu:MixArgs
    _fields_ = [("y", ctypes.c_void_p), ("src", ctypes.c_void_p),
                ("y_stride", ctypes.c_longlong),
                ("src_stride", ctypes.c_longlong),
                ("Lc", ctypes.c_longlong), ("nb", ctypes.c_int),
                ("wb", ctypes.c_int), ("c0", ctypes.c_int),
                ("nrows", ctypes.c_int), ("nsteps", ctypes.c_int),
                ("scaled", ctypes.c_int), ("ys_shared", ctypes.c_int),
                ("vec", ctypes.c_int),
                ("diag", ctypes.c_float * MIX_ROWS),
                ("step", _MixStep * MIX_STEPS)]


def _mix_step_fields(st, C, nb, Lc, wb, wire_dtype, device):
    """Checks one step's payload; returns the kernel's (vals, off, scale,
    vtype, omode, k_b, off_bytes)."""
    name = "wire_decode_mix"
    if len(st.coef) != C or len(st.senders) != C:
        raise ValueError(f"{name}: coef and senders need {C} entries")
    if st.k_b is None:
        (rows,) = st.payload
        if rows.dtype not in _DENSE_CODE:
            raise ValueError(f"{name}: dense rows of {rows.dtype}")
        _check(name, [rows], [rows.dtype], ndim=2)
        m = rows.shape[0]
        if rows.shape[1] != Lc or rows.device != device:
            raise ValueError(f"{name}: dense rows {tuple(rows.shape)} on "
                             f"{rows.device} for {Lc} columns on {device}")
        fields = (rows.data_ptr(), None, None, _DENSE_CODE[rows.dtype], 0,
                  0, 0)
    else:
        vals, off, scale = st.payload
        k_b = int(st.k_b)
        mode = offset_mode(wb, k_b, wire_dtype)
        k_out = -(-k_b // 2) if wire_dtype == "int4" else k_b
        n_off = {"u8": k_b, "p4": sum(_p4_sizes(wb, k_b))}.get(mode, k_b)
        m = vals.shape[0]
        _check(name, [vals, off], [_VAL_DTYPE[wire_dtype], _OFF_DTYPE[mode]])
        if vals.device != device:
            raise ValueError(f"{name}: payload on {vals.device}, y on "
                             f"{device}")
        if (tuple(vals.shape) != (m, nb, k_out)
                or tuple(off.shape) != (m, nb, n_off)):
            raise ValueError(f"{name}: payload shapes {tuple(vals.shape)}, "
                             f"{tuple(off.shape)} for {nb} blocks, k_b "
                             f"{k_b}, {mode} offsets")
        if (scale is None) != (wire_dtype in ("f32", "bf16")):
            raise ValueError(f"{name}: {wire_dtype} payload with scale "
                             f"{scale is not None}")
        if scale is not None:
            _check(name, [scale], [torch.float32], ndim=2)
            if tuple(scale.shape) != (m, nb):
                raise ValueError(f"{name}: scale {tuple(scale.shape)}")
        fields = (vals.data_ptr(), off.data_ptr(),
                  None if scale is None else scale.data_ptr(),
                  _WIRE_CODE[wire_dtype], _OFF_CODE[mode], k_b,
                  n_off if mode in ("u8", "p4") else 0)
    if any(not -1 <= s < m for s in st.senders):
        raise ValueError(f"{name}: senders {st.senders} for {m} payload "
                         f"rows")
    return fields


def decode_mix_cuda(y, steps, *, wb: int, wire_dtype: str, diag=None):
    """The decode-and-mix kernel: ``decode_mix_plain``'s result, bit for
    bit, in a new (C, Lc) f32 tensor.  y: (C, Lc) f32 on the card with
    unit column stride (read only); the payloads on the same card.  One
    launch per MIX_STEPS steps (at least one) and MIX_ROWS destination
    rows, each later launch over the previous one's result."""
    name = "wire_decode_mix"
    if not y.is_cuda:
        raise ValueError(f"{name}: CUDA kernel given a tensor on "
                         f"{y.device}; the plain version serves the CPU")
    if y.dtype != torch.float32 or y.ndim != 2 or (
            y.shape[1] > 1 and y.stride(1) != 1):
        raise ValueError(f"{name}: need a (C, Lc) f32 matrix with unit "
                         f"column stride, got {y.dtype} {tuple(y.shape)}")
    if wire_dtype not in _WIRE_CODE:
        raise ValueError(f"{name}: wire_dtype {wire_dtype!r} not in "
                         f"{WIRE_DTYPES}")
    if not 1 <= wb <= MAX_ENCODE_BLOCK:
        raise ValueError(f"{name}: wb {wb} outside [1, {MAX_ENCODE_BLOCK}]")
    C, Lc = y.shape
    nb = -(-Lc // wb)
    fields = [_mix_step_fields(st, C, nb, Lc, wb, wire_dtype, y.device)
              for st in steps]
    f32 = lambda v: np.asarray(v, np.float64).astype(np.float32)
    diag32 = None if diag is None else f32(diag)
    if diag32 is not None and len(diag32) != C:
        raise ValueError(f"{name}: diag needs {C} entries")
    src, out = y, torch.empty((C, Lc), dtype=torch.float32, device=y.device)
    lib = build.lib()
    for s0 in range(0, max(len(steps), 1), MIX_STEPS):
        part = range(s0, min(s0 + MIX_STEPS, len(steps)))
        for c0 in range(0, C, MIX_ROWS):
            rows = range(c0, min(c0 + MIX_ROWS, C))
            a = _MixArgs(y=out.data_ptr(), src=src.data_ptr(),
                         y_stride=out.stride(0), src_stride=src.stride(0),
                         Lc=Lc, nb=nb, wb=wb, c0=c0, nrows=len(rows),
                         nsteps=len(part), scaled=int(s0 == 0 and
                                                      diag32 is not None))
            if a.scaled:
                for i, c in enumerate(rows):
                    a.diag[i] = diag32[c]
            for j, s in enumerate(part):
                st, f = steps[s], fields[s]
                d = a.step[j]
                (d.vals, d.off, d.scale, d.vtype, d.omode, d.k_b,
                 d.off_bytes) = f
                coef = f32(st.coef)
                for i, c in enumerate(rows):
                    d.coef[i] = coef[c]
                    d.row[i] = st.senders[(c - st.offset) % C]
            err = lib.repro_wire_decode_mix(ctypes.addressof(a),
                                            ctypes.sizeof(a), _stream(y))
            _launched(name, err)
        src = out  # a later launch reads the result in place
    return out

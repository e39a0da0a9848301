"""Wire byte layouts (own copy of ``repro/core/wire_format.py``, numpy).

The single source of the wire's sizes: ``dist/collectives`` (the wire
block, k_b, the offset encoding and the dense-fallback test of each wire
plan) and the cost model (``compression_ratio_bytes``) both read them.

Formats (per wire block of ``wb`` dense entries, ``k_b`` kept):

  dtype   values                offsets                      scale
  f32     k_b * 4 B (f32)       k_b * 4 B (int32)            —
  bf16    k_b * 2 B (bf16)      k_b * 4 B (int32)            —
  int8    k_b * 1 B (int8)      k_b * 2 B (int16)            4 B (f32)
  fp8     k_b * 1 B (e4m3)      packed (u8 | p4, see below)  4 B (f32)
  int4    ceil(k_b/2) B         packed (u8 | p4)             4 B (f32)
          (2 nibbles / byte)

The v2 formats (int4/fp8) ship sorted ascending block-local offsets in
whichever packed encoding is smaller for the static (wb, k_b) pair:

  u8  raw uint8 offsets, k_b bytes — valid only when wb <= 256;
  p4  lo nibbles packed two per byte (ceil(k_b/2) bytes) followed by a
      delta-unary bitmap of the hi nibbles, ceil((k_b + ceil(wb/16)) / 8)
      bytes.

All sizes are static in (wb, k_b); functions accept scalar or ndarray
``k_b``/``theta`` (the cost model's per-device vectors).
"""
from __future__ import annotations

import numpy as np

WIRE_DTYPES = ("f32", "bf16", "int8", "int4", "fp8")

# value bits per kept entry
_VAL_BITS = {"f32": 32, "bf16": 16, "int8": 8, "fp8": 8, "int4": 4}
# per-wire-block f32 dequant scale (quantized formats only)
_SCALE_BYTES = {"f32": 0, "bf16": 0, "int8": 4, "fp8": 4, "int4": 4}
# fixed-width offset itemsize of the v1 formats (v2 formats pack)
_V1_OFF_BYTES = {"f32": 4, "bf16": 4, "int8": 2}


def wire_block_of(L: int, wire_block: int) -> int:
    """Effective wire block: never larger than the row."""
    return max(1, min(int(wire_block), int(L)))


def num_blocks(L: int, wb: int) -> int:
    return -(-int(L) // int(wb))


def wire_k(theta: float, L: int, wire_block: int = 1024) -> int:
    """Static per-wire-block k for a compression level theta (k_b)."""
    wb = wire_block_of(L, wire_block)
    return max(1, min(wb, int(np.ceil(float(theta) * wb))))


def _ceil_div(a, b):
    return -(-a // b)


def value_bytes(k_b, wire_dtype: str):
    """Bytes the k_b kept values occupy (int4 packs 2 per byte)."""
    return _ceil_div(np.asarray(k_b) * _VAL_BITS[wire_dtype], 8)


def p4_bytes(wb: int, k_b):
    """Bytes of the p4 packed-offset encoding (lo nibbles + hi bitmap)."""
    k = np.asarray(k_b)
    return _ceil_div(k, 2) + _ceil_div(k + _ceil_div(int(wb), 16), 8)


def offset_mode(wb: int, k_b: int, wire_dtype: str) -> str:
    """Static offset encoding for one (wb, k_b) pair:
    "i32"/"i16" for the v1 formats, else the smaller of "u8"/"p4"."""
    if wire_dtype in _V1_OFF_BYTES:
        return "i16" if wire_dtype == "int8" else "i32"
    if wb <= 256 and int(k_b) <= int(p4_bytes(wb, k_b)):
        return "u8"
    return "p4"


def offset_bytes(wb: int, k_b, wire_dtype: str):
    """Bytes the k_b block-local offsets occupy on the wire."""
    if wire_dtype in _V1_OFF_BYTES:
        return np.asarray(k_b) * _V1_OFF_BYTES[wire_dtype]
    p4 = p4_bytes(wb, k_b)
    if wb <= 256:
        return np.minimum(np.asarray(k_b), p4)
    return p4


def block_bytes(wb: int, k_b, wire_dtype: str):
    """Exact bytes one encoded wire block occupies (values+offsets+scale)."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype {wire_dtype!r} not in {WIRE_DTYPES}")
    return (value_bytes(k_b, wire_dtype) + offset_bytes(wb, k_b, wire_dtype)
            + _SCALE_BYTES[wire_dtype])


def row_bytes(theta: float, L: int, *, wire_dtype: str = "f32",
              wire_block: int = 1024) -> int:
    """Exact bytes one encoded row occupies on the wire."""
    wb = wire_block_of(L, wire_block)
    return int(num_blocks(L, wb)
               * block_bytes(wb, wire_k(theta, L, wire_block), wire_dtype))


def encoding_reaches_dense(k_b: int, L: int, wire_block: int,
                           wire_dtype: str, dense_itemsize: int) -> bool:
    """True when the sparse encoding at per-block budget k_b would occupy
    at least the dense row at ``dense_itemsize`` bytes/entry: the level
    then takes the dense-wire fallback (dist/collectives)."""
    wb = wire_block_of(L, wire_block)
    return bool(num_blocks(L, wb) * block_bytes(wb, int(k_b), wire_dtype)
                >= int(L) * int(dense_itemsize))


def compression_ratio_bytes(theta, *, wire_dtype: str = "f32",
                            wire_block: int = 1024, dense_bits=16):
    """Wire bytes of the sparse encoding as a fraction of the dense
    payload — the cost model's effective theta.  Exact per-block math
    (k_b = ceil(theta * wb), clamped to [1, wb]) over the same tables
    ``dist/collectives.wire_encode`` ships, elementwise over scalar or
    array theta (the controller's per-device vector)."""
    wb = int(wire_block)
    k_b = np.clip(np.ceil(np.asarray(theta, np.float64) * wb),
                  1, wb).astype(np.int64)
    return block_bytes(wb, k_b, wire_dtype) / (wb * dense_bits / 8)
